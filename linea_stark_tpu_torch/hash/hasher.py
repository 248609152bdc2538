"""Merkle hashers (Poseidon2 and Keccak-256), port of
``linea_stark_tpu/hash/hasher.py``.

Digests are one field element: Keccak's 32-byte output is read as a
big-endian integer and reduced mod r.  Device sweeps take (8, N) Montgomery
tensors; the ``*_ints`` forms take canonical Python ints.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..field import fr
from . import keccak as kk
from . import poseidon2 as p2


@dataclass(frozen=True)
class Poseidon2Hasher:
    params: p2.Poseidon2Params = field(default_factory=lambda: p2.DEFAULT_PARAMS)

    def hash_columns(self, cols):
        return p2.hash_columns(list(cols), self.params)

    def hash_matrix(self, m):
        """Row-hash of a whole (8, W, N) matrix (columns as strided views)."""
        return p2.hash_columns([m[:, c] for c in range(m.shape[1])], self.params)

    def compress(self, left, right):
        return p2.compress(left, right, self.params)

    def merkle_level(self, d):
        """Next natural-order tree level: (8, 2m) -> (8, m)."""
        return p2.merkle_level(d, self.params)

    def hash_ints(self, vals):
        return p2.hash_ints(vals, self.params)

    def compress_ints(self, a, b):
        return p2.compress_ints(a, b, self.params)


# ---------------------------------------------------------------------------
# Keccak
# ---------------------------------------------------------------------------

def _bswap64(x: torch.Tensor) -> torch.Tensor:
    """Byte-reverse int64 lanes."""
    out = torch.zeros_like(x)
    for i in range(8):
        out = out | (((x >> (8 * i)) & 0xFF) << (56 - 8 * i))
    return out


def _mont_cols_to_words(cols) -> torch.Tensor:
    """Montgomery (8, N) columns -> (4W, N) int64 Keccak message words: each
    value's canonical 32-byte big-endian encoding, concatenated, read as
    little-endian 64-bit words (message word 4c + q is the byte swap of
    canonical 64-bit word 3 - q of column c)."""
    words = []
    for col in cols:
        canon = fr._wide(fr.from_mont(col))  # (8, N) int64 in [0, 2**32)
        le = [canon[2 * k] | (canon[2 * k + 1] << 32) for k in range(4)]
        words.extend(_bswap64(le[3 - q]) for q in range(4))
    return torch.stack(words)


def _digest_words_to_field_mont(dw: torch.Tensor) -> torch.Tensor:
    """(4, N) int64 digest words (LE 64-bit words of the digest bytes) ->
    (8, N) Montgomery field digests: the digest as a big-endian integer
    (64-bit word k = byte swap of digest word 3 - k), then ``to_mont``, whose
    multiply by R² also reduces a value >= r."""
    words = []
    for k in range(4):
        be = _bswap64(dw[3 - k])
        words.extend([be & fr.WORD_MASK, (be >> 32) & fr.WORD_MASK])
    return fr.to_mont(fr._narrow(torch.stack(words)))


@dataclass(frozen=True)
class KeccakHasher:
    """Keccak-256 MMCS hasher with field-element digests (digest mod r).

    On CUDA tensors every method below launches K5 ``kc_hash`` once; on CPU
    tensors it composes the plain pieces above."""

    def hash_columns(self, cols):
        from ..kernels import keccak as kc

        return kc.hash_columns(cols)

    def hash_matrix(self, m):
        """Row-hash of a whole (8, W, N) matrix (columns as strided views)."""
        return self.hash_columns([m[:, c] for c in range(m.shape[1])])

    def compress(self, left, right):
        return self.hash_columns([left, right])

    def merkle_level(self, d):
        """Next natural-order tree level: (8, 2m) -> (8, m)."""
        return self.hash_columns([d[:, 0::2], d[:, 1::2]])

    def hash_ints(self, vals):
        return kk.keccak256_field(vals)

    def compress_ints(self, a, b):
        return kk.keccak256_field([a, b])


def make_hasher(obj):
    """Normalize: Poseidon2Params | hasher instance -> hasher."""
    if isinstance(obj, (Poseidon2Hasher, KeccakHasher)):
        return obj
    if isinstance(obj, p2.Poseidon2Params):
        return Poseidon2Hasher(obj)
    raise TypeError(f"not a hasher: {type(obj)}")
