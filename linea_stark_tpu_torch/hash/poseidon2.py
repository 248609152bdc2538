"""Poseidon2 permutation (width 3) over BLS12-377 Fr.

The host half (``Poseidon2Params``, ``derive_round_constants``,
``DEFAULT_PARAMS`` and the ``*_ints`` reference functions) is a jax-free
copy of ``linea_stark_tpu/hash/poseidon2.py``: the transcript and the
constant schedule must agree bit for bit with the reference, and the
reference module cannot be imported without JAX.  The device half runs the
permutation through the K4 CUDA kernels (``kernels/poseidon2.py``) on CUDA
tensors and through their plain versions on CPU tensors.

Round structure: 8 external + 22 internal rounds, S-box x^11, external
matrix circ(2,1,1), internal matrix diag(1,1,2) + ones; constants derived
from a seed with SHA-256.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Sequence

import torch

from ..field import oracle
from ..field.constants import POSEIDON2_ALPHA, R_MOD

WIDTH = 3
RATE = 2
OUT = 1
DEFAULT_ROUNDS_F = 8
DEFAULT_ROUNDS_P = 22
DEFAULT_SEED = b"linea-stark-tpu/poseidon2/bls12-377-fr/t3/v1"


def derive_round_constants(
    seed: bytes = DEFAULT_SEED,
    rounds_f: int = DEFAULT_ROUNDS_F,
    rounds_p: int = DEFAULT_ROUNDS_P,
) -> list:
    """Deterministic constant schedule: SHA-256(seed || counter) mod r.

    The modulo bias is ~2^-3 per draw (r is a 253-bit prime) which is
    irrelevant for constant generation; we keep the simple rule so any
    implementation can reproduce it from the seed alone.
    """
    n = rounds_f * WIDTH + rounds_p
    out = []
    for i in range(n):
        h = hashlib.sha256(seed + i.to_bytes(4, "little")).digest()
        out.append(int.from_bytes(h, "big") % R_MOD)
    return out


@dataclass(frozen=True)
class Poseidon2Params:
    """Full permutation specification (hashable: a cache key for the
    constant schedules)."""

    rounds_f: int = DEFAULT_ROUNDS_F
    rounds_p: int = DEFAULT_ROUNDS_P
    alpha: int = POSEIDON2_ALPHA
    constants: tuple = field(
        default_factory=lambda: tuple(derive_round_constants())
    )

    def __post_init__(self):
        assert self.rounds_f % 2 == 0
        assert len(self.constants) == self.rounds_f * WIDTH + self.rounds_p

    def external_constants(self, half: int) -> list:
        """3-element constant rows for the first/second half of external rounds."""
        rf2 = self.rounds_f // 2
        base = 0 if half == 0 else rf2 * WIDTH + self.rounds_p
        return [
            self.constants[base + r * WIDTH : base + (r + 1) * WIDTH]
            for r in range(rf2)
        ]

    def internal_constants(self) -> list:
        base = (self.rounds_f // 2) * WIDTH
        return list(self.constants[base : base + self.rounds_p])


DEFAULT_PARAMS = Poseidon2Params()


# ---------------------------------------------------------------------------
# Host oracle (Python ints) — used by the Fiat-Shamir challenger and tests
# ---------------------------------------------------------------------------

def _sbox_int(x: int, alpha: int) -> int:
    return pow(x, alpha, R_MOD)


def _external_int(s):
    t = (s[0] + s[1] + s[2]) % R_MOD
    return [(x + t) % R_MOD for x in s]


def _internal_int(s):
    t = (s[0] + s[1] + s[2]) % R_MOD
    return [(s[0] + t) % R_MOD, (s[1] + t) % R_MOD, (2 * s[2] + t) % R_MOD]


def permute_ints(state: Sequence[int], params: Poseidon2Params = DEFAULT_PARAMS) -> list:
    s = [x % R_MOD for x in state]
    assert len(s) == WIDTH
    s = _external_int(s)
    for rc in params.external_constants(0):
        s = [_sbox_int((x + c) % R_MOD, params.alpha) for x, c in zip(s, rc)]
        s = _external_int(s)
    for c in params.internal_constants():
        s = [_sbox_int((s[0] + c) % R_MOD, params.alpha)] + list(s[1:])
        s = _internal_int(s)
    for rc in params.external_constants(1):
        s = [_sbox_int((x + c) % R_MOD, params.alpha) for x, c in zip(s, rc)]
        s = _external_int(s)
    return s


def hash_ints(inputs: Sequence[int], params: Poseidon2Params = DEFAULT_PARAMS) -> int:
    """PaddingFreeSponge(width 3, rate 2, out 1) over Python ints.

    Overwrite-absorb semantics: each chunk of <=2 inputs overwrites the rate
    portion of the state, then the state is permuted — including for the
    final (possibly partial) chunk.  Zero-length input hashes to 0 (state is
    never permuted).  Mirrors ``PaddingFreeSponge<Perm, 3, 2, 1>``
    (bin/src/config.rs:12).
    """
    state = [0] * WIDTH
    vals = [x % R_MOD for x in inputs]
    for i in range(0, len(vals), RATE):
        chunk = vals[i : i + RATE]
        state[: len(chunk)] = chunk
        state = permute_ints(state, params)
    return state[0]


def compress_ints(a: int, b: int, params: Poseidon2Params = DEFAULT_PARAMS) -> int:
    """2-to-1 compression = hash of the pair (CompressionFunctionFromHasher,
    bin/src/config.rs:17): one permutation of (a, b, 0)."""
    return hash_ints([a, b], params)


# ---------------------------------------------------------------------------
# Device path: (8, N) Montgomery tensors
# ---------------------------------------------------------------------------

def permute(s0, s1, s2, params: Poseidon2Params = DEFAULT_PARAMS):
    """Permutation of a batch of states; each s_i is (8, N)."""
    from ..kernels import poseidon2 as kp

    return kp.permute(s0, s1, s2, params)


def permute2(left, right, params: Poseidon2Params = DEFAULT_PARAMS, outputs: int = 3):
    """Permutation of (left, right, 0): the first ``outputs`` state words."""
    from ..kernels import poseidon2 as kp

    return kp.permute2(left, right, params, outputs)


def hash_columns(columns: Sequence, params: Poseidon2Params = DEFAULT_PARAMS):
    """Sponge-hash W columns of (8, N) values into one (8, N) digest column.

    Rate-2 overwrite absorb (``PaddingFreeSponge<3, 2, 1>``), as
    ``pallas_poseidon2.hash_columns_list``: the first chunk is one
    ``permute2`` (the zero capacity word is built in the kernel), later
    chunks thread only the capacity word, and an odd tail chunk keeps the
    second rate word's previous value."""
    w = len(columns)
    assert w >= 1
    if w == 1:
        return permute2(columns[0], torch.zeros_like(columns[0]), params, 1)[0]
    s0, s1, s2 = permute2(columns[0], columns[1], params)
    i = RATE
    while i + 1 < w:
        s0, s1, s2 = permute(columns[i], columns[i + 1], s2, params)
        i += RATE
    if i < w:
        s0, s1, s2 = permute(columns[i], s1, s2, params)
    return s0


def compress(left, right, params: Poseidon2Params = DEFAULT_PARAMS):
    """2-to-1 digest compression: (8, N) x2 -> (8, N)."""
    return permute2(left, right, params, 1)[0]


def merkle_level(d, params: Poseidon2Params = DEFAULT_PARAMS):
    """Next natural-order Merkle level: (8, 2m) -> (8, m)."""
    from ..kernels import poseidon2 as kp

    return kp.merkle_level(d, params)
