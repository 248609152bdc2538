"""Merkle hasher interface (Poseidon2), port of
``linea_stark_tpu/hash/hasher.py:Poseidon2Hasher``.

Digests are one field element.  Device sweeps take (8, N) Montgomery
tensors; the ``*_ints`` forms take canonical Python ints.
"""

from __future__ import annotations

from dataclasses import dataclass, field

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


def make_hasher(obj):
    """Normalize: Poseidon2Params | Poseidon2Hasher -> Poseidon2Hasher."""
    if isinstance(obj, Poseidon2Hasher):
        return obj
    if isinstance(obj, p2.Poseidon2Params):
        return Poseidon2Hasher(obj)
    raise TypeError(f"not a hasher: {type(obj)}")
