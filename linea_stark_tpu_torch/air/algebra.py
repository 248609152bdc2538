"""Dual-backend algebra for AIR constraint evaluation; port of
``linea_stark_tpu/air/algebra.py``.

The same gadget code (``air/gadgets.py``) runs vectorized over the LDE
domain inside the quotient and at one opened point inside the verifier.
"""

from __future__ import annotations

from .. import fr_ops as fo
from ..field import fr, oracle
from ..field.constants import R_MOD


class VectorAlgebra:
    """Tensor backend: elements are (8, *batch_shape) Montgomery tensors on
    ``device``; ops go through :mod:`..fr_ops` (kernels on CUDA)."""

    def __init__(self, batch_shape, device=None):
        self.batch_shape = tuple(batch_shape)
        self.device = device

    def add(self, a, b):
        return fo.add(a, b)

    def sub(self, a, b):
        return fo.sub(a, b)

    def mul(self, a, b):
        return fo.mul(a, b)

    @property
    def one(self):
        return fr.ones(self.batch_shape, device=self.device)

    @property
    def zero(self):
        return fr.zeros(self.batch_shape, device=self.device)

    def constant(self, v: int):
        return fr.full(self.batch_shape, v, device=self.device)


class ScalarAlgebra:
    """Python-int backend: elements are canonical residues (verifier path)."""

    def add(self, a, b):
        return oracle.add(a, b)

    def sub(self, a, b):
        return oracle.sub(a, b)

    def mul(self, a, b):
        return oracle.mul(a, b)

    one = 1
    zero = 0

    def constant(self, v: int):
        return v % R_MOD


def horner(alg, alpha, values):
    """sum values[j]·alpha^(W-1-j) — the row compression used by both gadgets
    (``comb = comb*alpha + col``)."""
    acc = alg.zero
    for v in values:
        acc = alg.add(alg.mul(acc, alpha), v)
    return acc
