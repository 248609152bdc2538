"""Host-side big-integer reference implementation of Fr.

Jax-free copy of ``linea_stark_tpu/field/oracle.py``: the bit-exactness
oracle for the limb kernels (the role ark-ff
plays for the reference prover — SURVEY.md §2c).  Everything here is plain
Python integers; it is used by unit tests and by the (tiny, serial) host-side
Fiat-Shamir challenger, never on the device hot path.
"""

from __future__ import annotations

from .constants import (
    LIMB_BITS,
    LIMB_MASK,
    MONT_N0,
    MONT_R,
    MONT_R2,
    NUM_LIMBS,
    R_MOD,
)


def add(a: int, b: int) -> int:
    s = a + b
    return s - R_MOD if s >= R_MOD else s


def sub(a: int, b: int) -> int:
    return (a - b) % R_MOD


def mul(a: int, b: int) -> int:
    return (a * b) % R_MOD


def neg(a: int) -> int:
    return (-a) % R_MOD


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("inverse of zero in Fr")
    return pow(a, R_MOD - 2, R_MOD)


def pow_(a: int, e: int) -> int:
    return pow(a, e, R_MOD)


MONT_R_INV = pow(MONT_R, R_MOD - 2, R_MOD)


def to_mont(a: int) -> int:
    return (a * MONT_R) % R_MOD


def from_mont(a: int) -> int:
    # a * R^{-1} mod r
    return (a * MONT_R_INV) % R_MOD


def mont_mul(a: int, b: int) -> int:
    """Word-by-word Montgomery multiplication, mirroring the limb kernel.

    Used to cross-check the radix-2**16 reduction in field/fr.py; returns
    a*b*R^{-1} mod r for canonical inputs a, b < r.
    """
    acc = a * b
    for _ in range(NUM_LIMBS):
        m = (-acc) & LIMB_MASK  # MONT_N0 == 0xFFFF => m = (-acc) mod 2^16
        acc = (acc + m * R_MOD) >> LIMB_BITS
    assert MONT_N0 == LIMB_MASK
    if acc >= R_MOD:
        acc -= R_MOD
    return acc


def from_be_bytes_mod_order(data: bytes) -> int:
    """Big-endian bytes reduced mod r — matches ark-ff's
    ``from_be_bytes_mod_order`` semantics used for every trace value
    (reference: trace/src/permutation.rs:102, trace/src/lookup.rs:266)."""
    return int.from_bytes(data, "big") % R_MOD

