"""Vectorized host-side Poseidon2 + FRI-tail helpers over numpy object
(bigint) arrays: a jax-free copy of ``linea_stark_tpu/hash/np_poseidon2.py``.

Each helper delegates to the native C engine (``hash/native_engine.py``);
the numpy object-array forms are the portable oracle for it.  Everything
operates on canonical Python-int values (no Montgomery form), matching
``field.oracle`` and ``hash.poseidon2.permute_ints`` exactly.
"""

from __future__ import annotations

import numpy as np

from ..field.constants import R_MOD
from . import poseidon2 as p2
from . import native_engine as ne


def _native() -> bool:
    return ne.available()


def _as_obj(vals) -> np.ndarray:
    return np.array([int(v) for v in vals], dtype=object)


def _sbox11(x: np.ndarray) -> np.ndarray:
    x2 = x * x % R_MOD
    x3 = x2 * x % R_MOD
    x4 = x2 * x2 % R_MOD
    x8 = x4 * x4 % R_MOD
    return x8 * x3 % R_MOD


def permute_vec(s0, s1, s2, params: p2.Poseidon2Params = p2.DEFAULT_PARAMS):
    """Vectorized width-3 permutation of object arrays (canonical ints).

    Delegates to the native C engine (hash/native_engine.py, ~25x the
    object-array throughput) when it is available; the numpy path below is
    the portable fallback and the differential-test oracle."""
    if _native() and params.alpha == 11:
        o0, o1, o2 = ne.permute(
            ne.obj_to_u64(np.asarray(s0, dtype=object) % R_MOD),
            ne.obj_to_u64(np.asarray(s1, dtype=object) % R_MOD),
            ne.obj_to_u64(np.asarray(s2, dtype=object) % R_MOD),
            params,
        )
        return [ne.u64_to_obj(o0), ne.u64_to_obj(o1), ne.u64_to_obj(o2)]
    assert params.alpha == 11, "host vector path specializes x^11"
    s = [s0 % R_MOD, s1 % R_MOD, s2 % R_MOD]

    def ext(sv):
        t = (sv[0] + sv[1] + sv[2]) % R_MOD
        return [(x + t) % R_MOD for x in sv]

    def intl(sv):
        t = (sv[0] + sv[1] + sv[2]) % R_MOD
        return [(sv[0] + t) % R_MOD, (sv[1] + t) % R_MOD, (2 * sv[2] + t) % R_MOD]

    s = ext(s)
    for rc in params.external_constants(0):
        s = [_sbox11((x + c) % R_MOD) for x, c in zip(s, rc)]
        s = ext(s)
    for c in params.internal_constants():
        s = [_sbox11((s[0] + c) % R_MOD)] + s[1:]
        s = intl(s)
    for rc in params.external_constants(1):
        s = [_sbox11((x + c) % R_MOD) for x, c in zip(s, rc)]
        s = ext(s)
    return s


def compress_vec(a: np.ndarray, b: np.ndarray, params=p2.DEFAULT_PARAMS) -> np.ndarray:
    if _native() and params.alpha == 11:
        out = ne.compress(
            ne.obj_to_u64(np.asarray(a, dtype=object) % R_MOD),
            ne.obj_to_u64(np.asarray(b, dtype=object) % R_MOD),
            params,
        )
        return ne.u64_to_obj(out)
    z = np.zeros(len(a), dtype=object)
    return permute_vec(a, b, z, params)[0]


def hash_columns_vec(cols, params=p2.DEFAULT_PARAMS) -> np.ndarray:
    """Sponge row-hash of a list of object-array columns (rate 2, out 1)."""
    if _native() and params.alpha == 11:
        cu = np.stack(
            [ne.obj_to_u64(np.asarray(c, dtype=object) % R_MOD) for c in cols]
        )
        return ne.u64_to_obj(ne.hash_columns(cu, params))
    n = len(cols[0])
    z = np.zeros(n, dtype=object)
    s0, s1, s2 = z, z, z
    for i in range(0, len(cols), p2.RATE):
        chunk = cols[i : i + p2.RATE]
        s0 = chunk[0] % R_MOD
        if len(chunk) > 1:
            s1 = chunk[1] % R_MOD
        s0, s1, s2 = permute_vec(s0, s1, s2, params)
    return s0


def batch_inverse_vec(x: np.ndarray) -> np.ndarray:
    """Montgomery-trick inversion of a nonzero object array mod r."""
    if _native():
        return ne.u64_to_obj(
            ne.inv(ne.obj_to_u64(np.asarray(x, dtype=object) % R_MOD))
        )
    # reduced running products (an unreduced accumulate would blow up to
    # len(x)·253-bit integers)
    pre = np.empty(len(x), dtype=object)
    acc = 1
    for i in range(len(x)):
        acc = acc * int(x[i]) % R_MOD
        pre[i] = acc
    total_inv = pow(int(pre[-1]), R_MOD - 2, R_MOD)
    out = np.empty(len(x), dtype=object)
    acc = total_inv
    for i in range(len(x) - 1, 0, -1):
        out[i] = acc * int(pre[i - 1]) % R_MOD
        acc = acc * int(x[i]) % R_MOD
    out[0] = acc
    return out


def powers_vec(base: int, count: int) -> np.ndarray:
    out = np.empty(count, dtype=object)
    acc = 1
    for i in range(count):
        out[i] = acc
        acc = acc * base % R_MOD
    return out


def fold_vec(f: np.ndarray, beta: int, shift: int, omega: int) -> np.ndarray:
    """One arity-2 FRI fold of an object-array codeword (natural order)."""
    if _native():
        return ne.u64_to_obj(
            ne.fold(
                ne.obj_to_u64(np.asarray(f, dtype=object) % R_MOD),
                beta, shift, omega,
            )
        )
    half = len(f) // 2
    a, b = f[:half], f[half:]
    inv2 = pow(2, R_MOD - 2, R_MOD)
    x = powers_vec(omega, half) * shift % R_MOD
    inv2x = batch_inverse_vec(2 * x % R_MOD)
    s = (a + b) * inv2 % R_MOD
    d = (a - b) * inv2x % R_MOD
    return (s + beta * d) % R_MOD


def tree_levels_vec(leaves: np.ndarray, params=p2.DEFAULT_PARAMS) -> list:
    """All digest levels above an object-array leaf layer."""
    if _native() and params.alpha == 11 and len(leaves) > 1:
        ups = ne.tree_levels(
            ne.obj_to_u64(np.asarray(leaves, dtype=object) % R_MOD), params
        )
        return [np.asarray(leaves, dtype=object)] + [
            ne.u64_to_obj(l) for l in ups
        ]
    levels = [leaves]
    cur = leaves
    while len(cur) > 1:
        cur = compress_vec(cur[0::2], cur[1::2], params)
        levels.append(cur)
    return levels
