"""K4 Poseidon2 (``csrc/poseidon2.cu``): ``permute``, ``permute2`` and
``merkle_level``.

Replaces ``linea_stark_tpu/kernels/pallas_poseidon2.py`` ``_permute_call``,
``_permute2_call`` and ``_tree_step``.  The permutation is compute-bound on
the card (230 Montgomery multiplies per state); the source explains how the
kernel keeps it in registers and where the round constants live.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field import fr, oracle
from . import LAUNCHES
from . import cuda_lib as cl


@functools.lru_cache(maxsize=8)
def constant_schedule(params) -> np.ndarray:
    """(rounds_f + rounds_p, 3, 8) uint32 Montgomery round constants in round
    order; internal rounds use lane 0 (lanes 1-2 zero), as the reference's
    ``_params_const_array``."""
    rows = [list(rc) for rc in params.external_constants(0)]
    rows += [[c, 0, 0] for c in params.internal_constants()]
    rows += [list(rc) for rc in params.external_constants(1)]
    flat = [oracle.to_mont(c) for row in rows for c in row]
    words = fr.pack_ints(flat, mont=False).numpy().view(np.uint32)  # (8, R*3)
    return np.ascontiguousarray(words.T.reshape(len(rows), 3, 8))


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _sbox(x):
    x2 = fr.mul(x, x)
    x3 = fr.mul(x2, x)
    x4 = fr.mul(x2, x2)
    x8 = fr.mul(x4, x4)
    return fr.mul(x8, x3)


def _ext(s):
    """External matrix on an (8, 3, N) state stack."""
    t = fr.add(fr.add(s[:, 0], s[:, 1]), s[:, 2])
    return fr.add(s, t[:, None])


def permute_plain(s0, s1, s2, params):
    """Width-3 permutation of (8, N) state words (the external rounds'
    three S-boxes run as one stacked chain)."""
    rc = torch.from_numpy(constant_schedule(params).view(np.int32)).to(s0.device)
    rc = rc.permute(2, 0, 1)  # (8, R, 3)
    half = params.rounds_f // 2
    s = _ext(torch.stack([s0, s1, s2], dim=1))
    for r in range(half):
        s = _ext(_sbox(fr.add(s, rc[:, r, :, None])))
    for r in range(half, half + params.rounds_p):
        a = _sbox(fr.add(s[:, 0], rc[:, r, 0, None]))
        t = fr.add(fr.add(a, s[:, 1]), s[:, 2])
        s = torch.stack(
            [fr.add(a, t), fr.add(s[:, 1], t), fr.add(fr.add(s[:, 2], s[:, 2]), t)],
            dim=1,
        )
    for r in range(half + params.rounds_p, params.rounds_f + params.rounds_p):
        s = _ext(_sbox(fr.add(s, rc[:, r, :, None])))
    return s[:, 0], s[:, 1], s[:, 2]


def permute2_plain(left, right, params):
    return permute_plain(left, right, torch.zeros_like(left), params)


def merkle_level_plain(d, params):
    return permute2_plain(d[:, 0::2], d[:, 1::2], params)[0]


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_LOADED = {}  # device index -> params whose constants sit in __constant__


def _load_constants(params, device) -> None:
    if _LOADED.get(device.index) == params:
        return
    sched = constant_schedule(params)
    with torch.cuda.device(device):
        cl.check(cl.lib().p2_set_constants(sched.ctypes.data, sched.shape[0]),
                 "p2_set_constants")
    _LOADED[device.index] = params


def _out(n, device):
    return torch.empty((8, n), dtype=torch.int32, device=device)


def permute(s0, s1, s2, params):
    """(8, N) x3 -> the three permuted state words."""
    if s0.device.type == "cpu":
        return permute_plain(s0, s1, s2, params)
    for name, t in (("s0", s0), ("s1", s1), ("s2", s2)):
        cl.check_field(t, name)
    n = s0.shape[1]
    if s1.shape[1] != n or s2.shape[1] != n:
        raise ValueError("state words differ in length")
    _load_constants(params, s0.device)
    o0, o1, o2 = _out(n, s0.device), _out(n, s0.device), _out(n, s0.device)
    rc = cl.lib().p2_permute(
        s0.data_ptr(), s0.stride(0), s1.data_ptr(), s1.stride(0),
        s2.data_ptr(), s2.stride(0), o0.data_ptr(), o1.data_ptr(),
        o2.data_ptr(), n, params.rounds_f, params.rounds_p,
        cl.stream_handle(s0),
    )
    cl.check(rc, "p2_permute")
    LAUNCHES["p2_permute"] += 1
    return o0, o1, o2


def permute2(left, right, params, outputs: int = 3):
    """Permutation of (left, right, 0); returns the first ``outputs`` words
    (1 for a 2-to-1 compression)."""
    if left.device.type == "cpu":
        return permute2_plain(left, right, params)[:outputs]
    cl.check_field(left, "left")
    cl.check_field(right, "right")
    n = left.shape[1]
    if right.shape[1] != n:
        raise ValueError("left and right differ in length")
    _load_constants(params, left.device)
    outs = [_out(n, left.device) for _ in range(outputs)]
    ptrs = [o.data_ptr() for o in outs] + [None] * (3 - outputs)
    rc = cl.lib().p2_permute2(
        left.data_ptr(), left.stride(0), right.data_ptr(), right.stride(0),
        *ptrs, n, params.rounds_f, params.rounds_p, cl.stream_handle(left),
    )
    cl.check(rc, "p2_permute2")
    LAUNCHES["p2_permute2"] += 1
    return tuple(outs)


def merkle_level(d, params):
    """(8, 2m) natural-order digests -> (8, m): out[j] = compress(d[2j], d[2j+1])."""
    if d.device.type == "cpu":
        return merkle_level_plain(d, params)
    cl.check_field(d, "d")
    if d.shape[1] % 2:
        raise ValueError(f"merkle_level needs an even number of digests, got {d.shape[1]}")
    n_out = d.shape[1] // 2
    _load_constants(params, d.device)
    out = _out(n_out, d.device)
    rc = cl.lib().p2_merkle_level(
        d.data_ptr(), d.stride(0), out.data_ptr(), n_out, params.rounds_f,
        params.rounds_p, cl.stream_handle(d),
    )
    cl.check(rc, "p2_merkle_level")
    LAUNCHES["p2_merkle_level"] += 1
    return out
