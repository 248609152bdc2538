"""K1 ``fr_binop`` and K2 the weighted column sum (``csrc/field_ops.cu``).

K1 replaces ``linea_stark_tpu/kernels/pallas_field.py`` ``mul``/``add``/
``sub`` (through ``_binop``), ``mul_scalar`` and
``linea_stark_tpu/kernels/pallas_ntt.py`` ``_mul_broadcast``.  K2 replaces
``pallas_field.py`` ``weighted_block_sums_128``.  What bounds each on the
card and how the design meets it is noted in the CUDA source.
"""

from __future__ import annotations

import torch

from ..field import fr
from . import LAUNCHES
from . import cuda_lib as cl

OPS = {"mul": 0, "add": 1, "sub": 2}
_PLAIN = {"mul": fr.mul, "add": fr.add, "sub": fr.sub}


def binop_plain(op: str, a, b, b_div: int = 1, b_mod: int = None):
    n = a.shape[1]
    b_mod = n if b_mod is None else b_mod
    if b_mod == 1:
        bb = b[:, :1]
    elif b_div == 1 and b_mod >= n:
        bb = b[:, :n]
    else:
        idx = (torch.arange(n, device=a.device) // b_div) % b_mod
        bb = b[:, idx]
    return _PLAIN[op](a, bb)


def binop(op: str, a: torch.Tensor, b: torch.Tensor, b_div: int = 1,
          b_mod: int = None) -> torch.Tensor:
    """out[:, i] = a[:, i] (op) b[:, (i // b_div) % b_mod] on (8, N) operands.

    ``b_mod`` defaults to N (same shape); 1 broadcasts one scalar.  Both
    operands may be views with any word stride; the output is contiguous."""
    if a.device.type == "cpu":
        return binop_plain(op, a, b, b_div, b_mod)
    cl.check_field(a, "a")
    cl.check_field(b, "b")
    n = a.shape[1]
    b_mod = n if b_mod is None else b_mod
    if b.device != a.device:
        raise ValueError("operands on different devices")
    if b_mod < 1 or b_div < 1 or b.shape[1] < min(b_mod, n):
        raise ValueError(f"b of shape {tuple(b.shape)} does not cover mod {b_mod}")
    out = torch.empty((8, n), dtype=torch.int32, device=a.device)
    rc = cl.lib().fr_binop(
        OPS[op], a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0),
        b_div, b_mod, out.data_ptr(), n, cl.stream_handle(a),
    )
    cl.check(rc, "fr_binop")
    LAUNCHES["fr_binop"] += 1
    return out


def _field_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """Field sum along the last axis by halving adds."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        if n % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
            n += 1
        x = fr.add(x[..., : n // 2], x[..., n // 2:])
    return x[..., 0]


def weighted_colsum_plain(mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return _field_sum_plain(fr.mul(mat, u[:, None, :]))


_NBLK = 256  # partial sums per column in pass 1


def weighted_colsum(mat: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(8, W, N) x (8, N) -> (8, W): sum_j mat[:, c, j] * u[:, j] per column
    (Montgomery in, Montgomery out)."""
    if mat.device.type == "cpu":
        return weighted_colsum_plain(mat, u)
    cl.check_field(mat, "mat", rank=3)
    cl.check_field(u, "u")
    w, n = mat.shape[1], mat.shape[2]
    if u.shape[1] != n or u.device != mat.device:
        raise ValueError("u does not match mat")
    nblk = max(1, min(_NBLK, (n + 255) // 256))
    partials = torch.empty((8, w, nblk), dtype=torch.int32, device=mat.device)
    out = torch.empty((8, w), dtype=torch.int32, device=mat.device)
    lib = cl.lib()
    stream = cl.stream_handle(mat)
    cl.check(lib.fr_wsum_partials(
        mat.data_ptr(), mat.stride(0), mat.stride(1), w, u.data_ptr(),
        u.stride(0), n, partials.data_ptr(), nblk, stream,
    ), "fr_wsum_partials")
    cl.check(lib.fr_sum_finish(partials.data_ptr(), w, nblk, out.data_ptr(), stream),
             "fr_sum_finish")
    LAUNCHES["fr_weighted_colsum"] += 1
    return out
