"""K1 ``fr_binop``, K2 the weighted column sum, K6 ``fr_mul3_scalar`` and K7
``fr_colsum`` (``csrc/field_ops.cu``).

K1 replaces ``linea_stark_tpu/kernels/pallas_field.py`` ``mul``/``add``/
``sub`` (through ``_binop``), ``mul_scalar`` and
``linea_stark_tpu/kernels/pallas_ntt.py`` ``_mul_broadcast``.  K2 replaces
``pallas_field.py`` ``weighted_block_sums_128``, K6 ``mul3_scalar`` and K7
``block_sums_128``.  What bounds each on the card and how the design meets
it is noted in the CUDA source.
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


def _partials(mat: torch.Tensor):
    """(nblk, buffer) for pass 1 over (8, W, N): one partial per (column,
    block)."""
    nblk = max(1, min(_NBLK, (mat.shape[2] + 255) // 256))
    return nblk, torch.empty((8, mat.shape[1], nblk), dtype=torch.int32, device=mat.device)


def _finish(partials: torch.Tensor, stream) -> torch.Tensor:
    """Pass 2: fold (8, W, nblk) partials to (8, W) sums on the device."""
    w, nblk = partials.shape[1], partials.shape[2]
    out = torch.empty((8, w), dtype=torch.int32, device=partials.device)
    cl.check(cl.lib().fr_sum_finish(partials.data_ptr(), w, nblk, out.data_ptr(), stream),
             "fr_sum_finish")
    return out


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
    nblk, partials = _partials(mat)
    stream = cl.stream_handle(mat)
    cl.check(cl.lib().fr_wsum_partials(
        mat.data_ptr(), mat.stride(0), mat.stride(1), w, u.data_ptr(),
        u.stride(0), n, partials.data_ptr(), nblk, stream,
    ), "fr_wsum_partials")
    out = _finish(partials, stream)
    LAUNCHES["fr_weighted_colsum"] += 1
    return out


def colsum_plain(x: torch.Tensor) -> torch.Tensor:
    return _field_sum_plain(x)


def colsum(x: torch.Tensor) -> torch.Tensor:
    """(8, W, N) -> (8, W): sum_j x[:, c, j] per column.  Field addition is
    the same in any residue form, so Montgomery words sum to Montgomery."""
    if x.device.type == "cpu":
        return colsum_plain(x)
    cl.check_field(x, "x", rank=3)
    nblk, partials = _partials(x)
    stream = cl.stream_handle(x)
    cl.check(cl.lib().fr_colsum_partials(
        x.data_ptr(), x.stride(0), x.stride(1), x.shape[1], x.shape[2],
        partials.data_ptr(), nblk, stream,
    ), "fr_colsum_partials")
    out = _finish(partials, stream)
    LAUNCHES["fr_colsum"] += 1
    return out


def mul3_scalar_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return fr.mul(fr.mul(a, b), c.reshape(8, 1))


def mul3_scalar(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(8, N) x (8, N) x one (8,) scalar -> (8, N): (a·b)·c, Montgomery.
    ``a`` and ``b`` may be views with any word stride; the output is
    contiguous."""
    if a.device.type == "cpu":
        return mul3_scalar_plain(a, b, c)
    c2 = c.reshape(8, 1)
    cl.check_field(a, "a")
    cl.check_field(b, "b")
    cl.check_field(c2, "c")
    n = a.shape[1]
    if b.shape[1] != n or b.device != a.device or c.device != a.device:
        raise ValueError(f"b {tuple(b.shape)} or c does not match a {tuple(a.shape)}")
    out = torch.empty((8, n), dtype=torch.int32, device=a.device)
    rc = cl.lib().fr_mul3_scalar(
        a.data_ptr(), a.stride(0), b.data_ptr(), b.stride(0), c2.data_ptr(),
        c2.stride(0), out.data_ptr(), n, cl.stream_handle(a),
    )
    cl.check(rc, "fr_mul3_scalar")
    LAUNCHES["fr_mul3_scalar"] += 1
    return out
