"""K3 ``ntt_stage`` (``csrc/ntt.cu``): one Stockham stage, radix 2 or 4.

Replaces ``linea_stark_tpu/kernels/pallas_ntt.py`` ``_stage_axis2`` (radix
2) and ``_stage4_axis2`` (radix 4); the four-step twiddle multiply
``_mul_broadcast`` maps onto K1.  The stage's index algebra and what bounds
it on the card are noted in the CUDA source.
"""

from __future__ import annotations

import torch

from ..field import fr
from . import LAUNCHES
from . import cuda_lib as cl


def _radix2_plain(x: torch.Tensor, table: torch.Tensor, m: int) -> torch.Tensor:
    _, b, n = x.shape
    big_l = n // m
    xv = x.reshape(8, b, big_l, m)
    lo, hi = xv[:, :, : big_l // 2], xv[:, :, big_l // 2:]
    w = table[:, :: n // (2 * m)][:, :m]
    t = fr.mul(hi, w)
    y = torch.cat([fr.add(lo, t), fr.sub(lo, t)], dim=-1)
    return y.reshape(8, b, n)


def stage_plain(x: torch.Tensor, table: torch.Tensor, m: int, radix: int) -> torch.Tensor:
    """Radix 4 is exactly two radix-2 stages (M, then 2M)."""
    y = _radix2_plain(x, table, m)
    if radix == 4:
        y = _radix2_plain(y, table, 2 * m)
    return y


def stage(x: torch.Tensor, table: torch.Tensor, m: int, radix: int) -> torch.Tensor:
    """One stage on a contiguous (8, B, n) batch of transforms: input rows of
    length ``m`` become rows of length ``radix * m``.  ``table`` is the
    contiguous (8, n/2) power table of the transform's root of unity."""
    if radix not in (2, 4):
        raise ValueError(f"radix must be 2 or 4, got {radix}")
    if x.device.type == "cpu":
        return stage_plain(x, table, m, radix)
    cl.check_field(x, "x", rank=3)
    cl.check_field(table, "table")
    _, b, n = x.shape
    if not x.is_contiguous() or not table.is_contiguous():
        raise ValueError("ntt stage operands must be contiguous")
    if n % (radix * m) or table.shape[1] < max(n // 2, 1):
        raise ValueError(f"bad stage: n={n} m={m} radix={radix} table={tuple(table.shape)}")
    y = torch.empty_like(x)
    rc = cl.lib().ntt_stage(
        radix, x.data_ptr(), y.data_ptr(), b, n, m, table.data_ptr(),
        table.shape[1], cl.stream_handle(x),
    )
    cl.check(rc, "ntt_stage")
    LAUNCHES["ntt_stage"] += 1
    return y
