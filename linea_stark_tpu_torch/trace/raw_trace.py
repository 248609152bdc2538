"""Trace aggregation for lookup and permutation gadgets; port of
``linea_stark_tpu/trace/raw_trace.py:build_trace``.

The global height is the max gadget height rounded up to a power of two;
every gadget trace is zero-padded to it (zero rows satisfy the gadgets
neutrally), decoded, built on the device and concatenated column-block-wise
with index-shifted configs, lookups first, then permutations.  The result is
one (8, W_total, H) Montgomery tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..air.gadgets import LineaAir
from ..device import resolve
from ..field import fr
from ..field.codec import decode_be_bytes_mod_order
from . import builders
from .loader import RawLookupTrace, RawPermutationTrace


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length() if n > 1 else 1


@dataclass
class BuiltTrace:
    matrix: torch.Tensor     # (8, W_total, H) Montgomery words
    air: LineaAir
    height: int


def _decode_cols(cols, device) -> torch.Tensor:
    """List of (H, 32) byte columns -> (8, W, H) on ``device`` (one decode)."""
    stacked = np.concatenate(cols, axis=0)
    h = cols[0].shape[0]
    return decode_be_bytes_mod_order(stacked, device=device).reshape(8, len(cols), h)


def build_trace(permutations: list, lookups: list, alpha: int, delta: int,
                check: bool = True, device=None) -> BuiltTrace:
    """Assemble the trace from raw lookup and permutation traces on
    ``device`` (the CUDA card when None: :func:`..device.default_device`).

    ``alpha``/``delta`` are the public challenges.  ``check`` enforces the
    reference's self-checks (a lookup's check column ends at 0, a
    permutation's at 1)."""
    device = resolve(device)
    heights = [t.get_max_height() for t in permutations + lookups]
    assert heights, "no traces"
    height = _next_pow2(max(heights))
    alpha_d = fr.const(alpha, device=device)
    delta_d = fr.const(delta, device=device)

    blocks, configs, offset = [], [], 0
    for lt in lookups:
        lt = RawLookupTrace(a=list(lt.a), b=[list(t) for t in lt.b], name=lt.name,
                            a_filter=lt.a_filter, b_filter=list(lt.b_filter))
        lt.resize(height)
        wa, t, wb = len(lt.a), len(lt.b), len(lt.b[0])
        m = _decode_cols(lt.a + [c for tbl in lt.b for c in tbl] + [lt.a_filter]
                         + lt.b_filter, device)
        f0 = wa + t * wb  # the a_filter column of m
        cols, cfg = builders.build_lookup_columns(
            m[:, :wa], [m[:, wa + i * wb: wa + (i + 1) * wb] for i in range(t)],
            m[:, f0], [m[:, f0 + 1 + i] for i in range(t)], alpha_d, delta_d)
        if check:
            last = fr.unpack_ints(cols[:, cfg.check_id, -1:])[0]
            assert last == 0, (
                "failed to check constrain: check column should be 0 on the last row"
            )
        blocks.append(cols)
        configs.append(cfg.shift(offset))
        offset += cfg.width

    for pt in permutations:
        pt = RawPermutationTrace(a=list(pt.a), b=list(pt.b), name=pt.name)
        pt.resize(height)
        a = _decode_cols(pt.a, device)
        b = _decode_cols(pt.b, device)
        cols, cfg = builders.build_permutation_columns(a, b, alpha_d, delta_d)
        if check:
            last = fr.unpack_ints(cols[:, cfg.check_id, -1:])[0]
            assert last == 1, (
                "failed to check constrain: check column should be 1 on the last row"
            )
        blocks.append(cols)
        configs.append(cfg.shift(offset))
        offset += cfg.width

    matrix = blocks[0] if len(blocks) == 1 else torch.cat(blocks, dim=1)
    return BuiltTrace(matrix=matrix, air=LineaAir(tuple(configs)), height=height)
