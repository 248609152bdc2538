"""Gadget trace columns on the device; port of
``linea_stark_tpu/trace/builders.py``.

* Horner row compression: W vectorized multiply-adds over all N rows.
* Per-row inversions: one blocked Montgomery-trick ``batch_inverse``.
* The running product (permutation check column) and the running sum
  (lookup check column): doubling prefix scans.
* The lookup multiplicities: the reference's sort-join.  An 8-pass LSD radix
  argsort over the 256-bit row compressions groups equal values into
  segments; filtered-A occurrence counts are a segment sum, and the rule
  that the first filtered B match (row-major, then table order) consumes
  the count is a segment minimum over flattened B positions.

Torch has no uint32 arithmetic on the CPU, so sort keys and counts are
int64.
"""

from __future__ import annotations

import torch

from .. import fr_ops as fo
from ..air.gadgets import LookupAirConfig, PermutationAirConfig
from ..field import fr


def horner_columns(matrix: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(8, W, N) columns -> (8, N) row compression sum col_j·alpha^(W-1-j)."""
    acc = fr.zeros(matrix.shape[2:], device=matrix.device)
    for w in range(matrix.shape[1]):
        acc = fo.add(fo.mul(acc, alpha), matrix[:, w])
    return acc


def counts_to_field(counts: torch.Tensor) -> torch.Tensor:
    """int64 counts (N,) below 2^32 -> (8, N) Montgomery field elements."""
    words = fr.zeros(counts.shape, device=counts.device)
    words[0] = fr._narrow(counts)
    return fo.to_mont(words)


def radix_argsort(vals: torch.Tensor) -> torch.Tensor:
    """Stable ascending argsort of (8, K) 256-bit keys: eight LSD passes,
    one stable argsort per 32-bit word read as unsigned (in int64)."""
    perm = torch.arange(vals.shape[-1], device=vals.device)
    for w in range(fr.NUM_WORDS):
        key = fr._wide(vals[w])
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


# ---------------------------------------------------------------------------
# Permutation gadget
# ---------------------------------------------------------------------------

def _perm_cols(a, b, alpha, delta):
    """[a..., b..., b_inverse, check] for (8, W, N) columns a and b."""
    a_comb = horner_columns(a, alpha)
    b_comb = horner_columns(b, alpha)
    b_inv = fo.batch_inverse(fo.add(b_comb, delta))
    ratio = fo.mul(fo.add(a_comb, delta), b_inv)
    check = fo.prefix_product(ratio)
    return torch.cat([a, b, b_inv[:, None], check[:, None]], dim=1)


def build_permutation_columns(a, b, alpha, delta):
    """a, b: (8, W, N); alpha, delta: (8,) Montgomery scalars.  Returns
    (8, 2W+2, N) trace columns and the (unshifted) PermutationAirConfig."""
    w = a.shape[1]
    assert b.shape[1] == w
    cols = _perm_cols(a, b, alpha, delta)
    cfg = PermutationAirConfig(
        a_columns_ids=tuple(range(w)),
        b_columns_ids=tuple(range(w, 2 * w)),
        b_inverse_id=2 * w,
        check_id=2 * w + 1,
    )
    return cols, cfg


# ---------------------------------------------------------------------------
# Lookup gadget
# ---------------------------------------------------------------------------

def lookup_multiplicities(a_comb: torch.Tensor, a_filter_nz: torch.Tensor,
                          b_comb_flat: torch.Tensor,
                          b_filter_nz_flat: torch.Tensor) -> torch.Tensor:
    """a_comb: (8, N); a_filter_nz: (N,) bool; b_comb_flat: (8, M) with
    M = N·T flattened row-major over (row, table); b_filter_nz_flat: (M,).
    Returns int64 multiplicities (M,): the filtered-A occurrence count of
    each value at its first filtered B position, zero elsewhere."""
    n = a_comb.shape[-1]
    m = b_comb_flat.shape[-1]
    total = n + m
    dev = a_comb.device
    vals = torch.cat([a_comb, b_comb_flat], dim=-1)
    perm = radix_argsort(vals)
    svals = vals[:, perm]
    boundary = torch.ones(total, dtype=torch.int64, device=dev)
    boundary[1:] = (svals[:, 1:] != svals[:, :-1]).any(dim=0)
    seg = torch.cumsum(boundary, 0) - 1

    is_a = perm < n
    a_weight = (is_a & a_filter_nz[perm.clamp(max=n - 1)]).to(torch.int64)
    count_per_seg = torch.zeros(total, dtype=torch.int64, device=dev).scatter_add_(
        0, seg, a_weight)

    b_pos = perm - n  # valid where ~is_a
    candidate = ~is_a & b_filter_nz_flat[b_pos.clamp(0, m - 1)]
    big = total + 1
    first_per_seg = torch.full((total,), big, dtype=torch.int64, device=dev).scatter_reduce_(
        0, seg, torch.where(candidate, b_pos, big), "amin")
    winner = candidate & (b_pos == first_per_seg[seg])
    mult_sorted = torch.where(winner, count_per_seg[seg], 0)

    out_all = torch.zeros(total, dtype=torch.int64, device=dev)
    out_all[perm] = mult_sorted
    return out_all[n:]


def _lookup_cols(a, b_tables, a_filter, b_filters, alpha, delta):
    """[a, b tables, a_filter, b_filters, a_inv, b_invs, occurrences, check]
    for (8, Wa, N) ``a``, (8, Wb, N) tables and (8, N) filters."""
    n = a.shape[-1]
    t = len(b_tables)
    a_comb = horner_columns(a, alpha)
    b_combs = [horner_columns(bt, alpha) for bt in b_tables]

    a_inv = fo.batch_inverse(fo.add(a_comb, delta))
    b_inv = fo.batch_inverse(torch.stack([fo.add(c, delta) for c in b_combs], dim=1))

    # B entries flattened row-major over (row, table), p = i·T + t: the
    # order in which the reference consumes occurrence counts.
    b_comb_flat = torch.stack(b_combs, dim=2).reshape(8, n * t)
    b_f_flat = torch.stack([~fr.is_zero(f) for f in b_filters], dim=1).reshape(n * t)
    mult = lookup_multiplicities(a_comb, ~fr.is_zero(a_filter), b_comb_flat,
                                 b_f_flat).reshape(n, t)
    occ = [counts_to_field(mult[:, i]) for i in range(t)]

    # check column: prefix sum of filter_a·a_inv − sum_t filter_b·occ·b_inv
    term = fo.mul(a_filter, a_inv)
    for i in range(t):
        term = fo.sub(term, fo.mul(fo.mul(b_filters[i], occ[i]), b_inv[:, i]))
    check = fo.prefix_sum(term)

    return torch.cat(
        [a, *b_tables, a_filter[:, None], *[f[:, None] for f in b_filters],
         a_inv[:, None], b_inv, *[o[:, None] for o in occ], check[:, None]],
        dim=1,
    )


def build_lookup_columns(a, b_tables: list, a_filter, b_filters: list, alpha, delta):
    """a: (8, Wa, N); b_tables: list of (8, Wb, N); a_filter: (8, N);
    b_filters: list of (8, N).  Returns the (8, width, N) trace columns and
    the unshifted LookupAirConfig, in the reference's layout."""
    t = len(b_tables)
    wa, wb = a.shape[1], b_tables[0].shape[1]
    cols = _lookup_cols(a, b_tables, a_filter, b_filters, alpha, delta)
    a_filter_id = wa + t * wb
    b_filter_id = tuple(a_filter_id + 1 + i for i in range(t))
    a_inverses_id = b_filter_id[-1] + 1
    b_inverses_id = tuple(a_inverses_id + 1 + i for i in range(t))
    occurrences_id = tuple(b_inverses_id[-1] + 1 + i for i in range(t))
    cfg = LookupAirConfig(
        a_columns_ids=tuple(range(wa)),
        b_columns_ids=tuple(tuple(wa + ti * wb + j for j in range(wb)) for ti in range(t)),
        a_filter_id=a_filter_id,
        b_filter_id=b_filter_id,
        a_inverses_id=a_inverses_id,
        b_inverses_id=b_inverses_id,
        occurrences_id=occurrences_id,
        check_id=occurrences_id[-1] + 1,
    )
    return cols, cfg
