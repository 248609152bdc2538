"""Permutation-gadget trace columns on the device; port of the permutation
half of ``linea_stark_tpu/trace/builders.py``.

* Horner row compression: W vectorized multiply-adds over all N rows.
* Per-row inversions: one blocked Montgomery-trick ``batch_inverse``.
* The running product (the check column): a doubling prefix product.
"""

from __future__ import annotations

import torch

from .. import fr_ops as fo
from ..air.gadgets import PermutationAirConfig
from ..field import fr


def horner_columns(matrix: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """(8, W, N) columns -> (8, N) row compression sum col_j·alpha^(W-1-j)."""
    acc = fr.zeros(matrix.shape[2:], device=matrix.device)
    for w in range(matrix.shape[1]):
        acc = fo.add(fo.mul(acc, alpha), matrix[:, w])
    return acc


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
