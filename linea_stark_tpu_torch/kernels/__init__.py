"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain
PyTorch versions.

Every TPU kernel of the reference maps onto one of seven CUDA kernels
(sources in ``linea_stark_tpu_torch/csrc/``):

=====================  ========================================================
K1 ``fr_binop``        elementwise mul/add/sub, scalar and shared-table operands
K2 weighted colsum     ``fr_wsum_partials`` + ``fr_sum_finish``
K3 ``ntt_stage``       one Stockham stage, radix 2 or 4
K4 Poseidon2           ``p2_permute``, ``p2_permute2``, ``p2_merkle_level``
K5 ``kc_hash``         Keccak-256 field digests of rows (Keccak MMCS)
K6 ``fr_mul3_scalar``  a·b·c, c one scalar (the eager batch-inverse finish)
K7 ``fr_colsum``       per-column sums: ``fr_colsum_partials`` + ``fr_sum_finish``
=====================  ========================================================

Dispatch follows the tensor: a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises.  Each wrapper adds one to its entry in
:data:`LAUNCHES` where it launches its kernel, and nowhere else, so a run can
show that its work went through the kernels.
"""

from __future__ import annotations

LAUNCHES = {
    "fr_binop": 0,
    "fr_weighted_colsum": 0,
    "ntt_stage": 0,
    "p2_permute": 0,
    "p2_permute2": 0,
    "p2_merkle_level": 0,
    "kc_hash": 0,
    "fr_mul3_scalar": 0,
    "fr_colsum": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launches() -> dict:
    return dict(LAUNCHES)
