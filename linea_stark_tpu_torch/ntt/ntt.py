"""Radix-2/4 Stockham NTT and coset low-degree extension over Fr.

Port of ``linea_stark_tpu/ntt/ntt.py``: natural order in and out, no
bit-reversal anywhere.  A length-n transform is log2(n) radix-2 stages
fused two at a time into radix-4 launches of the K3 kernel
(``kernels/ntt.py``), with one leading radix-2 stage when log2(n) is odd.
Twiddles are one device power table P[k] = w^k, k < n/2, built by doubling
(``fr_ops.powers``).
"""

from __future__ import annotations

import torch

from .. import fr_ops as fo
from ..field.constants import R_MOD, TWO_ADICITY, TWO_ADIC_GENERATOR
from ..kernels import ntt as kn


def root_of_unity(log_n: int, inverse: bool = False) -> int:
    """Canonical primitive 2**log_n-th root of unity (Python int)."""
    assert log_n <= TWO_ADICITY
    w = pow(TWO_ADIC_GENERATOR, 1 << (TWO_ADICITY - log_n), R_MOD)
    if inverse:
        w = pow(w, R_MOD - 2, R_MOD)
    return w


def _twiddle_table(log_n: int, inverse: bool, device) -> torch.Tensor:
    """Master table P[k] = w^k for k < n/2 (contiguous (8, n/2))."""
    n = 1 << log_n
    return fo.powers(root_of_unity(log_n, inverse), max(n // 2, 1), device).contiguous()


def ntt(x: torch.Tensor, inverse: bool = False, scale: bool = True) -> torch.Tensor:
    """Stockham NTT along the last axis of (8, *batch, n): natural in and
    out.  ``inverse`` uses w^-1; with ``scale`` it also multiplies by 1/n."""
    n = x.shape[-1]
    log_n = n.bit_length() - 1
    assert 1 << log_n == n
    if n == 1:
        return x
    table = _twiddle_table(log_n, inverse, x.device)
    y = x.reshape(8, -1, n).contiguous()
    m = 1
    if log_n % 2:
        y = kn.stage(y, table, m, 2)
        m = 2
    while m < n:
        y = kn.stage(y, table, m, 4)
        m *= 4
    out = y.reshape(x.shape)
    if inverse and scale:
        out = fo.mul_const(out, pow(n, R_MOD - 2, R_MOD))
    return out


def intt(x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT, natural in / natural out."""
    return ntt(x, inverse=True, scale=True)


def _coset_scale(n: int, shift_int: int, device) -> torch.Tensor:
    """(8, n) vector of shift^d at position d."""
    return fo.powers(shift_int, n, device)


def evals_to_coeffs(evals: torch.Tensor, shift_int: int = 1) -> torch.Tensor:
    """Evaluations on shift·H (natural order) -> coefficients (natural)."""
    n = evals.shape[-1]
    coeffs = ntt(evals, inverse=True, scale=True)
    if shift_int != 1:
        inv_shift = pow(shift_int, R_MOD - 2, R_MOD)
        coeffs = fo.mul(coeffs, _coset_scale(n, inv_shift, evals.device))
    return coeffs


def coeffs_to_evals(coeffs: torch.Tensor, shift_int: int = 1) -> torch.Tensor:
    """Coefficients (natural order) -> evaluations on shift·H (natural)."""
    n = coeffs.shape[-1]
    if shift_int != 1:
        coeffs = fo.mul(coeffs, _coset_scale(n, shift_int, coeffs.device))
    return ntt(coeffs)


def pad_coeffs(coeffs: torch.Tensor, added_bits: int) -> torch.Tensor:
    """Zero-pad natural-order coefficients of size n to size n·2**added_bits."""
    if added_bits == 0:
        return coeffs
    n = coeffs.shape[-1]
    zeros = torch.zeros(coeffs.shape[:-1] + (n * ((1 << added_bits) - 1),),
                        dtype=coeffs.dtype, device=coeffs.device)
    return torch.cat([coeffs, zeros], dim=-1)


def coset_lde(evals: torch.Tensor, added_bits: int, shift_int: int,
              src_shift_int: int = 1) -> torch.Tensor:
    """Evaluations of degree-<n polys on src_shift·H_n (natural order) ->
    evaluations on shift·H_{n·2^added_bits} (natural)."""
    coeffs = evals_to_coeffs(evals, src_shift_int)
    padded = pad_coeffs(coeffs, added_bits)
    return coeffs_to_evals(padded, shift_int)
