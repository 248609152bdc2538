"""FRI folding: device halving step + scalar verifier counterpart; port of
``linea_stark_tpu/fri/fold.py``.

Arity-2 fold of evaluations on s·H in natural order: with
f(x) = f_e(x²) + x·f_o(x²) and −x_i = x_{i+N/2},

    f'(x²) = (f(x) + f(−x))/2 + β·(f(x) − f(−x))/(2x),

so the fold pairs the two halves of the array and the result lives on
s²·H² (natural order again).  The 1/(2x) table is built on the device with
``fr_ops.powers`` (the reference built it with a host loop over bigints).
"""

from __future__ import annotations

import torch

from .. import fr_ops as fo
from ..field import oracle
from ..field.constants import R_MOD


def inv2x_table(shift_int: int, omega_int: int, half: int, device) -> torch.Tensor:
    """(8, half) table 1/(2·shift·omega^i) = (1/(2 shift))·(omega^-1)^i."""
    inv2 = pow(2, R_MOD - 2, R_MOD)
    c = (inv2 * pow(shift_int, R_MOD - 2, R_MOD)) % R_MOD
    inv_omega = pow(omega_int, R_MOD - 2, R_MOD)
    return fo.mul_const(fo.powers(inv_omega, half, device), c)


def fold_codeword(f: torch.Tensor, beta_int: int, shift_int: int, omega_int: int) -> torch.Tensor:
    """One fold of (8, N) evals on shift·<omega> -> (8, N/2) on shift²·<omega²>."""
    n = f.shape[-1]
    half = n // 2
    a, b = f[..., :half], f[..., half:]
    inv2 = pow(2, R_MOD - 2, R_MOD)
    s = fo.mul_const(fo.add(a, b), inv2)
    d = fo.mul(fo.sub(a, b), inv2x_table(shift_int, omega_int, half, f.device))
    return fo.add(s, fo.mul_const(d, beta_int))


def fold_pair_int(lo: int, hi: int, x_lo: int, beta: int) -> int:
    """Scalar fold for the verifier's per-query walk."""
    inv2 = pow(2, R_MOD - 2, R_MOD)
    s = oracle.mul(oracle.add(lo, hi), inv2)
    d = oracle.mul(oracle.sub(lo, hi), oracle.inv((2 * x_lo) % R_MOD))
    return oracle.add(s, oracle.mul(beta, d))
