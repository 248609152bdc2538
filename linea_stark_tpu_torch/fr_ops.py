"""Field ops for prover-level code: each O(N) operation goes through the K1,
K2, K6 or K7 kernel wrappers, which launch the CUDA kernel for a CUDA tensor
and run the plain PyTorch version for a CPU tensor.

Operands are ``(8, *batch)`` int32 tensors whose batch axes broadcast
numpy-style, right-aligned (axis 0 is always the words).  The second operand
of a binary op reaches the kernel as one of its strided forms (same shape,
one scalar, a table shared over leading axes, one value per row), so a
broadcast operand is never materialized; anything else is expanded first.
Layout ops (cat, slices, reshapes) stay plain torch.
"""

from __future__ import annotations

import math

import torch

from .field import fr, oracle
from .field.constants import MONT_R2, R_MOD
from .kernels import field_ops as kf


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(8, *batch) -> (8, N) with a unit inner stride (a view when possible)."""
    x2 = x.reshape(8, -1)
    if x2.shape[1] > 1 and x2.stride(1) != 1:
        x2 = x2.contiguous()
    return x2


def _unexpand(x: torch.Tensor) -> torch.Tensor:
    """Narrow every stride-0 (expanded) batch axis back to length 1."""
    for d in range(1, x.dim()):
        if x.shape[d] > 1 and x.stride(d) == 0:
            x = x.narrow(d, 0, 1)
    return x


def _b_pattern(b: torch.Tensor, batch: tuple):
    """(b2, div, mod) reading b's broadcast over ``batch`` as the kernel's
    b[(i // div) % mod], or None when b's kept axes are not one run."""
    bshape = (1,) * (len(batch) - (b.dim() - 1)) + tuple(b.shape[1:])
    kept = [d for d in range(len(batch)) if batch[d] != 1 and bshape[d] != 1]
    if not kept:
        return b.reshape(8, -1)[:, :1], 1, 1
    p, q = kept[0], kept[-1] + 1
    if any(batch[d] != 1 and bshape[d] == 1 for d in range(p, q)):
        return None
    mod = math.prod(batch[p:q])
    div = math.prod(batch[q:])
    return _flat(b.reshape((8,) + bshape)), div, mod


def _binop(op: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    batch = tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
    a, b = _unexpand(a), _unexpand(b)
    a_full = tuple(a.shape[1:]) == batch
    if not a_full and op != "sub" and tuple(b.shape[1:]) == batch:
        a, b = b, a
    elif not a_full:
        a = fr._align(a, batch)
    pat = _b_pattern(b, batch)
    if pat is None:
        pat = (_flat(fr._align(b, batch)), 1, math.prod(batch))
    b2, div, mod = pat
    out = kf.binop(op, _flat(a), b2, div, mod)
    return out.reshape((8, *batch))


def mul(a, b):
    return _binop("mul", a, b)


def add(a, b):
    return _binop("add", a, b)


def sub(a, b):
    return _binop("sub", a, b)


def mul_const(a: torch.Tensor, c_int: int) -> torch.Tensor:
    """Multiply by a host-known constant (converted once to Montgomery)."""
    if c_int % R_MOD == 1:
        return a
    return mul_scalar_arr(a, fr.const(c_int, device=a.device))


def mul_scalar_arr(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Multiply (8, *batch) by one (8,) Montgomery scalar."""
    out = kf.binop("mul", _flat(a), c.reshape(8, 1), 1, 1)
    return out.reshape(a.shape)


def to_mont(x: torch.Tensor) -> torch.Tensor:
    """Raw words (any value < 2**256) -> canonical Montgomery form."""
    return mul_scalar_arr(x, fr.const(MONT_R2, mont=False, device=x.device))


def from_mont(x: torch.Tensor) -> torch.Tensor:
    return mul_scalar_arr(x, fr.const(1, mont=False, device=x.device))


# Tables are seeded on the host up to one block, then extended on the device
# by doubling: P[k..2k) = P[0..k)·w^k, log2(count / block) launches.
_POWERS_BLOCK = 64


def powers(base_int: int, count: int, device=None) -> torch.Tensor:
    """(8, count) table [1, w, ..., w^(count-1)] on ``device``."""
    base = base_int % R_MOD
    b = min(_POWERS_BLOCK, count)
    first = [1]
    for _ in range(b - 1):
        first.append(oracle.mul(first[-1], base))
    p = fr.pack_ints(first, device=device)
    size = b
    while size < count:
        p = torch.cat([p, mul_const(p, pow(base, size, R_MOD))], dim=-1)
        size *= 2
    return p[:, :count]


def _shift_fill(x: torch.Tensor, k: int, fill: torch.Tensor,
                reverse: bool = False) -> torch.Tensor:
    """Shift along the last axis by k (right, or left with ``reverse``),
    filling the vacated slots with ``fill``."""
    pad = fill.expand(x.shape[:-1] + (k,))
    if reverse:
        return torch.cat([x[..., k:], pad], dim=-1)
    return torch.cat([pad, x[..., : x.shape[-1] - k]], dim=-1)


def _doubling_scan(x: torch.Tensor, op: str, reverse: bool) -> torch.Tensor:
    """Inclusive scan along the last axis: log2(N) full-width K1 launches
    (Hillis-Steele doubling, each step combining x with itself shifted by k
    and identity-filled)."""
    combine = mul if op == "mul" else add
    ident = fr.full((1,) * (x.dim() - 1), 1 if op == "mul" else 0, device=x.device)
    k = 1
    while k < x.shape[-1]:
        x = combine(x, _shift_fill(x, k, ident, reverse))
        k *= 2
    return x


def prefix_product(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (suffix with ``reverse``) product along the last axis."""
    return _doubling_scan(x, "mul", reverse)


def prefix_sum(x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """Inclusive prefix (suffix with ``reverse``) sum along the last axis."""
    return _doubling_scan(x, "add", reverse)


_INV_BLOCK = 64


def batch_inverse(x: torch.Tensor) -> torch.Tensor:
    """Invert every element (all must be nonzero) with the blocked
    Montgomery trick: ~3 multiplies per element plus the inverses of the
    block products, found the same way one level down (one host Fermat
    inversion per element only below one block).

    Every element is independent, so the whole tensor is one flat batch
    viewed as (L, B) positions-by-blocks: a forward sweep of L launches
    builds the within-block prefix products, a backward sweep of 2L
    launches emits inv(x[t]) = inv(block) · prefix[t-1] · suffix, each
    launch B elements wide."""
    shape = x.shape
    flat = _flat(x)
    t = flat.shape[1]
    if t <= _INV_BLOCK:
        vals = fr.unpack_ints(flat)
        return fr.pack_ints([oracle.inv(v) for v in vals], device=x.device).reshape(shape)
    big_l = _INV_BLOCK
    nb = -(-t // big_l)
    pad = nb * big_l - t
    if pad:
        flat = torch.cat([flat, fr.ones((pad,), device=x.device)], dim=-1)
    xs = flat.reshape(8, nb, big_l).permute(0, 2, 1).contiguous()  # (8, L, B)
    prefix = [xs[:, 0]]
    for k in range(1, big_l):
        prefix.append(mul(prefix[-1], xs[:, k]))
    running = batch_inverse(prefix[-1])  # inverse of each block's product
    out = [None] * big_l
    for k in range(big_l - 1, 0, -1):
        out[k] = mul(running, prefix[k - 1])
        running = mul(running, xs[:, k])
    out[0] = running
    res = torch.stack(out, dim=1).permute(0, 2, 1).reshape(8, -1)
    return res[:, :t].reshape(shape)


def batch_inverse_eager(x: torch.Tensor) -> torch.Tensor:
    """Invert every element (all must be nonzero): the reference's eager
    form, which its ``LINEA_FUSED=0`` phases take.  The whole tensor is one
    flat batch: prefix and suffix doubling products (2·log2(N) K1 launches),
    the total read back and inverted on the host by Fermat (a sync), then
    inv(x[i]) = prefix[i-1]·suffix[i+1]·inv(total) in one K6 launch."""
    flat = _flat(x)
    pre = prefix_product(flat)
    suf = prefix_product(flat, reverse=True)
    total = fr.unpack_ints(pre[:, -1:])[0]
    total_inv = fr.const(oracle.inv(total), device=x.device)
    one = fr.ones((1,), device=x.device)
    out = kf.mul3_scalar(_shift_fill(pre, 1, one), _shift_fill(suf, 1, one, reverse=True),
                         total_inv)
    return out.reshape(x.shape)


def weighted_sums_to_ints(mat: torch.Tensor, u: torch.Tensor) -> list:
    """sum_j mat[:, c, j]·u[:, j] per column of (8, W, N); W canonical ints
    (one fused multiply-and-sum launch pair for all columns)."""
    return fr.unpack_ints(kf.weighted_colsum(mat, u))


def sum_to_ints(x: torch.Tensor) -> list:
    """Field sum along the last axis of (8, W, N); W canonical ints.  One K7
    launch pair for N >= 128, the halving adds of :func:`tree_sum` below."""
    sums = kf.colsum(x) if x.shape[-1] >= 128 else tree_sum(x)
    return fr.unpack_ints(sums)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Field sum along the last axis by halving adds (an odd last element
    joins the first partial sum)."""
    while x.shape[-1] > 1:
        n = x.shape[-1]
        half = n // 2
        s = add(x[..., :half], x[..., half:2 * half])
        if n % 2:
            s = torch.cat([add(s[..., :1], x[..., n - 1:]), s[..., 1:]], dim=-1)
        x = s
    return x[..., 0]
