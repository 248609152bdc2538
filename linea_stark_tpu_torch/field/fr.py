"""BLS12-377 Fr arithmetic on limb-packed torch tensors: layout, converters
and the plain PyTorch versions of the field operations.

Representation
--------------
A batch of field elements is a ``torch.int32`` tensor of shape
``(8, *batch)``: axis 0 holds 8 little-endian 32-bit words, bit for bit (the
CUDA kernels read them as ``uint32``).  Values are canonical (< r) and in
Montgomery form x·R mod r with R = 2**256, exactly the integers the JAX
reference stores as 16 limbs of 16 bits: word k is limbs 2k | 2k+1 << 16.
The limb axis leads so every axis expression of the reference (``mat[:, c]``,
``[..., i::blowup]``) keeps its meaning, and thread i of a kernel reads word
k at k·N + i (coalesced).

Converters carry values between four layouts: canonical Python ints, the
reference's ``(16, ...)`` uint32 planes, this ``(8, ...)`` int32 layout and
the host C engine's ``(N, 4)`` uint64 rows (an ``(N, 8)`` u32 row viewed as
u64 words is exactly that row).

The plain versions below are what a CPU tensor runs and what the CUDA
kernels are held against.  Torch on the CPU cannot add or shift ``uint32``,
so they compute in ``int64``: add/sub on 8 words of 32 bits, the Montgomery
product as the reference's radix-2**16 CIOS (``linea_stark_tpu/field/fr.py``
``mul_wide``) on 16 sub-limbs, whose partial products stay far below 2**63.
Whatever digit size the reduction uses, its quotient M is the unique value in
[0, R) making a·b + M·r divisible by R, so these results equal the kernels'
8×32-bit CIOS bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from . import oracle
from .constants import MONT_R, MONT_R2, R_MOD

NUM_WORDS = 8
WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1
DTYPE = torch.int32

_R_WORDS = [(R_MOD >> (WORD_BITS * i)) & WORD_MASK for i in range(NUM_WORDS)]
_R_SUB16 = [(R_MOD >> (16 * i)) & 0xFFFF for i in range(16)]


# ---------------------------------------------------------------------------
# Converters
# ---------------------------------------------------------------------------

def _words_np(vals: np.ndarray) -> np.ndarray:
    """Object array of ints < 2**256 -> (8, N) uint32 words."""
    out = np.empty((NUM_WORDS, len(vals)), dtype=np.uint32)
    for i in range(NUM_WORDS):
        out[i] = ((vals >> (WORD_BITS * i)) & WORD_MASK).astype(np.uint64)
    return out


def pack_ints(values, mont: bool = True, device=None) -> torch.Tensor:
    """Canonical Python ints -> (8, N) int32 tensor (Montgomery by default)."""
    vals = np.array([int(v) for v in values], dtype=object) % R_MOD
    if mont:
        vals = (vals * MONT_R) % R_MOD
    words = _words_np(vals) if len(vals) else np.zeros((NUM_WORDS, 0), np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(device)


def unpack_ints(t: torch.Tensor, mont: bool = True) -> list:
    """(8, *batch) tensor -> flat list of canonical Python ints."""
    w = t.detach().cpu().reshape(NUM_WORDS, -1).numpy().view(np.uint32)
    acc = w[NUM_WORDS - 1].astype(object)
    for i in range(NUM_WORDS - 2, -1, -1):
        acc = acc * (1 << WORD_BITS) + w[i].astype(object)
    if mont:
        acc = (acc * oracle.MONT_R_INV) % R_MOD
    return acc.tolist()


def const(value_int: int, mont: bool = True, device=None) -> torch.Tensor:
    """One field constant as an (8,) tensor."""
    return pack_ints([value_int], mont, device)[:, 0]


def full(batch_shape, value_int: int, mont: bool = True, device=None) -> torch.Tensor:
    """A single value broadcast (as a view) to ``(8, *batch_shape)``."""
    batch_shape = tuple(batch_shape)
    c = const(value_int, mont, device).reshape((NUM_WORDS,) + (1,) * len(batch_shape))
    return c.expand((NUM_WORDS, *batch_shape))


def zeros(batch_shape=(), device=None) -> torch.Tensor:
    return torch.zeros((NUM_WORDS, *tuple(batch_shape)), dtype=DTYPE, device=device)


def ones(batch_shape=(), device=None) -> torch.Tensor:
    return full(batch_shape, 1, device=device)


def from_ref_planes(planes: np.ndarray) -> torch.Tensor:
    """Reference (16, *batch) uint32 16-bit limb planes -> (8, *batch) int32."""
    p = np.asarray(planes, dtype=np.uint32)
    words = p[0::2] | (p[1::2] << np.uint32(16))
    return torch.from_numpy(np.ascontiguousarray(words).view(np.int32))


def to_ref_planes(t: torch.Tensor) -> np.ndarray:
    """(8, *batch) int32 tensor -> reference (16, *batch) uint32 planes."""
    w = t.detach().cpu().contiguous().numpy().view(np.uint32)
    out = np.empty((16,) + w.shape[1:], dtype=np.uint32)
    out[0::2] = w & np.uint32(0xFFFF)
    out[1::2] = w >> np.uint32(16)
    return out


def to_u64_rows(t: torch.Tensor) -> np.ndarray:
    """(8, N) int32 tensor -> (N, 4) uint64 rows of the host C engine (the
    same residues, Montgomery or not, as the tensor holds)."""
    w = t.detach().cpu().reshape(NUM_WORDS, -1).numpy().view(np.uint32)
    return np.ascontiguousarray(w.T).view(np.uint64)


def from_u64_rows(rows: np.ndarray, device=None) -> torch.Tensor:
    """(N, 4) uint64 rows -> (8, N) int32 tensor."""
    r = np.ascontiguousarray(rows, dtype=np.uint64).view(np.uint32)  # (N, 8)
    return torch.from_numpy(np.ascontiguousarray(r.T).view(np.int32)).to(device)


# ---------------------------------------------------------------------------
# Plain int64 arithmetic
# ---------------------------------------------------------------------------

def _wide(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 words in [0, 2**32)."""
    return x.to(torch.int64) & WORD_MASK


def _narrow(w: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2**32) -> int32 bit patterns."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(DTYPE)


def _cond_sub_r(w: list) -> list:
    """Subtract r from a value < 2r given as 8 int64 words (< 2**32 each)."""
    out = []
    borrow = torch.zeros_like(w[0])
    for i in range(NUM_WORDS):
        d = w[i] - _R_WORDS[i] - borrow
        borrow = (d < 0).to(torch.int64)
        out.append(d + (borrow << WORD_BITS))
    keep = borrow.bool()  # borrow out: value < r
    return [torch.where(keep, w[i], out[i]) for i in range(NUM_WORDS)]


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod r, elementwise (broadcasting over the batch axes)."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    s = _align(_wide(a), batch) + _align(_wide(b), batch)
    words = []
    carry = torch.zeros_like(s[0])
    for i in range(NUM_WORDS):
        t = s[i] + carry
        words.append(t & WORD_MASK)
        carry = t >> WORD_BITS
    # a, b < r < 2**253: the sum fits in 8 words
    return _narrow(torch.stack(_cond_sub_r(words)))


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a − b mod r (borrow-add of r)."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    d = _align(_wide(a), batch) - _align(_wide(b), batch)
    words = []
    borrow = torch.zeros_like(d[0])
    for i in range(NUM_WORDS):
        t = d[i] - borrow
        borrow = (t < 0).to(torch.int64)
        words.append(t + (borrow << WORD_BITS))
    carry = torch.zeros_like(borrow)
    out = []
    for i in range(NUM_WORDS):
        t = words[i] + borrow * _R_WORDS[i] + carry
        out.append(t & WORD_MASK)
        carry = t >> WORD_BITS
    return _narrow(torch.stack(out))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    """(8, *batch) words -> (*batch) bool: the element is 0 (in any form)."""
    return (a == 0).all(dim=0)


def _align(x: torch.Tensor, batch) -> torch.Tensor:
    """Broadcast (L, *b) to (L, *batch), batch axes right-aligned."""
    pad = (1,) * (len(batch) - (x.dim() - 1))
    return x.reshape((x.shape[0],) + pad + tuple(x.shape[1:])).expand(
        (x.shape[0], *batch))


def _sub16(x: torch.Tensor) -> torch.Tensor:
    """(8, *b) int32 -> (16, *b) int64 16-bit sub-limbs."""
    w = _wide(x)
    return torch.stack([w & 0xFFFF, w >> 16], dim=1).reshape((16,) + w.shape[1:])


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product a·b·R^{-1} mod r (radix-2**16 CIOS in int64).

    Valid for any a < 2**256 and canonical b (the product bound a·b + M·r
    < 2r·R then holds), which ``to_mont`` of raw decoded words relies on.
    Accumulator entries stay below 2**39, far under the int64 ceiling."""
    batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
    la = _align(_sub16(a), batch)
    lb = _align(_sub16(b), batch)
    acc = torch.zeros((33, *batch), dtype=torch.int64, device=a.device)
    for j in range(16):
        acc[j : j + 16] += la * lb[j]
    r16 = torch.tensor(_R_SUB16, dtype=torch.int64, device=a.device).reshape(
        (16,) + (1,) * len(batch)
    )
    for i in range(16):
        m = (-acc[i]) & 0xFFFF  # -r^{-1} mod 2**16 == 0xFFFF
        acc[i : i + 16] += m * r16
        acc[i + 1] += acc[i] >> 16
    res = acc[16:]
    limbs = []
    carry = torch.zeros_like(res[0])
    for k in range(17):
        t = res[k] + carry
        limbs.append(t & 0xFFFF)
        carry = t >> 16
    # value < 2r < 2**254: the top sub-limb and the carry are zero
    words = [limbs[2 * i] | (limbs[2 * i + 1] << 16) for i in range(NUM_WORDS)]
    return _narrow(torch.stack(_cond_sub_r(words)))


def to_mont(a: torch.Tensor) -> torch.Tensor:
    """Raw words (any value < 2**256) -> canonical Montgomery form."""
    return mul(a, const(MONT_R2, mont=False, device=a.device).reshape(
        (NUM_WORDS,) + (1,) * (a.dim() - 1)))


def from_mont(a: torch.Tensor) -> torch.Tensor:
    """Montgomery form -> canonical residue words (multiplies by raw 1)."""
    return mul(a, const(1, mont=False, device=a.device).reshape(
        (NUM_WORDS,) + (1,) * (a.dim() - 1)))


def pow_const(a: torch.Tensor, e: int, mul_fn=mul) -> torch.Tensor:
    """a**e for a Python-int exponent (square and multiply)."""
    assert e >= 0
    result = ones(a.shape[1:], device=a.device)
    base = a
    first = True
    while e:
        if e & 1:
            result = base if first else mul_fn(result, base)
            first = False
        e >>= 1
        if e:
            base = mul_fn(base, base)
    return result.contiguous() if first else result


def inv(a: torch.Tensor, mul_fn=mul) -> torch.Tensor:
    """Elementwise inverse by Fermat (a**(r-2)); a must be nonzero."""
    return pow_const(a, R_MOD - 2, mul_fn)
