"""Keccak-256, the alternative MMCS hasher.

The host oracle (``_RC``, ``_ROT``, ``keccak_f_ints``, ``keccak256`` with the
original 0x01 padding, not SHA3's 0x06, ``keccak256_field`` and
``RATE_BYTES``) is a jax-free copy of ``linea_stark_tpu/hash/keccak.py``.

:func:`keccak256_fixed_vec` is the plain PyTorch version of the reference's
``keccak256_fixed_vec``: 64-bit lanes are int64 tensors (Hopper and torch
have 64-bit integers, so the TPU's (lo, hi) u32 pairs are gone).  It runs on
any device; the K5 CUDA kernel (``csrc/keccak.cu``) is held against it.
"""

from __future__ import annotations

import torch

from ..field.constants import R_MOD

# ---------------------------------------------------------------------------
# Host oracle (Python ints)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A,
    0x8000000080008000, 0x000000000000808B, 0x0000000080000001,
    0x8000000080008081, 0x8000000000008009, 0x000000000000008A,
    0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089,
    0x8000000000008003, 0x8000000000008002, 0x8000000000000080,
    0x000000000000800A, 0x800000008000000A, 0x8000000080008081,
    0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

# rotation offsets r[x][y]
_ROT = [
    [0, 36, 3, 41, 18],
    [1, 44, 10, 45, 2],
    [62, 6, 43, 15, 61],
    [28, 55, 25, 21, 56],
    [27, 20, 39, 8, 14],
]


def _rotl64(v: int, r: int) -> int:
    r %= 64
    return ((v << r) | (v >> (64 - r))) & _MASK64


def keccak_f_ints(lanes: list) -> list:
    """Keccak-f[1600] on 25 ints (lane order A[x + 5y])."""
    a = list(lanes)
    for rc in _RC:
        # θ
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
        # ρ and π: B[y, 2x+3y] = rotl(A[x, y], r[x][y])
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl64(a[x + 5 * y], _ROT[x][y])
        # χ
        a = [
            b[x + 5 * y] ^ ((~b[(x + 1) % 5 + 5 * y] & _MASK64) & b[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        # ι
        a[0] ^= rc
    return a


RATE_BYTES = 136  # Keccak-256 rate
RATE_WORDS = RATE_BYTES // 8


def keccak256(data: bytes) -> bytes:
    """Original Keccak-256 (0x01 padding), e.g. keccak256(b"") =
    c5d2460186f7233c…"""
    padded = bytearray(data)
    pad_len = RATE_BYTES - (len(padded) % RATE_BYTES)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    lanes = [0] * 25
    for off in range(0, len(padded), RATE_BYTES):
        block = padded[off : off + RATE_BYTES]
        for i in range(RATE_WORDS):
            lanes[i] ^= int.from_bytes(block[8 * i : 8 * i + 8], "little")
        lanes = keccak_f_ints(lanes)
    return b"".join(int(lanes[i]).to_bytes(8, "little") for i in range(4))


def keccak256_field(chunks: list) -> int:
    """Hash a list of field elements (as canonical 32-byte BE each) to a
    field element: BE-int of the digest reduced mod r."""
    data = b"".join(int(v).to_bytes(32, "big") for v in chunks)
    return int.from_bytes(keccak256(data), "big") % R_MOD


# ---------------------------------------------------------------------------
# Plain PyTorch version: batched fixed-length Keccak-256 on int64 lanes
# ---------------------------------------------------------------------------

def _i64(v: int) -> int:
    """A 64-bit pattern as the signed value an int64 tensor holds."""
    return v - (1 << 64) if v >> 63 else v


def rotl_i64(x: torch.Tensor, r: int) -> torch.Tensor:
    """Rotate int64 lanes left by ``r`` (``>>`` is arithmetic, so the bits
    shifted in from the top are masked off)."""
    r %= 64
    if r == 0:
        return x
    return (x << r) | ((x >> (64 - r)) & ((1 << r) - 1))


def keccak_f_vec(a: list) -> list:
    """Keccak-f[1600] on 25 int64 lane tensors (lane order A[x + 5y])."""
    a = list(a)
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ rotl_i64(c[(x + 1) % 5], 1) for x in range(5)]
        a = [a[x + 5 * y] ^ d[x] for y in range(5) for x in range(5)]
        b = [None] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl_i64(a[x + 5 * y], _ROT[x][y])
        a = [
            b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y])
            for y in range(5)
            for x in range(5)
        ]
        a[0] = a[0] ^ _i64(rc)
    return a


def keccak256_fixed_vec(words: torch.Tensor) -> torch.Tensor:
    """Keccak-256 of N fixed-length messages.

    ``words``: (K, N) int64, K little-endian 64-bit message words per
    message (8K bytes).  Returns (4, N) int64: the 32-byte digest as 4 LE
    words.  Padding: 0x01 in the word after the message, 0x80 in the top
    byte of lane 16 of the last of ⌊8K/136⌋+1 blocks (at K = 17 the message
    fills a block and the padding goes alone into a second one)."""
    k, n = words.shape
    zeros = torch.zeros(n, dtype=torch.int64, device=words.device)
    nblocks = (8 * k) // RATE_BYTES + 1
    lanes = [zeros] * 25
    widx = 0
    for blk in range(nblocks):
        for i in range(RATE_WORDS):
            if widx < k:
                lanes[i] = lanes[i] ^ words[widx]
            elif widx == k:
                lanes[i] = lanes[i] ^ 0x01  # pad start
            widx += 1
        if blk == nblocks - 1:
            lanes[RATE_WORDS - 1] = lanes[RATE_WORDS - 1] ^ _i64(1 << 63)  # pad end
        lanes = keccak_f_vec(lanes)
    return torch.stack(lanes[:4])
