// BLS12-377 Fr arithmetic for Hopper: 8 little-endian 32-bit words per
// element, Montgomery form with R = 2^256, canonical (< r) in and out.
//
// Field tensors are limb-major: word k of element i of a (8, N) operand
// lives at base[k * stride + i], so a warp's loads of one word are
// coalesced.  The multiply is CIOS on 32-bit digits with 64-bit
// multiply-accumulates (IMAD.WIDE.U32 carry chains); r = 1 mod 2^32, so the
// per-digit Montgomery quotient is simply m = -t0 mod 2^32.
#pragma once

#include <stdint.h>

namespace fr {

constexpr int W = 8;

struct fe {
  uint32_t v[W];
};

// r = 0x12ab655e9a2ca55660b44d1e5c37b00159aa76fed00000010a11800000000001,
// word i.  Resolved to immediates once the callers' loops are unrolled.
__device__ __forceinline__ uint32_t r_word(int i) {
  switch (i) {
    case 0: return 0x00000001u;
    case 1: return 0x0a118000u;
    case 2: return 0xd0000001u;
    case 3: return 0x59aa76feu;
    case 4: return 0x5c37b001u;
    case 5: return 0x60b44d1eu;
    case 6: return 0x9a2ca556u;
    default: return 0x12ab655eu;
  }
}

__device__ __forceinline__ fe load(const uint32_t* base, uint64_t stride,
                                   uint64_t i) {
  fe x;
#pragma unroll
  for (int k = 0; k < W; k++) x.v[k] = base[k * stride + i];
  return x;
}

__device__ __forceinline__ void store(uint32_t* base, uint64_t stride,
                                      uint64_t i, const fe& x) {
#pragma unroll
  for (int k = 0; k < W; k++) base[k * stride + i] = x.v[k];
}

// x - r if x >= r (x < 2r, with a possible carry word `hi`).
__device__ __forceinline__ fe cond_sub_r(const fe& x, uint32_t hi) {
  fe d;
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; i++) {
    int64_t t = (int64_t)x.v[i] - (int64_t)r_word(i) - borrow;
    d.v[i] = (uint32_t)t;
    borrow = t < 0 ? 1 : 0;
  }
  // keep x when it is below r (a borrow out and no carry word)
  const bool keep = borrow && !hi;
  fe out;
#pragma unroll
  for (int i = 0; i < W; i++) out.v[i] = keep ? x.v[i] : d.v[i];
  return out;
}

__device__ __forceinline__ fe add(const fe& a, const fe& b) {
  fe s;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < W; i++) {
    c += (uint64_t)a.v[i] + b.v[i];
    s.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return cond_sub_r(s, (uint32_t)c);
}

__device__ __forceinline__ fe sub(const fe& a, const fe& b) {
  fe d;
  int64_t borrow = 0;
#pragma unroll
  for (int i = 0; i < W; i++) {
    int64_t t = (int64_t)a.v[i] - (int64_t)b.v[i] - borrow;
    d.v[i] = (uint32_t)t;
    borrow = t < 0 ? 1 : 0;
  }
  // a < b: add r back (the carry out of the add-back cancels the borrow)
  const uint32_t mask = borrow ? 0xffffffffu : 0u;
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < W; i++) {
    c += (uint64_t)d.v[i] + (r_word(i) & mask);
    d.v[i] = (uint32_t)c;
    c >>= 32;
  }
  return d;
}

// Montgomery product a*b*R^-1 mod r (CIOS).  Valid for any a < 2^256 and
// canonical b: the result is then < 2r before the final subtract.
__device__ __forceinline__ fe mul(const fe& a, const fe& b) {
  uint32_t t[W + 2];
#pragma unroll
  for (int i = 0; i < W + 2; i++) t[i] = 0;
#pragma unroll
  for (int i = 0; i < W; i++) {
    // t += a * b[i]
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < W; j++) {
      c += (uint64_t)a.v[j] * b.v[i] + t[j];
      t[j] = (uint32_t)c;
      c >>= 32;
    }
    c += t[W];
    t[W] = (uint32_t)c;
    t[W + 1] = (uint32_t)(c >> 32);
    // t = (t + m*r) / 2^32 with m = -t0 mod 2^32 (-r^-1 = -1 mod 2^32)
    const uint32_t m = 0u - t[0];
    c = (uint64_t)m * r_word(0) + t[0];
    c >>= 32;
#pragma unroll
    for (int j = 1; j < W; j++) {
      c += (uint64_t)m * r_word(j) + t[j];
      t[j - 1] = (uint32_t)c;
      c >>= 32;
    }
    c += t[W];
    t[W - 1] = (uint32_t)c;
    t[W] = t[W + 1] + (uint32_t)(c >> 32);
  }
  fe x;
#pragma unroll
  for (int i = 0; i < W; i++) x.v[i] = t[i];
  return cond_sub_r(x, t[W]);
}

__device__ __forceinline__ fe zero() {
  fe z;
#pragma unroll
  for (int i = 0; i < W; i++) z.v[i] = 0;
  return z;
}

}  // namespace fr
