// Keccak-256 field digests of rows (K5 kc_hash) for the Keccak MMCS.
//
// Replaces the TPU's hash/hasher.py _keccak_fixed_kernel_call, whose body is
// hash/keccak.py keccak256_fixed_vec over keccak_f_vec, and fuses the two
// conversions around it (_mont_cols_to_words, _digest_words_to_field_mont).
// Row j of W columns becomes one (8,) Montgomery digest:
//
//   1. each value leaves Montgomery form (CIOS multiply by raw 1);
//   2. its 32-byte big-endian encoding joins the message: message word
//      4c + q is the byte swap of canonical 64-bit word 3 - q of column c;
//   3. Keccak-256 with the original 0x01 ... 0x80 padding over
//      floor(32W / 136) + 1 blocks of 17 lanes;
//   4. the digest, read as a big-endian integer, enters Montgomery form by a
//      CIOS multiply by R^2, which also reduces a value >= r.
//
// The TPU carried every 64-bit lane as a (lo, hi) u32 pair and kept the
// (4W, 2, N) message words in device memory (1 GiB for the 2^22-row trace
// leaves); here the whole chain is one pass and only the field values are
// read.  Every mode is one launch over W strided column views: a leaf hash
// (the columns of an (8, W, N) matrix), a Merkle level (views d[:, 0::2] and
// d[:, 1::2]) and a compression (two separate tensors).
//
// Bound: integer issue.  One Keccak-f compiles to 4645 SASS instructions
// (chip_smoke.py's probe counts them), against the 32 B that each absorbed
// value costs in traffic: a two-block trace leaf moves 288 B and issues
// ~12k instructions, so a leaf sweep is ~8x longer at the int32 issue rate
// than at the memory rate.  The design is one row per thread with the 25
// lanes in registers: the 24 rounds unrolled, rotation counts and round
// constants as immediates, a rotate as two funnel shifts (SHF.L.W) on the
// 32-bit halves and chi's b0 ^ (~b1 & b2) one LOP3 per half.  The absorb
// loop runs over the 17 rate lanes with static indices, so the state never
// leaves registers: ptxas gives the kernel 88 registers and no spill stores
// (chip_smoke.py's build phase prints that line for every kernel).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxCols = 64;     // kernels/keccak.py MAX_COLUMNS
constexpr int kRateWords = 17;   // 136-byte rate

// Column views, passed by value in the kernel's parameter space.
struct Columns {
  const uint32_t* ptr[kMaxCols];
  uint64_t limb_stride[kMaxCols];
  uint64_t elem_stride[kMaxCols];
};

__device__ __forceinline__ uint64_t round_constant(int round) {
  switch (round) {
    case 0: return 0x0000000000000001ull;
    case 1: return 0x0000000000008082ull;
    case 2: return 0x800000000000808Aull;
    case 3: return 0x8000000080008000ull;
    case 4: return 0x000000000000808Bull;
    case 5: return 0x0000000080000001ull;
    case 6: return 0x8000000080008081ull;
    case 7: return 0x8000000000008009ull;
    case 8: return 0x000000000000008Aull;
    case 9: return 0x0000000000000088ull;
    case 10: return 0x0000000080008009ull;
    case 11: return 0x000000008000000Aull;
    case 12: return 0x000000008000808Bull;
    case 13: return 0x800000000000008Bull;
    case 14: return 0x8000000000008089ull;
    case 15: return 0x8000000000008003ull;
    case 16: return 0x8000000000008002ull;
    case 17: return 0x8000000000000080ull;
    case 18: return 0x000000000000800Aull;
    case 19: return 0x800000008000000Aull;
    case 20: return 0x8000000080008081ull;
    case 21: return 0x8000000000008080ull;
    case 22: return 0x0000000080000001ull;
    default: return 0x8000000080008008ull;
  }
}

// Rotation offset of lane A[x + 5y].
__device__ __forceinline__ int rot_offset(int lane) {
  switch (lane) {
    case 0: return 0;   case 1: return 1;   case 2: return 62;
    case 3: return 28;  case 4: return 27;  case 5: return 36;
    case 6: return 44;  case 7: return 6;   case 8: return 55;
    case 9: return 20;  case 10: return 3;  case 11: return 10;
    case 12: return 43; case 13: return 25; case 14: return 39;
    case 15: return 41; case 16: return 45; case 17: return 15;
    case 18: return 21; case 19: return 8;  case 20: return 18;
    case 21: return 2;  case 22: return 61; case 23: return 56;
    default: return 14;
  }
}

// Rotate left by a count known after unrolling: two funnel shifts.
__device__ __forceinline__ uint64_t rotl(uint64_t x, int r) {
  uint32_t lo = (uint32_t)x, hi = (uint32_t)(x >> 32);
  if (r >= 32) {
    const uint32_t t = lo;
    lo = hi;
    hi = t;
    r -= 32;
  }
  const uint32_t nhi = __funnelshift_l(lo, hi, r);
  const uint32_t nlo = __funnelshift_l(hi, lo, r);
  return ((uint64_t)nhi << 32) | nlo;
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0, 0x0123);
}

__device__ __forceinline__ void keccak_f(uint64_t a[25]) {
#pragma unroll
  for (int round = 0; round < 24; round++) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; x++) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; x++) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl(c[(x + 1) % 5], 1);
#pragma unroll
      for (int y = 0; y < 5; y++) a[x + 5 * y] ^= d;
    }
    // rho and pi: B[y, 2x + 3y] = rotl(A[x, y], r[x][y])
#pragma unroll
    for (int x = 0; x < 5; x++) {
#pragma unroll
      for (int y = 0; y < 5; y++) {
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl(a[x + 5 * y], rot_offset(x + 5 * y));
      }
    }
    // chi
#pragma unroll
    for (int y = 0; y < 5; y++) {
#pragma unroll
      for (int x = 0; x < 5; x++) {
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] & b[(x + 2) % 5 + 5 * y]);
      }
    }
    a[0] ^= round_constant(round);  // iota
  }
}

// R^2 mod r (to_mont multiplier), word i.
__device__ __forceinline__ fr::fe mont_r2() {
  fr::fe x;
  x.v[0] = 0xb861857bu; x.v[1] = 0x25d577bau; x.v[2] = 0x8860591fu;
  x.v[3] = 0xcc2c27b5u; x.v[4] = 0xe5dc8593u; x.v[5] = 0xa7cc008fu;
  x.v[6] = 0xeff1c939u; x.v[7] = 0x011fdae7u;
  return x;
}

__global__ void __launch_bounds__(kThreads)
kc_hash_kernel(const __grid_constant__ Columns cols, int w,
               uint32_t* __restrict__ out, uint64_t n) {
  fr::fe one = fr::zero();  // raw 1: a Montgomery multiply by it is from_mont
  one.v[0] = 1;
  const int msg_words = 4 * w;
  const int nblocks = (32 * w) / (8 * kRateWords) + 1;
  for (uint64_t j = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; j < n;
       j += (uint64_t)gridDim.x * blockDim.x) {
    uint64_t a[25];
#pragma unroll
    for (int i = 0; i < 25; i++) a[i] = 0;
    fr::fe cur = fr::zero();  // canonical value of column cur_c
    int cur_c = -1;
    for (int blk = 0; blk < nblocks; blk++) {
#pragma unroll
      for (int i = 0; i < kRateWords; i++) {
        const int m = kRateWords * blk + i;  // message word index
        uint64_t word = 0;
        if (m < msg_words) {
          const int c = m >> 2;
          if (c != cur_c) {
            cur = fr::mul(fr::load(cols.ptr[c], cols.limb_stride[c],
                                   j * cols.elem_stride[c]),
                          one);
            cur_c = c;
          }
          // word q of the BE encoding = bswap64(canonical 64-bit word 3 - q)
          const int q = m & 3;
          const uint32_t lo = q == 0 ? cur.v[6] : q == 1 ? cur.v[4] : q == 2 ? cur.v[2] : cur.v[0];
          const uint32_t hi = q == 0 ? cur.v[7] : q == 1 ? cur.v[5] : q == 2 ? cur.v[3] : cur.v[1];
          word = ((uint64_t)bswap32(lo) << 32) | bswap32(hi);
        } else if (m == msg_words) {
          word = 0x01;  // pad start
        }
        if (i == kRateWords - 1 && blk == nblocks - 1) word ^= 0x8000000000000000ull;  // pad end
        a[i] ^= word;
      }
      keccak_f(a);
    }
    // big-endian digest integer: its 64-bit word k = bswap64(lane 3 - k)
    fr::fe x;
#pragma unroll
    for (int k = 0; k < 4; k++) {
      const uint64_t v = a[3 - k];
      x.v[2 * k] = bswap32((uint32_t)(v >> 32));
      x.v[2 * k + 1] = bswap32((uint32_t)v);
    }
    fr::store(out, n, j, fr::mul(x, mont_r2()));
  }
}

unsigned grid_for(uint64_t n) {
  uint64_t g = (n + kThreads - 1) / kThreads;
  const uint64_t cap = 132ull * 64;
  return (unsigned)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

// out[:, j] = Keccak-256 field digest of row j of the w columns; column c is
// word k of element j at ptrs[c][k * limb_strides[c] + j * elem_strides[c]]
// (the three arrays are host memory).
extern "C" int kc_hash(const uint64_t* ptrs, const long long* limb_strides,
                       const long long* elem_strides, int w, uint32_t* out,
                       long long n, void* stream) {
  if (w < 1 || w > kMaxCols) return (int)cudaErrorInvalidValue;
  Columns cols;
  for (int c = 0; c < kMaxCols; c++) {
    const bool used = c < w;
    cols.ptr[c] = used ? (const uint32_t*)ptrs[c] : nullptr;
    cols.limb_stride[c] = used ? (uint64_t)limb_strides[c] : 0;
    cols.elem_stride[c] = used ? (uint64_t)elem_strides[c] : 0;
  }
  if (n > 0) {
    kc_hash_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        cols, w, out, (uint64_t)n);
  }
  return (int)cudaGetLastError();
}
