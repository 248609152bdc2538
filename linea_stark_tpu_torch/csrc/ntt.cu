// One Stockham NTT stage, radix 2 or 4, natural order in and out.
//
// Replaces the TPU's pallas_ntt._stage_axis2 (radix 2) and _stage4_axis2
// (two merged stages held in registers).  The input of a stage is viewed per
// transform as X[L][M] (L*M = n): row l holds the length-M DFT of the
// stride-L subsequence starting at l.  A radix-2 stage combines rows l and
// l + L/2 into Y[L/2][2M]:
//   Y[l][j]     = X[l][j] + w X[l+L/2][j]
//   Y[l][j + M] = X[l][j] - w X[l+L/2][j],      w = omega_2M^j
// and radix 4 is two such stages fused, so the middle values never leave
// registers.  Twiddles come from one device table P[k] = omega_n^k, k < n/2:
// omega_2M^j = P[j n/(2M)].
//
// Bound: a stage moves 64 B per element; radix 4 spends one Montgomery
// multiply per element (radix 2: half of one), so at the main path's sizes
// each stage is close to balanced between memory and integer issue.  Thread
// t handles butterfly (l, j) = (t / M, t % M): its loads X[l + k L/4][j] sit
// at t + k n/4, coalesced for every M; its stores are runs of M.
// log2(n) / 2 launches per transform; the four-step and shared-memory
// multi-stage forms are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 256;

template <int RADIX>
__global__ void stage_kernel(const uint32_t* __restrict__ x,
                             uint32_t* __restrict__ y, uint64_t batch,
                             uint64_t n, uint64_t m,
                             const uint32_t* __restrict__ table,
                             uint64_t table_n) {
  const uint64_t limb = batch * n;  // limb stride of x and y
  const uint64_t per = n / RADIX;   // butterflies per transform
  const uint64_t total = batch * per;
  for (uint64_t t = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
       t < total; t += (uint64_t)gridDim.x * blockDim.x) {
    const uint64_t b = t / per;
    const uint64_t r = t - b * per;
    const uint64_t l = r / m;
    const uint64_t j = r - l * m;
    const uint64_t base = b * n;
    if (RADIX == 2) {
      const fr::fe a0 = fr::load(x, limb, base + r);
      const fr::fe a1 = fr::load(x, limb, base + r + per);
      const fr::fe w = fr::load(table, table_n, j * (n / (2 * m)));
      const fr::fe t1 = fr::mul(a1, w);
      const uint64_t o = base + l * 2 * m + j;
      fr::store(y, limb, o, fr::add(a0, t1));
      fr::store(y, limb, o + m, fr::sub(a0, t1));
    } else {
      const fr::fe a0 = fr::load(x, limb, base + r);
      const fr::fe a1 = fr::load(x, limb, base + r + per);
      const fr::fe a2 = fr::load(x, limb, base + r + 2 * per);
      const fr::fe a3 = fr::load(x, limb, base + r + 3 * per);
      const uint64_t q = n / (4 * m);
      const fr::fe w1 = fr::load(table, table_n, 2 * j * q);  // omega_2M^j
      const fr::fe w2 = fr::load(table, table_n, j * q);      // omega_4M^j
      const fr::fe w3 = fr::load(table, table_n, (j + m) * q);
      const fr::fe p2 = fr::mul(a2, w1);
      const fr::fe p3 = fr::mul(a3, w1);
      const fr::fe u0 = fr::add(a0, p2), u1 = fr::sub(a0, p2);
      const fr::fe v0 = fr::add(a1, p3), v1 = fr::sub(a1, p3);
      const fr::fe s0 = fr::mul(v0, w2), s1 = fr::mul(v1, w3);
      const uint64_t o = base + l * 4 * m + j;
      fr::store(y, limb, o, fr::add(u0, s0));
      fr::store(y, limb, o + m, fr::add(u1, s1));
      fr::store(y, limb, o + 2 * m, fr::sub(u0, s0));
      fr::store(y, limb, o + 3 * m, fr::sub(u1, s1));
    }
  }
}

unsigned grid_for(uint64_t n) {
  uint64_t g = (n + kThreads - 1) / kThreads;
  const uint64_t cap = 132ull * 64;
  return (unsigned)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

extern "C" int ntt_stage(int radix, const uint32_t* x, uint32_t* y,
                         long long batch, long long n, long long m,
                         const uint32_t* table, long long table_n,
                         void* stream) {
  const uint64_t total = (uint64_t)batch * (n / radix);
  if (radix == 2) {
    stage_kernel<2><<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        x, y, batch, n, m, table, table_n);
  } else if (radix == 4) {
    stage_kernel<4><<<grid_for(total), kThreads, 0, (cudaStream_t)stream>>>(
        x, y, batch, n, m, table, table_n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
