// Elementwise field ops and the fused weighted column sum.
//
// fr_binop replaces the TPU's pallas_field.mul/add/sub (_binop),
// mul_scalar and the four-step twiddle multiply pallas_ntt._mul_broadcast:
// one launch computes out[i] = a[i] (op) b[(i / b_div) % b_mod], which covers
// equal shapes (div 1, mod N), one scalar (mod 1), a table shared over a
// leading batch (div 1, mod n) and one value per row (div n, mod rows).
// Bound: device memory for add/sub (96 B moved per element, a handful of
// integer ops); integer issue for mul (~200 IMADs for 96 B).  One element per
// thread in a grid-stride loop keeps loads coalesced.
//
// fr_wsum_partials + fr_sum_finish replace pallas_field.weighted_block_sums_128:
// sum_j x[c, j] * u[j] for every column c.  The TPU carried the running sums
// across its sequential grid; here blocks run in parallel, so pass 1 writes
// one partial per (column, block) and pass 2 folds them to W values on the
// device.  Field addition is exact, so the order of the sums is free.
//
// fr_mul3_scalar replaces pallas_field.mul3_scalar, the finish of the eager
// batch inversion: out[i] = (a[i] * b[i]) * c with c one scalar, read once
// per thread.  Two Montgomery products for 96 B moved: integer issue bounds
// it, as it does K1's mul.  a and b are strided views like K1's operands.
//
// fr_colsum_partials + fr_sum_finish replace pallas_field.block_sums_128:
// sum_j x[c, j] for every column, K2's two passes without the multiply.  The
// TPU carried 128 partials per column across its sequential grid; here pass
// 1 writes one partial per (column, block) and pass 2 folds them on the
// device.  32 B read per element and one add (~50 instructions): device
// memory bounds it.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void binop_kernel(int op, const uint32_t* __restrict__ a,
                             uint64_t a_stride, const uint32_t* __restrict__ b,
                             uint64_t b_stride, uint64_t b_div, uint64_t b_mod,
                             uint32_t* __restrict__ out, uint64_t n) {
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const uint64_t bi =
        b_mod == 1 ? 0 : (b_div == 1 && b_mod >= n ? i : (i / b_div) % b_mod);
    const fr::fe x = fr::load(a, a_stride, i);
    const fr::fe y = fr::load(b, b_stride, bi);
    fr::fe z;
    if (op == 0) {
      z = fr::mul(x, y);
    } else if (op == 1) {
      z = fr::add(x, y);
    } else {
      z = fr::sub(x, y);
    }
    fr::store(out, n, i, z);
  }
}

// Shared-memory tree reduction of one fe per thread; thread 0 returns the sum.
__device__ fr::fe block_sum(fr::fe acc, uint32_t (*sh)[kThreads]) {
#pragma unroll
  for (int k = 0; k < fr::W; k++) sh[k][threadIdx.x] = acc.v[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      fr::fe x, y;
#pragma unroll
      for (int k = 0; k < fr::W; k++) {
        x.v[k] = sh[k][threadIdx.x];
        y.v[k] = sh[k][threadIdx.x + s];
      }
      x = fr::add(x, y);
#pragma unroll
      for (int k = 0; k < fr::W; k++) sh[k][threadIdx.x] = x.v[k];
    }
    __syncthreads();
  }
  fr::fe out;
#pragma unroll
  for (int k = 0; k < fr::W; k++) out.v[k] = sh[k][0];
  return out;
}

// grid (nblk, W): block (blk, c) sums x[c, j] * u[j] over j = blk*T + t (mod
// nblk*T) into partials[k, c, blk].
__global__ void wsum_partials_kernel(const uint32_t* __restrict__ mat,
                                     uint64_t mat_limb_stride,
                                     uint64_t mat_col_stride,
                                     const uint32_t* __restrict__ u,
                                     uint64_t u_stride, uint64_t n,
                                     uint32_t* __restrict__ partials) {
  __shared__ uint32_t sh[fr::W][kThreads];
  const int c = blockIdx.y;
  const uint32_t* col = mat + c * mat_col_stride;
  fr::fe acc = fr::zero();
  for (uint64_t j = blockIdx.x * (uint64_t)kThreads + threadIdx.x; j < n;
       j += (uint64_t)gridDim.x * kThreads) {
    acc = fr::add(acc, fr::mul(fr::load(col, mat_limb_stride, j),
                               fr::load(u, u_stride, j)));
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    const uint64_t w = gridDim.y, nblk = gridDim.x;
    fr::store(partials, w * nblk, (uint64_t)c * nblk + blockIdx.x, acc);
  }
}

__global__ void mul3_scalar_kernel(const uint32_t* __restrict__ a,
                                   uint64_t a_stride,
                                   const uint32_t* __restrict__ b,
                                   uint64_t b_stride,
                                   const uint32_t* __restrict__ c,
                                   uint64_t c_stride,
                                   uint32_t* __restrict__ out, uint64_t n) {
  const fr::fe s = fr::load(c, c_stride, 0);
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    const fr::fe ab = fr::mul(fr::load(a, a_stride, i), fr::load(b, b_stride, i));
    fr::store(out, n, i, fr::mul(ab, s));
  }
}

// grid (nblk, W): block (blk, c) sums x[c, j] over j = blk*T + t (mod
// nblk*T) into partials[k, c, blk].
__global__ void sum_partials_kernel(const uint32_t* __restrict__ x,
                                    uint64_t limb_stride, uint64_t col_stride,
                                    uint64_t n, uint32_t* __restrict__ partials) {
  __shared__ uint32_t sh[fr::W][kThreads];
  const int c = blockIdx.y;
  const uint32_t* col = x + c * col_stride;
  fr::fe acc = fr::zero();
  for (uint64_t j = blockIdx.x * (uint64_t)kThreads + threadIdx.x; j < n;
       j += (uint64_t)gridDim.x * kThreads) {
    acc = fr::add(acc, fr::load(col, limb_stride, j));
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) {
    const uint64_t w = gridDim.y, nblk = gridDim.x;
    fr::store(partials, w * nblk, (uint64_t)c * nblk + blockIdx.x, acc);
  }
}

// grid (W): out[k, c] = sum_b partials[k, c, b].
__global__ void sum_finish_kernel(const uint32_t* __restrict__ partials,
                                  uint64_t nblk, uint32_t* __restrict__ out) {
  __shared__ uint32_t sh[fr::W][kThreads];
  const uint64_t c = blockIdx.x, w = gridDim.x;
  fr::fe acc = fr::zero();
  for (uint64_t b = threadIdx.x; b < nblk; b += kThreads) {
    acc = fr::add(acc, fr::load(partials, w * nblk, c * nblk + b));
  }
  acc = block_sum(acc, sh);
  if (threadIdx.x == 0) fr::store(out, w, c, acc);
}

unsigned grid_for(uint64_t n) {
  uint64_t g = (n + kThreads - 1) / kThreads;
  const uint64_t cap = 132ull * 64;  // enough waves to fill the card
  return (unsigned)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

extern "C" {

int fr_binop(int op, const uint32_t* a, long long a_stride, const uint32_t* b,
             long long b_stride, long long b_div, long long b_mod,
             uint32_t* out, long long n, void* stream) {
  if (n > 0) {
    binop_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        op, a, a_stride, b, b_stride, b_div, b_mod, out, n);
  }
  return (int)cudaGetLastError();
}

int fr_wsum_partials(const uint32_t* mat, long long limb_stride,
                     long long col_stride, int w, const uint32_t* u,
                     long long u_stride, long long n, uint32_t* partials,
                     int nblk, void* stream) {
  dim3 grid(nblk, w);
  wsum_partials_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      mat, limb_stride, col_stride, u, u_stride, n, partials);
  return (int)cudaGetLastError();
}

int fr_mul3_scalar(const uint32_t* a, long long a_stride, const uint32_t* b,
                   long long b_stride, const uint32_t* c, long long c_stride,
                   uint32_t* out, long long n, void* stream) {
  if (n > 0) {
    mul3_scalar_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        a, a_stride, b, b_stride, c, c_stride, out, n);
  }
  return (int)cudaGetLastError();
}

int fr_colsum_partials(const uint32_t* x, long long limb_stride,
                       long long col_stride, int w, long long n,
                       uint32_t* partials, int nblk, void* stream) {
  dim3 grid(nblk, w);
  sum_partials_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      x, limb_stride, col_stride, n, partials);
  return (int)cudaGetLastError();
}

int fr_sum_finish(const uint32_t* partials, int w, int nblk, uint32_t* out,
                  void* stream) {
  sum_finish_kernel<<<w, kThreads, 0, (cudaStream_t)stream>>>(partials, nblk,
                                                              out);
  return (int)cudaGetLastError();
}

}  // extern "C"
