// Width-3 Poseidon2 over Fr: x^11 S-box, external matrix circ(2,1,1),
// internal matrix diag(1,1,2) + ones.  Three launches share one permutation:
//
//   p2_permute       (s0, s1, s2) -> 3 words     pallas_poseidon2._permute_call
//   p2_permute2      (l, r, 0)    -> 3 words     pallas_poseidon2._permute2_call
//   p2_merkle_level  out[j] = compress(d[2j], d[2j+1])
//                                                pallas_poseidon2._tree_step
//
// The TPU's tree step worked on a bit-reversed buffer so one compiled shape
// served every level; here levels stay in natural order and the pair is read
// with stride-2 loads, so a level needs no gather copy.
//
// Bound: integer issue.  A permutation is 230 Montgomery multiplies (~50k
// integer instructions) against 96-192 B of traffic, so the kernel is
// compute-bound at any size: one state per thread, everything in
// registers, round constants in __constant__ memory (all lanes of a warp
// read the same word, which the constant cache broadcasts).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fr.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRounds = 64;

// Montgomery round constants, [round][lane][word]; internal rounds use lane 0.
__constant__ uint32_t RC[kMaxRounds][3][fr::W];

__device__ __forceinline__ fr::fe rc(int round, int lane) {
  fr::fe c;
#pragma unroll
  for (int k = 0; k < fr::W; k++) c.v[k] = RC[round][lane][k];
  return c;
}

__device__ __forceinline__ fr::fe sbox(const fr::fe& x) {
  const fr::fe x2 = fr::mul(x, x);
  const fr::fe x3 = fr::mul(x2, x);
  const fr::fe x4 = fr::mul(x2, x2);
  const fr::fe x8 = fr::mul(x4, x4);
  return fr::mul(x8, x3);
}

__device__ __forceinline__ void ext_linear(fr::fe s[3]) {
  const fr::fe t = fr::add(fr::add(s[0], s[1]), s[2]);
  s[0] = fr::add(s[0], t);
  s[1] = fr::add(s[1], t);
  s[2] = fr::add(s[2], t);
}

__device__ __forceinline__ void int_linear(fr::fe s[3]) {
  const fr::fe t = fr::add(fr::add(s[0], s[1]), s[2]);
  s[0] = fr::add(s[0], t);
  s[1] = fr::add(s[1], t);
  s[2] = fr::add(fr::add(s[2], s[2]), t);
}

__device__ void permute(fr::fe s[3], int rf, int rp) {
  const int half = rf / 2;
  ext_linear(s);
  for (int r = 0; r < half; r++) {
#pragma unroll
    for (int k = 0; k < 3; k++) s[k] = sbox(fr::add(s[k], rc(r, k)));
    ext_linear(s);
  }
  for (int r = half; r < half + rp; r++) {
    s[0] = sbox(fr::add(s[0], rc(r, 0)));
    int_linear(s);
  }
  for (int r = half + rp; r < rf + rp; r++) {
#pragma unroll
    for (int k = 0; k < 3; k++) s[k] = sbox(fr::add(s[k], rc(r, k)));
    ext_linear(s);
  }
}

__global__ void permute_kernel(const uint32_t* __restrict__ s0, uint64_t st0,
                               const uint32_t* __restrict__ s1, uint64_t st1,
                               const uint32_t* __restrict__ s2, uint64_t st2,
                               uint32_t* o0, uint32_t* o1, uint32_t* o2,
                               uint64_t n, int rf, int rp) {
  for (uint64_t i = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x; i < n;
       i += (uint64_t)gridDim.x * blockDim.x) {
    fr::fe s[3] = {fr::load(s0, st0, i), fr::load(s1, st1, i),
                   s2 ? fr::load(s2, st2, i) : fr::zero()};
    permute(s, rf, rp);
    fr::store(o0, n, i, s[0]);
    if (o1) fr::store(o1, n, i, s[1]);
    if (o2) fr::store(o2, n, i, s[2]);
  }
}

__global__ void merkle_level_kernel(const uint32_t* __restrict__ d,
                                    uint64_t d_stride,
                                    uint32_t* __restrict__ out, uint64_t n_out,
                                    int rf, int rp) {
  for (uint64_t j = blockIdx.x * (uint64_t)blockDim.x + threadIdx.x;
       j < n_out; j += (uint64_t)gridDim.x * blockDim.x) {
    fr::fe s[3] = {fr::load(d, d_stride, 2 * j), fr::load(d, d_stride, 2 * j + 1),
                   fr::zero()};
    permute(s, rf, rp);
    fr::store(out, n_out, j, s[0]);
  }
}

unsigned grid_for(uint64_t n) {
  uint64_t g = (n + kThreads - 1) / kThreads;
  const uint64_t cap = 132ull * 64;
  return (unsigned)(g < 1 ? 1 : (g > cap ? cap : g));
}

}  // namespace

extern "C" {

// Load a (rounds, 3, 8) Montgomery constant schedule from host memory.
int p2_set_constants(const uint32_t* host, int rounds) {
  if (rounds > kMaxRounds) return (int)cudaErrorInvalidValue;
  cudaMemcpyToSymbol(RC, host, (size_t)rounds * 3 * fr::W * sizeof(uint32_t));
  return (int)cudaGetLastError();
}

// (s0, s1, s2) -> (o0, o1, o2); o1/o2 == nullptr skip those outputs.
int p2_permute(const uint32_t* s0, long long st0, const uint32_t* s1,
               long long st1, const uint32_t* s2, long long st2, uint32_t* o0,
               uint32_t* o1, uint32_t* o2, long long n, int rf, int rp,
               void* stream) {
  if (n > 0) {
    permute_kernel<<<grid_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        s0, st0, s1, st1, s2, st2, o0, o1, o2, n, rf, rp);
  }
  return (int)cudaGetLastError();
}

// (l, r, 0) -> (o0, o1, o2): the third word is built in the kernel.
int p2_permute2(const uint32_t* l, long long st_l, const uint32_t* r,
                long long st_r, uint32_t* o0, uint32_t* o1, uint32_t* o2,
                long long n, int rf, int rp, void* stream) {
  return p2_permute(l, st_l, r, st_r, nullptr, 0, o0, o1, o2, n, rf, rp,
                    stream);
}

int p2_merkle_level(const uint32_t* d, long long d_stride, uint32_t* out,
                    long long n_out, int rf, int rp, void* stream) {
  if (n_out > 0) {
    merkle_level_kernel<<<grid_for(n_out), kThreads, 0, (cudaStream_t)stream>>>(
        d, d_stride, out, n_out, rf, rp);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
