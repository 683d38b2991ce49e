// K4: one weighted farthest-point (maximin) step on the raw channel-major
// feature rows.
//
// Replaces models/kmeans_chw.py::_maximin_chw_kernel (wrapper
// _maximin_chw_pass). For probe p and weights a^2 (the standardisation
// affine squared, so distances are the normalised-space ones):
//
//   d2(r)  = sum_d a_d^2 (r_d - p_d)^2
//   dmin   = d2 on a reset step, else min(dmin, d2)      (updated in place)
//   next   = raw feature column at the first flat index of max(dmin)
//
// maximin_pass_kernel: one thread per pixel, 256 pixels per block, probe and
// weights in shared memory; each block writes its (max, first index).
// maximin_select_kernel: one block per image picks the global winner from
// the block partials (larger value, then smaller index: the first index on
// ties, whatever the reduction order) and reads the winning raw column
// directly, with no one-hot contraction.
//
// Bound on the H100: HBM bandwidth, one read of the (E + 3)-row buffer and
// one read and write of dmin per step; 3 flops per element.

#include "common.cuh"

namespace {

using gcis::ArgMax;
using gcis::better;
using gcis::block_argmax;
using gcis::ld;
using gcis::neg_inf;

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT) maximin_pass_kernel(
    const T* __restrict__ xe, const T* __restrict__ xc,
    const float* __restrict__ a2, const float* __restrict__ probe,
    float* dmin, float* __restrict__ bestv, int* __restrict__ besti, int E,
    int N, int reset) {
  extern __shared__ float smem[];
  __shared__ ArgMax scratch[32];
  const int D = E + 3;
  float* wa = smem;      // (D,) a^2
  float* pr = smem + D;  // (D,) probe
  const int tid = threadIdx.x, blk = blockIdx.x, b = blockIdx.y;
  const long n = N;
  for (int e = tid; e < D; e += NT) {
    wa[e] = a2[(long)b * D + e];
    pr[e] = probe[(long)b * D + e];
  }
  __syncthreads();
  const long p = (long)blk * NT + tid;
  ArgMax m{neg_inf(), INT_MAX};
  if (p < n) {
    const T* xb = xe + (long)b * E * n;
    const T* cb = xc + (long)b * 4 * n;
    float d2 = 0.f;
    for (int ch = 0; ch < D; ++ch) {
      const float v = ch < E ? ld(xb, ch * n + p) : ld(cb, (ch - E) * n + p);
      const float t = v - pr[ch];
      d2 += wa[ch] * t * t;
    }
    float* dp = dmin + (long)b * n + p;
    const float dm = reset ? d2 : fminf(*dp, d2);
    *dp = dm;
    m = ArgMax{dm, (int)p};
  }
  m = block_argmax(m, scratch);
  if (tid == 0) {
    bestv[(long)b * gridDim.x + blk] = m.v;
    besti[(long)b * gridDim.x + blk] = m.i;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) maximin_select_kernel(
    const T* __restrict__ xe, const T* __restrict__ xc,
    const float* __restrict__ bestv, const int* __restrict__ besti,
    float* __restrict__ best, int E, int N, int nblk) {
  __shared__ ArgMax scratch[32];
  const int D = E + 3, tid = threadIdx.x, b = blockIdx.x;
  const long n = N;
  ArgMax m{neg_inf(), INT_MAX};
  for (int i = tid; i < nblk; i += NT)
    m = better(m, ArgMax{bestv[(long)b * nblk + i], besti[(long)b * nblk + i]});
  m = block_argmax(m, scratch);
  const long idx = m.i == INT_MAX ? 0 : m.i;  // all-NaN distances: pixel 0
  for (int ch = tid; ch < D; ch += NT) {
    best[(long)b * D + ch] = ch < E ? ld(xe, ((long)b * E + ch) * n + idx)
                                    : ld(xc, ((long)b * 4 + ch - E) * n + idx);
  }
}

template <typename T>
int launch(const void* xe, const void* xc, const float* a2, const float* probe,
           float* dmin, float* bestv, int* besti, float* best, int B, int E,
           int N, int reset, cudaStream_t s) {
  const int nblk = (N + NT - 1) / NT;
  const size_t smem = 2 * (size_t)(E + 3) * sizeof(float);
  maximin_pass_kernel<T><<<dim3(nblk, B), NT, smem, s>>>(
      (const T*)xe, (const T*)xc, a2, probe, dmin, bestv, besti, E, N, reset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maximin_select_kernel<T><<<B, NT, 0, s>>>((const T*)xe, (const T*)xc, bestv,
                                             besti, best, E, N, nblk);
  return (int)cudaGetLastError();
}

}  // namespace

// xe: (B, E, N) and xc: (B, 4, N), float32 or bfloat16 (bf16 != 0).
// a2, probe: (B, E + 3) float32. dmin: (B, N) float32, read unless reset,
// always written. bestv/besti: (B, ceil(N / 256)) scratch. best: (B, E + 3)
// float32, the raw column at the argmax of the new dmin.
GCIS_API int gcis_maximin_chw(const void* xe, const void* xc, const float* a2,
                              const float* probe, float* dmin, float* bestv,
                              int* besti, float* best, int B, int E, int N,
                              int bf16, int reset, void* stream) {
  if (2 * (size_t)(E + 3) * sizeof(float) > 40 * 1024 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(xe, xc, a2, probe, dmin, bestv, besti,
                                      best, B, E, N, reset, s)
              : launch<float>(xe, xc, a2, probe, dmin, bestv, besti, best, B,
                              E, N, reset, s);
}
