// K6: one farthest-point (maximin) step on the normalised (B, D, N) solver
// buffer.
//
// Replaces models/kmeans_pallas.py::_maximin_kernel (wrapper _maximin_pass),
// the seeding of the GMM's k-means init (_maximin_init_t_fused). For probe p
// (float32), in the TPU kernel's expanded form:
//
//   d2(x)  = ||x||^2 - 2 round(p) . x + ||p||^2   (round: to the storage type)
//   dmin   = d2 on a reset step, else min(dmin, d2)      (updated in place)
//   next   = column of x at the first flat index of max(dmin)
//
// The TPU buffer's ones-row added 1 - 2 + 1 = 0 to d2 and is left out.
// maximin_t_pass_kernel: one thread per pixel, 256 pixels per block, the
// rounded probe in shared memory; each block writes its (max, first index).
// maximin_t_select_kernel: one block per image picks the global winner from
// the block partials (larger value, then smaller index: the first index on
// ties, whatever the reduction order) and reads the winning column
// directly, where the TPU kernel contracted a one-hot row per block.
//
// Bound on the H100: at the GMM fit grid (8 x 39 x 9600) a step reads 6 MB
// (bf16) and does ~4 D flops per pixel, microseconds of either: it is bound
// by the latency of its two launches. At full resolution it would be bound
// by HBM (one read of the buffer, one read and write of dmin).

#include "common.cuh"

namespace {

using gcis::ArgMax;
using gcis::better;
using gcis::block_argmax;
using gcis::ld;
using gcis::neg_inf;
using gcis::round_to;

constexpr int NT = 256;

template <typename T>
__global__ void __launch_bounds__(NT) maximin_t_pass_kernel(
    const T* __restrict__ x, const float* __restrict__ probe, float* dmin,
    float* __restrict__ bestv, int* __restrict__ besti, int D, int N, int reset) {
  extern __shared__ float pr[];  // (D,) probe rounded to T
  __shared__ ArgMax scratch[32];
  __shared__ float psq_s;
  const int tid = threadIdx.x, blk = blockIdx.x, b = blockIdx.y;
  const long n = N;
  const float* pb = probe + (long)b * D;
  for (int e = tid; e < D; e += NT) pr[e] = round_to<T>(pb[e]);
  if (tid == 0) {
    float s = 0.f;
    for (int e = 0; e < D; ++e) s += pb[e] * pb[e];
    psq_s = s;
  }
  __syncthreads();
  const long p = (long)blk * NT + tid;
  ArgMax m{neg_inf(), INT_MAX};
  if (p < n) {
    const T* xb = x + (long)b * D * n;
    float xsq = 0.f, cross = 0.f;
    for (int ch = 0; ch < D; ++ch) {
      const float v = ld(xb, ch * n + p);
      xsq += v * v;
      cross += pr[ch] * v;
    }
    const float d2 = xsq - 2.f * cross + psq_s;
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
__global__ void __launch_bounds__(NT) maximin_t_select_kernel(
    const T* __restrict__ x, const float* __restrict__ bestv,
    const int* __restrict__ besti, float* __restrict__ best, int D, int N,
    int nblk) {
  __shared__ ArgMax scratch[32];
  const int tid = threadIdx.x, b = blockIdx.x;
  const long n = N;
  ArgMax m{neg_inf(), INT_MAX};
  for (int i = tid; i < nblk; i += NT)
    m = better(m, ArgMax{bestv[(long)b * nblk + i], besti[(long)b * nblk + i]});
  m = block_argmax(m, scratch);
  const long idx = m.i == INT_MAX ? 0 : m.i;  // all-NaN distances: pixel 0
  for (int ch = tid; ch < D; ch += NT)
    best[(long)b * D + ch] = ld(x, ((long)b * D + ch) * n + idx);
}

template <typename T>
int launch(const void* x, const float* probe, float* dmin, float* bestv, int* besti,
           float* best, int B, int D, int N, int reset, cudaStream_t s) {
  const int nblk = (N + NT - 1) / NT;
  maximin_t_pass_kernel<T><<<dim3(nblk, B), NT, D * sizeof(float), s>>>(
      (const T*)x, probe, dmin, bestv, besti, D, N, reset);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  maximin_t_select_kernel<T><<<B, NT, 0, s>>>((const T*)x, bestv, besti, best, D, N,
                                              nblk);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, D, N) float32 or bfloat16 (bf16 != 0). probe: (B, D) float32.
// dmin: (B, N) float32, read unless reset, always written. bestv/besti:
// (B, ceil(N / 256)) scratch. best: (B, D) float32, the column at the argmax
// of the new dmin.
GCIS_API int gcis_maximin_t(const void* x, const float* probe, float* dmin,
                            float* bestv, int* besti, float* best, int B, int D,
                            int N, int bf16, int reset, void* stream) {
  if (D < 1 || (size_t)D * sizeof(float) > 40 * 1024 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, probe, dmin, bestv, besti, best, B, D, N,
                                      reset, s)
              : launch<float>(x, probe, dmin, bestv, besti, best, B, D, N, reset, s);
}
