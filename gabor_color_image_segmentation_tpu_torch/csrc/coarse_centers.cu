// K3: maximin seeding and a fixed number of Lloyd passes on the pooled,
// normalised coarse buffer, one launch for the whole warm start.
//
// Replaces models/kmeans_pallas.py::_coarse_all_kernel (wrapper
// _coarse_centers_fused_all). xp holds d feature rows of m pixels
// (row stride `cols`), normalised, in float32 or bfloat16. Semantics as the
// TPU kernel:
//   seeding  probe the mean (rounded to the storage type, as the TPU
//            kernel's cross term was), then k farthest-point steps: the
//            running min restarts on steps 0 and 1, the first index of the
//            maximum wins and its column is the next centre;
//   Lloyd    `iters` passes, score ||c||^2 - 2 x . round(c) with ||c||^2 in
//            float32 and the centres rounded to the storage type for the
//            cross term, first minimum wins, an empty cluster keeps its
//            centre. No early exit: at the fixed point a pass is an identity.
// Unlike the TPU (bf16 only there; f32 took the blocked passes), this kernel
// serves both dtypes.
//
// One block of 1024 threads per image; the centres, their rounded copies
// and the per-pass sums live in shared memory, the running min and the
// labels in global scratch. Sums are deterministic: one warp per feature
// row, lanes striding over the pixels, a fixed butterfly across lanes.
//
// Bound on the H100: one SM per image, so at batch 16 only 16 of the 132
// SMs are busy and each streams its 4.9 MB pooled buffer (config1 bf16)
// about 2 * iters + k times from L2 or HBM at single-SM bandwidth. Spreading
// an image over several SMs (clusters, or a grid-wide loop) is later work.

#include "common.cuh"

namespace {

using gcis::ArgMax;
using gcis::better;
using gcis::block_argmax;
using gcis::ld;
using gcis::neg_inf;
using gcis::round_to;
using gcis::warp_sum;

constexpr int NT = 1024;
constexpr int KMAX = 8;

template <typename T>
__global__ void __launch_bounds__(NT) coarse_centers_kernel(
    const T* __restrict__ xp, float* __restrict__ centers, float* dmin,
    int* labels, int rows, int cols, int d, int m, int k, int iters) {
  extern __shared__ float smem[];
  __shared__ ArgMax scratch[32];
  float* c = smem;                  // (KMAX, d) centres, float32
  float* cr = c + KMAX * d;         // (KMAX, d) centres rounded to T; row 0 = probe
  float* sums = cr + KMAX * d;      // (KMAX, d + 1) member sums, column d = counts
  float* csq = sums + KMAX * (d + 1);  // (KMAX,)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = NT / 32;
  const T* x = xp + (long)b * rows * cols;
  float* dm = dmin + (long)b * m;
  int* lb = labels + (long)b * m;

  // ---- maximin seeding: the mean first, then the farthest point ----------
  for (int ch = warp; ch < d; ch += nw) {
    float s = 0.f;
    for (int col = lane; col < m; col += 32) s += ld(x, (long)ch * cols + col);
    s = warp_sum(s);
    if (lane == 0) cr[ch] = round_to<T>(s / (float)m);
  }
  __syncthreads();
  for (int step = 0; step < k; ++step) {
    ArgMax best{neg_inf(), INT_MAX};
    for (int col = tid; col < m; col += NT) {
      float d2 = 0.f;
      for (int ch = 0; ch < d; ++ch) {
        const float t = ld(x, (long)ch * cols + col) - cr[ch];
        d2 += t * t;
      }
      const float v = step < 2 ? d2 : fminf(dm[col], d2);
      dm[col] = v;
      best = better(best, ArgMax{v, col});
    }
    best = block_argmax(best, scratch);
    const int j = best.i == INT_MAX ? 0 : best.i;
    for (int ch = tid; ch < d; ch += NT) c[step * d + ch] = ld(x, (long)ch * cols + j);
    __syncthreads();
    for (int ch = tid; ch < d; ch += NT) cr[ch] = c[step * d + ch];  // exact in T
    __syncthreads();
  }

  // ---- Lloyd passes ------------------------------------------------------
  for (int it = 0; it < iters; ++it) {
    for (int e = tid; e < k * d; e += NT) cr[e] = round_to<T>(c[e]);
    if (warp < k) {
      float s = 0.f;
      for (int ch = lane; ch < d; ch += 32) {
        const float v = c[warp * d + ch];
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) csq[warp] = s;
    }
    __syncthreads();
    for (int col = tid; col < m; col += NT) {
      float acc[KMAX];
#pragma unroll
      for (int q = 0; q < KMAX; ++q) acc[q] = 0.f;
      for (int ch = 0; ch < d; ++ch) {
        const float v = ld(x, (long)ch * cols + col);
#pragma unroll
        for (int q = 0; q < KMAX; ++q)
          if (q < k) acc[q] += cr[q * d + ch] * v;
      }
      int bq = 0;
      float bs = csq[0] - 2.f * acc[0];
#pragma unroll
      for (int q = 1; q < KMAX; ++q) {
        if (q < k) {
          const float sc = csq[q] - 2.f * acc[q];
          if (sc < bs) {
            bs = sc;
            bq = q;
          }
        }
      }
      lb[col] = bq;
    }
    __syncthreads();
    for (int ch = warp; ch <= d; ch += nw) {
      float acc[KMAX];
#pragma unroll
      for (int q = 0; q < KMAX; ++q) acc[q] = 0.f;
      for (int col = lane; col < m; col += 32) {
        const int l = lb[col];
        const float v = ch == d ? 1.f : ld(x, (long)ch * cols + col);
#pragma unroll
        for (int q = 0; q < KMAX; ++q) acc[q] += (l == q) ? v : 0.f;
      }
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        if (q < k) {
          const float s = warp_sum(acc[q]);
          if (lane == 0) sums[q * (d + 1) + ch] = s;
        }
      }
    }
    __syncthreads();
    for (int e = tid; e < k * d; e += NT) {
      const int q = e / d, ch = e % d;
      const float cnt = sums[q * (d + 1) + d];
      if (cnt > 0.f) c[e] = sums[q * (d + 1) + ch] / fmaxf(cnt, 1.f);
    }
    __syncthreads();
  }
  for (int e = tid; e < k * d; e += NT) centers[(long)b * k * d + e] = c[e];
}

template <typename T>
int launch(const void* xp, float* centers, float* dmin, int* labels, int B,
           int rows, int cols, int d, int m, int k, int iters, cudaStream_t s) {
  const size_t smem = (size_t)(3 * KMAX * d + 2 * KMAX) * sizeof(float);
  if (smem > 200 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      coarse_centers_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  coarse_centers_kernel<T><<<B, NT, smem, s>>>((const T*)xp, centers, dmin,
                                               labels, rows, cols, d, m, k,
                                               iters);
  return (int)cudaGetLastError();
}

}  // namespace

// xp: (B, rows, cols) float32 or bfloat16 (bf16 != 0), features in rows
// [0, d) and pixels in columns [0, m). centers: (B, k, d) float32 out.
// dmin: (B, m) float32 and labels: (B, m) int32 scratch.
GCIS_API int gcis_coarse_centers(const void* xp, float* centers, float* dmin,
                                 int* labels, int B, int rows, int cols, int d,
                                 int m, int k, int iters, int bf16,
                                 void* stream) {
  if (k < 1 || k > KMAX || d > rows || m > cols || m < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(xp, centers, dmin, labels, B, rows, cols,
                                      d, m, k, iters, s)
              : launch<float>(xp, centers, dmin, labels, B, rows, cols, d, m, k,
                              iters, s);
}
