// K5: one Lloyd pass on the normalised (B, D, N) solver buffer.
//
// Replaces models/kmeans_pallas.py::_lloyd_t_kernel (wrapper _lloyd_t_pass),
// the pass behind the GMM's k-means init (kmeans_fused_t_xt -> _solve_t).
// Pixel x scores ||c||^2 - 2 round(c) . x for each of k <= 8 centres: the
// norm from the float32 centres, the cross term with the centres rounded
// to the storage type (as the TPU kernel's operands were). The first
// minimum wins; the pass writes int32 labels and, unless assign_only, the
// member sums and counts.
//
// Layout: D feature rows of N pixels, float32 or bfloat16. One block holds
// 256 consecutive pixels, one per thread, so every row load is coalesced.
// The rounded centres and their norms live in shared memory. The TPU
// kernel's ones-row (counts), padding of k to 8 sublanes and one-hot
// matmuls are gone.
//
// Sums without float atomics, as in K2: each block writes (k, D + 1)
// partials of its own pixels (one warp per feature row, lanes striding over
// the block's pixels, a fixed butterfly across lanes; row D counts), and a
// second launch adds them in block order.
//
// Bound on the H100: at the GMM fit grid (8 x 39 x 9600, 6 MB in bf16) a
// pass moves a few MB and does ~2 k D flops per pixel, microseconds of
// either; it is bound by the latency of its two launches. At full
// resolution it would be bound by HBM (one read of the buffer, a second
// mostly from L2 for the sums).

#include "common.cuh"

namespace {

using gcis::ld;
using gcis::round_to;
using gcis::warp_sum;

constexpr int NT = 256;
constexpr int KMAX = 8;

template <typename T>
__global__ void __launch_bounds__(NT) lloyd_t_kernel(
    const T* __restrict__ x, const float* __restrict__ centers,
    int* __restrict__ labels, float* __restrict__ partial, int D, int N, int k,
    int assign_only) {
  extern __shared__ float smem[];
  float* c = smem;                  // (k, D) centres rounded to T
  float* csq = smem + k * D;        // (KMAX,) norms of the float32 centres
  int* lab = (int*)(csq + KMAX);    // (NT,) labels of this block's pixels
  const int tid = threadIdx.x, blk = blockIdx.x, b = blockIdx.y;
  const int nblk = gridDim.x;
  const long n = N;
  const T* xb = x + (long)b * D * n;
  const float* cb = centers + (long)b * k * D;

  for (int e = tid; e < k * D; e += NT) c[e] = round_to<T>(cb[e]);
  if (tid < k) {
    float s = 0.f;
    for (int ch = 0; ch < D; ++ch) s += cb[tid * D + ch] * cb[tid * D + ch];
    csq[tid] = s;
  }
  __syncthreads();

  const long p = (long)blk * NT + tid;
  int best = -1;
  if (p < n) {
    float acc[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) acc[q] = 0.f;
    for (int ch = 0; ch < D; ++ch) {
      const float v = ld(xb, ch * n + p);
#pragma unroll
      for (int q = 0; q < KMAX; ++q)
        if (q < k) acc[q] += c[q * D + ch] * v;
    }
    float bs = csq[0] - 2.f * acc[0];
    best = 0;
#pragma unroll
    for (int q = 1; q < KMAX; ++q) {
      if (q < k) {
        const float sc = csq[q] - 2.f * acc[q];
        if (sc < bs) {
          bs = sc;
          best = q;
        }
      }
    }
    labels[(long)b * n + p] = best;
  }
  if (assign_only) return;
  lab[tid] = best;
  __syncthreads();

  // partial sums: warp per feature row, row D counts the members
  const int lane = tid & 31, warp = tid >> 5;
  const long base = (long)blk * NT;
  for (int ch = warp; ch <= D; ch += NT / 32) {
    const T* row = xb + ch * n;
    float acc[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) acc[q] = 0.f;
    for (int t = lane; t < NT; t += 32) {
      const int l = lab[t];
      if (l < 0) continue;
      const float v = ch == D ? 1.f : ld(row, base + t);
#pragma unroll
      for (int q = 0; q < KMAX; ++q) acc[q] += (l == q) ? v : 0.f;
    }
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      if (q < k) {
        const float s = warp_sum(acc[q]);
        if (lane == 0) partial[(((long)b * nblk + blk) * k + q) * (D + 1) + ch] = s;
      }
    }
  }
}

}  // namespace

// x: (B, D, N) float32 or bfloat16 (bf16 != 0). centers: (B, k, D) float32.
// labels: (B, N) int32. partial: (B, ceil(N / 256), k, D + 1) float32
// scratch; sums: (B, k, D + 1) float32, column D = member counts. partial
// and sums are untouched when assign_only != 0.
GCIS_API int gcis_lloyd_t(const void* x, const float* centers, int* labels,
                          float* partial, float* sums, int B, int D, int N, int k,
                          int bf16, int assign_only, void* stream) {
  const size_t smem = ((size_t)k * D + KMAX) * sizeof(float) + NT * sizeof(int);
  if (k < 1 || k > KMAX || D < 1 || smem > 48 * 1024 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (N + NT - 1) / NT;
  const dim3 grid(nblk, B);
  if (bf16) {
    lloyd_t_kernel<__nv_bfloat16><<<grid, NT, smem, s>>>(
        (const __nv_bfloat16*)x, centers, labels, partial, D, N, k, assign_only);
  } else {
    lloyd_t_kernel<float><<<grid, NT, smem, s>>>((const float*)x, centers, labels,
                                                 partial, D, N, k, assign_only);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || assign_only) return (int)err;
  return (int)gcis::block_order_sum(partial, sums, B, nblk, k * (D + 1), s);
}
