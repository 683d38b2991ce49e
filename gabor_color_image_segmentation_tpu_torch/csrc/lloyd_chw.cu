// K2: one Lloyd pass on the raw channel-major feature rows.
//
// Replaces models/kmeans_chw.py::_lloyd_chw_kernel (wrapper _lloyd_chw_pass).
// The per-image standardisation affine x = a*r + b is folded into the
// centres by the caller: pixel r scores offs_c - 2 * wc_c . r with
// wc_c = a*(c - b) and offs_c = ||c - b||^2, the first minimum over k <= 8
// centres wins, and the pass writes int32 labels plus raw-space member sums
// and counts. assign_only skips the sums.
//
// Layout: features are E energy planes (B, E, N) and the colour rows
// (B, 4, N) of color4 (rows 0..2 are L, a, b; row 3 is not read: counts are
// counted). One block holds 256 consecutive pixels, one per thread, so every
// load of a feature plane is coalesced along W. The k centre rows live in
// shared memory.
//
// Sums without float atomics: each block writes (k, D + 1) partial sums of
// its own pixels (one warp per feature row, lanes striding over the block's
// pixels, a fixed butterfly across lanes), and a second launch adds the
// blocks' partials in block order (gcis::block_order_sum). The result is
// the same on every run.
//
// Bound on the H100: HBM bandwidth. A pass reads the (E + 3)-row feature
// buffer once to assign and once more, mostly from L2, for the sums; the
// scoring is k FMAs per element. The TPU kernel's block-diagonal expanded
// weights, padding of k to 8 sublanes, ones-row counts and one-hot matmuls
// are gone.

#include "common.cuh"

namespace {

using gcis::ld;
using gcis::warp_sum;

constexpr int NT = 256;
constexpr int KMAX = 8;

template <typename T>
__global__ void __launch_bounds__(NT) lloyd_assign_kernel(
    const T* __restrict__ xe, const T* __restrict__ xc,
    const float* __restrict__ wc, const float* __restrict__ offs,
    int* __restrict__ labels, float* __restrict__ partial, int E, int N, int k,
    int assign_only) {
  extern __shared__ float smem[];
  const int D = E + 3;
  float* w = smem;                  // (k, D) folded centre rows
  int* lab = (int*)(smem + k * D);  // (NT,) labels of this block's pixels
  const int tid = threadIdx.x, blk = blockIdx.x, b = blockIdx.y;
  const int nblk = gridDim.x;
  const long n = N;
  const T* xb = xe + (long)b * E * n;
  const T* cb = xc + (long)b * 4 * n;

  for (int e = tid; e < k * D; e += NT) w[e] = wc[(long)b * k * D + e];
  __syncthreads();

  const long p = (long)blk * NT + tid;
  int best = -1;
  if (p < n) {
    float acc[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) acc[q] = 0.f;
    for (int ch = 0; ch < D; ++ch) {
      const float v = ch < E ? ld(xb, ch * n + p) : ld(cb, (ch - E) * n + p);
#pragma unroll
      for (int q = 0; q < KMAX; ++q)
        if (q < k) acc[q] += w[q * D + ch] * v;
    }
    float bs = offs[b * k] - 2.f * acc[0];
    best = 0;
#pragma unroll
    for (int q = 1; q < KMAX; ++q) {
      if (q < k) {
        const float sc = offs[b * k + q] - 2.f * acc[q];
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
    const T* row = ch < E ? xb + ch * n : cb + (ch - E) * n;
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
        if (lane == 0)
          partial[(((long)b * nblk + blk) * k + q) * (D + 1) + ch] = s;
      }
    }
  }
}

}  // namespace

// xe: (B, E, N) and xc: (B, 4, N), float32 or bfloat16 (bf16 != 0).
// wc: (B, k, E + 3) and offs: (B, k) float32. labels: (B, N) int32.
// partial: (B, ceil(N / 256), k, E + 4) float32 scratch; sums: (B, k, E + 4)
// float32, column E + 3 = member counts. partial and sums are untouched
// when assign_only != 0.
GCIS_API int gcis_lloyd_chw(const void* xe, const void* xc, const float* wc,
                            const float* offs, int* labels, float* partial,
                            float* sums, int B, int E, int N, int k, int bf16,
                            int assign_only, void* stream) {
  const int D = E + 3;
  const size_t smem = (size_t)k * D * sizeof(float) + NT * sizeof(int);
  if (k < 1 || k > KMAX || smem > 48 * 1024 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (N + NT - 1) / NT;
  const dim3 grid(nblk, B);
  if (bf16) {
    lloyd_assign_kernel<__nv_bfloat16><<<grid, NT, smem, s>>>(
        (const __nv_bfloat16*)xe, (const __nv_bfloat16*)xc, wc, offs, labels,
        partial, E, N, k, assign_only);
  } else {
    lloyd_assign_kernel<float><<<grid, NT, smem, s>>>(
        (const float*)xe, (const float*)xc, wc, offs, labels, partial, E, N,
        k, assign_only);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || assign_only) return (int)err;
  return (int)gcis::block_order_sum(partial, sums, B, nblk, k * (D + 1), s);
}
