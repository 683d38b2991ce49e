// K8: one E+M step of the per-image full-covariance GMM on the normalised
// (B, D, N) solver buffer.
//
// Replaces models/gmm_pallas.py::_em_kernel (wrapper _em_pass, both call
// sites: with moments and labels only). For each pixel x and component j:
//
//   y_j     = P_j^T x - b_j           (P_j^T lower triangular, D x D)
//   lp_j    = const_j - ||y_j||^2 / 2
//   label   = first j of max lp_j
// and, with moments:
//   r_j     = exp(lp_j - max lp) / sum_j exp(lp_j - max lp)
//   ll     += max lp + log sum_j exp(lp_j - max lp)
//   M_j    += r_j [x 1] [x 1]^T       (lower triangle: scatter, sums, count)
//
// All arithmetic is float32, bf16 storage included. The TPU kernel split
// every float32 operand into bf16 halves (bf16x3) because its matrix unit
// had no float32-accurate dot; the CUDA cores need no such trick.
//
// em_kernel, one block of 256 pixels, one thread per pixel:
//   scores   the k lower triangles of P^T, the biases and constants sit in
//            shared memory (5 x 780 floats at D = 39) and are read as
//            broadcasts; the pixel's column of x sits in registers (the
//            loops over the triangle are unrolled to DMAX = 40 rows: the
//            GMM's D is 39), so the triangle halves the FMAs of a full
//            P^T x. Each lp_j goes to a shared tile, the argmax to the
//            labels.
//   moments  the thread turns its lp column into responsibilities; the
//            block stages its x tile (with a ones row) and the
//            responsibility tile in shared memory, padded so that rows fall
//            in different banks. Each thread then owns a strided set of the
//            k (D + 1)(D + 2) / 2 distinct entries of the k extended
//            scatters (the symmetry halves them; the ones row makes sums and
//            counts entries of the same triangle) and sums its entries over
//            the block's 256 pixels in pixel order.
//   Each block writes its packed entries and its log-likelihood sum to a
//   partial row; block_order_sum adds the rows in block order. No float
//   atomics: labels depend on these sums over 30 EM iterations, and the
//   basin EM lands in can turn on their last bits.
//
// Bound on the H100: float32 operations. Per pixel the scores take
// k D (D + 1) / 2 FMAs and the moments k (D + 1)(D + 2) / 2, about 16 kFLOP
// at k = 5, D = 39 (half that labels only), against 78 (bf16) or 156 (f32)
// bytes of x: ~100-200 FLOP per byte, far above the card's ~20 for float32.
// The moments phase reads three shared-memory words per FMA, so it runs at
// a fraction of the FMA rate; register tiling of the scatter and tensor
// cores (tf32x3) are later work.

#include "common.cuh"

namespace {

using gcis::ld;
using gcis::neg_inf;
using gcis::warp_sum;

constexpr int NT = 256;
constexpr int KMAX = 8;
constexpr int DMAX = 40;  // feature rows held in registers
constexpr int PAD = NT + 1;  // row stride of the shared x and resp tiles

template <typename T>
__global__ void __launch_bounds__(NT) em_kernel(
    const T* __restrict__ x, const float* __restrict__ pt,
    const float* __restrict__ bias, const float* __restrict__ cnst,
    int* __restrict__ labels, float* __restrict__ partial, int D, int N, int k,
    int moments) {
  extern __shared__ float smem[];
  const int tri = D * (D + 1) / 2;
  float* P = smem;                  // (k, tri) lower triangles, row i at i(i+1)/2
  float* bs = P + k * tri;          // (k, D) biases
  float* cs = bs + k * D;           // (KMAX,) constants
  float* rs = cs + KMAX;            // (k, PAD) lp, then responsibilities
  float* xs = rs + k * PAD;         // (D + 1, PAD) x tile, ones row at D (moments)
  __shared__ float warp_ll[NT / 32];
  const int tid = threadIdx.x, blk = blockIdx.x, b = blockIdx.y;
  const long n = N;

  const float* ptb = pt + (long)b * k * D * D;
  for (int e = tid; e < k * D * D; e += NT) {
    const int j = e / (D * D), r = e - j * D * D, i = r / D, l = r - i * D;
    if (l <= i) P[j * tri + i * (i + 1) / 2 + l] = ptb[e];
  }
  for (int e = tid; e < k * D; e += NT) bs[e] = bias[(long)b * k * D + e];
  if (tid < k) cs[tid] = cnst[(long)b * k + tid];
  __syncthreads();

  const long p = (long)blk * NT + tid;
  const bool valid = p < n;
  const T* xb = x + (long)b * D * n;
  float xv[DMAX];
#pragma unroll
  for (int i = 0; i < DMAX; ++i) xv[i] = (i < D && valid) ? ld(xb, i * n + p) : 0.f;

  int best = 0;
  float bestv = neg_inf();
  for (int j = 0; j < k; ++j) {
    const float* Pj = P + j * tri;
    const float* bj = bs + j * D;
    float maha = 0.f;
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      if (i < D) {
        float y = 0.f;
#pragma unroll
        for (int l = 0; l <= i; ++l) y += Pj[i * (i + 1) / 2 + l] * xv[l];
        y -= bj[i];
        maha += y * y;
      }
    }
    const float lp = cs[j] - 0.5f * maha;
    rs[j * PAD + tid] = lp;
    if (j == 0 || lp > bestv) {
      bestv = lp;
      best = j;
    }
  }
  if (valid) labels[(long)b * n + p] = best;
  if (!moments) return;

  // responsibilities and the log-sum-exp, in place in the lp tile
  float lse = 0.f;
  if (valid) {
    float se = 0.f;
    for (int j = 0; j < k; ++j) {
      const float ex = expf(rs[j * PAD + tid] - bestv);
      rs[j * PAD + tid] = ex;
      se += ex;
    }
    for (int j = 0; j < k; ++j) rs[j * PAD + tid] /= se;
    lse = bestv + logf(se);
  } else {
    for (int j = 0; j < k; ++j) rs[j * PAD + tid] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < DMAX; ++i)
    if (i < D) xs[i * PAD + tid] = xv[i];
  xs[D * PAD + tid] = 1.f;
  const float wl = warp_sum(lse);
  if ((tid & 31) == 0) warp_ll[tid >> 5] = wl;
  __syncthreads();

  const int T1 = (D + 1) * (D + 2) / 2;  // extended triangle per component
  const int width = k * T1 + 1;
  float* out = partial + ((long)b * gridDim.x + blk) * width;
  for (int o = tid; o < k * T1; o += NT) {
    const int j = o / T1, t = o - j * T1;
    int a = (int)((sqrtf(8.f * t + 1.f) - 1.f) * 0.5f);
    while (a * (a + 1) / 2 > t) --a;
    while ((a + 1) * (a + 2) / 2 <= t) ++a;
    const int c = t - a * (a + 1) / 2;
    const float* ra = rs + j * PAD;
    const float* xa = xs + a * PAD;
    const float* xc = xs + c * PAD;
    float acc = 0.f;
    for (int q = 0; q < NT; ++q) acc += (ra[q] * xa[q]) * xc[q];
    out[o] = acc;
  }
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < NT / 32; ++w) s += warp_ll[w];
    out[k * T1] = s;
  }
}

template <typename T>
int launch(const void* x, const float* pt, const float* bias, const float* cnst,
           int* labels, float* partial, float* out, int B, int D, int N, int k,
           int moments, cudaStream_t s) {
  const int nblk = (N + NT - 1) / NT;
  const size_t words = (size_t)k * D * (D + 1) / 2 + (size_t)k * D + KMAX +
                       (size_t)k * PAD + (moments ? (size_t)(D + 1) * PAD : 0);
  const size_t smem = words * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      em_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  em_kernel<T><<<dim3(nblk, B), NT, smem, s>>>(
      (const T*)x, pt, bias, cnst, labels, partial, D, N, k, moments);
  err = cudaGetLastError();
  if (err != cudaSuccess || !moments) return (int)err;
  const int width = k * (D + 1) * (D + 2) / 2 + 1;
  return (int)gcis::block_order_sum(partial, out, B, nblk, width, s);
}

}  // namespace

// x: (B, D, N) float32 or bfloat16 (bf16 != 0). pt: (B, k, D, D) float32 P^T
// (lower triangle read). bias: (B, k, D), cnst: (B, k) float32. labels:
// (B, N) int32. With moments != 0: partial (B, ceil(N / 256), W) scratch and
// out (B, W) float32, W = k (D + 1)(D + 2) / 2 + 1: per component the lower
// triangle of sum r [x 1][x 1]^T, entry (a, c) at a (a + 1) / 2 + c, then the
// sum of the per-pixel log-likelihoods. partial and out are untouched when
// moments == 0.
GCIS_API int gcis_em_pass(const void* x, const float* pt, const float* bias,
                          const float* cnst, int* labels, float* partial, float* out,
                          int B, int D, int N, int k, int bf16, int moments,
                          void* stream) {
  if (k < 1 || k > KMAX || D < 1 || D > DMAX || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, pt, bias, cnst, labels, partial, out, B, D,
                                      N, k, moments, s)
              : launch<float>(x, pt, bias, cnst, labels, partial, out, B, D, N, k,
                              moments, s);
}
