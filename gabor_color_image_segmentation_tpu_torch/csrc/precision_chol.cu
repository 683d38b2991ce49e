// K9: batched Cholesky factor and its inverse, one thread block per matrix;
// K10: the same factorisation behind the GMM's moments -> parameters step.
//
// K9 replaces models/chol_pallas.py::_kernel (wrapper precision_chol_pallas):
// for each SPD float32 matrix C (d x d, d <= 64)
//
//   L    = cholesky(C)            (lower; only the lower triangle of C is read)
//   P^T  = L^-1                   (lower; sklearn's precision Cholesky, transposed)
//   diag = diag(L)                (log det P = -sum log diag)
//
// in the TPU kernel's order of operations: a right-looking factorisation
// whose step j takes 1/sqrt of the pivot and scales column j by it (the
// diagonal entry of L is pivot * (1/sqrt(pivot)); `diag` is the sqrt
// itself), then forward substitution row by row, X_i = (e_i - sum_{l<i}
// L_il X_l) / L_ii. The TPU kernel vectorised all M matrices over its
// (M, R, 128) tiles with one-hot row and column extractions; here the matrix
// sits in shared memory (39 x 39 float32 is 6 KB, with X 12 KB) and the
// block's threads share each step's row, column or trailing update.
//
// K10 replaces models/chol_pallas.py::_params_kernel (wrapper
// precision_chol_params_pallas), which the reference runs only behind
// gmm_pallas.py's _FUSED_PREP switch: from one EM pass's moments of a
// component (count n, sums s, scatter Q = sum r x x^T) it forms sklearn's
// parameters and K8's inputs in one launch,
//
//   nk = n + 10 eps,  mu = s / nk,  C = Q / nk - mu mu^T + reg I,
//   P^T = L^-1 (K9's factorisation),  bias = P^T mu,
//   const = log(nk / m) - sum log diag L - d/2 log 2 pi.
//
// The TPU kernel read the moments from a ones-extended (dp x dp) scatter;
// here they come as EM's (count, sums, scatter) outputs. C is formed with
// explicitly rounded operations in the plain version's order, so it is
// bit-equal to the plain version's C; bias and const differ from it by the
// order of their sums.
//
// Bound on the H100: latency. A matrix takes 2 d dependent steps, each a
// __syncthreads away from the next, and the GMM factors M = B k = 40
// matrices of d = 39 per EM iteration: ~12 MFLOP, nothing for 132 SMs, so
// the time is the launch and the 2 d step latencies. The design keeps each
// step in shared memory and runs all M matrices in one launch.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int DMAX = 64;
constexpr double LOG2PI = 1.8378770664093453;

// S (d x d, its lower triangle SPD) in shared memory becomes L (lower); X
// (zeroed by the caller) becomes L^-1 (lower); dl[j] = L_jj. Every thread
// of the block calls it.
__device__ void factorize(float* S, float* X, float* dl, int d) {
  const int tid = threadIdx.x;
  // right-looking Cholesky on the lower triangle
  for (int j = 0; j < d; ++j) {
    const float dsq = S[j * d + j];
    const float dj = sqrtf(dsq);
    const float inv = 1.f / dj;
    __syncthreads();  // every thread has read the pivot before column j changes
    for (int i = j + tid; i < d; i += NT) S[i * d + j] *= inv;
    if (tid == 0) dl[j] = dj;
    __syncthreads();
    const int r = d - 1 - j;  // trailing order
    for (int e = tid; e < r * r; e += NT) {
      const int i = j + 1 + e / r, l = j + 1 + e % r;
      if (l <= i) S[i * d + l] -= S[i * d + j] * S[l * d + j];
    }
    __syncthreads();
  }

  // forward substitution, one row of X per step; X[l][c] = 0 for l < c
  for (int i = 0; i < d; ++i) {
    const float dinv = 1.f / S[i * d + i];
    for (int c = tid; c <= i; c += NT) {
      float acc = 0.f;
      for (int l = c; l < i; ++l) acc += S[i * d + l] * X[l * d + c];
      X[i * d + c] = ((c == i ? 1.f : 0.f) - acc) * dinv;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(NT) precision_chol_kernel(
    const float* __restrict__ covs, float* __restrict__ pt, float* __restrict__ diag,
    int d) {
  __shared__ float S[DMAX * DMAX];  // the trailing matrix, becoming L (lower)
  __shared__ float X[DMAX * DMAX];  // L^-1 (lower)
  __shared__ float dl[DMAX];
  const int tid = threadIdx.x;
  const long m = blockIdx.x;
  const float* A = covs + m * d * d;
  for (int e = tid; e < d * d; e += NT) {
    S[e] = A[e];
    X[e] = 0.f;
  }
  __syncthreads();
  factorize(S, X, dl, d);
  float* out = pt + m * d * d;
  for (int e = tid; e < d * d; e += NT) out[e] = X[e];
  for (int j = tid; j < d; j += NT) diag[m * d + j] = dl[j];
}

__global__ void __launch_bounds__(NT) params_kernel(
    const float* __restrict__ counts, const float* __restrict__ sums,
    const float* __restrict__ scatter, float* __restrict__ pt, float* __restrict__ bias,
    float* __restrict__ cnst, int d, float m_rows, float reg) {
  __shared__ float S[DMAX * DMAX];
  __shared__ float X[DMAX * DMAX];
  __shared__ float dl[DMAX];
  __shared__ float mu[DMAX];
  const int tid = threadIdx.x;
  const long m = blockIdx.x;
  const float nk = __fadd_rn(counts[m], 10.f * FLT_EPSILON);
  for (int i = tid; i < d; i += NT) mu[i] = __fdiv_rn(sums[m * d + i], nk);
  __syncthreads();
  const float* Q = scatter + m * d * d;
  for (int e = tid; e < d * d; e += NT) {
    const int i = e / d, j = e % d;
    const float c = __fsub_rn(__fdiv_rn(Q[e], nk), __fmul_rn(mu[i], mu[j]));
    S[e] = i == j ? __fadd_rn(c, reg) : c;
    X[e] = 0.f;
  }
  __syncthreads();
  factorize(S, X, dl, d);

  float* out = pt + m * d * d;
  for (int e = tid; e < d * d; e += NT) out[e] = X[e];
  for (int i = tid; i < d; i += NT) {
    float acc = 0.f;
    for (int j = 0; j <= i; ++j) acc += X[i * d + j] * mu[j];
    bias[m * d + i] = acc;
  }
  if (tid == 0) {
    float logdet = 0.f;
    for (int j = 0; j < d; ++j) logdet += logf(dl[j]);
    cnst[m] = (logf(__fdiv_rn(nk, m_rows)) - logdet) - (float)(0.5 * d * LOG2PI);
  }
}

}  // namespace

// covs: (M, d, d) float32, row-major. pt: (M, d, d) float32 out, L^-1 with a
// zero upper triangle. diag: (M, d) float32 out.
GCIS_API int gcis_precision_chol(const float* covs, float* pt, float* diag, int M,
                                 int d, void* stream) {
  if (d < 1 || d > DMAX || M < 1) return (int)cudaErrorInvalidValue;
  precision_chol_kernel<<<M, NT, 0, (cudaStream_t)stream>>>(covs, pt, diag, d);
  return (int)cudaGetLastError();
}

// counts: (M,), sums: (M, d), scatter: (M, d, d) float32, one EM pass's
// moments per component. pt: (M, d, d), bias: (M, d), cnst: (M,) float32
// out. m_rows: the pixels the moments were taken over (the weights are
// nk / m_rows); reg: reg_covar.
GCIS_API int gcis_precision_chol_params(const float* counts, const float* sums,
                                        const float* scatter, float* pt, float* bias,
                                        float* cnst, int M, int d, float m_rows,
                                        float reg, void* stream) {
  if (d < 1 || d > DMAX || M < 1 || !(m_rows > 0.f)) return (int)cudaErrorInvalidValue;
  params_kernel<<<M, NT, 0, (cudaStream_t)stream>>>(counts, sums, scatter, pt, bias, cnst,
                                                    d, m_rows, reg);
  return (int)cudaGetLastError();
}
