// K9: batched Cholesky factor and its inverse, one thread block per matrix.
//
// Replaces models/chol_pallas.py::_kernel (wrapper precision_chol_pallas):
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
// Bound on the H100: latency. A matrix takes 2 d dependent steps, each a
// __syncthreads away from the next, and the GMM factors M = B k = 40
// matrices of d = 39 per EM iteration: ~12 MFLOP, nothing for 132 SMs, so
// the time is the launch and the 2 d step latencies. The design keeps each
// step in shared memory and runs all M matrices in one launch.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int DMAX = 64;

__global__ void __launch_bounds__(NT) precision_chol_kernel(
    const float* __restrict__ covs, float* __restrict__ pt, float* __restrict__ diag,
    int d) {
  __shared__ float S[DMAX * DMAX];  // the trailing matrix, becoming L (lower)
  __shared__ float X[DMAX * DMAX];  // L^-1 (lower)
  const int tid = threadIdx.x;
  const long m = blockIdx.x;
  const float* A = covs + m * d * d;
  for (int e = tid; e < d * d; e += NT) {
    S[e] = A[e];
    X[e] = 0.f;
  }
  __syncthreads();

  // right-looking Cholesky on the lower triangle
  for (int j = 0; j < d; ++j) {
    const float dsq = S[j * d + j];
    const float dj = sqrtf(dsq);
    const float inv = 1.f / dj;
    __syncthreads();  // every thread has read the pivot before column j changes
    for (int i = j + tid; i < d; i += NT) S[i * d + j] *= inv;
    if (tid == 0) diag[m * d + j] = dj;
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
  float* out = pt + m * d * d;
  for (int e = tid; e < d * d; e += NT) out[e] = X[e];
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
