// K9: batched Cholesky factor and its inverse, one warp per matrix;
// K10: the GMM's moments -> parameters step around a block factorisation.
//
// K9 replaces models/chol_pallas.py::_kernel (wrapper precision_chol_pallas):
// for each SPD float32 matrix C (d x d, d <= 128, the reference's lane
// width)
//
//   L    = cholesky(C)            (lower; only the lower triangle of C is used)
//   P^T  = L^-1                   (lower; sklearn's precision Cholesky, transposed)
//   diag = diag(L)                (log det P = -sum log diag)
//
// The TPU kernel vectorised all M matrices over its (M, R, 128) tiles with
// one-hot row and column extractions, a right-looking factorisation and
// then forward substitution row by row.
//
// Bound on the H100: latency. The GMM factors M = B k = 40 matrices of
// d = 39 per EM iteration, ~12 MFLOP: nothing for 132 SMs, so the time is
// the launch and the chain of dependent steps of one matrix. The design
// (precision_chol_kernel) cuts that chain:
//   - one warp per matrix, one 32-thread block each, so the M matrices
//     spread over M SMs; steps are separated by __syncwarp, never by a
//     block-wide barrier;
//   - L^-1 is formed in the same sweep as the factor, in the LDL^T form of
//     the reference's right-looking elimination: column j is eliminated
//     from every row i > j with L_ij = S_ij / p_j (p_j the pivot), from the
//     trailing matrix (S_il -= L_ij S_lj, j < l <= i) and from X = I
//     (X_ic -= L_ij X_jc, c <= j: a right-looking, column-oriented forward
//     substitution for the unit-lower L^-1). No step holds a serial dot or
//     a square root: at the end diag = sqrt(p) and P^T = D^(-1/2) L^-1;
//   - four columns a step (a rank-4 update): every lane factors the step's
//     4 x 4 diagonal block, then each entry of a row is loaded and stored
//     once for the four updates, and one __syncwarp ends the step. The
//     matrix is extended to a multiple of 4 by an identity block, whose
//     factor and inverse extend it the same way;
//   - lanes over columns, rows in a warp-uniform loop: lane q takes the
//     columns j + 4 + q + 32 k of S and q + 32 k of X of every row, its
//     operands (the columns' entries in the block's rows, after the
//     block's earlier columns) in registers for the step, and the rows go
//     in batches of 8, a batch one branch-free block whose loads issue
//     before its stores: the step is instantiated for its number of live
//     column slots (<= 5), and rows and columns are padded so no batch
//     checks a bound. A row's four block entries are one 16-byte broadcast
//     load. Both matrices sit in dynamic shared memory sized at launch:
//     34 KB at d = 39, 195 KB at d = 128.
// K10 replaces models/chol_pallas.py::_params_kernel (wrapper
// precision_chol_params_pallas), which the reference runs only behind
// gmm_pallas.py's _FUSED_PREP switch: from one EM pass's moments of a
// component (count n, sums s, scatter Q = sum r x x^T) it forms sklearn's
// parameters and K8's inputs in one launch,
//
//   nk = n + 10 eps,  mu = s / nk,  C = Q / nk - mu mu^T + reg I,
//   P^T = L^-1 (a block's right-looking factorisation, then forward
//   substitution row by row),  bias = P^T mu,
//   const = log(nk / m) - sum log diag L - d/2 log 2 pi,
//
// for d <= 127 (the reference's dp <= 128 with the ones row at index d).
// One 256-thread block per matrix, its shared memory sized at launch. The
// TPU kernel read the moments from a ones-extended (dp x dp) scatter; here
// they come as EM's (count, sums, scatter) outputs. C is formed with
// explicitly rounded operations in the plain version's order, so it is
// bit-equal to the plain version's C; bias and const differ from it by the
// order of their sums. Bound: latency, as K9; its factorisation keeps three
// block barriers a step (a later redesign).

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int D_CHOL = 128;   // K9: the reference's _LANES
constexpr int D_PARAMS = 127; // K10: dp <= 128 with the ones row at d
constexpr int NT = 256;       // K10's block
constexpr double LOG2PI = 1.8378770664093453;

// K9's geometry. The matrix is extended to order n, a multiple of KB, by
// an identity block (its factor and inverse extend the same way), and a
// step eliminates KB columns. A step updates rows in batches of RB and
// columns in slots of 32 (a lane each) without bound checks, so S has 32
// padding rows and X RB (rows past n, written and never read), and both
// have 32 padding columns; the row stride is 4 (mod 8) floats, so a row's
// KB entries of the step's columns are one aligned 16-byte broadcast load.
constexpr int KB = 4;  // a row's KB entries are one float4
constexpr int RB = 8;
__host__ __device__ inline int chol_order(int d) { return (d + KB - 1) / KB * KB; }
__host__ __device__ inline int chol_stride(int d) { return (chol_order(d) + 32 + 7) / 8 * 8 + 4; }
inline size_t chol_smem(int d) {
  const size_t n = chol_order(d);
  return sizeof(float) * ((2 * n + 32 + RB) * chol_stride(d) + 2 * n);
}

// A row's KB entries w of columns j .. j + KB - 1 after eliminating the
// columns before each (w_t -= w_s L_j+t,j+s for s < t), in place; lb[t][s]
// = L_j+t,j+s of the step's diagonal block.
__device__ __forceinline__ void chol_block_solve(float (&w)[KB], const float (&lb)[KB][KB]) {
#pragma unroll
  for (int t = 1; t < KB; ++t)
#pragma unroll
    for (int s = 0; s < t; ++s) w[t] = fmaf(-w[s], lb[t][s], w[t]);
}

// Steps j .. j + KB - 1 at once (a rank-KB update) with T live column
// slots: lane q's slot k is column j + KB + q + 32 k of S (k < ns) or
// column q + 32 (k - ns) of X, at off[k] from the start of a row of S (X
// lies xo floats after S), with its operands: the slot column's entries of
// rows j .. j + KB - 1 after the step's earlier columns (of S: its own
// row's, by symmetry; of X: rows j .. j + KB - 1 themselves, which the lane
// then stores: they are final). Every batch of RB rows i >= j + KB is one
// branch-free block: its loads issue together, then its stores, each entry
// loaded and stored once for the KB updates.
template <int T>
__device__ __forceinline__ void chol_step(float* S, int ld, int xo, int n, int j,
                                          const float (&r)[KB], const float (&lb)[KB][KB],
                                          int ns, int lane) {
  int off[T];
  float bw[T][KB];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const bool in_s = k < ns;
    const int c = in_s ? j + KB + lane + 32 * k : lane + 32 * (k - ns);
    off[k] = in_s ? c : xo + c;
#pragma unroll
    for (int t = 0; t < KB; ++t) bw[k][t] = in_s ? S[c * ld + j + t] : S[xo + (j + t) * ld + c];
    chol_block_solve(bw[k], lb);
    if (!in_s)
#pragma unroll
      for (int t = 1; t < KB; ++t) S[xo + (j + t) * ld + c] = bw[k][t];
  }
  for (int i0 = j + KB; i0 < n; i0 += RB) {
    float w[RB][KB], a[RB][T];
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      const float* row = S + (i0 + u) * ld;
      const float4 q = *reinterpret_cast<const float4*>(row + j);
      w[u][0] = q.x;
      w[u][1] = q.y;
      w[u][2] = q.z;
      w[u][3] = q.w;
#pragma unroll
      for (int k = 0; k < T; ++k) a[u][k] = row[off[k]];
    }
#pragma unroll
    for (int u = 0; u < RB; ++u) {
      float* row = S + (i0 + u) * ld;
      chol_block_solve(w[u], lb);
#pragma unroll
      for (int k = 0; k < T; ++k) {
        float v = a[u][k];
#pragma unroll
        for (int t = 0; t < KB; ++t) v = fmaf(-w[u][t] * r[t], bw[k][t], v);
        row[off[k]] = v;
      }
    }
  }
}

__global__ void __launch_bounds__(32) precision_chol_kernel(
    const float* __restrict__ covs, float* __restrict__ pt, float* __restrict__ diag,
    int d) {
  extern __shared__ __align__(16) float sm[];
  const int n = chol_order(d), ld = chol_stride(d), xo = (n + 32) * ld;
  float* S = sm;                 // (n + 32, ld): C (+ I), becoming D L^T
  float* X = S + xo;             // (n + RB, ld): I, becoming L^-1 (unit lower), 0 elsewhere
  float* pv = X + (n + RB) * ld; // (n,): the pivots p
  float* rs = pv + n;            // (n,): 1 / sqrt(p_i)
  const int lane = threadIdx.x;
  const long m = blockIdx.x;
  const float* A = covs + m * d * d;
  for (int e = lane; e < n * ld; e += 32) X[e] = 0.f;
#pragma unroll 4
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, l = e - i * n;
    S[i * ld + l] = i < d && l < d ? A[i * d + l] : (i == l ? 1.f : 0.f);
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) X[i * ld + i] = 1.f;
  __syncwarp();

  // C = L D L^T, L unit lower: step j eliminates column j from the rows
  // i > j with L_ij = S_ij / p_j, in S (S_il -= L_ij S_lj, j < l <= i) and
  // in X (X_ic -= L_ij X_jc, c <= j); steps go KB at a time (chol_step).
  // Columns j .. j + KB - 1 of S are read, never written, in the block
  // step, rows j .. j + KB - 1 of X are read and written only by their own
  // columns' lanes, so one __syncwarp a block step suffices. Entries past
  // a row's diagonal and in the padding are updated too and never read
  // into the lower triangles: X's stay 0 (X_jc = 0 for c > j), S's are
  // unused.
  for (int j = 0; j < n; j += KB) {
    // the diagonal block, by every lane: its pivots and unit-lower factor
    float r[KB], lb[KB][KB];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      const float4 q = *reinterpret_cast<const float4*>(S + (j + t) * ld + j);
      float w[KB] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int s = 0; s < t; ++s) {
#pragma unroll
        for (int u = 0; u < s; ++u) w[s] = fmaf(-w[u], lb[s][u], w[s]);
        lb[t][s] = w[s] * r[s];
        w[t] = fmaf(-lb[t][s], w[s], w[t]);
      }
      r[t] = __frcp_rn(w[t]);
      if (lane == 0) pv[j + t] = w[t];
    }
    const int ns = (n - KB - j + 31) / 32, nx = (j + KB - 1) / 32 + 1;  // live column slots
    switch (ns + nx) {  // <= 5: ceil((n - 4 - j) / 32) + (j + 3) / 32 + 1, n <= 128
      case 1: chol_step<1>(S, ld, xo, n, j, r, lb, ns, lane); break;
      case 2: chol_step<2>(S, ld, xo, n, j, r, lb, ns, lane); break;
      case 3: chol_step<3>(S, ld, xo, n, j, r, lb, ns, lane); break;
      case 4: chol_step<4>(S, ld, xo, n, j, r, lb, ns, lane); break;
      default: chol_step<5>(S, ld, xo, n, j, r, lb, ns, lane); break;
    }
    __syncwarp();
  }

  // the Cholesky factor is L D^(1/2): diag = sqrt(p), P^T = D^(-1/2) L^-1
  for (int i = lane; i < d; i += 32) {
    diag[m * d + i] = sqrtf(pv[i]);
    rs[i] = __frsqrt_rn(pv[i]);
  }
  __syncwarp();
  float* out = pt + m * d * d;
#pragma unroll 4
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d, c = e - i * d;
    out[e] = X[i * ld + c] * rs[i];
  }
}

// K10's factorisation. S (d x d, its lower triangle SPD) in shared memory
// becomes L (lower); X (zeroed by the caller) becomes L^-1 (lower); dl[j] =
// L_jj. Every thread of the block calls it.
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

// K10's shared memory: S, X (d x d) and dl, mu (d).
inline size_t params_smem(int d) { return sizeof(float) * (2 * (size_t)d * d + 2 * d); }

__global__ void __launch_bounds__(NT) params_kernel(
    const float* __restrict__ counts, const float* __restrict__ sums,
    const float* __restrict__ scatter, float* __restrict__ pt, float* __restrict__ bias,
    float* __restrict__ cnst, int d, float m_rows, float reg) {
  extern __shared__ float sm[];
  float* S = sm;          // (d, d)
  float* X = S + d * d;   // (d, d)
  float* dl = X + d * d;  // (d,)
  float* mu = dl + d;     // (d,)
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

// covs: (M, d, d) float32, row-major, d <= 128. pt: (M, d, d) float32 out,
// L^-1 with a zero upper triangle. diag: (M, d) float32 out.
GCIS_API int gcis_precision_chol(const float* covs, float* pt, float* diag, int M,
                                 int d, void* stream) {
  if (d < 1 || d > D_CHOL || M < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = chol_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      precision_chol_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  precision_chol_kernel<<<M, 32, smem, (cudaStream_t)stream>>>(covs, pt, diag, d);
  return (int)cudaGetLastError();
}

// counts: (M,), sums: (M, d), scatter: (M, d, d) float32, one EM pass's
// moments per component, d <= 127. pt: (M, d, d), bias: (M, d), cnst: (M,)
// float32 out. m_rows: the pixels the moments were taken over (the weights
// are nk / m_rows); reg: reg_covar.
GCIS_API int gcis_precision_chol_params(const float* counts, const float* sums,
                                        const float* scatter, float* pt, float* bias,
                                        float* cnst, int M, int d, float m_rows,
                                        float reg, void* stream) {
  if (d < 1 || d > D_PARAMS || M < 1 || !(m_rows > 0.f)) return (int)cudaErrorInvalidValue;
  const size_t smem = params_smem(d);
  cudaError_t err = cudaFuncSetAttribute(
      params_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  params_kernel<<<M, NT, smem, (cudaStream_t)stream>>>(counts, sums, scatter, pt, bias, cnst,
                                                       d, m_rows, reg);
  return (int)cudaGetLastError();
}
