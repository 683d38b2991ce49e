// K9: batched Cholesky factor and its inverse, one warp per matrix;
// K10: the GMM's moments -> parameters step around the same factorisation.
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
//   P^T = L^-1,  bias = P^T mu,  const = log(nk / m) - sum log diag L - d/2 log 2 pi,
//
// for d <= 127 (the reference's dp <= 128 with the ones row at index d).
// The TPU kernel read the moments from a ones-extended (dp x dp) scatter;
// here they come as EM's (count, sums, scatter) outputs. Bound: latency,
// as K9 (M = 40 matrices of d = 39, ~0.25 MB of moments). Its design is
// K9's (params_kernel): one warp a matrix, no block barrier, and the same
// LDL^T sweep (chol_sweep), behind a prologue that forms C in shared memory
// with explicitly rounded operations in the plain version's order, so C is
// bit-equal to the plain chain's C (and P^T to K9's on that C), and before
// an epilogue of a lane a row: P^T = D^(-1/2) L^-1, bias = P^T mu (a serial
// dot a row), log det L = sum log sqrt(p_i) over lanes in a fixed-order
// warp sum. bias and const differ from the plain chain by the order of
// their sums. The prologue is latency: the scatter's loads go 24 a lane
// at a time, all in flight (the first batch beside the means'), and a
// lane walks its entries' (row, column) without a division a step.

#include <cfloat>

#include "common.cuh"

namespace {

constexpr int D_CHOL = 128;   // K9: the reference's _LANES
constexpr int D_PARAMS = 127; // K10: dp <= 128 with the ones row at d
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

// S (n + 32 rows of stride ld, from its start) holds C extended by an
// identity block to order n, X (xo floats after S, n + RB rows) the identity
// (0 elsewhere): the sweep leaves L^-1 (unit lower) in X and the pivots p in
// pv, with C = L D L^T. Every lane of the warp calls it; it ends synced.
__device__ __forceinline__ void chol_sweep(float* S, int ld, int xo, int n, float* pv,
                                           int lane) {
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
}

// S (n + 32, ld), X (n + RB, ld), pv and rs (n,), and extra floats, in
// dynamic shared memory.
inline size_t chol_smem(int d, int extra = 0) {
  const size_t n = chol_order(d);
  return sizeof(float) * ((2 * n + 32 + RB) * chol_stride(d) + 2 * n + extra);
}

// X cleared and its diagonal set, S's identity extension written (rows and
// columns d .. n - 1); the caller fills S's first d x d entries.
__device__ __forceinline__ void chol_setup(float* S, float* X, int d, int n, int ld,
                                           int lane) {
  for (int e = lane; e < n * ld; e += 32) X[e] = 0.f;
  for (int e = lane; e < (n - d) * n; e += 32) {
    const int i = d + e / n, l = e - (i - d) * n;  // row i >= d, every column
    S[i * ld + l] = i == l ? 1.f : 0.f;
    S[l * ld + i] = i == l ? 1.f : 0.f;  // column i >= d, every row
  }
  __syncwarp();
  for (int i = lane; i < n; i += 32) X[i * ld + i] = 1.f;
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
  chol_setup(S, X, d, n, ld, lane);
#pragma unroll 4
  for (int e = lane; e < d * d; e += 32) {
    const int i = e / d;
    S[i * ld + e - i * d] = A[e];
  }
  __syncwarp();
  chol_sweep(S, ld, xo, n, pv, lane);

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

// Lane `lane`'s entries e = lane + 32 u of a d x d row-major matrix, as
// (row, column), stepped without a division a step.
struct Walk {
  int i, j, di, dj;  // 32 = di d + dj
  __device__ __forceinline__ Walk(int lane, int d)
      : i(lane / d), j(lane % d), di(32 / d), dj(32 % d) {}
  __device__ __forceinline__ void next(int d) {
    i += di;
    j += dj;
    if (j >= d) {
      j -= d;
      ++i;
    }
  }
};

constexpr int QB = 24;  // scatter entries a lane loads before it uses them

// K10: one warp a matrix, as K9, with the moments -> C prologue and the
// bias and const epilogue.
__global__ void __launch_bounds__(32) params_kernel(
    const float* __restrict__ counts, const float* __restrict__ sums,
    const float* __restrict__ scatter, float* __restrict__ pt, float* __restrict__ bias,
    float* __restrict__ cnst, int d, float m_rows, float reg) {
  extern __shared__ __align__(16) float sm[];
  const int n = chol_order(d), ld = chol_stride(d), xo = (n + 32) * ld;
  float* S = sm;                 // (n + 32, ld): C (+ I), becoming D L^T
  float* X = S + xo;             // (n + RB, ld): I, becoming L^-1
  float* pv = X + (n + RB) * ld; // (n,): the pivots p
  float* rs = pv + n;            // (n,): 1 / sqrt(p_i)
  float* mu = rs + n;            // (d,): the means
  const int lane = threadIdx.x;
  const long m = blockIdx.x;
  const int dd = d * d;
  const float* Q = scatter + m * dd;
  // the scatter's loads go QB a lane at a time, all in flight together, the
  // first batch's beside the means'
  float q[QB];
  auto load = [&](int e0) {
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      const int e = e0 + lane + 32 * u;
      q[u] = e < dd ? Q[e] : 0.f;
    }
  };
  load(0);
  const float nk = __fadd_rn(counts[m], 10.f * FLT_EPSILON);
  for (int i = lane; i < d; i += 32) mu[i] = __fdiv_rn(sums[m * d + i], nk);
  chol_setup(S, X, d, n, ld, lane);  // its __syncwarp publishes mu too
  // C = Q / nk - mu mu^T + reg I, rounded op by op as the plain chain
  Walk at(lane, d);
  for (int e0 = 0; e0 < dd; e0 += 32 * QB) {
    if (e0 > 0) load(e0);
#pragma unroll
    for (int u = 0; u < QB; ++u) {
      if (e0 + lane + 32 * u < dd) {
        const float c = __fsub_rn(__fdiv_rn(q[u], nk), __fmul_rn(mu[at.i], mu[at.j]));
        S[at.i * ld + at.j] = at.i == at.j ? __fadd_rn(c, reg) : c;
      }
      at.next(d);
    }
  }
  __syncwarp();
  chol_sweep(S, ld, xo, n, pv, lane);

  // log det L = sum_i log sqrt(p_i): each lane its rows in order, then a
  // fixed butterfly; P^T = D^(-1/2) L^-1; bias = P^T mu, a lane a row
  float ldet = 0.f;
  for (int i = lane; i < d; i += 32) {
    ldet += logf(sqrtf(pv[i]));
    rs[i] = __frsqrt_rn(pv[i]);
  }
  ldet = gcis::warp_sum(ldet);
  __syncwarp();
  float* out = pt + m * dd;
  Walk ot(lane, d);
#pragma unroll 4
  for (int e = lane; e < dd; e += 32) {
    out[e] = X[ot.i * ld + ot.j] * rs[ot.i];
    ot.next(d);
  }
  for (int i = lane; i < d; i += 32) {
    const float* xi = X + i * ld;
    float acc = 0.f;
    for (int c = 0; c <= i; ++c) acc = fmaf(xi[c] * rs[i], mu[c], acc);
    bias[m * d + i] = acc;
  }
  if (lane == 0)
    cnst[m] = (logf(__fdiv_rn(nk, m_rows)) - ldet) - (float)(0.5 * d * LOG2PI);
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
  const size_t smem = chol_smem(d, d);
  cudaError_t err = cudaFuncSetAttribute(
      params_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  params_kernel<<<M, 32, smem, (cudaStream_t)stream>>>(counts, sums, scatter, pt, bias, cnst,
                                                       d, m_rows, reg);
  return (int)cudaGetLastError();
}
