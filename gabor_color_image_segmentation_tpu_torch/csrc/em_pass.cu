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
// had no float32-accurate dot; the CUDA cores need no such trick, and no
// tensor core runs here.
//
// em_kernel: blocks of NT = 320 threads walk chunks of CH = 640 pixels (the
// wrapper's em_plan gives each block a run of consecutive chunks, sized so
// that one wave of blocks covers the card). Per chunk:
//   scores   each thread takes two pixels (p and p + NT): their columns of
//            x sit in registers (unrolled to DMAX = 40 rows), the k lower
//            triangles of P^T sit in shared memory with each row padded to
//            a multiple of 4, so one float4 broadcast feeds eight FMAs.
//   moments  the thread turns its lp values into responsibilities and
//            stores its pixels' extended columns [x 1 0...] pixel-major in
//            shared memory. The k lower triangles of the extended
//            (D + 1) x (D + 1) scatter are cut into 4 x 8 tiles (the
//            wrapper's tile map, one entry per tile: component, first row,
//            first column; 30 tiles a component at D = 39); each thread
//            owns one tile and sums it over a fixed share of the chunk's
//            pixels in pixel order: per pixel three float4 loads and one
//            load of r feed 32 FMAs. Where the tiles are fewer than the
//            threads, S = NT / tiles threads share a tile, each taking every
//            S-th pixel.
//   sums     float32 only where the runs are short: an owner adds RUN = 32
//            pixels into a run tile and the runs into its tile, which spans
//            FOLD = 4 chunks (at most 4 x 640 / S pixels); then it stores
//            the tile in shared memory, and after the chunk's barrier the
//            block's threads convert the shares' tiles and add them, in
//            share order, into the block's float64 partial row in device
//            memory (stored at the block's first fold, then read, added and
//            stored: one writer an entry, chunk order).
//   The log-likelihood adds each pixel's float32 log-sum-exp in float64.
//   block_order_sum adds the partial rows in block order in float64 and
//   rounds each entry to float32 once, as em_pass_plain sums in float64
//   and rounds once. A block walks up to ~120 chunks (config2 at batch 50):
//   float32 sums across them carried 1e-5-4e-5 of an entry from float64,
//   enough to move a covariance by its smallest eigenvalue. No float
//   atomics: labels depend on these sums over 30 EM iterations, and the
//   basin EM lands in can turn on their last bits. Two launches give the
//   same bits.
//
// em_wide_kernel: the feature rows 40 < D <= 128 (the reference's K9 takes
// d <= 128; a 16-kernel bank gives D = 51), where x no longer fits in a
// thread's registers and the k padded triangles of P^T (~270 KB at k = 8,
// D = 123) no longer fit in shared memory. Simple, not tuned: blocks of
// NTW = 256 threads walk chunks of CHW = 256 pixels, one a thread. Per
// chunk the block stores the pixels' extended columns [x 1 0 ...]
// pixel-major in shared memory (a stride of 4 (mod 8) floats, so a
// thread's float4 reads of its own column hit distinct banks), then stages
// the components' padded triangles one at a time and scores its pixel
// against each; with moments every thread owns the tiles t, t + NTW, ...
// of the wrapper's tile map, sums each over the chunk's pixels in pixel
// order in float32 registers (runs of RUN pixels, then the runs), and adds
// the sum into the block's float64 partial row in device memory (its
// entries read before the chunk's sums, stored at the block's first chunk:
// one owner, chunk order). The partial rows, their layout and
// block_order_sum are the narrow kernel's, so two launches give the same
// bits.
//
// Bound on the H100: float32 operations. Per pixel the scores take
// k D (D + 1) / 2 FMAs and the moments k (D + 1)(D + 2) / 2, about 16 kFLOP
// at k = 5, D = 39 (half that labels only), against 78 (bf16) or 156 (f32)
// bytes of x: ~100-200 FLOP per byte, far above the card's ~20 for float32.
// The padded rows add ~13 % to the score FMAs and the square tiles ~17 % to
// the moments' (entries above the diagonal, which the wrapper does not
// read). The runs add 32 float32 adds a tile every RUN pixels (1,024
// FMAs), and the float64 row a load, a conversion, an add and a store an
// entry a share every FOLD chunks: ~2 % at the fit grid and ~3 % at full
// resolution of config2 at batch 50, where the moments lie within twice
// the plain pass's distance from float64 (experiments/torch_em_moments.py).

#include "common.cuh"

namespace {

using gcis::ld;
using gcis::neg_inf;
using gcis::warp_sum;

constexpr int NT = 320;
constexpr int CH = 2 * NT;  // pixels a chunk, two a thread
constexpr int KMAX = 8;
constexpr int DMAX = 40;      // feature rows held in registers
constexpr int PSTRIDE = 880;  // padded lower triangle of DMAX rows
constexpr int XS = 52;        // floats a pixel's extended column takes in shared memory
constexpr int TA = 4, TC = 8;  // rows and columns of a moments tile
constexpr int TILE = TA * TC;
constexpr int RSTRIDE = CH + 4;  // rs rows fall in different banks
constexpr int RUN = 32;   // pixels a float32 run of the moments' sums adds
constexpr int FOLD = 4;   // chunks an owner's float32 tile spans before the float64 row

// Offset of row i in a padded triangle: row i holds 4 * (i / 4 + 1) floats.
__host__ __device__ constexpr int row_off(int i) {
  return 8 * (i / 4) * (i / 4 + 1) + 4 * (i % 4) * (i / 4 + 1);
}

// One pixel's responsibilities (in place of its lp values in rs) and its
// extended column [x 1 0 ...] in col; returns its log-sum-exp (0 past N).
__device__ __forceinline__ float finish(float* rs, float* col, int p, const float (&xv)[DMAX],
                                        float bv, bool valid, int D, int k) {
  float lse = 0.f;
  if (valid) {
    float se = 0.f;
    for (int j = 0; j < k; ++j) {
      const float ex = expf(rs[j * RSTRIDE + p] - bv);
      rs[j * RSTRIDE + p] = ex;
      se += ex;
    }
    for (int j = 0; j < k; ++j) rs[j * RSTRIDE + p] /= se;
    lse = bv + logf(se);
  } else {
    for (int j = 0; j < k; ++j) rs[j * RSTRIDE + p] = 0.f;
  }
#pragma unroll
  for (int u = 0; u < XS; u += 4) {
    float v[4];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int i = u + h;
      v[h] = i < D ? xv[i < DMAX ? i : DMAX - 1] : (i == D ? 1.f : 0.f);
    }
    *reinterpret_cast<float4*>(col + u) = make_float4(v[0], v[1], v[2], v[3]);
  }
  return lse;
}

template <typename T, bool MOMENTS>
__global__ void __launch_bounds__(NT, 1) em_kernel(
    const T* __restrict__ x, const float* __restrict__ pt, const float* __restrict__ bias,
    const float* __restrict__ cnst, const int* __restrict__ tiles, int* __restrict__ labels,
    double* __restrict__ partial, int D, int N, int k, int chunks, int njobs) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double warp_ll[NT / 32];
  float* P = smem;                 // (k, PSTRIDE) padded lower triangles
  float* bs = P + k * PSTRIDE;     // (k, DMAX) biases
  float* cs = bs + k * DMAX;       // (KMAX,) constants
  float* rs = cs + KMAX;           // (k, RSTRIDE) responsibilities (moments)
  float* xs = rs + k * RSTRIDE;    // (CH, XS) extended columns (moments)
  float* red = xs + CH * XS;       // (nshare, njobs, TILE) a chunk's tiles (moments)
  const int tid = threadIdx.x, blk = blockIdx.x, b = blockIdx.y;
  const long n = N;

  const float* ptb = pt + (long)b * k * D * D;
  for (int e = tid; e < k * DMAX * DMAX; e += NT) {
    const int j = e / (DMAX * DMAX), r = e - j * DMAX * DMAX, i = r / DMAX, l = r - i * DMAX;
    if (l < 4 * (i / 4 + 1))
      P[j * PSTRIDE + row_off(i) + l] =
          (i < D && l <= i) ? ptb[((long)j * D + i) * D + l] : 0.f;
  }
  for (int e = tid; e < k * DMAX; e += NT) {
    const int j = e / DMAX, i = e - j * DMAX;
    bs[e] = i < D ? bias[((long)b * k + j) * D + i] : 0.f;
  }
  if (tid < k) cs[tid] = cnst[(long)b * k + tid];

  // this thread's moments tile
  const int job = tid % njobs, share = tid / njobs;
  const int nshare = max(1, NT / njobs);
  const bool tile_owner = share < nshare;
  const int code = tiles[job];
  const int tj = code >> 16, a0 = (code >> 8) & 0xff, c0 = code & 0xff;
  const int width = njobs * TILE + 1;
  double* out = partial + ((long)b * gridDim.x + blk) * width;
  float acc[TA][TC];  // the owner's tile since the last fold, a sum of runs
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  double ll = 0.0;
  __syncthreads();

  const T* xb = x + (long)b * D * n;
  const int nchunks = (N + CH - 1) / CH;
  const int q0 = blk * chunks, q1 = min(nchunks, q0 + chunks);
  for (int q = q0; q < q1; ++q) {
    const long base = (long)q * CH;
    const long p0 = base + tid, p1 = p0 + NT;
    const bool v0 = p0 < n, v1 = p1 < n;
    float x0[DMAX], x1[DMAX];
#pragma unroll
    for (int i = 0; i < DMAX; ++i) {
      x0[i] = (i < D && v0) ? ld(xb, i * n + p0) : 0.f;
      x1[i] = (i < D && v1) ? ld(xb, i * n + p1) : 0.f;
    }
    int best0 = 0, best1 = 0;
    float bv0 = neg_inf(), bv1 = neg_inf();
    for (int j = 0; j < k; ++j) {
      const float* Pj = P + j * PSTRIDE;
      const float* bj = bs + j * DMAX;
      float m0 = 0.f, m1 = 0.f;
#pragma unroll
      for (int i = 0; i < DMAX; ++i) {
        if (i < D) {
          float y0 = 0.f, y1 = 0.f;
#pragma unroll
          for (int l4 = 0; l4 <= i / 4; ++l4) {
            const float4 w = *reinterpret_cast<const float4*>(Pj + row_off(i) + 4 * l4);
            y0 += w.x * x0[4 * l4];
            y1 += w.x * x1[4 * l4];
            y0 += w.y * x0[4 * l4 + 1];
            y1 += w.y * x1[4 * l4 + 1];
            y0 += w.z * x0[4 * l4 + 2];
            y1 += w.z * x1[4 * l4 + 2];
            y0 += w.w * x0[4 * l4 + 3];
            y1 += w.w * x1[4 * l4 + 3];
          }
          const float z0 = y0 - bj[i], z1 = y1 - bj[i];
          m0 += z0 * z0;
          m1 += z1 * z1;
        }
      }
      const float lp0 = cs[j] - 0.5f * m0, lp1 = cs[j] - 0.5f * m1;
      if (MOMENTS) {
        rs[j * RSTRIDE + tid] = lp0;
        rs[j * RSTRIDE + tid + NT] = lp1;
      }
      if (j == 0 || lp0 > bv0) {
        bv0 = lp0;
        best0 = j;
      }
      if (j == 0 || lp1 > bv1) {
        bv1 = lp1;
        best1 = j;
      }
    }
    if (v0) labels[(long)b * n + p0] = best0;
    if (v1) labels[(long)b * n + p1] = best1;
    if (!MOMENTS) continue;

    // responsibilities, the log-sum-exp and the extended columns
    ll += finish(rs, xs + tid * XS, tid, x0, bv0, v0, D, k);
    ll += finish(rs, xs + (tid + NT) * XS, tid + NT, x1, bv1, v1, D, k);
    __syncthreads();
    if (tile_owner) {
      const int nvalid = (int)min((long)CH, n - base);
      const float* rj = rs + tj * RSTRIDE;
      for (int p0 = share; p0 < nvalid; p0 += RUN * nshare) {
        const int p1 = min(nvalid, p0 + RUN * nshare);
        float run[TA][TC];
#pragma unroll
        for (int i = 0; i < TA; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) run[i][c] = 0.f;
#pragma unroll 4
        for (int p = p0; p < p1; p += nshare) {
          const float r = rj[p];
          const float* col = xs + p * XS;
          float wa[TA], xc[TC];
#pragma unroll
          for (int u = 0; u < TA; u += 4) {
            const float4 f = *reinterpret_cast<const float4*>(col + a0 + u);
            wa[u] = r * f.x;
            wa[u + 1] = r * f.y;
            wa[u + 2] = r * f.z;
            wa[u + 3] = r * f.w;
          }
#pragma unroll
          for (int u = 0; u < TC; u += 4) {
            const float4 f = *reinterpret_cast<const float4*>(col + c0 + u);
            xc[u] = f.x;
            xc[u + 1] = f.y;
            xc[u + 2] = f.z;
            xc[u + 3] = f.w;
          }
#pragma unroll
          for (int i = 0; i < TA; ++i)
#pragma unroll
            for (int c = 0; c < TC; ++c) run[i][c] += wa[i] * xc[c];
        }
#pragma unroll
        for (int i = 0; i < TA; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[i][c] += run[i][c];
      }
    }
    // the block's every FOLD-th chunk and its last (the same for all threads)
    const bool fold = (q - q0) % FOLD == FOLD - 1 || q == q1 - 1;
    if (fold && tile_owner) {
      float* rd = red + (share * njobs + job) * TILE;
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int c = 0; c < TC; c += 4) {
          *reinterpret_cast<float4*>(rd + i * TC + c) =
              make_float4(acc[i][c], acc[i][c + 1], acc[i][c + 2], acc[i][c + 3]);
          acc[i][c] = acc[i][c + 1] = acc[i][c + 2] = acc[i][c + 3] = 0.f;
        }
    }
    // every owner is done with rs and xs (rewritten next chunk) and has
    // stored its tile
    __syncthreads();
    if (!fold) continue;
    // the tiles, each share converted and added in share order, into the
    // block's float64 row (stored at its first fold): one writer an entry,
    // chunk order. red is stored again only after the next chunk's first
    // barrier.
#pragma unroll 4
    for (int e = tid; e < njobs * TILE; e += NT) {
      double s = q - q0 < FOLD ? 0.0 : out[e];
      for (int h = 0; h < nshare; ++h) s += (double)red[h * njobs * TILE + e];
      out[e] = s;
    }
  }
  if (!MOMENTS) return;

  // the log-likelihood in warp order
  const double wl = warp_sum(ll);
  if ((tid & 31) == 0) warp_ll[tid >> 5] = wl;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < NT / 32; ++w) s += warp_ll[w];
    out[njobs * TILE] = s;
  }
}

constexpr int NTW = 256;         // the wide kernel's threads
constexpr int CHW = NTW;         // and pixels a chunk, one a thread
constexpr int DWIDE = 128;       // its feature rows: the reference's K9 limit

// Floats a pixel's extended column takes in the wide kernel's shared memory:
// every tile's rows (a0 .. a0 + 3) and columns (c0 .. c0 + 7) of the tile
// map, rounded to 4 (mod 8) floats.
__host__ __device__ inline int wide_stride(int D) {
  const int a0 = 4 * (D / 4), c0 = 8 * ((a0 + 3) / 8);
  const int need = max(a0 + 4, c0 + 8);
  return 4 * (((need + 3) / 4) | 1);
}

template <typename T>
__global__ void __launch_bounds__(NTW) em_wide_kernel(
    const T* __restrict__ x, const float* __restrict__ pt, const float* __restrict__ bias,
    const float* __restrict__ cnst, const int* __restrict__ tiles, int* __restrict__ labels,
    double* __restrict__ partial, int D, int N, int k, int chunks, int njobs, int moments) {
  extern __shared__ __align__(16) float smem[];
  __shared__ double warp_ll[NTW / 32];
  const int xsw = wide_stride(D);
  float* P = smem;                 // (row_off(D),) one padded lower triangle
  float* bs = P + row_off(D);      // (D,) its bias
  float* rs = bs + DWIDE;          // (k, CHW) lp values, then responsibilities
  float* xs = rs + k * CHW;        // (CHW, xsw) extended columns
  const int tid = threadIdx.x, blk = blockIdx.x, b = blockIdx.y;
  const long n = N;
  const T* xb = x + (long)b * D * n;
  const float* ptb = pt + (long)b * k * D * D;
  const int width = njobs * TILE + 1;
  double* out = partial + ((long)b * gridDim.x + blk) * width;
  const int rw = 4 * ((D + 3) / 4);  // a padded row's widest length
  double ll = 0.0;

  const int nchunks = (N + CHW - 1) / CHW;
  const int q0 = blk * chunks, q1 = min(nchunks, q0 + chunks);
  for (int q = q0; q < q1; ++q) {
    const long base = (long)q * CHW, p = base + tid;
    const bool valid = p < n;
    float* col = xs + tid * xsw;
    __syncthreads();  // the previous chunk is done with xs and rs
    for (int i = 0; i < xsw; ++i)
      col[i] = i < D ? (valid ? ld(xb, i * n + p) : 0.f) : (i == D ? 1.f : 0.f);
    int best = 0;
    float bv = neg_inf();
    for (int j = 0; j < k; ++j) {
      __syncthreads();  // every thread is done with the previous triangle
      for (int e = tid; e < D * rw; e += NTW) {
        const int i = e / rw, l = e - i * rw;
        if (l < 4 * (i / 4 + 1))
          P[row_off(i) + l] = (l <= i && l < D) ? ptb[((long)j * D + i) * D + l] : 0.f;
      }
      for (int i = tid; i < D; i += NTW) bs[i] = bias[((long)b * k + j) * D + i];
      __syncthreads();
      float m = 0.f;
      for (int i = 0; i < D; ++i) {
        const float* Pi = P + row_off(i);
        float y = 0.f;
        for (int l4 = 0; l4 <= i / 4; ++l4) {
          const float4 w = *reinterpret_cast<const float4*>(Pi + 4 * l4);
          const float4 v = *reinterpret_cast<const float4*>(col + 4 * l4);
          y += w.x * v.x;
          y += w.y * v.y;
          y += w.z * v.z;
          y += w.w * v.w;
        }
        const float z = y - bs[i];
        m += z * z;
      }
      const float lp = cnst[(long)b * k + j] - 0.5f * m;
      rs[j * CHW + tid] = lp;
      if (j == 0 || lp > bv) {
        bv = lp;
        best = j;
      }
    }
    if (valid) labels[(long)b * n + p] = best;
    if (!moments) continue;

    // responsibilities and the log-sum-exp, as the narrow kernel's finish
    if (valid) {
      float se = 0.f;
      for (int j = 0; j < k; ++j) {
        const float ex = expf(rs[j * CHW + tid] - bv);
        rs[j * CHW + tid] = ex;
        se += ex;
      }
      for (int j = 0; j < k; ++j) rs[j * CHW + tid] /= se;
      ll += bv + logf(se);
    } else {
      for (int j = 0; j < k; ++j) rs[j * CHW + tid] = 0.f;
    }
    __syncthreads();
    const int nvalid = (int)min((long)CHW, n - base);
    for (int t = tid; t < njobs; t += NTW) {
      const int code = tiles[t];
      const int tj = code >> 16, a0 = (code >> 8) & 0xff, c0 = code & 0xff;
      const float* rj = rs + tj * CHW;
      double* o = out + t * TILE;
      double prev[TA][TC];  // the row so far, read before the chunk's sums
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) prev[i][c] = q == q0 ? 0.0 : o[i * TC + c];
      float acc[TA][TC];  // a sum of runs of at most RUN pixels
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
      for (int p0 = 0; p0 < nvalid; p0 += RUN) {
        float run[TA][TC];
#pragma unroll
        for (int i = 0; i < TA; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) run[i][c] = 0.f;
        for (int pp = p0; pp < min(nvalid, p0 + RUN); ++pp) {
          const float r = rj[pp];
          const float* cp = xs + pp * xsw;
          const float4 fa = *reinterpret_cast<const float4*>(cp + a0);
          const float4 f0 = *reinterpret_cast<const float4*>(cp + c0);
          const float4 f1 = *reinterpret_cast<const float4*>(cp + c0 + 4);
          const float wa[TA] = {r * fa.x, r * fa.y, r * fa.z, r * fa.w};
          const float xc[TC] = {f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w};
#pragma unroll
          for (int i = 0; i < TA; ++i)
#pragma unroll
            for (int c = 0; c < TC; ++c) run[i][c] += wa[i] * xc[c];
        }
#pragma unroll
        for (int i = 0; i < TA; ++i)
#pragma unroll
          for (int c = 0; c < TC; ++c) acc[i][c] += run[i][c];
      }
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) o[i * TC + c] = prev[i][c] + (double)acc[i][c];
    }
  }
  if (!moments) return;
  const double wl = warp_sum(ll);
  if ((tid & 31) == 0) warp_ll[tid >> 5] = wl;
  __syncthreads();
  if (tid == 0) {
    double s = 0.0;
    for (int w = 0; w < NTW / 32; ++w) s += warp_ll[w];
    out[njobs * TILE] = s;
  }
}

template <typename T>
int launch_wide(const void* x, const float* pt, const float* bias, const float* cnst,
                const int* tiles, int* labels, double* partial, float* out, int B, int D,
                int N, int k, int chunks, int njobs, int moments, cudaStream_t s) {
  const int nchunks = (N + CHW - 1) / CHW;
  const int nblk = (nchunks + chunks - 1) / chunks;
  const size_t words = (size_t)row_off(D) + DWIDE + (size_t)k * CHW +
                       (size_t)CHW * wide_stride(D);
  const size_t smem = words * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      em_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  em_wide_kernel<T><<<dim3(nblk, B), NTW, smem, s>>>((const T*)x, pt, bias, cnst, tiles,
                                                     labels, partial, D, N, k, chunks, njobs,
                                                     moments);
  err = cudaGetLastError();
  if (err != cudaSuccess || !moments) return (int)err;
  return (int)gcis::block_order_sum(partial, out, B, nblk, njobs * TILE + 1, s);
}

template <typename T>
int launch(const void* x, const float* pt, const float* bias, const float* cnst,
           const int* tiles, int* labels, double* partial, float* out, int B, int D, int N,
           int k, int chunks, int njobs, int moments, cudaStream_t s) {
  const int nchunks = (N + CH - 1) / CH;
  const int nblk = (nchunks + chunks - 1) / chunks;
  const size_t nshare = NT / njobs > 1 ? NT / njobs : 1;  // as the kernel's
  const size_t words = (size_t)k * PSTRIDE + (size_t)k * DMAX + KMAX +
                       (moments ? (size_t)k * RSTRIDE + (size_t)CH * XS +
                                      nshare * njobs * TILE
                                : 0);
  const size_t smem = words * sizeof(float);
  // one kernel a pass: with the flag read at run time the compiler kept two
  // copies of the scoring loop, spilled, and the labels-only pass took
  // 0.41 ms against 0.24 (config2's fit grid at batch 50)
  auto kern = moments ? em_kernel<T, true> : em_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3(nblk, B), NT, smem, s>>>((const T*)x, pt, bias, cnst, tiles, labels, partial,
                                       D, N, k, chunks, njobs);
  err = cudaGetLastError();
  if (err != cudaSuccess || !moments) return (int)err;
  return (int)gcis::block_order_sum(partial, out, B, nblk, njobs * TILE + 1, s);
}

}  // namespace

// x: (B, D, N) float32 or bfloat16 (bf16 != 0), D <= 128 (D <= 40 takes
// em_kernel, D > 40 em_wide_kernel). pt: (B, k, D, D) float32 P^T (lower
// triangle read). bias: (B, k, D), cnst: (B, k) float32. tiles: (njobs,)
// int32, the moments tiles (component << 16 | first row << 8 | first
// column, rows a multiple of 4, columns of 8), njobs <= 320 for D <= 40.
// labels: (B, N) int32. chunks: the chunks a block walks, of 640 pixels
// (D <= 40) or 256 (D > 40). With moments != 0: partial (B, nblk, W)
// float64 scratch, nblk = ceil(ceil(N / chunk) / chunks), and out (B, W) float32,
// W = 32 njobs + 1: tile t's entry (i, c) at 32 t + 8 i + c, the sum of
// r [x 1]_(row + i) [x 1]_(column + c), then the sum of the per-pixel
// log-likelihoods. partial and out are untouched when moments == 0.
GCIS_API int gcis_em_pass(const void* x, const float* pt, const float* bias,
                          const float* cnst, const int* tiles, int* labels, double* partial,
                          float* out, int B, int D, int N, int k, int chunks, int njobs,
                          int bf16, int moments, void* stream) {
  if (k < 1 || k > KMAX || D < 1 || D > DWIDE || B < 1 || B > 65535 || N < 1 ||
      chunks < 1 || njobs < 1 || (D <= DMAX && njobs > NT))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (D > DMAX)
    return bf16 ? launch_wide<__nv_bfloat16>(x, pt, bias, cnst, tiles, labels, partial, out,
                                             B, D, N, k, chunks, njobs, moments, s)
                : launch_wide<float>(x, pt, bias, cnst, tiles, labels, partial, out, B, D,
                                     N, k, chunks, njobs, moments, s);
  return bf16 ? launch<__nv_bfloat16>(x, pt, bias, cnst, tiles, labels, partial, out, B, D,
                                      N, k, chunks, njobs, moments, s)
              : launch<float>(x, pt, bias, cnst, tiles, labels, partial, out, B, D, N, k,
                              chunks, njobs, moments, s);
}
