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
//            S-th pixel; their sums are added in share order at the end.
//   Each block writes its tiles and its log-likelihood sum to a partial row;
//   block_order_sum adds the rows in block order. No float atomics: labels
//   depend on these sums over 30 EM iterations, and the basin EM lands in
//   can turn on their last bits. Two launches give the same bits.
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
// order in 32 registers, and adds the sum into the block's partial row in
// device memory (stored at the block's first chunk, then read, added and
// stored: one owner, chunk order). The partial rows, their layout and
// block_order_sum are the narrow kernel's, so two launches give the same
// bits.
//
// Bound on the H100: float32 operations. Per pixel the scores take
// k D (D + 1) / 2 FMAs and the moments k (D + 1)(D + 2) / 2, about 16 kFLOP
// at k = 5, D = 39 (half that labels only), against 78 (bf16) or 156 (f32)
// bytes of x: ~100-200 FLOP per byte, far above the card's ~20 for float32.
// The padded rows add ~13 % to the score FMAs and the square tiles ~17 % to
// the moments' (entries above the diagonal, which the wrapper does not
// read).

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

template <typename T>
__global__ void __launch_bounds__(NT, 1) em_kernel(
    const T* __restrict__ x, const float* __restrict__ pt, const float* __restrict__ bias,
    const float* __restrict__ cnst, const int* __restrict__ tiles, int* __restrict__ labels,
    float* __restrict__ partial, int D, int N, int k, int chunks, int njobs, int moments) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_ll[NT / 32];
  float* P = smem;                 // (k, PSTRIDE) padded lower triangles
  float* bs = P + k * PSTRIDE;     // (k, DMAX) biases
  float* cs = bs + k * DMAX;       // (KMAX,) constants
  float* rs = cs + KMAX;           // (k, RSTRIDE) responsibilities (moments)
  float* xs = rs + k * RSTRIDE;    // (CH, XS) extended columns (moments)
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
  float acc[TA][TC];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
  float ll = 0.f;
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
      if (moments) {
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
    if (!moments) continue;

    // responsibilities, the log-sum-exp and the extended columns
    ll += finish(rs, xs + tid * XS, tid, x0, bv0, v0, D, k);
    ll += finish(rs, xs + (tid + NT) * XS, tid + NT, x1, bv1, v1, D, k);
    __syncthreads();
    if (tile_owner) {
      const int nvalid = (int)min((long)CH, n - base);
      const float* rj = rs + tj * RSTRIDE;
#pragma unroll 4
      for (int p = share; p < nvalid; p += nshare) {
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
          for (int c = 0; c < TC; ++c) acc[i][c] += wa[i] * xc[c];
      }
    }
    __syncthreads();  // rs and xs are rewritten next chunk
  }
  if (!moments) return;

  // the shares' tiles, added in share order; the log-likelihood in warp order
  float* red = xs;  // (nshare, njobs, TILE), free after the last chunk
  if (tile_owner) {
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int c = 0; c < TC; ++c) red[(share * njobs + job) * TILE + i * TC + c] = acc[i][c];
  }
  const float wl = warp_sum(ll);
  if ((tid & 31) == 0) warp_ll[tid >> 5] = wl;
  __syncthreads();
  const int width = njobs * TILE + 1;
  float* out = partial + ((long)b * gridDim.x + blk) * width;
  for (int e = tid; e < njobs * TILE; e += NT) {
    float s = 0.f;
    for (int h = 0; h < nshare; ++h) s += red[h * njobs * TILE + e];
    out[e] = s;
  }
  if (tid == 0) {
    float s = 0.f;
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
    float* __restrict__ partial, int D, int N, int k, int chunks, int njobs, int moments) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float warp_ll[NTW / 32];
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
  float* out = partial + ((long)b * gridDim.x + blk) * width;
  const int rw = 4 * ((D + 3) / 4);  // a padded row's widest length
  float ll = 0.f;

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
      float acc[TA][TC];
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c) acc[i][c] = 0.f;
      for (int pp = 0; pp < nvalid; ++pp) {
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
          for (int c = 0; c < TC; ++c) acc[i][c] += wa[i] * xc[c];
      }
      float* o = out + t * TILE;
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int c = 0; c < TC; ++c)
          o[i * TC + c] = q == q0 ? acc[i][c] : o[i * TC + c] + acc[i][c];
    }
  }
  if (!moments) return;
  const float wl = warp_sum(ll);
  if ((tid & 31) == 0) warp_ll[tid >> 5] = wl;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < NTW / 32; ++w) s += warp_ll[w];
    out[njobs * TILE] = s;
  }
}

template <typename T>
int launch_wide(const void* x, const float* pt, const float* bias, const float* cnst,
                const int* tiles, int* labels, float* partial, float* out, int B, int D,
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
           const int* tiles, int* labels, float* partial, float* out, int B, int D, int N,
           int k, int chunks, int njobs, int moments, cudaStream_t s) {
  const int nchunks = (N + CH - 1) / CH;
  const int nblk = (nchunks + chunks - 1) / chunks;
  const size_t words = (size_t)k * PSTRIDE + (size_t)k * DMAX + KMAX +
                       (moments ? (size_t)k * RSTRIDE + (size_t)CH * XS : 0);
  const size_t smem = words * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      em_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  em_kernel<T><<<dim3(nblk, B), NT, smem, s>>>((const T*)x, pt, bias, cnst, tiles,
                                               labels, partial, D, N, k, chunks, njobs,
                                               moments);
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
// scratch, nblk = ceil(ceil(N / chunk) / chunks), and out (B, W) float32,
// W = 32 njobs + 1: tile t's entry (i, c) at 32 t + 8 i + c, the sum of
// r [x 1]_(row + i) [x 1]_(column + c), then the sum of the per-pixel
// log-likelihoods. partial and out are untouched when moments == 0.
GCIS_API int gcis_em_pass(const void* x, const float* pt, const float* bias,
                          const float* cnst, const int* tiles, int* labels, float* partial,
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
