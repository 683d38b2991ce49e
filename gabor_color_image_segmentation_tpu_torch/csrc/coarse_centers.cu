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
// Design. The TPU kept the whole buffer in VMEM; 16 images of 4.67 MB
// (config1 bf16) exceed the H100's 50 MB L2 and all of its shared memory, so
// every pass streams the buffer from device memory. Each image spans a
// thread-block cluster of `ctas` CTAs (the wrapper's coarse_plan: 8 at batch
// 16, 16 at batch <= 8), each CTA (512 threads) owning a contiguous pixel
// range. A CTA streams its range in tiles of TP pixels x d rows (about
// 62 KB), double buffered with cp.async, and does all of a pass's work on
// the staged tile:
//   mean     row sums of the tile;
//   seeding  the squared distance of each pixel to the probe, the running
//            min in global scratch (each CTA its own pixels) and the CTA's
//            (max, first index);
//   Lloyd    the k scores of each pixel (two pixels a thread, the rows split
//            over RP = 2 NT / TP parts, partial dots added in part order),
//            its label as a one-hot row, then the member sums and counts of
//            the k clusters from the same tile, each thread owning whole
//            rows for half of the tile's pixels (k FMAs by the one-hot
//            weights, exact additions).
// After each pass the CTAs of an image exchange their partials through
// distributed shared memory: every CTA adds all ranks' partial sums in rank
// order (or takes the (max, first index) winner, an associative rule), so
// every CTA computes the same new centres. No float atomics; two launches
// give the same bits.
//
// Bound on the H100: the operations bound of the whole warm start is
// ~0.1 ms at config1, but the buffer cannot stay on chip, so the design's
// floor is the k + 1 + iters reads of the (B, d, m) buffer from device
// memory: 21 x 75 MB / 3.35 TB/s = ~0.47 ms at config1 bf16.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using gcis::ArgMax;
using gcis::better;
using gcis::block_argmax;
using gcis::cp_async16;
using gcis::cp_commit;
using gcis::cp_wait;
using gcis::neg_inf;
using gcis::round_to;
using gcis::warp_sum;

constexpr int NT = 512;
constexpr int GROUPS = NT / 256;      // row owners: each group takes part of a tile's pixels
constexpr int KMAX = 8;
constexpr int DMAX = 511;             // rows; with the ones row each thread owns <= 2
constexpr int TILE_BYTES = 72 * 1024;  // one staged tile at most (two in flight)
constexpr int SMEM_MAX = 226 * 1024;   // dynamic, beside ~0.3 KB of static shared memory
constexpr int MAX_CTAS = 16;
constexpr int MEAN = 0, SEED = 1, LLOYD = 2;

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

size_t smem_bytes(int d, int tp, int esize) {
  const size_t dpad = round4(d), w = d + 1;
  return 2 * dpad * (tp * esize + 16) +
         sizeof(float) * (2 * KMAX * dpad + 3 * KMAX * w + 2 * NT * KMAX + 2 * KMAX * tp + KMAX);
}

// Pixels per tile: the widest of 128, 64, 32 whose tile of d rows fits
// TILE_BYTES and whose shared memory fits the SM (0 when none does).
int tile_pixels(int d, int esize) {
  for (int tp = 128; tp >= 32; tp >>= 1)
    if ((long)round4(d) * (tp * esize + 16) <= TILE_BYTES &&
        smem_bytes(d, tp, esize) <= SMEM_MAX)
      return tp;
  return 0;
}

struct Geometry {
  int d, dpad, cols, k;
  int tp, rp, rc;  // pixels a tile, row parts of the dots, rows a part
  int rs;          // bytes between tile rows (16 bytes of padding)
  int lo, hi, ntiles;
  bool aligned;    // 16-byte cp.async path
};

// Copy tile `t` of this CTA's range into shared buffer `dst` (rows < d);
// pixels past hi read as zeros.
template <typename T>
__device__ void stage(const T* __restrict__ x, char* dst, int t, const Geometry& g) {
  const int base = g.lo + t * g.tp;
  if (g.aligned) {
    constexpr int VEC = 16 / sizeof(T);
    const int cpr = g.tp / VEC;
    for (int e = threadIdx.x; e < g.d * cpr; e += NT) {
      const int row = e / cpr, cc = e - row * cpr, px = base + cc * VEC;
      const int valid = max(0, min(VEC, g.hi - px)) * (int)sizeof(T);
      cp_async16(dst + row * g.rs + cc * 16, x + (long)row * g.cols + (valid ? px : 0), valid);
    }
  } else {
    for (int e = threadIdx.x; e < g.d * g.tp; e += NT) {
      const int row = e / g.tp, p = e - row * g.tp, px = base + p;
      gcis::st(reinterpret_cast<T*>(dst + row * g.rs), p,
               px < g.hi ? gcis::ld(x, (long)row * g.cols + px) : 0.f);
    }
  }
  cp_commit();
}

// Two neighbouring pixels (2 pp, 2 pp + 1) of a staged row, as float32.
__device__ __forceinline__ float2 pair(const char* buf, int rs, int row, int pp, float) {
  return reinterpret_cast<const float2*>(buf + row * rs)[pp];
}
__device__ __forceinline__ float2 pair(const char* buf, int rs, int row, int pp,
                                       __nv_bfloat16) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(buf + row * rs)[pp]);
}

// One sweep over the CTA's range. SEED: returns the CTA-local (max, first
// index) of the updated running min. MEAN and LLOYD: leave the member sums
// of rows rid and rid + 256 (the ones row at d giving the counts) in acc of
// the threads of group 0 (tid < 256).
//   dots     thread (pp, part) takes pixels 2 pp and 2 pp + 1 of the tile
//            and rows [part rc, (part + 1) rc): one float4 of a centre
//            feeds eight FMAs; the parts' partial dots are added in part
//            order.
//   sums     the label of each pixel as a one-hot row; group gi of 256
//            threads takes half of the tile's pixels, each thread its rows:
//            acc[q] = fma(onehot_q, x, acc[q]) is exact addition (onehot is
//            0 or 1, staged values are finite), in pixel order; group 1's
//            sums are added to group 0's at the end.
template <typename T, int MODE>
__device__ __forceinline__ ArgMax sweep(const T* __restrict__ x, char* xs, const float* cr,
                                        const float* csq, float* dots, float* sc, float* oh,
                                        float* dm, int step, const Geometry& g,
                                        float (&acc)[2][KMAX]) {
  const int tid = threadIdx.x;
  const int tile_bytes = g.dpad * g.rs;
  const int np = g.tp / 2;
  const int pp = tid % np, part = tid / np;
  const int r0 = part * g.rc, r1 = min(g.dpad, r0 + g.rc);
  const int gi = tid / 256, rid = tid % 256;
  const int kk = MODE == MEAN ? 1 : g.k;
  ArgMax best{neg_inf(), INT_MAX};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int q = 0; q < KMAX; ++q) acc[i][q] = 0.f;
  if (g.ntiles > 0) stage(x, xs, 0, g);
  for (int t = 0; t < g.ntiles; ++t) {
    const char* buf = xs + (t & 1) * tile_bytes;
    if (t + 1 < g.ntiles) {
      stage(x, xs + ((t + 1) & 1) * tile_bytes, t + 1, g);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int base = g.lo + t * g.tp;
    const int nvalid = min(g.tp, g.hi - base);

    if (MODE == SEED) {
      float s0 = 0.f, s1 = 0.f;
      for (int r = r0; r < r1; r += 4) {
        const float4 c4 = *reinterpret_cast<const float4*>(cr + r);
        const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const float2 v = pair(buf, g.rs, r + h, pp, T());
          const float t0 = v.x - c[h], t1 = v.y - c[h];
          s0 += t0 * t0;
          s1 += t1 * t1;
        }
      }
      reinterpret_cast<float2*>(dots + part * g.tp)[pp] = make_float2(s0, s1);
      __syncthreads();
      if (tid < nvalid) {
        float d2 = 0.f;
        for (int q = 0; q < g.rp; ++q) d2 += dots[q * g.tp + tid];
        const int px = base + tid;
        const float v = step < 2 ? d2 : fminf(dm[px], d2);
        dm[px] = v;
        best = better(best, ArgMax{v, px});
      }
    } else {
      if (MODE == LLOYD) {
        float a0[KMAX], a1[KMAX];
#pragma unroll
        for (int q = 0; q < KMAX; ++q) a0[q] = a1[q] = 0.f;
        for (int r = r0; r < r1; r += 4) {
          float2 v[4];
#pragma unroll
          for (int h = 0; h < 4; ++h) v[h] = pair(buf, g.rs, r + h, pp, T());
#pragma unroll
          for (int q = 0; q < KMAX; ++q) {
            if (q < g.k) {
              const float4 c4 = *reinterpret_cast<const float4*>(cr + q * g.dpad + r);
              a0[q] += c4.x * v[0].x;
              a1[q] += c4.x * v[0].y;
              a0[q] += c4.y * v[1].x;
              a1[q] += c4.y * v[1].y;
              a0[q] += c4.z * v[2].x;
              a1[q] += c4.z * v[2].y;
              a0[q] += c4.w * v[3].x;
              a1[q] += c4.w * v[3].y;
            }
          }
        }
#pragma unroll
        for (int q = 0; q < KMAX; ++q)
          if (q < g.k)
            reinterpret_cast<float2*>(dots + (part * KMAX + q) * g.tp)[pp] =
                make_float2(a0[q], a1[q]);
        __syncthreads();
        for (int e = tid; e < g.k * g.tp; e += NT) {
          const int q = e / g.tp, p = e - q * g.tp;
          float s = 0.f;
          for (int r = 0; r < g.rp; ++r) s += dots[(r * KMAX + q) * g.tp + p];
          sc[e] = s;
        }
        __syncthreads();
        if (tid < g.tp) {
          int bq = -1;
          if (tid < nvalid) {
            float bs = 0.f;
            for (int q = 0; q < g.k; ++q) {
              const float s = csq[q] - 2.f * sc[q * g.tp + tid];
              if (q == 0 || s < bs) {
                bs = s;
                bq = q;
              }
            }
          }
#pragma unroll
          for (int q = 0; q < KMAX; ++q) oh[tid * KMAX + q] = q == bq ? 1.f : 0.f;
        }
      } else if (tid < g.tp) {
#pragma unroll
        for (int q = 0; q < KMAX; ++q) oh[tid * KMAX + q] = (q == 0 && tid < nvalid) ? 1.f : 0.f;
      }
      __syncthreads();
      constexpr int VEC = 16 / sizeof(T);
      const int half = g.tp / GROUPS;
      const int p0 = gi * half, p1 = min(p0 + half, nvalid);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = rid + i * 256;
        if (row > g.d) continue;
        for (int pc = p0; pc < p1; pc += VEC) {
          float v[VEC];
          if (row < g.d) {
            const uint4 raw = *reinterpret_cast<const uint4*>(buf + row * g.rs + pc * sizeof(T));
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int u = 0; u < VEC; ++u) v[u] = gcis::ld(e, u);
          } else {
#pragma unroll
            for (int u = 0; u < VEC; ++u) v[u] = 1.f;
          }
#pragma unroll
          for (int u = 0; u < VEC; ++u) {
            const float4 o0 = *reinterpret_cast<const float4*>(oh + (pc + u) * KMAX);
            const float4 o1 = *reinterpret_cast<const float4*>(oh + (pc + u) * KMAX + 4);
            const float o[KMAX] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
            for (int q = 0; q < KMAX; ++q)
              if (q < kk) acc[i][q] = fmaf(o[q], v[u], acc[i][q]);
          }
        }
      }
    }
    __syncthreads();  // the buffer, dots, sc and oh are rewritten next tile
  }
  if (MODE != SEED) {  // group 1's sums onto group 0's
    if (gi == 1)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < KMAX; ++q)
          if (q < kk) dots[(i * KMAX + q) * 256 + rid] = acc[i][q];
    __syncthreads();
    if (gi == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < KMAX; ++q)
          if (q < kk) acc[i][q] += dots[(i * KMAX + q) * 256 + rid];
    __syncthreads();
  }
  return best;
}

template <typename T>
__global__ void __launch_bounds__(NT) coarse_centers_kernel(
    const T* __restrict__ xp, float* __restrict__ centers, float* __restrict__ dmin,
    int rows, int cols, int d, int m, int k, int iters, int tp, int aligned) {
  extern __shared__ __align__(16) char smem[];
  __shared__ ArgMax scratch[32];
  __shared__ ArgMax cta_best[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), ctas = (int)cluster.num_blocks();
  const int b = blockIdx.y, tid = threadIdx.x;

  Geometry g;
  g.d = d;
  g.dpad = round4(d);
  g.cols = cols;
  g.k = k;
  g.tp = tp;
  g.rp = 2 * NT / tp;
  g.rc = round4((g.dpad + g.rp - 1) / g.rp);
  g.rs = tp * (int)sizeof(T) + 16;
  const int per = ((m + ctas - 1) / ctas + tp - 1) / tp * tp;
  g.lo = min(m, rank * per);
  g.hi = min(m, g.lo + per);
  g.ntiles = (g.hi - g.lo + tp - 1) / tp;
  g.aligned = aligned != 0;

  const int w = d + 1;  // member sums and the count, per cluster
  char* xs = smem;      // two tiles
  float* c = reinterpret_cast<float*>(xs + 2 * g.dpad * g.rs);  // (KMAX, dpad)
  float* cr = c + KMAX * g.dpad;    // (KMAX, dpad) rounded to T; row 0 = probe
  float* part = cr + KMAX * g.dpad;  // 2 x (k, d + 1) partial sums, read by the cluster
  float* tot = part + 2 * KMAX * w;  // (k, d + 1) the image's sums
  float* dots = tot + KMAX * w;      // (RP, KMAX, TP) partial dots
  float* sc = dots + 2 * NT * KMAX;  // (KMAX, TP) dots
  float* oh = sc + KMAX * tp;        // (TP, KMAX) one-hot labels
  float* csq = oh + KMAX * tp;       // (KMAX,)
  const T* x = xp + (long)b * rows * cols;
  float* dm = dmin + (long)b * m;

  for (int e = tid; e < 2 * KMAX * g.dpad; e += NT) c[e] = 0.f;  // c and cr
  for (int e = tid; e < 2 * (g.dpad - d) * tp; e += NT) {  // zero pad rows
    const int buf = e / ((g.dpad - d) * tp), r = e % ((g.dpad - d) * tp);
    const int row = d + r / tp;
    gcis::st(reinterpret_cast<T*>(xs + buf * g.dpad * g.rs + row * g.rs), r % tp, 0.f);
  }
  __syncthreads();

  float acc[2][KMAX];
  int ex = 0;  // exchanges so far: partials alternate between two buffers

  // The image's sums from every CTA's partials, added in rank order into
  // tot (identical in every CTA). kk clusters.
  auto exchange_sums = [&](int kk) {
    float* mine = part + (ex & 1) * KMAX * w;
    if (tid < 256)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = tid + i * 256;
        if (row <= d)
#pragma unroll
          for (int q = 0; q < KMAX; ++q)
            if (q < kk) mine[q * w + row] = acc[i][q];
      }
    cluster.sync();
    for (int e = tid; e < kk * w; e += NT) {
      float s = 0.f;
      for (int r = 0; r < ctas; ++r) s += cluster.map_shared_rank(mine, r)[e];
      tot[e] = s;
    }
    ++ex;
    __syncthreads();
  };

  // ---- maximin seeding: the mean first, then the farthest point ----------
  sweep<T, MEAN>(x, xs, cr, csq, dots, sc, oh, dm, 0, g, acc);
  exchange_sums(1);
  for (int ch = tid; ch < d; ch += NT) cr[ch] = round_to<T>(tot[ch] / (float)m);
  __syncthreads();
  for (int step = 0; step < k; ++step) {
    ArgMax best = sweep<T, SEED>(x, xs, cr, csq, dots, sc, oh, dm, step, g, acc);
    best = block_argmax(best, scratch);
    if (tid == 0) cta_best[ex & 1] = best;
    cluster.sync();
    ArgMax win{neg_inf(), INT_MAX};
    for (int r = 0; r < ctas; ++r) win = better(win, cluster.map_shared_rank(cta_best, r)[ex & 1]);
    ++ex;
    const int j = win.i == INT_MAX ? 0 : win.i;
    for (int ch = tid; ch < d; ch += NT) {
      const float v = gcis::ld(x, (long)ch * cols + j);
      c[step * g.dpad + ch] = v;
      cr[ch] = v;  // exact in T
    }
    __syncthreads();
  }

  // ---- Lloyd passes ------------------------------------------------------
  const int warp = tid >> 5, lane = tid & 31;
  for (int it = 0; it < iters; ++it) {
    for (int e = tid; e < k * g.dpad; e += NT) cr[e] = round_to<T>(c[e]);
    if (warp < k) {
      float s = 0.f;
      for (int ch = lane; ch < d; ch += 32) {
        const float v = c[warp * g.dpad + ch];
        s += v * v;
      }
      s = warp_sum(s);
      if (lane == 0) csq[warp] = s;
    }
    __syncthreads();
    sweep<T, LLOYD>(x, xs, cr, csq, dots, sc, oh, dm, 0, g, acc);
    exchange_sums(k);
    for (int e = tid; e < k * d; e += NT) {
      const int q = e / d, ch = e - q * d;
      const float cnt = tot[q * w + d];
      if (cnt > 0.f) c[q * g.dpad + ch] = tot[q * w + ch] / fmaxf(cnt, 1.f);
    }
    __syncthreads();
  }
  if (rank == 0)
    for (int e = tid; e < k * d; e += NT)
      centers[(long)b * k * d + e] = c[(e / d) * g.dpad + e % d];
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// The launch of B images over clusters of `ctas` CTAs: the kernel's
// attributes set, cfg filled (cfg.attrs points at attr). Returns the tile
// width, 0 when d does not fit.
template <typename T>
int configure(int B, int d, int ctas, cudaStream_t s, cudaLaunchConfig_t& cfg,
              cudaLaunchAttribute& attr, cudaError_t& err) {
  const int esize = sizeof(T);
  const int tp = tile_pixels(d, esize);
  if (tp == 0) {
    err = cudaErrorInvalidValue;
    return 0;
  }
  const size_t smem = smem_bytes(d, tp, esize);
  err = cudaFuncSetAttribute(coarse_centers_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && ctas > 8)
    err = cudaFuncSetAttribute(coarse_centers_kernel<T>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3(ctas, B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return tp;
}

template <typename T>
int launch(const void* xp, float* centers, float* dmin, int B, int rows, int cols, int d,
           int m, int k, int iters, int ctas, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err;
  const int tp = configure<T>(B, d, ctas, s, cfg, attr, err);
  if (err != cudaSuccess) return (int)err;
  const int aligned = ((size_t)xp % 16 == 0) && ((long)cols * sizeof(T) % 16 == 0);
  err = cudaLaunchKernelEx(&cfg, coarse_centers_kernel<T>, (const T*)xp, centers, dmin,
                           rows, cols, d, m, k, iters, tp, aligned);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int active(int d, int* out, cudaStream_t s) {
  for (int i = 0, ctas = 1; ctas <= MAX_CTAS; ++i, ctas *= 2) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t err;
    configure<T>(1, d, ctas, s, cfg, attr, err);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&out[i], (const void*)coarse_centers_kernel<T>,
                                           &cfg);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

// xp: (B, rows, cols) float32 or bfloat16 (bf16 != 0), features in rows
// [0, d) and pixels in columns [0, m). centers: (B, k, d) float32 out.
// dmin: (B, m) float32 scratch. ctas: CTAs per image, the cluster's size
// (1..16).
GCIS_API int gcis_coarse_centers(const void* xp, float* centers, float* dmin, int B,
                                 int rows, int cols, int d, int m, int k, int iters,
                                 int bf16, int ctas, void* stream) {
  if (k < 1 || k > KMAX || d < 1 || d > DMAX || d > rows || m > cols || m < 1 ||
      ctas < 1 || ctas > MAX_CTAS || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(xp, centers, dmin, B, rows, cols, d, m, k, iters,
                                      ctas, s)
              : launch<float>(xp, centers, dmin, B, rows, cols, d, m, k, iters, ctas, s);
}

// out: (5,) int32, the clusters of 1, 2, 4, 8 and 16 CTAs (the launch's
// shared memory at this d and dtype) that the card holds at once.
GCIS_API int gcis_coarse_active_clusters(int d, int bf16, int* out, void* stream) {
  if (d < 1 || d > DMAX) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? active<__nv_bfloat16>(d, out, s) : active<float>(d, out, s);
}
