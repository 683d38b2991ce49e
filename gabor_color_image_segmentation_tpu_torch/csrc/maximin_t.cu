// K6: one farthest-point (maximin) step on the normalised (B, D, N) solver
// buffer, one launch.
//
// Replaces models/kmeans_pallas.py::_maximin_kernel (wrapper _maximin_pass),
// the seeding of the GMM's k-means init (_maximin_init_t_fused). For probe p
// (float32), in the TPU kernel's expanded form:
//
//   d2(x)  = ||x||^2 - 2 round(p) . x + ||p||^2   (round: to the storage type)
//   dmin   = d2 on a reset step, else min(dmin, d2)      (updated in place)
//   next   = column of x at the first flat index of max(dmin)
//
// The TPU buffer's ones-row added 1 - 2 + 1 = 0 to d2 and is left out. The
// TPU kernel wrote a (max, one-hot column) per block and left the choice
// among blocks to XLA; here the last CTA of each image makes it.
//
// Bound on the H100: at the GMM fit grid (8 x 39 x 9600) a step reads 6 MB
// (bf16) and reads and writes dmin, 2.0 us at 3.35 TB/s; its ~4 D flops a
// pixel take 0.2 us. An empty launch alone takes about 1.8 us, so the step
// is bound by latency: one launch, every load of a CTA in flight at once,
// one reduction across CTAs. The design:
//   - `cpi` CTAs an image (the wrapper's plan: the SMs shared among the
//     images), each owning a contiguous range of the image's pixels, walk
//     it in tiles of tp pixels x rb rows staged by cp.async in two buffers
//     (the next job's copies in flight while the current one is summed).
//     Each row's copies start at its 16-byte-aligned address (odd N) and
//     bytes past the buffer's end are zero-filled (common.cuh);
//   - a tile is as wide as the CTA's range (at most 1024 pixels), so at the
//     fit grid a CTA stages its pixels once, with all its copies issued
//     before the first is waited for; rb is as many rows as shared memory
//     then holds, at most 256 (any D: past them a tile's rows come in
//     blocks, each block's rounded probe staged with its rows, and a
//     block's sums ||x||^2 and round(p) . x are added to the pixel's
//     totals in registers: a float32 sum run down 10,241 rows in one
//     chain strayed past 1e-5 of the largest distance from the plain
//     version, blocks of <= 256 rows stay well inside it);
//   - a thread takes pixels tid and tid + 512 of a tile, its dmin loaded
//     with the tile's first block; ||p||^2 is one fixed-order warp sum;
//   - each CTA reduces to one (max, first index) pair (larger value, then
//     smaller index: any order gives the first index of the maximum),
//     stores it and counts itself done on the image's int counter (one
//     acquire-release add); the last CTA picks the winner among the pairs,
//     copies the winning column into `best` and resets the counter for the
//     next launch. No float atomics: two launches give the same bits.

#include "common.cuh"

namespace {

using gcis::ArgMax;
using gcis::better;
using gcis::block_argmax;
using gcis::count_done;
using gcis::cp_wait;
using gcis::neg_inf;
using gcis::round_to;
using gcis::row_bytes;
using gcis::warp_argmax;
using gcis::warp_sum;

constexpr int NT = 512;
constexpr int RB_MAX = 256;  // rows a staged block at the most
constexpr int SMEM_MAX = 220 * 1024;

// Shared memory a staged row takes in each of the two buffers: its bytes,
// its rounded probe value and its shift.
inline int row_cost(int tp, int esize) {
  return 2 * (row_bytes(tp, esize) + (int)sizeof(float) + (int)sizeof(int));
}

// Pixels a tile: the CTA's range `per` rounded up to 32, at most 2 NT.
inline int tile_pixels(int per) { return min(2 * NT, (per + 31) / 32 * 32); }

// Rows a staged block: as many as shared memory holds at tp pixels, at most
// RB_MAX, D split into blocks as even as can be.
inline int block_rows(int d, int tp, int esize) {
  const int fit = min(RB_MAX, SMEM_MAX / row_cost(tp, esize));
  const int nb = (d + fit - 1) / fit;
  return (d + nb - 1) / nb;
}

// ||x||^2 and round(p) . x of the `rows` staged rows into sq[h], cr[h] for
// the P pixels px[] of the tile, a row at a time.
template <typename T, int P>
__device__ __forceinline__ void sum_rows(const char* buf, const int* sh, const float* pr,
                                         int rows, int rs, const int (&px)[P], float (&sq)[2],
                                         float (&cr)[2]) {
#pragma unroll
  for (int h = 0; h < P; ++h) sq[h] = cr[h] = 0.f;
#pragma unroll 4
  for (int ch = 0; ch < rows; ++ch) {
    const T* row = reinterpret_cast<const T*>(buf + ch * rs) + sh[ch];
    const float pv = pr[ch];
#pragma unroll
    for (int h = 0; h < P; ++h) {
      const float v = gcis::ld(row, px[h]);
      sq[h] += v * v;
      cr[h] += pv * v;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) maximin_t_kernel(
    const T* __restrict__ x, const float* __restrict__ probe, float* __restrict__ dmin,
    float* __restrict__ bestv, int* __restrict__ besti, float* __restrict__ best,
    unsigned* __restrict__ counters, int D, int N, int tp, int rb, int reset, long total) {
  extern __shared__ __align__(16) char smem[];
  __shared__ ArgMax scratch[32];
  __shared__ float psq;
  __shared__ int last, win;
  const int rank = blockIdx.x, ctas = gridDim.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = row_bytes(tp, sizeof(T)), nrb = (D + rb - 1) / rb;
  char* xs = smem;                                          // 2 x rb x rs
  float* pr = reinterpret_cast<float*>(xs + 2 * rb * rs);   // (2, rb) rounded probe
  int* shift = reinterpret_cast<int*>(pr + 2 * rb);         // (2, rb)
  const long n = N;
  const T* xb = x + (long)b * D * n;
  const float* pb = probe + (long)b * D;
  float* db = dmin + (long)b * n;
  const char* end = reinterpret_cast<const char*>(x + total);

  const int per = (N + ctas - 1) / ctas;
  const int lo = min(N, rank * per), hi = min(N, lo + per);
  const int jobs = (hi - lo + tp - 1) / tp * nrb;  // (tile, row block), row blocks inner
  // the rows' copies first: the probe's loads would hold them back
  auto stage_job = [&](int j) {
    const int base = lo + (j / nrb) * tp, r0 = (j % nrb) * rb, rows = min(rb, D - r0);
    gcis::stage_rows<T, NT>(xb + r0 * n, xs + (j & 1) * rb * rs, shift + (j & 1) * rb, n,
                            rows, base, min(tp, hi - base), rs, end);
    float* p = pr + (j & 1) * rb;
    for (int e = tid; e < rows; e += NT) p[e] = round_to<T>(pb[r0 + e]);
  };
  ArgMax m{neg_inf(), INT_MAX};
  float sq[2], cr[2], old[2] = {0.f, 0.f};  // a pixel's totals over the blocks, its dmin
  float bsq[2], bcr[2];                     // its sums over one block
  // a tile's dmin, loaded with its first block; the first tile's before
  // anything else, so that its loads, the copies and the probe's loads are
  // in flight together
  auto load_old = [&](int base) {
    const int nv = min(tp, hi - base);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (!reset && tid + h * NT < nv) old[h] = db[base + tid + h * NT];
  };
  if (jobs > 0) {
    load_old(lo);
    stage_job(0);
  }
  if (warp == 0) {
    float s = 0.f;
    for (int ch = lane; ch < D; ch += 32) s = fmaf(pb[ch], pb[ch], s);
    s = warp_sum(s);
    if (lane == 0) psq = s;
  }

  for (int j = 0; j < jobs; ++j) {
    const int i = j % nrb, base = lo + (j / nrb) * tp, nv = min(tp, hi - base);
    if (i == 0 && j > 0) load_old(base);
    cp_wait<0>();
    // job j's rows and probe are in; every thread is done with job j - 1,
    // whose buffers job j + 1 takes
    __syncthreads();
    if (j + 1 < jobs) stage_job(j + 1);
    const char* buf = xs + (j & 1) * rb * rs;
    const int* sh = shift + (j & 1) * rb;
    const int rows = min(rb, D - i * rb);
    // a pixel past the tile is clamped into it and dropped below
    if (warp * 32 + NT < nv) {
      const int px[2] = {tid, min(tid + NT, nv - 1)};
      sum_rows<T, 2>(buf, sh, pr + (j & 1) * rb, rows, rs, px, bsq, bcr);
    } else {
      const int px[1] = {min(tid, nv - 1)};
      sum_rows<T, 1>(buf, sh, pr + (j & 1) * rb, rows, rs, px, bsq, bcr);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // up to rb rows the block's sums are the totals
      sq[h] = i == 0 ? bsq[h] : sq[h] + bsq[h];
      cr[h] = i == 0 ? bcr[h] : cr[h] + bcr[h];
    }
    if (i == nrb - 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = tid + h * NT;
        if (p < nv) {
          const float d2 = sq[h] - 2.f * cr[h] + psq;
          const float dm = reset ? d2 : fminf(old[h], d2);
          db[base + p] = dm;
          m = better(m, ArgMax{dm, base + p});
        }
      }
    }
  }

  // the CTA's pair, and the last CTA of the image picks among the pairs
  m = block_argmax(m, scratch);
  if (tid == 0) {
    bestv[(long)b * ctas + rank] = m.v;
    besti[(long)b * ctas + rank] = m.i;
    last = count_done(counters + b) == (unsigned)ctas - 1;
  }
  __syncthreads();
  if (!last) return;
  if (warp == 0) {
    ArgMax w{neg_inf(), INT_MAX};
    for (int r = lane; r < ctas; r += 32)
      w = better(w, ArgMax{__ldcg(bestv + (long)b * ctas + r), __ldcg(besti + (long)b * ctas + r)});
    w = warp_argmax(w);
    if (lane == 0) {
      win = w.i == INT_MAX ? 0 : w.i;  // all-NaN distances: pixel 0
      counters[b] = 0u;                 // every CTA of the image has counted
    }
  }
  __syncthreads();
  for (int ch = tid; ch < D; ch += NT) best[(long)b * D + ch] = gcis::ld(xb, ch * n + win);
}

template <typename T>
int launch(const void* x, const float* probe, float* dmin, float* bestv, int* besti,
           float* best, unsigned* counters, int B, int D, int N, int reset, int cpi,
           cudaStream_t s) {
  const int tp = tile_pixels((N + cpi - 1) / cpi), rb = block_rows(D, tp, sizeof(T));
  const size_t smem = (size_t)rb * row_cost(tp, sizeof(T));
  cudaError_t err = cudaFuncSetAttribute(maximin_t_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  maximin_t_kernel<T><<<dim3(cpi, B), NT, smem, s>>>((const T*)x, probe, dmin, bestv, besti,
                                                     best, counters, D, N, tp, rb, reset,
                                                     (long)B * D * N);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, D, N) float32 or bfloat16 (bf16 != 0). probe: (B, D) float32.
// dmin: (B, N) float32, read unless reset, always written. bestv/besti:
// (B, cpi) scratch, a CTA's (max, first index). best: (B, D) float32, the
// column at the argmax of the new dmin. counters: (B,) uint32, 0 on entry
// and left 0. cpi: CTAs an image. Launches on one stream at a time may share
// counters.
GCIS_API int gcis_maximin_t(const void* x, const float* probe, float* dmin, float* bestv,
                            int* besti, float* best, unsigned* counters, int B, int D, int N,
                            int bf16, int reset, int cpi, void* stream) {
  if (D < 1 || N < 1 || B < 1 || B > 65535 || cpi < 1 || cpi > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, probe, dmin, bestv, besti, best, counters, B, D, N,
                                      reset, cpi, s)
              : launch<float>(x, probe, dmin, bestv, besti, best, counters, B, D, N, reset,
                              cpi, s);
}
