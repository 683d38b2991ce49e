// K5: one Lloyd pass on the normalised (B, D, N) solver buffer, one launch.
//
// Replaces models/kmeans_pallas.py::_lloyd_t_kernel (wrapper _lloyd_t_pass),
// the pass behind the GMM's k-means init (kmeans_fused_t_xt -> _solve_t).
// Pixel x scores ||c||^2 - 2 round(c) . x for each of k <= 8 centres: the
// norm from the float32 centres, the cross term with the centres rounded
// to the storage type (as the TPU kernel's operands were). The first
// minimum wins; the pass writes int32 labels and, unless assign_only, the
// member sums and counts. The TPU kernel's ones-row (counts), padding of k
// to 8 sublanes and one-hot matmuls are gone.
//
// Bound on the H100: at the GMM fit grid (8 x 39 x 9600, 6 MB in bf16) a
// pass is bound by its bytes, 1.9 us (its ~2 k D flops a pixel take 0.5),
// and an empty launch alone takes about as long. What it costs is latency
// and per-pixel instructions on few SMs. The design keeps it to one launch
// over the whole card:
//   - `cpi` CTAs an image (the wrapper's plan: the SMs shared among the
//     images), each owning a contiguous range of the image's pixels, walk
//     it in tiles of tp pixels x D rows staged by cp.async in two buffers
//     (the next tile's copies in flight while the current one is scored).
//     A row's copies start at its 16-byte-aligned address and `shift`
//     holds the offset of its first pixel, so odd N (rows 2-byte aligned
//     in bf16) takes the same 16-byte copies; bytes past the buffer's end
//     are zero-filled;
//   - a tile is sized to the CTA's range (at most 1024 pixels, shared
//     memory permitting), so at the fit grid a CTA stages its pixels once;
//   - scores: a thread takes two pixels (tid and tid + 512; a warp none of
//     whose second pixels lies in the tile takes one), the rounded centres
//     transposed in shared memory (a row's k entries one or two 16-byte
//     broadcasts), K FMAs a row a pixel, K = k a template;
//   - sums: a warp takes 4 rows at a time, its lanes the tile's pixels,
//     each pixel's one-hot row formed once for the 4 rows (exact FMAs by 0
//     or 1), then a fixed butterfly a (row, cluster) and a float64 add into
//     the CTA's partial, in tile order; row D counts the members;
//   - the image's sums: each CTA writes its float64 partial to the
//     caller's scratch and counts itself done on the image's int counter
//     (one acquire-release add: two __threadfence()s cost more than the
//     reduction); the last CTA adds all the partials in CTA order, rounds
//     once and resets the counter for the next launch. No float atomics,
//     no second launch: two launches give the same bits. A thread-block
//     cluster an image, its partials added over distributed shared memory
//     (K3's form), would hold batch 8 to 64 SMs: the card co-schedules 7
//     clusters of 16 CTAs, and per-pixel work, not the reduction, costs.
//
// Any D: past RB = 512 rows a tile's rows no longer fit shared memory, so
// they are staged in blocks of at most 128 rows through the same two
// buffers. The scores' accumulators stay in registers across the blocks
// (the blocks' centres restaged with them); once the labels are known the
// blocks are staged again for the sums, and the CTA's float64 partial,
// too large for shared memory, is kept in its slot of the scratch (each
// entry read and written by one thread, tile after tile). Up to RB rows
// (every path of the pipeline) a tile is one block, staged once.

#include "common.cuh"

namespace {

using gcis::count_done;
using gcis::cp_wait;
using gcis::round_to;
using gcis::row_bytes;
using gcis::warp_sum;

constexpr int NT = 512;
constexpr int KMAX = 8;
constexpr int RG = 4;                  // rows a warp sums at once
constexpr int RB = 512;                // rows a tile stages in one block at the most
constexpr int RB_WIDE = 128;           // rows a staged block past RB, at the most
constexpr int SMEM_MAX = 220 * 1024;

// Rows a staged block: D up to RB; past it D split into blocks of at most
// RB_WIDE rows, as even as can be (short blocks leave room for wide tiles).
__host__ __device__ inline int block_rows(int d) {
  if (d <= RB) return d;
  const int nb = (d + RB_WIDE - 1) / RB_WIDE;
  return (d + nb - 1) / nb;
}

// Shared memory: two buffers of a block's rows, the block's centres (rb x 8
// floats), the CTA's float64 partial (KMAX x (D + 1)) unless D > RB, the
// norms, the tile's labels and the rows' shifts.
inline size_t smem_bytes(int d, int tp, int esize) {
  const int rb = block_rows(d);
  return 2 * (size_t)rb * row_bytes(tp, esize) + sizeof(float) * 8 * rb +
         (d > RB ? 0 : sizeof(double) * KMAX * (d + 1)) + sizeof(float) * KMAX +
         sizeof(int) * (tp + 2 * rb);
}

// Pixels a tile: a multiple of 32, at most 1024 and the CTA's range `per`
// rounded up, the widest whose shared memory fits (0 when none does).
int tile_pixels(int d, int esize, int per) {
  for (int tp = min(2 * NT, (per + 31) / 32 * 32); tp >= 32; tp -= 32)
    if (smem_bytes(d, tp, esize) <= SMEM_MAX) return tp;
  return 0;
}

// Add the cross terms round(c_q) . x of the `rows` staged rows to a[h][q],
// for the P pixels px[] of the tile, a row at a time.
template <typename T, int K, int P>
__device__ __forceinline__ void score_rows(const char* buf, const int* sh, const float* ct,
                                           int rows, int rs, const int (&px)[P],
                                           float (&a)[2][K]) {
#pragma unroll 2
  for (int ch = 0; ch < rows; ++ch) {
    const T* row = reinterpret_cast<const T*>(buf + ch * rs) + sh[ch];
    float v[P];
#pragma unroll
    for (int h = 0; h < P; ++h) v[h] = gcis::ld(row, px[h]);
    const float4 c0 = *reinterpret_cast<const float4*>(ct + 8 * ch);
    float c[8] = {c0.x, c0.y, c0.z, c0.w, 0.f, 0.f, 0.f, 0.f};
    if (K > 4) {
      const float4 c1 = *reinterpret_cast<const float4*>(ct + 8 * ch + 4);
      c[4] = c1.x;
      c[5] = c1.y;
      c[6] = c1.z;
      c[7] = c1.w;
    }
#pragma unroll
    for (int q = 0; q < K; ++q)
#pragma unroll
      for (int h = 0; h < P; ++h) a[h][q] = fmaf(c[q], v[h], a[h][q]);
  }
}

// The first minimum of csq[q] - 2 a[q] over the K centres.
template <int K>
__device__ __forceinline__ int first_min(const float* csq, const float (&a)[K]) {
  float bs = csq[0] - 2.f * a[0];
  int best = 0;
#pragma unroll
  for (int q = 1; q < K; ++q) {
    const float sc = csq[q] - 2.f * a[q];
    if (sc < bs) {
      bs = sc;
      best = q;
    }
  }
  return best;
}

// WIDE: D > RB, the rows staged in blocks and the partial in the scratch (a
// template, so that up to RB rows the partial's adds stay shared-memory
// operations and a tile's one job takes no job arithmetic).
template <typename T, int K, bool WIDE>
__global__ void __launch_bounds__(NT) lloyd_t_kernel(
    const T* __restrict__ x, const float* __restrict__ centers, int* __restrict__ labels,
    float* __restrict__ sums, double* __restrict__ partial, unsigned* __restrict__ counters,
    int D, int N, int tp, int assign_only, long total) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int last;
  const int rank = blockIdx.x, ctas = gridDim.x;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rs = row_bytes(tp, sizeof(T)), w = D + 1;
  const int rb = WIDE ? block_rows(D) : D, nrb = WIDE ? (D + rb - 1) / rb : 1;
  char* xs = smem;                                                // 2 x rb x rs
  float* ct = reinterpret_cast<float*>(xs + 2 * rb * rs);         // (rb, 8) rounded centres
  double* spart = reinterpret_cast<double*>(ct + 8 * rb);         // (KMAX, D + 1) unless WIDE
  float* csq = reinterpret_cast<float*>(spart + (WIDE ? 0 : KMAX * w));  // (KMAX,)
  int* lab = reinterpret_cast<int*>(csq + KMAX);                  // (tp,)
  int* shift = lab + tp;                                          // (2, rb)
  const long n = N;
  const T* xb = x + (long)b * D * n;
  const float* cb = centers + (long)b * K * D;
  const char* end = reinterpret_cast<const char*>(x + total);
  // this CTA's slot of the scratch, and where its partial is summed
  double* mine = assign_only ? nullptr : partial + ((long)b * ctas + rank) * K * w;
  double* part = WIDE ? mine : spart;

  const int per = (N + ctas - 1) / ctas;
  const int lo = min(N, rank * per), hi = min(N, lo + per);
  const int ntiles = (hi - lo + tp - 1) / tp;
  // a tile's jobs: its row blocks scored, then (WIDE, with sums) summed;
  // a tile of one block is summed from it as soon as it is scored
  const int jobs = WIDE && !assign_only ? 2 * nrb : nrb;
  auto stage_job = [&](int j) {
    const int base = lo + (j / jobs) * tp, r0 = (j % jobs % nrb) * rb;
    gcis::stage_rows<T, NT>(xb + r0 * n, xs + (j & 1) * rb * rs, shift + (j & 1) * rb, n,
                            min(rb, D - r0), base, min(tp, hi - base), rs, end);
  };
  if (ntiles > 0) stage_job(0);

  auto load_centres = [&](int r0, int rows) {
    for (int e = tid; e < 8 * rows; e += NT) {
      const int ch = e >> 3, q = e & 7;
      ct[e] = q < K ? round_to<T>(cb[q * D + r0 + ch]) : 0.f;
    }
  };
  if (!WIDE) load_centres(0, D);
  if (warp < K) {
    float s = 0.f;
    for (int ch = lane; ch < D; ch += 32) s = fmaf(cb[warp * D + ch], cb[warp * D + ch], s);
    s = warp_sum(s);
    if (lane == 0) csq[warp] = s;
  }
  if (!assign_only)
    for (int e = tid; e < K * w; e += NT) part[e] = 0.0;

  float a[2][K];
  for (int j = 0; j < ntiles * jobs; ++j) {
    const int i = j % jobs, base = lo + (j / jobs) * tp, nv = min(tp, hi - base);
    const int r0 = (i % nrb) * rb, rows = min(rb, D - r0);
    if (j + 1 < ntiles * jobs) {
      stage_job(j + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    if (WIDE && i < nrb) load_centres(r0, rows);
    __syncthreads();
    const char* buf = xs + (j & 1) * rb * rs;
    const int* sh = shift + (j & 1) * rb;

    if (i < nrb) {
      // scores of pixels tid and tid + NT: a warp none of whose second
      // pixels lies in the tile scores one (a pixel past the tile is
      // clamped into it and its label dropped)
      if (i == 0) {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int q = 0; q < K; ++q) a[h][q] = 0.f;
      }
      const bool two = warp * 32 + NT < nv;
      if (two) {
        const int px[2] = {min(tid, nv - 1), min(tid + NT, nv - 1)};
        score_rows<T, K, 2>(buf, sh, ct, rows, rs, px, a);
      } else {
        const int px[1] = {min(tid, nv - 1)};
        score_rows<T, K, 1>(buf, sh, ct, rows, rs, px, a);
      }
      if (i == nrb - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if ((h == 0 || two) && tid + h * NT < nv) {
            const int l = first_min<K>(csq, a[h]);
            labels[(long)b * n + base + tid + h * NT] = l;
            lab[tid + h * NT] = l;
          }
        }
      }
      __syncthreads();
    }

    // member sums of the block's rows [r0, r0 + rows), the counts after the
    // last block's: a warp takes RG rows at a time, lanes over the tile's
    // pixels, then a butterfly a (row, cluster) into the partial
    if (!assign_only && (!WIDE || i >= nrb)) {
      const int nr = rows + (r0 + rows == D ? 1 : 0);  // the count row after row D - 1
      for (int g = warp * RG; g < nr; g += (NT / 32) * RG) {
        const T* rp[RG];
#pragma unroll
        for (int u = 0; u < RG; ++u)
          rp[u] = g + u < rows ? reinterpret_cast<const T*>(buf + (g + u) * rs) + sh[g + u]
                               : nullptr;
        float acc[RG][K];
#pragma unroll
        for (int u = 0; u < RG; ++u)
#pragma unroll
          for (int q = 0; q < K; ++q) acc[u][q] = 0.f;
        for (int p = lane; p < nv; p += 32) {
          const int l = lab[p];
          float oh[K];
#pragma unroll
          for (int q = 0; q < K; ++q) oh[q] = l == q ? 1.f : 0.f;
#pragma unroll
          for (int u = 0; u < RG; ++u) {
            const float v = rp[u] ? gcis::ld(rp[u], p) : 1.f;
#pragma unroll
            for (int q = 0; q < K; ++q) acc[u][q] = fmaf(oh[q], v, acc[u][q]);
          }
        }
#pragma unroll
        for (int u = 0; u < RG; ++u) {
#pragma unroll
          for (int q = 0; q < K; ++q) {
            const float s = warp_sum(acc[u][q]);
            if (lane == 0 && g + u < nr) part[q * w + r0 + g + u] += (double)s;
          }
        }
      }
      __syncthreads();  // the buffer, its shifts and lab are rewritten next
    }
  }
  if (assign_only) return;

  // the image's sums: every CTA's partial in the scratch, and the last CTA
  // to finish adds them in CTA order
  if (!WIDE)
    for (int e = tid; e < K * w; e += NT) mine[e] = part[e];
  // one acquire-release add orders every thread's partial (ordered before it
  // by the barrier) before the count, and the last CTA's reads after it
  __syncthreads();
  if (tid == 0) last = count_done(counters + b) == (unsigned)ctas - 1;
  __syncthreads();
  if (!last) return;
  const double* all = partial + (long)b * ctas * K * w;
  float* out = sums + (long)b * K * w;
  for (int e = tid; e < K * w; e += NT) {
    double s = 0.0;
#pragma unroll 16
    for (int r = 0; r < ctas; ++r) s += __ldcg(all + (long)r * K * w + e);
    out[e] = (float)s;
  }
  if (tid == 0) counters[b] = 0u;  // every CTA of the image has counted
}

template <typename T, int K>
int launch(const void* x, const float* centers, int* labels, float* sums, double* partial,
           unsigned* counters, int B, int D, int N, int assign_only, int cpi, cudaStream_t s) {
  const int tp = tile_pixels(D, sizeof(T), (N + cpi - 1) / cpi);
  if (tp == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(D, tp, sizeof(T));
  auto kernel = D > RB ? lloyd_t_kernel<T, K, true> : lloyd_t_kernel<T, K, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(cpi, B), NT, smem, s>>>((const T*)x, centers, labels, sums, partial, counters, D,
                                        N, tp, assign_only, (long)B * D * N);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_k(const void* x, const float* centers, int* labels, float* sums, double* partial,
             unsigned* counters, int B, int D, int N, int k, int assign_only, int cpi,
             cudaStream_t s) {
#define GCIS_K5(KK) \
  launch<T, KK>(x, centers, labels, sums, partial, counters, B, D, N, assign_only, cpi, s)
  switch (k) {
    case 1: return GCIS_K5(1);
    case 2: return GCIS_K5(2);
    case 3: return GCIS_K5(3);
    case 4: return GCIS_K5(4);
    case 5: return GCIS_K5(5);
    case 6: return GCIS_K5(6);
    case 7: return GCIS_K5(7);
    default: return GCIS_K5(8);
  }
#undef GCIS_K5
}

}  // namespace

// x: (B, D, N) float32 or bfloat16 (bf16 != 0). centers: (B, k, D) float32.
// labels: (B, N) int32 out. sums: (B, k, D + 1) float32 out, column D =
// member counts. partial: (B, cpi, k, D + 1) float64 scratch; counters: (B,)
// uint32, 0 on entry and left 0. cpi: CTAs an image. sums, partial and
// counters are untouched when assign_only != 0. Launches on one stream at a
// time may share counters.
GCIS_API int gcis_lloyd_t(const void* x, const float* centers, int* labels, float* sums,
                          double* partial, unsigned* counters, int B, int D, int N, int k,
                          int bf16, int assign_only, int cpi, void* stream) {
  if (k < 1 || k > KMAX || D < 1 || N < 1 || B < 1 || B > 65535 || cpi < 1 || cpi > N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch_k<__nv_bfloat16>(x, centers, labels, sums, partial, counters, B, D, N,
                                        k, assign_only, cpi, s)
              : launch_k<float>(x, centers, labels, sums, partial, counters, B, D, N, k,
                                assign_only, cpi, s);
}
