// K7: one Lloyd pass on a row-major (B, N, D) feature buffer.
//
// Replaces models/kmeans_pallas.py::_lloyd_kernel (wrapper _lloyd_pass), the
// pass behind the reference's kmeans_fused, its drop-in for a vmapped
// kmeans. Pixel x scores ||c||^2 - 2 round(c) . x for each of k <= 8
// centres: the norm from the float32 centres, the cross term with the
// centres rounded to the storage type, as the TPU kernel's operands were
// and as models/kmeans.py::_assign does. The first minimum wins; the pass
// writes int32 labels, the member sums and the counts.
//
// The TPU kernel padded D with a ones column (the member count) to a
// multiple of 128 lanes and k to 8 sublanes; here the counts are counted,
// D is read as it is and k is the number of centres.
//
// Layout: a warp takes one pixel at a time, its lanes across the D values
// of the row (coalesced; a thread per row would read 243 bf16 values 486
// bytes apart); the row is held in registers (16 per lane, D <= 512), each
// lane forms its part of the k dot products, and a butterfly over the lanes
// gives every lane the same k totals. A block of 8 warps takes 1,024
// consecutive pixels, 128 per warp in order.
//
// Sums without float atomics, as in K2 and K5: each warp adds the rows of
// its pixels to its own (k, D + 1) table in shared memory (column D counts),
// the block adds its warps' tables in warp order into its partial, and a
// second launch adds the partials in block order (common.cuh).
//
// Bound on the H100: bytes, one read of the buffer (config1's standardised
// features, 16 x 154,401 x 243 bf16: 1.2 GB, 0.36 ms at 3.35 TB/s); the
// operations (2 k D + D per pixel, 6.6 GFLOP) take 0.10 ms at the float32
// rate. A warp's row is a chain of dependent steps (loads, the butterfly,
// the table update), so the design relies on ~40 warps per SM to keep
// enough loads in flight.
//
// Past DMAX rows (lloyd_rows_wide_kernel) neither the row nor the per-warp
// tables fit, so a block of 128 pixels works in two steps. It labels its
// pixels, a warp a pixel, each lane's dot products accumulated over the
// row in chunks of JMAX values a lane, the centres rounded as they are read
// (through L1), the same butterfly and first-minimum rule, the labels kept
// in shared memory. Then its threads own columns of the row (and the count
// column D), walk the block's pixels in order and add each value into the
// owning thread's k sums (loads coalesced along the row), written once to
// the block's partial. The partials are added in block order as above. A
// simple kernel: the second step reads the block's rows again.

#include "common.cuh"

namespace {

using gcis::ld;
using gcis::round_to;
using gcis::warp_sum;

constexpr int NT = 256;
constexpr int NW = NT / 32;
constexpr int ROWS = 128;  // pixels per warp
constexpr int KMAX = 8;
constexpr int JMAX = 16;  // row values per lane
constexpr int DMAX = 32 * JMAX;
constexpr int ROWS_WIDE = 128;  // pixels per block past DMAX rows

template <typename T>
__global__ void __launch_bounds__(NT) lloyd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ centers, int* __restrict__ labels,
    float* __restrict__ partial, int D, int N, int k) {
  extern __shared__ float smem[];
  float* c = smem;               // (k, D) centres rounded to T
  float* csq = c + k * D;        // (KMAX,) norms of the float32 centres
  float* tab = csq + KMAX;       // (NW, k, D + 1) per-warp sums, column D counts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const int width = k * (D + 1);
  const float* cb = centers + (long)b * k * D;

  for (int e = tid; e < k * D; e += NT) c[e] = round_to<T>(cb[e]);
  if (tid < k) {
    float s = 0.f;
    for (int ch = 0; ch < D; ++ch) s += cb[tid * D + ch] * cb[tid * D + ch];
    csq[tid] = s;
  }
  float* mine = tab + warp * width;
  for (int e = lane; e < width; e += 32) mine[e] = 0.f;
  __syncthreads();

  const T* xb = x + (long)b * N * D;
  const long p0 = (long)blk * NW * ROWS + (long)warp * ROWS;
  for (int r = 0; r < ROWS; ++r) {
    const long p = p0 + r;
    if (p >= N) break;  // the whole warp
    const T* row = xb + p * D;
    float v[JMAX];
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int ch = lane + 32 * j;
      v[j] = ch < D ? ld(row, ch) : 0.f;
    }
    float dot[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) {
      dot[q] = 0.f;
      if (q < k) {
#pragma unroll
        for (int j = 0; j < JMAX; ++j) {
          const int ch = lane + 32 * j;
          if (ch < D) dot[q] += c[q * D + ch] * v[j];
        }
        dot[q] = warp_sum(dot[q]);  // the same bits on every lane
      }
    }
    int best = 0;
    float bs = csq[0] - 2.f * dot[0];
#pragma unroll
    for (int q = 1; q < KMAX; ++q) {
      if (q < k) {
        const float sc = csq[q] - 2.f * dot[q];
        if (sc < bs) {
          bs = sc;
          best = q;
        }
      }
    }
    float* acc = mine + best * (D + 1);
#pragma unroll
    for (int j = 0; j < JMAX; ++j) {
      const int ch = lane + 32 * j;
      if (ch < D) acc[ch] += v[j];
    }
    if (lane == 0) {
      acc[D] += 1.f;
      labels[(long)b * N + p] = best;
    }
  }
  __syncthreads();

  float* out = partial + ((long)b * nblk + blk) * width;
  for (int e = tid; e < width; e += NT) {
    float s = 0.f;
    for (int w = 0; w < NW; ++w) s += tab[w * width + e];
    out[e] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) lloyd_rows_wide_kernel(
    const T* __restrict__ x, const float* __restrict__ centers, int* __restrict__ labels,
    float* __restrict__ partial, int D, int N, int k) {
  __shared__ float csq[KMAX];  // norms of the float32 centres
  __shared__ int lab[ROWS_WIDE];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  const float* cb = centers + (long)b * k * D;
  if (warp < k) {
    float s = 0.f;
    for (int ch = lane; ch < D; ch += 32) s = fmaf(cb[warp * D + ch], cb[warp * D + ch], s);
    s = warp_sum(s);
    if (lane == 0) csq[warp] = s;
  }
  __syncthreads();

  const T* xb = x + ((long)b * N + (long)blk * ROWS_WIDE) * D;  // the block's first row
  const int nv = (int)min((long)ROWS_WIDE, (long)N - (long)blk * ROWS_WIDE);
  for (int r = warp; r < nv; r += NW) {
    const T* row = xb + (long)r * D;
    float dot[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) dot[q] = 0.f;
    for (int c0 = 0; c0 < D; c0 += DMAX) {
      float v[JMAX];
#pragma unroll
      for (int j = 0; j < JMAX; ++j) {
        const int ch = c0 + lane + 32 * j;
        v[j] = ch < D ? ld(row, ch) : 0.f;
      }
#pragma unroll
      for (int q = 0; q < KMAX; ++q) {
        if (q < k) {
#pragma unroll
          for (int j = 0; j < JMAX; ++j) {
            const int ch = c0 + lane + 32 * j;
            if (ch < D) dot[q] += round_to<T>(__ldg(cb + q * D + ch)) * v[j];
          }
        }
      }
    }
    int best = 0;
    float bs = csq[0] - 2.f * warp_sum(dot[0]);
#pragma unroll
    for (int q = 1; q < KMAX; ++q) {
      if (q < k) {
        const float sc = csq[q] - 2.f * warp_sum(dot[q]);
        if (sc < bs) {
          bs = sc;
          best = q;
        }
      }
    }
    if (lane == 0) {
      lab[r] = best;
      labels[(long)b * N + (long)blk * ROWS_WIDE + r] = best;
    }
  }
  __syncthreads();

  float* out = partial + ((long)b * nblk + blk) * k * (D + 1);
  for (int col = tid; col <= D; col += NT) {
    float acc[KMAX];
#pragma unroll
    for (int q = 0; q < KMAX; ++q) acc[q] = 0.f;
#pragma unroll 8
    for (int r = 0; r < nv; ++r) {
      const int l = lab[r];
      const float v = col < D ? ld(xb, (long)r * D + col) : 1.f;
#pragma unroll
      for (int q = 0; q < KMAX; ++q) acc[q] += l == q ? v : 0.f;
    }
#pragma unroll
    for (int q = 0; q < KMAX; ++q)
      if (q < k) out[q * (D + 1) + col] = acc[q];
  }
}

template <typename T>
int launch_wide(const void* x, const float* centers, int* labels, float* partial, float* sums,
                int B, int D, int N, int k, cudaStream_t s) {
  const int nblk = (N + ROWS_WIDE - 1) / ROWS_WIDE;
  lloyd_rows_wide_kernel<T><<<dim3(nblk, B), NT, 0, s>>>((const T*)x, centers, labels,
                                                         partial, D, N, k);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gcis::block_order_sum(partial, sums, B, nblk, k * (D + 1), s);
}

template <typename T>
int launch(const void* x, const float* centers, int* labels, float* partial, float* sums,
           int B, int D, int N, int k, cudaStream_t s) {
  if (D > DMAX) return launch_wide<T>(x, centers, labels, partial, sums, B, D, N, k, s);
  const size_t smem = ((size_t)k * D + KMAX + (size_t)NW * k * (D + 1)) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      lloyd_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nblk = (N + NW * ROWS - 1) / (NW * ROWS);
  lloyd_rows_kernel<T><<<dim3(nblk, B), NT, smem, s>>>((const T*)x, centers, labels,
                                                      partial, D, N, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)gcis::block_order_sum(partial, sums, B, nblk, k * (D + 1), s);
}

}  // namespace

// x: (B, N, D) float32 or bfloat16 (bf16 != 0), row-major. centers: (B, k, D)
// float32. labels: (B, N) int32 out. partial: (B, ceil(N / 1024), k, D + 1)
// float32 scratch up to 512 rows, (B, ceil(N / 128), k, D + 1) past them;
// sums: (B, k, D + 1) float32 out, column D the counts.
GCIS_API int gcis_lloyd_rows(const void* x, const float* centers, int* labels,
                             float* partial, float* sums, int B, int D, int N, int k,
                             int bf16, void* stream) {
  if (k < 1 || k > KMAX || D < 1 || N < 1 || B < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, centers, labels, partial, sums, B, D, N, k, s)
              : launch<float>(x, centers, labels, partial, sums, B, D, N, k, s);
}
