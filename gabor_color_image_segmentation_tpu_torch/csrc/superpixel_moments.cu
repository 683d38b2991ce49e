// K16, K17, K18: per-superpixel feature sums and member counts.
//
// Replaces models/graph_pallas.py::_moments_kernel (K16, row-major input),
// ::_moments_t_kernel (K17, transposed input) and ::_moments_nhwc_kernel
// (K18, row-major input with pad-only staging): three TPU layouts of one
// segmented sum,
//
//   sums[b, s, c] = sum over pixels p with labels[b, p] == s of x[b, c, p]
//   counts[b, s]  = the number of those pixels,
//
// which the TPU kernels computed as a one-hot (S x chunk) matmul per pixel
// chunk. Labels outside [0, S) add to no bucket. Here one kernel reads the
// features through a channel stride and a pixel stride, so it takes the
// channel-major (B, D, N) buffer of the graph stage and the row-major
// (B, N, D) layout alike, in float32 or bfloat16. Any S >= 1.
//
// Sums are taken in float64 and rounded once to float32, as the plain
// version does: in bfloat16 the float64 sums of 8-bit mantissas are exact,
// so any order of addition gives the same bits, and in float32 two orders
// agree after the rounding to within one ulp. The graph stage's n-cut turns
// ulp-level differences in the means into whole superpixels changing
// region, so the bits matter. No float atomics: two launches on the same
// input give the same bits.
//
// Bound on the H100: bytes, one read of the features and the labels
// (config3 bf16: 8 x 39 x 154,401 x 2 + 8 x 154,401 x 4 bytes = 101 MB,
// 0.030 ms at 3.35 TB/s). The design below runs about ten times that on an
// H100 80GB HBM3 at 700 W (PERF.md, chip_smoke.py): each 32-pixel step of
// a warp is a dependent chain of up to five shuffle rounds of five float64
// values, and the tiles' loads wait at the block's barriers.
//
// Design: two launches.
// 1. moments_partial_kernel, grid (pixel chunk, group of 40 channels,
//    image), 8 warps. A block first takes the range [lo, hi] of the labels
//    its chunk holds. Then for each window of W labels in that range (one
//    window where the range is narrow, as on the graph stage, whose labels
//    are numbered in raster order of their components' roots), it walks the
//    chunk in tiles of TP pixels: the tile's labels, their __match_any_sync
//    peer masks (one per 32-pixel step, shared by the block's warps) and
//    the values of its channels are staged in shared memory with coalesced
//    loads (a thread's loads of a tile all in flight together), then each
//    warp reduces its 5 channels over the tile's steps:
//    lanes that share a label are summed by a shuffle tree fixed by their
//    mask, and the group's lowest lane adds the sums to the window's
//    float64 columns, one writer per entry. The window's sums go out as
//    the chunk's float64 partials for labels [lo, hi] only, and the block
//    writes [lo, hi] beside them. Only chunks whose range exceeds W pay for
//    more than one walk.
// 2. moments_reduce_kernel, a thread per (image, superpixel, channel): adds
//    the partials of the chunks whose range holds the superpixel, in chunk
//    order, and rounds once to float32.
// The partials buffer is (B, n_chunks, S, D + 1) float64, of which only
// each chunk's [lo, hi] rows are written and read; the wrapper picks the
// chunk so that there are many blocks and the buffer stays bounded.

#include "common.cuh"

#include <climits>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;
constexpr int NW = NT / 32;   // warps per block
constexpr int CPW = 5;        // channels per warp
constexpr int CG = NW * CPW;  // channels per block: the graph stage's 39 and the count
constexpr int TP = 256;       // pixels staged per tile (a 32-pixel step per warp)
constexpr int TPP = TP + 1;   // pitch of a staged channel (floats)
constexpr int W = 128;        // labels per accumulator window
constexpr int WP = W + 1;     // pitch of an accumulator column (doubles)
constexpr size_t SMEM = (size_t)CG * WP * sizeof(double) + (size_t)CG * TPP * sizeof(float) +
                        2 * TP * sizeof(int) + 2 * NW * sizeof(int);

static_assert(TP == NT, "the mask staging gives each warp one 32-pixel step of a tile");

__device__ __forceinline__ long lmin(long a, long b) { return a < b ? a : b; }

// Sum of each v[j] over the lanes in `peers` (this lane's __match_any_sync
// group), by a pairwise tree fixed by the mask; the group's lowest lane
// ends with the sums. Every lane of the warp must call it.
__device__ __forceinline__ void peer_sum(unsigned peers, double (&v)[CPW]) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));  // position among the peers
  unsigned rest = peers & ~((2u << lane) - 1u);     // peers above this lane
  while (__any_sync(FULL, rest != 0u)) {
    const int next = __ffs(rest);  // 1 + the next peer's lane, 0 if none
    const int src = (next - 1) & 31;
#pragma unroll
    for (int j = 0; j < CPW; ++j) {
      const double t = __shfl_sync(FULL, v[j], src);
      if (next) v[j] += t;
    }
    // lanes whose rank has its lowest bit set have handed their value on
    rest &= ~__ballot_sync(FULL, rank & 1);
    rank >>= 1;
  }
}

// A stored value's bits in a 32-bit register, and back to float32. The
// load is not followed by any use before the shared-memory store, so a
// thread's loads of a tile are all in flight together (a conversion right
// after each bf16 load would make every load wait for the one before).
__device__ __forceinline__ unsigned load_bits(const float* p, long i) {
  return __float_as_uint(p[i]);
}
__device__ __forceinline__ unsigned load_bits(const __nv_bfloat16* p, long i) {
  return reinterpret_cast<const unsigned short*>(p)[i];
}
template <typename T>
__device__ __forceinline__ float from_bits(unsigned u);
template <>
__device__ __forceinline__ float from_bits<float>(unsigned u) { return __uint_as_float(u); }
template <>
__device__ __forceinline__ float from_bits<__nv_bfloat16>(unsigned u) {
  return __uint_as_float(u << 16);
}

// How a block moves a tile of TP pixels x its ng channels into shared
// memory. Thread t holds up to CG values of the tile in registers, element
// r of them being (pixel q, channel c): channel-major, q = t and c = r (a
// warp reads 32 consecutive pixels of one channel); row-major, the r-th of
// the thread's stride-NT steps through the tile's (q, c) pairs in order (a
// warp reads consecutive channels of consecutive pixels). Every load is
// unconditional (an element outside the tile reads element 0 and is
// masked at the store), so none waits behind a branch.
template <typename T>
struct Staging {
  const T* xb;
  const int* lb;
  long ch_stride, px_stride;
  int D, S, c0, ng;
  bool channel_major;

  __device__ __forceinline__ void first(int& q, int& c) const {
    q = channel_major ? (int)threadIdx.x : (int)threadIdx.x / ng;
    c = channel_major ? 0 : (int)threadIdx.x % ng;
  }
  __device__ __forceinline__ void next(int& q, int& c) const {
    if (channel_major) {
      ++c;
    } else {  // (q, c) of the element NT further on
      q += NT / ng;
      c += NT % ng;
      if (c >= ng) {
        c -= ng;
        ++q;
      }
    }
  }
  // The label (-1: no bucket) and the value bits of the tile at t0.
  __device__ __forceinline__ void load(long t0, int tn, unsigned (&v)[CG], int& l) const {
    const bool in = (int)threadIdx.x < tn;
    l = lb[t0 + (in ? threadIdx.x : 0)];
    if (!in || l < 0 || l >= S) l = -1;
    int q, c;
    first(q, c);
#pragma unroll
    for (int r = 0; r < CG; ++r) {
      const bool ok = r < ng && c0 + c < D && q < tn;
      v[r] = load_bits(xb, ok ? (long)(c0 + c) * ch_stride + (t0 + q) * px_stride : 0);
      next(q, c);
    }
  }
  __device__ __forceinline__ void store(float* vals, const unsigned (&v)[CG], int tn) const {
    int q, c;
    first(q, c);
#pragma unroll
    for (int r = 0; r < CG; ++r) {
      if (r < ng) {
        const float val = c0 + c >= D ? 1.0f : (q < tn ? from_bits<T>(v[r]) : 0.0f);
        vals[c * TPP + q] = val;  // channel D is the count
      }
      next(q, c);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 2) moments_partial_kernel(
    const T* __restrict__ x, const int* __restrict__ labels, double* __restrict__ part,
    int2* __restrict__ ranges, int D, int N, int S, int chunk, int n_chunks,
    long ch_stride, long px_stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* acc = reinterpret_cast<double*>(smem);            // (CG, WP)
  float* vals = reinterpret_cast<float*>(acc + CG * WP);    // (CG, TPP)
  int* lab = reinterpret_cast<int*>(vals + CG * TPP);       // (TP)
  unsigned* peers = reinterpret_cast<unsigned*>(lab + TP);  // (TP)
  int* red = reinterpret_cast<int*>(peers + TP);            // (2, NW)

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k = blockIdx.x, b = blockIdx.z;
  const int dc = D + 1;                // channels with the count (channel D)
  const int c0 = blockIdx.y * CG;      // the group's first channel
  const int ng = min(CG, dc - c0);     // the group's channels
  const int cw = warp * CPW;           // this warp's first channel in the group
  const long p_begin = (long)k * chunk;
  const long p_end = lmin(N, p_begin + chunk);
  const int* lb = labels + (long)b * N;
  const Staging<T> stage{x + (long)b * D * N, lb, ch_stride, px_stride, D, S, c0, ng,
                         px_stride == 1};

  // the range [lo, hi] of the chunk's labels in [0, S); lo > hi if none
  int lo = INT_MAX, hi = -1;
  for (long p = p_begin + threadIdx.x; p < p_end; p += NT) {
    const int l = lb[p];
    if (l >= 0 && l < S) {
      lo = min(lo, l);
      hi = max(hi, l);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    lo = min(lo, __shfl_xor_sync(FULL, lo, off));
    hi = max(hi, __shfl_xor_sync(FULL, hi, off));
  }
  if (lane == 0) {
    red[warp] = lo;
    red[NW + warp] = hi;
  }
  __syncthreads();
  lo = red[0];
  hi = red[NW];
  for (int i = 1; i < NW; ++i) {
    lo = min(lo, red[i]);
    hi = max(hi, red[NW + i]);
  }
  if (blockIdx.y == 0 && threadIdx.x == 0) ranges[(long)b * n_chunks + k] = make_int2(lo, hi);

  double* out = part + ((long)b * n_chunks + k) * S * dc;  // this chunk's (S, D + 1)
  for (long w0 = lo; w0 <= hi; w0 += W) {  // the same windows in every thread
    for (int i = threadIdx.x; i < CG * WP; i += NT) acc[i] = 0.0;
    for (long t0 = p_begin; t0 < p_end; t0 += TP) {
      const int tn = (int)lmin(TP, p_end - t0);
      unsigned v[CG];
      int l;
      stage.load(t0, tn, v, l);
      __syncthreads();  // the last tile's readers are done, acc is zeroed
      lab[threadIdx.x] = l;
      peers[threadIdx.x] = __match_any_sync(FULL, l);  // a 32-pixel step per warp
      stage.store(vals, v, tn);
      __syncthreads();
      if (cw < ng) {  // a whole warp: every lane takes part in the shuffles
        for (int s0 = 0; s0 < tn; s0 += 32) {
          const int q = s0 + lane;
          const int lq = lab[q];
          const unsigned pm = peers[q];
          const int loc = (lq >= w0 && lq < w0 + W) ? (int)(lq - w0) : -1;
          double u[CPW];
#pragma unroll
          for (int j = 0; j < CPW; ++j)
            u[j] = (loc >= 0 && cw + j < ng) ? (double)vals[(cw + j) * TPP + q] : 0.0;
          peer_sum(pm, u);
          if (loc >= 0 && (pm & ((1u << lane) - 1u)) == 0u) {
#pragma unroll
            for (int j = 0; j < CPW; ++j)
              if (cw + j < ng) acc[(cw + j) * WP + loc] += u[j];
          }
        }
      }
    }
    __syncthreads();
    // the window's partials, labels w0 .. min(w0 + W, hi + 1) - 1
    const int wn = (int)lmin(W, hi + 1 - w0);
    for (int i = threadIdx.x; i < wn * ng; i += NT) {
      const int s = i / ng, c = i - s * ng;
      out[(w0 + s) * dc + c0 + c] = acc[c * WP + s];
    }
    __syncthreads();  // before the next window zeroes acc
  }
}

__global__ void __launch_bounds__(NT) moments_reduce_kernel(
    const double* __restrict__ part, const int2* __restrict__ ranges, float* __restrict__ sums,
    float* __restrict__ counts, int D, int S, int n_chunks) {
  const int dc = D + 1;
  const int b = blockIdx.y;
  const long e = (long)blockIdx.x * NT + threadIdx.x;  // s * (D + 1) + c
  if (e >= (long)S * dc) return;
  const int s = (int)(e / dc), c = (int)(e - (long)s * dc);
  const int2* rg = ranges + (long)b * n_chunks;
  const long plane = (long)S * dc;
  const double* pp = part + (long)b * n_chunks * plane + e;
  double acc = 0.0;
  for (int k = 0; k < n_chunks; ++k) {
    const int2 r = __ldg(rg + k);
    if (s >= r.x && s <= r.y) acc += pp[k * plane];
  }
  if (c < D) sums[((long)b * S + s) * D + c] = (float)acc;
  else counts[(long)b * S + s] = (float)acc;
}

template <typename T>
int launch(const void* x, const int* labels, float* sums, float* counts, double* part,
           int2* ranges, int B, int D, int N, int S, int chunk, int n_chunks,
           int ch_stride, int px_stride, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      moments_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  moments_partial_kernel<T><<<dim3(n_chunks, (D + 1 + CG - 1) / CG, B), NT, SMEM, s>>>(
      (const T*)x, labels, part, ranges, D, N, S, chunk, n_chunks, ch_stride, px_stride);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long cells = (long)S * (D + 1);
  moments_reduce_kernel<<<dim3((unsigned)((cells + NT - 1) / NT), B), NT, 0, s>>>(
      part, ranges, sums, counts, D, S, n_chunks);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, ...) float32 or bfloat16 (bf16 != 0), D * N values per image,
// channel c of pixel p at c * ch_stride + p * px_stride ((N, 1) for
// (B, D, N), (1, D) for (B, N, D)). labels: (B, N) int32. sums: (B, S, D)
// and counts: (B, S) float32 out. part: (B, n_chunks, S, D + 1) float64 and
// ranges: (B, n_chunks) int2 scratch; chunk: pixels per chunk, a multiple
// of 256, with n_chunks * chunk >= N.
GCIS_API int gcis_superpixel_moments(const void* x, const int* labels, float* sums,
                                     float* counts, void* part, void* ranges, int B, int D,
                                     int N, int S, int chunk, int n_chunks, int ch_stride,
                                     int px_stride, int bf16, void* stream) {
  if (B < 1 || B > 65535 || D < 1 || N < 1 || S < 1 || chunk < 1 || chunk % TP != 0 ||
      n_chunks < 1 || (long)n_chunks * chunk < N || (D + 1 + CG - 1) / CG > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  double* p = (double*)part;
  int2* r = (int2*)ranges;
  return bf16 ? launch<__nv_bfloat16>(x, labels, sums, counts, p, r, B, D, N, S, chunk,
                                      n_chunks, ch_stride, px_stride, s)
              : launch<float>(x, labels, sums, counts, p, r, B, D, N, S, chunk, n_chunks,
                              ch_stride, px_stride, s);
}
