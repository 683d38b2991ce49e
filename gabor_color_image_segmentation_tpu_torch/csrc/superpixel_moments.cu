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
// (B, N, D) layout alike, in float32 or bfloat16.
//
// Sums are taken in float64 and rounded once to float32, as the plain
// version does: in bfloat16 the float64 sums of 8-bit mantissas are exact,
// so any order of addition gives the same bits, and in float32 two orders
// agree after the rounding except in a vanishing share of values. The
// graph stage's n-cut turns ulp-level differences in the means into whole
// superpixels changing region, so the bits matter.
//
// Design, no float atomics: one block per (image, group of 8 channels), the
// count as channel D. Each warp owns one channel and one float64 column of
// S entries in shared memory (8 x 925 x 8 bytes = 59 KB at config3's S).
// It walks the image's pixels 32 at a time in a fixed order; lanes that
// share a label (__match_any_sync) are summed by a shuffle tree fixed by
// their lane mask, and the group's lowest lane adds the sum to the warp's
// own column, so each entry has one writer. S beyond what shared memory
// holds (3,632) is refused.
//
// Bound on the H100: bytes, one read of the features and the labels
// (config3 bf16: 8 x 39 x 154,401 x 2 + 8 x 154,401 x 4 bytes = 101 MB,
// 0.030 ms). This design runs B x 5 blocks (40 at batch 8) that each walk
// every pixel of their image, so it sits far above that bound: each
// 32-pixel step is a dependent chain of a match, up to five shuffle rounds
// and a shared-memory add. Splitting the pixels over more blocks, with
// float64 partials added in order, is later work.

#include "common.cuh"

namespace {

using gcis::ld;

constexpr int NT = 256;
constexpr int NW = NT / 32;  // channels per block, one per warp
constexpr int SMAX = 232448 / (NW * 8);  // float64 columns of S in 227 KB

// Sum of v over the lanes in `peers` (this lane's __match_any_sync group),
// by a pairwise tree fixed by the mask; the group's lowest lane returns the
// sum. Every lane of the warp must call it.
__device__ __forceinline__ double peer_sum(unsigned peers, double v) {
  const int lane = threadIdx.x & 31;
  int rank = __popc(peers & ((1u << lane) - 1u));  // position among the peers
  unsigned rest = peers & ~((2u << lane) - 1u);     // peers above this lane
  while (__any_sync(0xffffffffu, rest != 0u)) {
    const int next = __ffs(rest);  // 1 + the next peer's lane, 0 if none
    const double t = __shfl_sync(0xffffffffu, v, (next - 1) & 31);
    if (next) v += t;
    // lanes whose rank has its lowest bit set have handed their value on
    rest &= ~__ballot_sync(0xffffffffu, rank & 1);
    rank >>= 1;
  }
  return v;
}

template <typename T>
__global__ void __launch_bounds__(NT) moments_kernel(
    const T* __restrict__ x, const int* __restrict__ labels, float* __restrict__ sums,
    float* __restrict__ counts, int D, int N, int S, int ch_stride, int px_stride) {
  extern __shared__ double col[];  // (NW, S): one column per warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int ch = blockIdx.x * NW + warp;  // this warp's channel; D is the count
  if (ch > D) return;  // a whole warp; warps never share a column
  double* mine = col + (long)warp * S;
  for (int s = lane; s < S; s += 32) mine[s] = 0.0;
  __syncwarp();

  const T* xc = x + (long)b * D * N + (long)(ch < D ? ch : 0) * ch_stride;
  const int* lb = labels + (long)b * N;
  for (long p0 = 0; p0 < N; p0 += 32) {
    const long p = p0 + lane;
    int l = p < N ? lb[p] : -1;
    if (l >= S) l = -1;
    double v = 0.0;
    if (l >= 0) v = ch == D ? 1.0 : (double)ld(xc, p * px_stride);
    const unsigned peers = __match_any_sync(0xffffffffu, l);
    v = peer_sum(peers, v);
    if (l >= 0 && (peers & ((1u << lane) - 1u)) == 0u) mine[l] += v;
    __syncwarp();
  }

  if (ch < D) {
    for (int s = lane; s < S; s += 32) sums[((long)b * S + s) * D + ch] = (float)mine[s];
  } else {
    for (int s = lane; s < S; s += 32) counts[(long)b * S + s] = (float)mine[s];
  }
}

template <typename T>
int launch(const void* x, const int* labels, float* sums, float* counts, int B, int D,
           int N, int S, int ch_stride, int px_stride, cudaStream_t s) {
  const size_t smem = (size_t)NW * S * sizeof(double);
  cudaError_t err = cudaFuncSetAttribute(
      moments_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  moments_kernel<T><<<dim3((D + 1 + NW - 1) / NW, B), NT, smem, s>>>(
      (const T*)x, labels, sums, counts, D, N, S, ch_stride, px_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, ...) float32 or bfloat16 (bf16 != 0), D * N values per image,
// channel c of pixel p at c * ch_stride + p * px_stride ((N, 1) for
// (B, D, N), (1, D) for (B, N, D)). labels: (B, N) int32. sums: (B, S, D)
// and counts: (B, S) float32 out.
GCIS_API int gcis_superpixel_moments(const void* x, const int* labels, float* sums,
                                     float* counts, int B, int D, int N, int S,
                                     int ch_stride, int px_stride, int bf16,
                                     void* stream) {
  if (B < 1 || B > 65535 || D < 1 || N < 1 || S < 1 || S > SMAX)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, labels, sums, counts, B, D, N, S, ch_stride,
                                      px_stride, s)
              : launch<float>(x, labels, sums, counts, B, D, N, S, ch_stride, px_stride,
                              s);
}
