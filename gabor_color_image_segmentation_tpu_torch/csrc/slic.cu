// K11: SLIC superpixels, every Lloyd iteration and the final assignment.
//
// Replaces models/slic_pallas.py::_slic_all_kernel_w3 (wrapper slic_fused,
// via slic_batch): for a batch of Lab images, n_iter rounds of
//
//   assign: each pixel z = [L, a, b, sw y, sw x] takes the argmin of
//           cs.cs - 2 z.cs over the centroids of its 3x3 neighbour cells
//           (cs = [L, a, b, sw y, sw x] of the centroid), ties to the
//           lowest superpixel id;
//   update: each centroid [L, a, b, y, x] becomes the mean of its members,
//           or stays where it was when it has none;
//
// then one last assignment. The arithmetic is models/slic.py::slic_plain's,
// term by term (the per-pixel part in slic_common.cuh, shared with K12 and
// K13): csq and the dot are summed left to right with no fused
// multiply-add (__fmul_rn, __fadd_rn), the cell of a pixel is
// int(f32(y) * f32(gh / h)) clipped to the grid, and the moments are summed
// in float64 and rounded to float32 once. The TPU kernel's bf16x3 split,
// penalty dot and 128-lane candidate window answered Mosaic's missing
// float32 dot and the TPU's tiling; none of them is carried over.
//
// Bound on the H100: operations, barely. A pass reads 12 B of Lab and
// writes 4 B of label per pixel, and scores <= 9 candidates at ~12 float32
// operations each; at config3 (8 x 321 x 481, S = 925) the images and
// labels (20 MB) stay in the 50 MB L2 across the 21 launches, so the time
// is launch latency and L2 traffic, not HBM. The design:
//   - assign: one thread per pixel, its <= 9 candidates read straight from
//     the (B, S, 5) centroid table (37 KB per image, L1-resident);
//   - update: one 256-thread block per (image, superpixel). A member of s
//     can only lie where s is a candidate, i.e. in the pixel window of the
//     3x3 cells around s's own; the block scans that window two pixels
//     wider on each side than the cell arithmetic gives (so rounding at a
//     cell edge cannot drop a member) and keeps the pixels labelled s. Each
//     thread sums a fixed stride of the window, then a fixed-order tree in
//     shared memory adds the threads' sums: no atomics, the same centroids
//     on every run, which matters because the centroids decide the labels.

#include "slic_common.cuh"

namespace {

constexpr int NT_ASSIGN = 256;
constexpr int NT_UPDATE = 256;

__global__ void __launch_bounds__(NT_ASSIGN) slic_assign_kernel(
    const float* __restrict__ lab, const float* __restrict__ cent, int* __restrict__ labels,
    int h, int w, int gh, int gw, float fy, float fx, float sw) {
  const int n = h * w;
  const int p = blockIdx.x * NT_ASSIGN + threadIdx.x;
  if (p >= n) return;
  const long b = blockIdx.y;
  const int y = p / w, x = p - y * w;
  labels[b * n + p] = gcis::slic_assign_pixel(lab + (b * n + p) * 3, y, x,
                                              cent + b * gh * gw * 5, gh, gw, fy, fx, sw);
}

__global__ void __launch_bounds__(NT_UPDATE) slic_update_kernel(
    const float* __restrict__ lab, const int* __restrict__ labels, float* __restrict__ cent,
    int h, int w, int gh, int gw) {
  __shared__ double acc[5][NT_UPDATE];
  __shared__ int cnt[NT_UPDATE];
  const int s = blockIdx.x, tid = threadIdx.x;
  const long b = blockIdx.y;
  const int n = h * w;
  const int gy = s / gw, gx = s - gy * gw;
  const int y0 = max(0, gcis::slic_first_in_cell(gy - 1, h, gh) - gcis::SLIC_MARGIN);
  const int y1 = min(h, gcis::slic_first_in_cell(gy + 2, h, gh) + gcis::SLIC_MARGIN);
  const int x0 = max(0, gcis::slic_first_in_cell(gx - 1, w, gw) - gcis::SLIC_MARGIN);
  const int x1 = min(w, gcis::slic_first_in_cell(gx + 2, w, gw) + gcis::SLIC_MARGIN);
  const int ww = x1 - x0, total = (y1 - y0) * ww;
  const int* lb = labels + b * n;
  const float* lp = lab + b * n * 3;
  double sL = 0.0, sa = 0.0, sb = 0.0, sy = 0.0, sx = 0.0;
  int c = 0;
  for (int i = tid; i < total; i += NT_UPDATE) {
    const int y = y0 + i / ww, x = x0 + i % ww;
    const int p = y * w + x;
    if (lb[p] == s) {
      sL += (double)lp[p * 3];
      sa += (double)lp[p * 3 + 1];
      sb += (double)lp[p * 3 + 2];
      sy += (double)y;
      sx += (double)x;
      ++c;
    }
  }
  acc[0][tid] = sL;
  acc[1][tid] = sa;
  acc[2][tid] = sb;
  acc[3][tid] = sy;
  acc[4][tid] = sx;
  cnt[tid] = c;
  __syncthreads();
  for (int half = NT_UPDATE / 2; half > 0; half >>= 1) {
    if (tid < half) {
      for (int k = 0; k < 5; ++k) acc[k][tid] += acc[k][tid + half];
      cnt[tid] += cnt[tid + half];
    }
    __syncthreads();
  }
  if (tid == 0 && cnt[0] > 0) {
    float* cs = cent + (b * gh * gw + s) * 5;
    const float fc = (float)cnt[0];
    for (int k = 0; k < 5; ++k) cs[k] = __fdiv_rn((float)acc[k][0], fc);
  }
}

}  // namespace

// lab: (B, H, W, 3) float32. cent: (B, gh * gw, 5) float32 [L, a, b, y, x]
// initial centroids, updated in place. labels: (B, H, W) int32 out.
// fy, fx: float32(gh / h), float32(gw / w); sw: the spatial weight sqrt.
GCIS_API int gcis_slic(const float* lab, float* cent, int* labels, int B, int h, int w,
                       int gh, int gw, int n_iter, float fy, float fx, float sw,
                       void* stream) {
  if (B < 1 || h < 1 || w < 1 || gh < 1 || gw < 1 || n_iter < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 assign_grid((h * w + NT_ASSIGN - 1) / NT_ASSIGN, B);
  const dim3 update_grid(gh * gw, B);
  for (int it = 0; it <= n_iter; ++it) {
    slic_assign_kernel<<<assign_grid, NT_ASSIGN, 0, st>>>(lab, cent, labels, h, w, gh, gw,
                                                          fy, fx, sw);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || it == n_iter) return (int)err;
    slic_update_kernel<<<update_grid, NT_UPDATE, 0, st>>>(lab, labels, cent, h, w, gh, gw);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
