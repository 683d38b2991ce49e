// K13 and K12: SLIC on uniform bands of pixel rows.
//
// K13 replaces models/slic_pallas.py::_slic_kernel, the reference's banded
// launch-per-pass SLIC for frames above its whole-image gate (config4's
// pooled 540 x 960 grid): one launch is one pass, which assigns every pixel
// and writes, per band, the moments of each candidate of the band's window.
// A small update launch then adds each superpixel's band partials and moves
// its centroid. The banded loop (models/slic_fused.py::slic_banded) runs
// n_iter passes and updates and a last assignment.
//
// K12 replaces models/slic_pallas.py::_slic_all_kernel, the whole-image
// kernel on the same uniform bands that plan="w5" selects: here one
// cooperative launch whose blocks stride over the (image, band) pieces, with
// a grid-wide barrier between the passes and the updates. It runs K13's
// band and update device functions, so its labels are bit-equal to the
// banded loop's.
//
// Both compute models/slic.py::slic_plain's exact-float32 SLIC: the
// per-pixel score of slic_common.cuh (shared with K11), ties to the lowest
// id. A band is band_rows pixel rows (the last one shorter); its pixels'
// candidates lie in the w_rows grid rows from rb = clip(floor(y0 gh / h) - 1,
// 0, gh - w_rows). A band is split further into column pieces of cw pixel
// columns (the last one narrower), so the partials are a (B, n_bands,
// n_col_pieces, w_rows * gw, 6) float64 table [L, a, b, y, x, count]: the
// reference's psums, split along the columns. The TPU kernel's bf16x3 split,
// penalty dot and 128-lane window answered Mosaic's missing float32 dot;
// none of them is carried over.
//
// Bound on the H100, for the whole loop (n_iter passes and updates and the
// last assignment): operations. It must read the Lab once and write the
// labels once, 16 B a pixel (66 MB at config4's 8 x 540 x 960, 0.020 ms at
// 3.35 TB/s); it scores <= 9 candidates at ~12 float32 operations per pixel
// in each of the 11 assignments and adds 6 sums per pixel in each of the 10
// updates (~4.8 GFLOP at config4, 0.072 ms at 67 TFLOP/s). This design
// re-reads the Lab in every pass (11 x 16 B a pixel, ~0.73 GB, 0.22 ms):
// that is its own floor, above the bound. The design:
//   - pass: one 256-thread block per (image, band, column piece); each warp
//     takes every eighth row of the piece, 32 pixels at a time, one per
//     lane. A lane scores its pixel, then the warp sums the lanes that took
//     the same candidate (a butterfly over the 32 lanes, non-members adding
//     0) and lane 0 adds the group to the warp's float64 accumulators in
//     shared memory. The block then adds its eight warps in warp order.
//     Each pixel is read once per pass; no atomics, so the same inputs give
//     the same bits on every run (the centroids decide the labels). The
//     column pieces are there because one block per (image, band) is 136
//     blocks at config4, one per SM at 8 warps, each warp walking 120
//     chunks of 32 pixels in sequence; pieces of 128 columns give 1,088
//     blocks of 16 chunks a warp, up to five resident per SM.
//   - update: one thread per superpixel adds the partials of the bands
//     whose window holds it, in band order and within a band in column
//     order, rounds to float32 once, and keeps an empty superpixel's
//     centroid.

#include <cooperative_groups.h>

#include "slic_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXC = 128;  // candidates per band window, w_rows * gw
constexpr unsigned FULL = 0xffffffffu;

struct BandAcc {  // per-warp moments of each candidate of the window
  double s[NWARP][MAXC][5];  // L, a, b, y, x
  int cnt[NWARP][MAXC];
};

__device__ __forceinline__ int band_first_row(int t, int br, int gh, int h, int wr) {
  const int base = (int)((long)t * br * gh / h) - 1;
  return max(0, min(base, gh - wr));
}

// One (image, band, column piece): assign its pixels (labels out) and, when
// parts is not null, write its partials. All threads of the block call it.
__device__ void band_pass(const float* __restrict__ lab, const float* cent, int* labels,
                          double* parts, BandAcc& acc, int b, int t, int cp, int h, int w,
                          int gh, int gw, int wr, int br, int nb, int cw, int ncp, float fy,
                          float fx, float sw) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ncr = wr * gw;
  const int y0 = t * br, y1 = min(h, y0 + br);
  const int x0 = cp * cw, x1 = min(w, x0 + cw);
  const int lo = band_first_row(t, br, gh, h, wr) * gw;
  const long n = (long)h * w;
  const float* lb = lab + b * n * 3;
  const float* cb = cent + (long)b * gh * gw * 5;
  int* ob = labels + b * n;
  const bool want = parts != nullptr;
  if (want) {
    for (int i = threadIdx.x; i < NWARP * ncr; i += NT) {
      const int q = i / ncr, j = i - q * ncr;
      for (int k = 0; k < 5; ++k) acc.s[q][j][k] = 0.0;
      acc.cnt[q][j] = 0;
    }
    __syncthreads();
  }
  for (int y = y0 + warp; y < y1; y += NWARP) {
    for (int xc = x0; xc < x1; xc += 32) {
      const int x = xc + lane;
      const bool valid = x < x1;
      int j = -1;
      float L = 0.f, A = 0.f, B = 0.f;
      if (valid) {
        const long p = (long)y * w + x;
        const float* px = lb + p * 3;
        const int s = gcis::slic_assign_pixel(px, y, x, cb, gh, gw, fy, fx, sw);
        ob[p] = s;
        j = s - lo;
        L = px[0];
        A = px[1];
        B = px[2];
      }
      if (!want) continue;
      unsigned todo = __ballot_sync(FULL, valid);
      while (todo) {  // one candidate of the 32 pixels at a time
        const int jj = __shfl_sync(FULL, j, __ffs(todo) - 1);
        const bool in = valid && j == jj;
        const unsigned grp = __ballot_sync(FULL, in);
        double sL = in ? (double)L : 0.0, sA = in ? (double)A : 0.0;
        double sB = in ? (double)B : 0.0;
        int sx = in ? x : 0;
        for (int off = 16; off > 0; off >>= 1) {
          sL += __shfl_xor_sync(FULL, sL, off);
          sA += __shfl_xor_sync(FULL, sA, off);
          sB += __shfl_xor_sync(FULL, sB, off);
          sx += __shfl_xor_sync(FULL, sx, off);
        }
        if (lane == 0 && jj >= 0 && jj < ncr) {  // the plan keeps every id in the window
          const int c = __popc(grp);
          double* a = acc.s[warp][jj];
          a[0] += sL;
          a[1] += sA;
          a[2] += sB;
          a[3] += (double)y * c;
          a[4] += (double)sx;
          acc.cnt[warp][jj] += c;
        }
        todo &= ~grp;
      }
    }
  }
  if (!want) return;
  __syncthreads();
  for (int j = threadIdx.x; j < ncr; j += NT) {
    double* out = parts + ((((long)b * nb + t) * ncp + cp) * ncr + j) * 6;
    int c = 0;
    for (int k = 0; k < 5; ++k) {
      double v = 0.0;
      for (int q = 0; q < NWARP; ++q) v += acc.s[q][j][k];
      out[k] = v;
    }
    for (int q = 0; q < NWARP; ++q) c += acc.cnt[q][j];
    out[5] = (double)c;
  }
  __syncthreads();  // acc is reused by the block's next piece (K12)
}

// Centroid s of image b from the partials of the bands whose window holds
// it, bands in order and the column pieces of each in order.
__device__ __forceinline__ void band_update(const double* parts, float* cent, int b, int s,
                                            int h, int gh, int gw, int wr, int br, int nb,
                                            int ncp) {
  const int gy = s / gw, ncr = wr * gw;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int t = 0; t < nb; ++t) {
    const int rb = band_first_row(t, br, gh, h, wr);
    if (gy < rb || gy >= rb + wr) continue;
    for (int cp = 0; cp < ncp; ++cp) {
      const double* p = parts + ((((long)b * nb + t) * ncp + cp) * ncr + (s - rb * gw)) * 6;
      for (int k = 0; k < 6; ++k) acc[k] += p[k];
    }
  }
  if (acc[5] > 0.0) {
    float* cs = cent + ((long)b * gh * gw + s) * 5;
    const float fc = (float)acc[5];
    for (int k = 0; k < 5; ++k) cs[k] = __fdiv_rn((float)acc[k], fc);
  }
}

__global__ void __launch_bounds__(NT) slic_band_pass_kernel(
    const float* __restrict__ lab, const float* __restrict__ cent, int* labels, double* parts,
    int h, int w, int gh, int gw, int wr, int br, int nb, int cw, int ncp, float fy, float fx,
    float sw) {
  __shared__ BandAcc acc;
  band_pass(lab, cent, labels, parts, acc, blockIdx.y, blockIdx.x / ncp, blockIdx.x % ncp, h,
            w, gh, gw, wr, br, nb, cw, ncp, fy, fx, sw);
}

__global__ void slic_band_update_kernel(const double* __restrict__ parts, float* cent, int h,
                                        int gh, int gw, int wr, int br, int nb, int ncp) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= gh * gw) return;
  band_update(parts, cent, blockIdx.y, s, h, gh, gw, wr, br, nb, ncp);
}

__global__ void __launch_bounds__(NT) slic_w5_kernel(
    const float* __restrict__ lab, float* cent, int* labels, double* parts, int B, int h, int w,
    int gh, int gw, int wr, int br, int nb, int cw, int ncp, int n_iter, float fy, float fx,
    float sw) {
  __shared__ BandAcc acc;
  cg::grid_group grid = cg::this_grid();
  const int per_image = nb * ncp, pieces = B * per_image, n_sp = gh * gw;
  for (int it = 0; it <= n_iter; ++it) {
    double* out = it < n_iter ? parts : nullptr;  // the last pass only assigns
    for (int q = blockIdx.x; q < pieces; q += gridDim.x) {
      const int r = q % per_image;
      band_pass(lab, cent, labels, out, acc, q / per_image, r / ncp, r % ncp, h, w, gh, gw,
                wr, br, nb, cw, ncp, fy, fx, sw);
    }
    if (it == n_iter) break;
    grid.sync();
    for (int i = blockIdx.x * NT + threadIdx.x; i < B * n_sp; i += gridDim.x * NT)
      band_update(parts, cent, i / n_sp, i % n_sp, h, gh, gw, wr, br, nb, ncp);
    grid.sync();
  }
}

bool bad_plan(int B, int h, int w, int gh, int gw, int wr, int br, int cw) {
  return B < 1 || h < 1 || w < 1 || gh < 1 || gw < 1 || wr < 1 || wr > gh ||
         wr * gw > MAXC || br < 1 || cw < 1;
}

}  // namespace

// K13, one pass. lab: (B, H, W, 3) float32; cent: (B, gh * gw, 5) float32
// [L, a, b, y, x]; labels: (B, H, W) int32 out; parts: (B, n_bands,
// ceil(W / cw), wr * gw, 6) float64 out, or null for an assignment only.
// fy, fx: float32(gh / h), float32(gw / w); sw: the spatial weight's square
// root; cw: the column piece's width.
GCIS_API int gcis_slic_band_pass(const float* lab, const float* cent, int* labels,
                                 double* parts, int B, int h, int w, int gh, int gw, int wr,
                                 int br, int cw, float fy, float fx, float sw, void* stream) {
  if (bad_plan(B, h, w, gh, gw, wr, br, cw)) return (int)cudaErrorInvalidValue;
  const int nb = (h + br - 1) / br, ncp = (w + cw - 1) / cw;
  slic_band_pass_kernel<<<dim3(nb * ncp, B), NT, 0, (cudaStream_t)stream>>>(
      lab, cent, labels, parts, h, w, gh, gw, wr, br, nb, cw, ncp, fy, fx, sw);
  return (int)cudaGetLastError();
}

// K13's update: cent (B, gh * gw, 5) in place from the pass's partials of
// ncp column pieces.
GCIS_API int gcis_slic_band_update(const double* parts, float* cent, int B, int h, int gh,
                                   int gw, int wr, int br, int ncp, void* stream) {
  if (bad_plan(B, h, 1, gh, gw, wr, br, ncp)) return (int)cudaErrorInvalidValue;
  const int nb = (h + br - 1) / br;
  slic_band_update_kernel<<<dim3((gh * gw + 127) / 128, B), 128, 0, (cudaStream_t)stream>>>(
      parts, cent, h, gh, gw, wr, br, nb, ncp);
  return (int)cudaGetLastError();
}

// K12: n_iter passes and updates and the last assignment in one cooperative
// launch; cent is updated in place, parts is scratch of K13's shape. The
// grid is as many blocks as fit on the card at once (a grid-wide barrier
// needs them all resident), at most one per piece.
GCIS_API int gcis_slic_w5(const float* lab, float* cent, int* labels, double* parts, int B,
                          int h, int w, int gh, int gw, int wr, int br, int cw, int n_iter,
                          float fy, float fx, float sw, void* stream) {
  if (bad_plan(B, h, w, gh, gw, wr, br, cw) || n_iter < 0) return (int)cudaErrorInvalidValue;
  int nb = (h + br - 1) / br, ncp = (w + cw - 1) / cw;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slic_w5_kernel, NT, 0);
  if (err != cudaSuccess) return (int)err;
  const int pieces = B * nb * ncp;
  const int grid = pieces < per_sm * sms ? pieces : per_sm * sms;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&lab, &cent, &labels, &parts, &B, &h, &w, &gh, &gw, &wr, &br, &nb,
                  &cw, &ncp, &n_iter, &fy, &fx, &sw};
  err = cudaLaunchCooperativeKernel((const void*)slic_w5_kernel, dim3(grid), dim3(NT), args,
                                    0, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
