// K11: SLIC superpixels on the whole image, every Lloyd iteration and the
// final assignment.
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
// Bound on the H100: operations, barely. The loop must read 12 B of Lab
// and write 4 B of label per pixel, and scores <= 9 candidates at ~12
// float32 operations each in every one of the n_iter + 1 assignments; at
// config3 (8 x 321 x 481, S = 925) the images and labels (20 MB) stay in
// the 50 MB L2 across the launches. The design (K13's in slic_banded.cu,
// carried to the whole-image geometry):
//   - pass: one 256-thread block per (image, tile of ty x tx grid cells;
//     models/slic_fused.py::slic_w3_plan picks the tile and gives each
//     tile's pixel rows and columns, the pixels whose float32 cell lies in
//     it). The block hoists the centroids its pixels can reach, the tile's
//     cells +- 1, into shared memory with sw y, sw x and |c|^2 formed once
//     in slic_plain's order (slic_cand), so a pixel scores from the table
//     (slic_score) and its label keeps slic_plain's bits. Each thread takes
//     a run of consecutive pixels of one row (the tile's width over the
//     threads a row gets) and loads their Lab as scalars: an odd W (481)
//     leaves rows unaligned for 16-byte loads, and the runs' lines are
//     reused from L1;
//   - moments, when the pass writes partials: a thread adds its run's
//     pixels in float64 registers while the id is unchanged and closes a
//     record when it changes; records are flushed through per-warp slots in
//     lane order (slic_common.cuh's flush, K13's), and the block adds its
//     warps' slots in warp order into the tile's partials: [L, a, b, y, x,
//     count] of each hoisted cell, (B, n_tile_rows, n_tile_cols,
//     (ty + 2)(tx + 2), 6) float64, zero where nothing landed. y, x and the
//     counts are summed as integers, exactly;
//   - update: one warp per superpixel adds the partials of the <= 4 tiles
//     whose hoisted set holds it (<= 9 for one-cell tiles), a tile a lane,
//     then a fixed butterfly, rounds to float32 once and keeps an empty
//     superpixel's centroid.
// No float atomics, a fixed order everywhere: two launches give the same
// bits. On the Lab of uint8 images the float64 sums are exact, so the
// labels are slic_plain's bit for bit.

#include "slic_common.cuh"

namespace {

using gcis::Cand;
using gcis::FULL;
using gcis::flush;
using gcis::Rec;
using gcis::REC;
using gcis::Slot;

constexpr int NT = 256;  // threads per pass block
constexpr int NWARP = NT / 32;
constexpr int LWMAX = 128;  // hoisted cells a tile, (ty + 2)(tx + 2)
constexpr int MASKW = LWMAX / 32;

// Shared memory of a pass block whose tile hoists lw cells.
inline size_t pass_smem(int lw, bool partials) {
  return sizeof(Cand) * lw + (partials ? sizeof(Slot) * NWARP * lw +
                                             sizeof(Rec) * NWARP * REC * 32 +
                                             sizeof(unsigned) * NWARP * MASKW
                                       : 0);
}

// One pass over tile (blockIdx.x = tile row * ntx + tile column) of image
// blockIdx.y: labels out, and the tile's partials when parts is not null.
// rows (n_tile_rows + 1,) and cols (ntx + 1,): the tiles' first pixel row
// and column.
__global__ void __launch_bounds__(NT) slic_w3_pass_kernel(
    const float* __restrict__ lab, const float* __restrict__ cent, int* __restrict__ labels,
    double* __restrict__ parts, const int* __restrict__ rows, const int* __restrict__ cols,
    int h, int w, int gh, int gw, int ty, int tx, int ntx, float fy, float fx, float sw) {
  extern __shared__ __align__(16) char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, ta = blockIdx.x / ntx, tc = blockIdx.x - ta * ntx;
  const int y0 = rows[ta], y1 = rows[ta + 1], x0 = cols[tc], x1 = cols[tc + 1];
  // the hoisted window: cell rows ta ty - 1 .. ta ty + ty, columns
  // tc tx - 1 .. tc tx + tx; local index (gy - gy_lo) lwc + gx - gx_lo,
  // ascending with the superpixel id
  const int lwc = tx + 2, lw = (ty + 2) * lwc;
  const int gy_lo = ta * ty - 1, gx_lo = tc * tx - 1;
  const bool want = parts != nullptr;
  Cand* cand = reinterpret_cast<Cand*>(smem);       // (lw,)
  Slot* slots = reinterpret_cast<Slot*>(cand + lw);  // (NWARP, lw)
  Rec* stages = reinterpret_cast<Rec*>(slots + NWARP * lw);
  Rec* stage = stages + warp * REC * 32;
  unsigned* masks = reinterpret_cast<unsigned*>(stages + NWARP * REC * 32);  // (NWARP, MASKW)
  Slot* wslots = slots + warp * lw;
  unsigned* wmask = masks + warp * MASKW;
  const long n = (long)h * w;
  const float* cb = cent + (long)b * gh * gw * 5;

  for (int j = tid; j < lw; j += NT) {
    const int gy = gy_lo + j / lwc, gx = gx_lo + j % lwc;
    if (gy >= 0 && gy < gh && gx >= 0 && gx < gw)
      cand[j] = gcis::slic_cand(cb + ((long)gy * gw + gx) * 5, sw);
  }
  if (want && tid < NWARP * MASKW) masks[tid] = 0u;  // no slot touched yet
  __syncthreads();

  // runs: the tile's width over the threads a row gets
  const int ht = y1 - y0, wt = x1 - x0;
  const int per_row = max(1, NT / max(1, ht));
  const int run = max(1, (wt + per_row - 1) / per_row);
  const int tpr = (wt + run - 1) / run;  // runs a row
  const int items = ht * tpr;
  const float* lb = lab + b * n * 3;
  int* ob = labels + b * n;
  for (int base = 0; base < items; base += NT) {  // the same trip count in every lane
    const int item = base + tid;
    const bool live = item < items;
    const int y = live ? y0 + item / tpr : y0;
    const int xs = live ? x0 + (item % tpr) * run : x1;
    const int xe = min(x1, xs + run);
    const int cy = gcis::slic_cell_of(y, fy, gh);
    const int gy0 = max(cy - 1, 0) - gy_lo, gy1 = min(cy + 1, gh - 1) - gy_lo;
    const float z3 = __fmul_rn(sw, (float)y);
    int cur = -1, nrec = 0, sx = 0, cnt = 0;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    for (int t = 0; t < run; ++t) {
      const int x = xs + t;
      const bool valid = x < xe;
      int s = -1;
      float z0 = 0.f, z1 = 0.f, z2 = 0.f;
      if (valid) {
        const float* px = lb + ((long)y * w + x) * 3;
        z0 = px[0];
        z1 = px[1];
        z2 = px[2];
        const float z4 = __fmul_rn(sw, (float)x);
        const int cx = gcis::slic_cell_of(x, fx, gw);
        const int gx0 = max(cx - 1, 0) - gx_lo, gx1 = min(cx + 1, gw - 1) - gx_lo;
        float best = 0.f;
        for (int gy = gy0; gy <= gy1; ++gy) {
          for (int gx = gx0; gx <= gx1; ++gx) {
            const int j = gy * lwc + gx;
            const float score = gcis::slic_score(cand[j], z0, z1, z2, z3, z4);
            if (s < 0 || score < best) {  // ascending ids: the first minimum wins
              best = score;
              s = j;
            }
          }
        }
        const int q = s / lwc;
        ob[(long)y * w + x] = (gy_lo + q) * gw + gx_lo + s - q * lwc;
      }
      if (!want) continue;
      // the moments: extend the open record, or close it and open another
      const bool change = valid && s != cur && cnt > 0;
      if (__any_sync(FULL, change && nrec == REC)) {
        flush(stage, wslots, wmask, nrec, lane);
        nrec = 0;
      }
      if (change) {
        stage[nrec * 32 + lane] = Rec{{s0, s1, s2}, cur, sx, cnt, y};
        ++nrec;
        s0 = s1 = s2 = 0.0;
        sx = cnt = 0;
      }
      if (valid) {
        cur = s;
        s0 += (double)z0;
        s1 += (double)z1;
        s2 += (double)z2;
        sx += x;
        ++cnt;
      }
    }
    if (!want) continue;
    // the run's open record, then the warp's flush
    if (__any_sync(FULL, cnt > 0 && nrec == REC)) {
      flush(stage, wslots, wmask, nrec, lane);
      nrec = 0;
    }
    if (cnt > 0) stage[nrec++ * 32 + lane] = Rec{{s0, s1, s2}, cur, sx, cnt, y};
    flush(stage, wslots, wmask, nrec, lane);
  }
  if (!want) return;
  __syncthreads();
  double* out = parts + ((long)b * gridDim.x + blockIdx.x) * lw * 6;
  for (int j = tid; j < lw; j += NT) {  // every hoisted cell, its warps' slots in warp order
    double v0 = 0.0, v1 = 0.0, v2 = 0.0;
    long sxs = 0, sys = 0, c = 0;
    for (int q = 0; q < NWARP; ++q) {
      if (!((masks[q * MASKW + (j >> 5)] >> (j & 31)) & 1u)) continue;
      const Slot& o = slots[q * lw + j];
      v0 += o.s[0];
      v1 += o.s[1];
      v2 += o.s[2];
      sxs += o.sx;
      sys += o.sy;
      c += o.cnt;
    }
    double* o = out + j * 6;
    o[0] = v0;
    o[1] = v1;
    o[2] = v2;
    o[3] = (double)sys;
    o[4] = (double)sxs;
    o[5] = (double)c;
  }
}

// Centroid of superpixel i (image i / (gh gw)) from the partials of the
// tiles whose hoisted set holds it, one warp each: lane e adds entry e of
// the (tile row, tile column) list, then a fixed butterfly.
__global__ void slic_w3_update_kernel(const double* __restrict__ parts, float* cent, int B,
                                      int gh, int gw, int ty, int tx, int nty, int ntx) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= (long)B * gh * gw) return;  // whole warps
  const int lane = threadIdx.x & 31;
  const int b = (int)(i / (gh * gw)), s = (int)(i % (gh * gw));
  const int gy = s / gw, gx = s - gy * gw;
  const int a_lo = max(gy - 1, 0) / ty, a_hi = min(nty - 1, (gy + 1) / ty);
  const int c_lo = max(gx - 1, 0) / tx, c_hi = min(ntx - 1, (gx + 1) / tx);
  const int nc = c_hi - c_lo + 1, entries = (a_hi - a_lo + 1) * nc;
  const int lwc = tx + 2, lw = (ty + 2) * lwc;
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int e = lane; e < entries; e += 32) {
    const int a = a_lo + e / nc, c = c_lo + e % nc;
    const int j = (gy - a * ty + 1) * lwc + gx - c * tx + 1;
    const double* p = parts + ((((long)b * nty + a) * ntx + c) * lw + j) * 6;
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[k] += p[k];
  }
#pragma unroll
  for (int k = 0; k < 6; ++k)
    for (int off = 16; off > 0; off >>= 1) acc[k] += __shfl_xor_sync(FULL, acc[k], off);
  if (lane == 0 && acc[5] > 0.0) {
    float* cs = cent + ((long)b * gh * gw + s) * 5;
    const float fc = (float)acc[5];
    for (int k = 0; k < 5; ++k) cs[k] = __fdiv_rn((float)acc[k], fc);
  }
}

bool bad_plan(int B, int h, int w, int gh, int gw, int ty, int tx) {
  return B < 1 || B > 65535 || h < 1 || w < 1 || gh < 1 || gw < 1 || ty < 1 || tx < 1 ||
         ty > gh || tx > gw || (ty + 2) * (tx + 2) > LWMAX;
}

cudaError_t pass(const float* lab, const float* cent, int* labels, double* parts,
                 const int* rows, const int* cols, int B, int h, int w, int gh, int gw, int ty,
                 int tx, float fy, float fx, float sw, cudaStream_t st) {
  const int nty = (gh + ty - 1) / ty, ntx = (gw + tx - 1) / tx;
  const size_t smem = pass_smem((ty + 2) * (tx + 2), parts != nullptr);
  if (smem > 48 * 1024) {  // tiles of many small cells
    const cudaError_t err = cudaFuncSetAttribute(
        slic_w3_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  slic_w3_pass_kernel<<<dim3(nty * ntx, B), NT, smem, st>>>(
      lab, cent, labels, parts, rows, cols, h, w, gh, gw, ty, tx, ntx, fy, fx, sw);
  return cudaGetLastError();
}

cudaError_t update(const double* parts, float* cent, int B, int gh, int gw, int ty, int tx,
                   cudaStream_t st) {
  const int nty = (gh + ty - 1) / ty, ntx = (gw + tx - 1) / tx;
  const long warps = (long)B * gh * gw;
  slic_w3_update_kernel<<<(unsigned)((warps + 3) / 4), 128, 0, st>>>(parts, cent, B, gh, gw,
                                                                     ty, tx, nty, ntx);
  return cudaGetLastError();
}

}  // namespace

// lab: (B, H, W, 3) float32. cent: (B, gh * gw, 5) float32 [L, a, b, y, x]
// initial centroids, updated in place. labels: (B, H, W) int32 out. parts:
// (B, ceil(gh / ty), ceil(gw / tx), (ty + 2)(tx + 2), 6) float64 scratch.
// rows, cols: int32 (ceil(gh / ty) + 1,) and (ceil(gw / tx) + 1,), the
// tiles' first pixel rows and columns (slic_w3_plan). fy, fx:
// float32(gh / h), float32(gw / w); sw: the spatial weight's square root.
// n_iter passes with partials and updates, then a pass that only assigns.
GCIS_API int gcis_slic(const float* lab, float* cent, int* labels, double* parts,
                       const int* rows, const int* cols, int B, int h, int w, int gh, int gw,
                       int ty, int tx, int n_iter, float fy, float fx, float sw,
                       void* stream) {
  if (bad_plan(B, h, w, gh, gw, ty, tx) || n_iter < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  for (int it = 0; it <= n_iter; ++it) {
    const bool last = it == n_iter;
    cudaError_t err = pass(lab, cent, labels, last ? nullptr : parts, rows, cols, B, h, w, gh,
                           gw, ty, tx, fy, fx, sw, st);
    if (err != cudaSuccess || last) return (int)err;
    err = update(parts, cent, B, gh, gw, ty, tx, st);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// One K11 pass: labels under cent, and the partials unless parts is null.
GCIS_API int gcis_slic_w3_pass(const float* lab, const float* cent, int* labels,
                               double* parts, const int* rows, const int* cols, int B, int h,
                               int w, int gh, int gw, int ty, int tx, float fy, float fx,
                               float sw, void* stream) {
  if (bad_plan(B, h, w, gh, gw, ty, tx)) return (int)cudaErrorInvalidValue;
  return (int)pass(lab, cent, labels, parts, rows, cols, B, h, w, gh, gw, ty, tx, fy, fx, sw,
                   (cudaStream_t)stream);
}

// One K11 update: cent in place from a pass's partials.
GCIS_API int gcis_slic_w3_update(const double* parts, float* cent, int B, int gh, int gw,
                                 int ty, int tx, void* stream) {
  if (bad_plan(B, 1, 1, gh, gw, ty, tx)) return (int)cudaErrorInvalidValue;
  return (int)update(parts, cent, B, gh, gw, ty, tx, (cudaStream_t)stream);
}
