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
// kernel on the same uniform bands that plan="w5" selects: here every
// iteration of an image in one thread-block cluster of an ordinary launch,
// each CTA owning a fixed run of the image's pieces (below). Its labels are
// bit-equal to the banded loop's.
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
// updates (~4.8 GFLOP at config4, 0.072 ms at 67 TFLOP/s). A pass re-reads
// the Lab (16 B a pixel, 0.020 ms at config4). The design:
//   - pass: one 256-thread block per (image, band, column piece). The
//     block first hoists the candidates its piece can reach (the window's
//     w_rows grid rows by the piece's cell columns +- 1) into shared memory
//     with their spatial terms sw * y, sw * x and |c|^2 computed once, in
//     slic_plain's order (no fused multiply-add), so a pixel scores
//     from the table and its labels stay bit-equal. Each thread then takes
//     a run of consecutive pixels of one row (the piece's width over the
//     band row's NT / band_rows threads, a multiple of 4; lanes on
//     neighbouring runs), loads its Lab as 16-byte vectors where rows are
//     16-byte aligned (W % 4 == 0; scalar loads otherwise) and writes its
//     labels as int4 the same way;
//   - moments: a run mostly keeps one id, so a thread adds its pixels'
//     moments in float64 registers while the id is unchanged and closes the
//     record when it changes. Closed records wait in a per-lane staging
//     area (REC a lane); at the end of a run, or when a lane would overflow,
//     the warp flushes: the lanes holding one id are matched
//     (__match_any_sync) and the lowest of them adds their records in lane
//     order into the warp's slot for that id (the first record stores it
//     and sets the slot's bit in the warp's mask, so slots need no
//     zeroing; a warp has a slot for each candidate of the piece). The
//     block adds the slots its warps touched in warp order and writes the
//     band window's partials, zero outside the piece's candidates.
//     No float atomics; x, y and counts are summed as integers, exactly;
//   - update: one warp per superpixel, lanes over the (band, column piece)
//     partials that hold it (in order, then a fixed butterfly), rounding to
//     float32 once and keeping an empty superpixel's centroid.
// On the Lab of uint8 images the float64 sums are exact, so these orders
// give the plain version's bits; the order is fixed all the same.
//
// K12 runs the whole loop in one launch on the geometry that
// models/slic_fused.py::slic_w5_plan computes and hands over as an int32
// table (each CTA copies it into its shared memory):
//   - one thread-block cluster of `ctas` CTAs an image (16 needs the
//     non-portable size) in an ordinary launch: images beyond what the card
//     holds at once run as later waves, since no barrier spans two images.
//     The bound above is not what holds it: a pass is latency-bound per
//     SM, and one cluster gives an image at most 16 SMs;
//   - the image's pieces (bands by column pieces of cw = 128 or 64
//     columns) in (band, piece) order: CTA r owns pieces first[r] ..
//     first[r + 1] - 1 for the whole call, and its `groups` groups of 256
//     threads pass every groups-th of them side by side, each group with
//     its own scratch and named barrier. A CTA keeps in its shared memory a
//     table of the hoisted candidates (gcis::Cand) of the grid rows its
//     pieces' windows reach, all gw columns: never the whole image's
//     (12,432 superpixels at the range's extreme would not fit one CTA);
//   - pass (w5_pass): K13's pass transposed: a warp takes 32 neighbouring
//     pixel columns and each lane walks down its column two rows a step,
//     so a warp's Lab loads and label stores are contiguous, its candidate
//     reads nearly broadcasts, and where both rows lie in one cell row
//     each candidate read feeds two independent score chains. Its
//     partials, the piece's own window (w_rows x its cell columns x [L, a,
//     b, y, x, count] float64), go to the CTA's shared memory, double-
//     buffered by iteration, or, where the plan finds they do not fit
//     (tall, narrow frames), to a (B, 2, pieces, nmax, 6) scratch in global
//     memory that stays in the L2; only the last pass writes labels;
//   - one cluster.sync() an iteration; then each CTA recomputes every
//     superpixel of its table, one thread each, from the partials of the
//     pieces whose window holds it, read from their owners' shared memory
//     (distributed shared memory) or the scratch in (band, column piece)
//     order, rounding to float32 once and keeping an empty superpixel's
//     centroid. Every CTA that holds a superpixel adds the same partials in
//     the same order, so all hold the same bits. Two buffers make one
//     barrier an iteration enough: a CTA rewrites a buffer only after the
//     next iteration's barrier, which every reader of it has passed.
// No grid-wide barrier, and where the partials fit shared memory no partial
// or centroid goes through global memory. Its pieces' partials are summed
// in another order than K13's (runs down columns, not along rows); on the
// Lab of uint8 images the float64 sums are exact, so the bits are the same.

#include <cooperative_groups.h>

#include "slic_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXC = 128;  // candidates per band window, w_rows * gw
constexpr int MASKW = MAXC / 32;  // words of a warp's touched-slot mask
constexpr int MAX_CTAS = 16;  // K12's largest cluster (the non-portable size)
// K12's dynamic shared memory at most: the 227 KB a block may take, less
// room for its static piece starts
constexpr int W5_SMEM_MAX = 227 * 1024 - 1024;

using gcis::Cand;
using gcis::FULL;
using gcis::flush;
using gcis::Rec;
using gcis::REC;
using gcis::Slot;

// Shared memory of a pass block whose pieces reach at most `nloc` window
// candidates (w_rows x the piece's cell columns +- 1).
__host__ __device__ inline size_t pass_smem(int nloc, bool partials) {
  return sizeof(Cand) * nloc + (partials ? sizeof(Slot) * NWARP * nloc +
                                               sizeof(Rec) * NWARP * REC * 32 +
                                               sizeof(unsigned) * NWARP * MASKW
                                         : 0);
}

// clip(int(f32(i) * scale), 0, g - 1) on the host, as slic_cell_of.
inline int host_cell(int i, float scale, int g) {
  const int c = (int)((float)i * scale);
  return c < 0 ? 0 : (c > g - 1 ? g - 1 : c);
}

// The cell columns a piece [x0, x1) reaches: its pixels' cells +- 1.
__host__ __device__ inline int2 piece_columns(int x0, int x1, float fx, int gw) {
#ifdef __CUDA_ARCH__
  const int lo = gcis::slic_cell_of(x0, fx, gw), hi = gcis::slic_cell_of(x1 - 1, fx, gw);
#else
  const int lo = host_cell(x0, fx, gw), hi = host_cell(x1 - 1, fx, gw);
#endif
  return make_int2(lo > 0 ? lo - 1 : 0, hi < gw - 1 ? hi + 1 : gw - 1);
}

// The most window candidates any column piece of width cw reaches.
inline int max_local(int w, int cw, float fx, int gw, int wr) {
  int most = 1;
  for (int x0 = 0; x0 < w; x0 += cw) {
    const int2 c = piece_columns(x0, x0 + cw < w ? x0 + cw : w, fx, gw);
    most = c.y - c.x + 1 > most ? c.y - c.x + 1 : most;
  }
  return wr * most;
}

__device__ __forceinline__ int band_first_row(int t, int br, int gh, int h, int wr) {
  const int base = (int)((long)t * br * gh / h) - 1;
  return max(0, min(base, gh - wr));
}

// One (image, band, column piece): assign its pixels (labels out) and, when
// parts is not null, write its partials. All threads of the block call it;
// smem holds pass_smem(nmax, parts != nullptr) bytes, nmax the most local
// candidates of any piece (max_local). A thread takes runs of `run` pixels
// (a multiple of 4).
__device__ void band_pass(const float* __restrict__ lab, const float* cent, int* labels,
                          double* parts, char* smem, int nmax, int b, int t, int cp, int h,
                          int w, int gh, int gw, int wr, int br, int nb, int cw, int ncp,
                          int run, float fy, float fx, float sw, bool vec) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ncr = wr * gw;
  const int y0 = t * br, y1 = min(h, y0 + br);
  const int x0 = cp * cw, x1 = min(w, x0 + cw);
  const int rb = band_first_row(t, br, gh, h, wr), lo = rb * gw;
  // the piece's local window: the w_rows grid rows from rb by the cell
  // columns gx_lo .. gx_lo + ncw - 1 its pixels reach
  const int2 cols = piece_columns(x0, x1, fx, gw);
  const int gx_lo = cols.x, ncw = cols.y - cols.x + 1, nloc = wr * ncw;
  const long n = (long)h * w;
  const float* lb = lab + b * n * 3;
  int* ob = labels + b * n;
  const bool want = parts != nullptr;
  Cand* cand = reinterpret_cast<Cand*>(smem);  // (nloc,)
  Slot* slots = reinterpret_cast<Slot*>(cand + nmax);  // (NWARP, nmax)
  Rec* stage = reinterpret_cast<Rec*>(slots + NWARP * nmax) + warp * REC * 32;
  unsigned* masks = reinterpret_cast<unsigned*>(reinterpret_cast<Rec*>(slots + NWARP * nmax) +
                                                NWARP * REC * 32);  // (NWARP, MASKW)
  Slot* wslots = slots + warp * nmax;
  unsigned* wmask = masks + warp * MASKW;

  __syncthreads();  // the block's previous piece (K12) is done with smem
  for (int j = tid; j < nloc; j += NT) {
    const int gyr = j / ncw;
    cand[j] = gcis::slic_cand(
        cent + ((long)b * gh * gw + (rb + gyr) * gw + gx_lo + j - gyr * ncw) * 5, sw);
  }
  if (want && tid < NWARP * MASKW) masks[tid] = 0u;  // no slot touched yet
  __syncthreads();

  const int tpr = (x1 - x0 + run - 1) / run;  // runs a row of the piece
  const int items = (y1 - y0) * tpr;
  for (int base = 0; base < items; base += NT) {  // the same trip count in every lane
    const int item = base + tid;
    const bool live = item < items;
    const int y = live ? y0 + item / tpr : y0;
    const int xs = live ? x0 + (item % tpr) * run : x1;
    const int cy = gcis::slic_cell_of(y, fy, gh);
    const int gy0 = max(cy - 1, 0) - rb, gy1 = min(cy + 1, gh - 1) - rb;
    const float z3 = __fmul_rn(sw, (float)y);
    int cur = -1, nrec = 0, sx = 0, cnt = 0;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    for (int g4 = 0; g4 < run; g4 += 4) {
      const int xg = xs + g4;
      float px[12];
      if (vec) {
        if (xg < x1) {  // x1 is a multiple of 4 here: a group is whole
          const float4* src = reinterpret_cast<const float4*>(lb + ((long)y * w + xg) * 3);
#pragma unroll
          for (int v = 0; v < 3; ++v) {
            const float4 f = src[v];
            px[4 * v] = f.x;
            px[4 * v + 1] = f.y;
            px[4 * v + 2] = f.z;
            px[4 * v + 3] = f.w;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (xg + i < x1) {
            const float* src = lb + ((long)y * w + xg + i) * 3;
            px[3 * i] = src[0];
            px[3 * i + 1] = src[1];
            px[3 * i + 2] = src[2];
          }
      }
      int out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int x = xg + i;
        const bool valid = x < x1;
        int s = -1;
        if (valid) {
          const float z0 = px[3 * i], z1 = px[3 * i + 1], z2 = px[3 * i + 2];
          const float z4 = __fmul_rn(sw, (float)x);
          const int cx = gcis::slic_cell_of(x, fx, gw);
          const int gx0 = max(cx - 1, 0) - gx_lo, gx1 = min(cx + 1, gw - 1) - gx_lo;
          float best = 0.f;
          for (int gy = gy0; gy <= gy1; ++gy) {
            for (int gx = gx0; gx <= gx1; ++gx) {
              const int j = gy * ncw + gx;  // local index, ascending with the id
              const float score = gcis::slic_score(cand[j], z0, z1, z2, z3, z4);
              if (s < 0 || score < best) {  // ascending ids: the first minimum wins
                best = score;
                s = j;
              }
            }
          }
          out[i] = lo + (s / ncw) * gw + gx_lo + s % ncw;
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
          s0 += (double)px[3 * i];
          s1 += (double)px[3 * i + 1];
          s2 += (double)px[3 * i + 2];
          sx += x;
          ++cnt;
        }
      }
      if (vec) {
        if (xg < x1)
          *reinterpret_cast<int4*>(ob + (long)y * w + xg) = make_int4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (xg + i < x1) ob[(long)y * w + xg + i] = out[i];
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
  for (int j = tid; j < ncr; j += NT) {  // every window candidate, 0 outside the piece's
    double v0 = 0.0, v1 = 0.0, v2 = 0.0;
    long sx = 0, sy = 0, c = 0;
    const int gyr = j / gw, gxr = j - gyr * gw - gx_lo;
    const int jl = gyr * ncw + gxr;
    for (int q = 0; q < NWARP && gxr >= 0 && gxr < ncw; ++q) {  // warp order, touched slots
      if (!((masks[q * MASKW + (jl >> 5)] >> (jl & 31)) & 1u)) continue;
      const Slot& o = slots[q * nmax + jl];
      v0 += o.s[0];
      v1 += o.s[1];
      v2 += o.s[2];
      sx += o.sx;
      sy += o.sy;
      c += o.cnt;
    }
    double* out = parts + ((((long)b * nb + t) * ncp + cp) * ncr + j) * 6;
    out[0] = v0;
    out[1] = v1;
    out[2] = v2;
    out[3] = (double)sy;
    out[4] = (double)sx;
    out[5] = (double)c;
  }
}

// Centroid s of image b from the partials of the bands whose window holds
// it, by one warp: lane l adds entries l, l + 32, ... of the (band, column
// piece) list in order, then a fixed butterfly. All lanes call it.
__device__ __forceinline__ void band_update(const double* parts, float* cent, int b, int s,
                                            int h, int gh, int gw, int wr, int br, int nb,
                                            int ncp) {
  const int lane = threadIdx.x & 31;
  const int gy = s / gw, ncr = wr * gw;
  int t_lo = nb, t_hi = -1;  // the window rows are nondecreasing in t
  for (int t = 0; t < nb; ++t) {
    const int rb = band_first_row(t, br, gh, h, wr);
    if (gy >= rb && gy < rb + wr) {
      t_lo = min(t_lo, t);
      t_hi = t;
    }
  }
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  const int entries = max(0, t_hi - t_lo + 1) * ncp;
  for (int e = lane; e < entries; e += 32) {
    const int t = t_lo + e / ncp, cp = e % ncp;
    const int rb = band_first_row(t, br, gh, h, wr);
    const double* p = parts + ((((long)b * nb + t) * ncp + cp) * ncr + (s - rb * gw)) * 6;
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

__global__ void __launch_bounds__(NT) slic_band_pass_kernel(
    const float* __restrict__ lab, const float* __restrict__ cent, int* labels, double* parts,
    int nmax, int h, int w, int gh, int gw, int wr, int br, int nb, int cw, int ncp, int run,
    float fy, float fx, float sw, int vec) {
  extern __shared__ __align__(16) char smem[];
  band_pass(lab, cent, labels, parts, smem, nmax, blockIdx.y, blockIdx.x / ncp,
            blockIdx.x % ncp, h, w, gh, gw, wr, br, nb, cw, ncp, run, fy, fx, sw, vec != 0);
}

__global__ void slic_band_update_kernel(const double* __restrict__ parts, float* cent, int B,
                                        int h, int gh, int gw, int wr, int br, int nb,
                                        int ncp) {
  const int i = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;  // one warp a superpixel
  if (i >= B * gh * gw) return;
  band_update(parts, cent, i / (gh * gw), i % (gh * gw), h, gh, gw, wr, br, nb, ncp);
}

// The ints of K12's plan table (below).
__host__ __device__ inline int w5_table_len(int ctas, int gh, int nb, int ncp) {
  return 3 * ctas + 1 + 2 * gh + nb + 2 * ncp;
}

// K12's scalars.
struct W5Geom {
  int h, w, gh, gw, wr, br, cw;
  float fy, fx, sw;
};

// A group's named barrier: K12 runs a pass on one group of NT threads of
// its CTA.
__device__ __forceinline__ void group_sync(int bar) {
  asm volatile("bar.sync %0, %1;" ::"r"(bar), "n"(NT) : "memory");
}

// Pixel i's Lab.
__device__ __forceinline__ void lab_at(const float* __restrict__ lb, long i, float& z0,
                                       float& z1, float& z2) {
  z0 = lb[3 * i];
  z1 = lb[3 * i + 1];
  z2 = lb[3 * i + 2];
}

// K12's pass of piece (t, cp) of image b by one group of NT threads (named
// barrier `bar`), with the candidates copied from the CTA's table (grid
// rows from ty0, gw columns), window rows from rb and cell columns gx_lo ..
// gx_lo + ncw - 1 (the plan's); labels written when labels is not null
// and, when parts is not null, the partials of the piece's nloc local
// candidates written to parts[0 .. 6 nloc). K13's pass transposed: a warp
// takes 32 neighbouring pixel columns and each lane walks down its column
// through a run of rows, so the Lab loads and label stores of a warp are
// contiguous, its lanes read the candidates of at most three cells from
// shared memory (nearly a broadcast), a lane's cell column is fixed and its
// id changes only where the run crosses a cell row. A lane takes two rows a
// step: where both lie in one cell row (nearly always) each candidate read
// feeds both pixels' scores, two independent chains. A pixel scores its 3x3
// neighbour cells unrolled, cells past the grid's edge clamped to the edge
// cell (they repeat a cell scored just before them, and a strict < keeps
// the first minimum in ascending id, as K13's loop does). The moments go
// through K13's records, flushes and slots, a record summing its rows.
__device__ void w5_pass(const float* __restrict__ lab, const Cand* table, int ty0, int* labels,
                        double* parts, char* smem, int nmax, int b, int t, int cp, int rb,
                        int gx_lo, int ncw, const W5Geom& g, int bar) {
  const int tid = threadIdx.x % NT, lane = tid & 31, warp = tid >> 5;
  const int y0 = t * g.br, y1 = min(g.h, y0 + g.br);
  const int x0 = cp * g.cw, x1 = min(g.w, x0 + g.cw);
  const int lo = rb * g.gw, nloc = g.wr * ncw;
  const long n = (long)g.h * g.w;
  const float* lb = lab + b * n * 3;
  int* ob = labels != nullptr ? labels + b * n : nullptr;
  const bool want = parts != nullptr;
  Cand* cand = reinterpret_cast<Cand*>(smem);  // (nloc,)
  Slot* slots = reinterpret_cast<Slot*>(cand + nmax);  // (NWARP, nmax)
  Rec* stage = reinterpret_cast<Rec*>(slots + NWARP * nmax) + warp * REC * 32;
  unsigned* masks = reinterpret_cast<unsigned*>(reinterpret_cast<Rec*>(slots + NWARP * nmax) +
                                                NWARP * REC * 32);  // (NWARP, MASKW)
  Slot* wslots = slots + warp * nmax;
  unsigned* wmask = masks + warp * MASKW;

  group_sync(bar);  // the group's previous piece is done with smem
  for (int j = tid; j < nloc; j += NT) {
    const int gyr = j / ncw;
    cand[j] = table[(rb + gyr - ty0) * g.gw + gx_lo + j - gyr * ncw];
  }
  if (want && tid < NWARP * MASKW) masks[tid] = 0u;  // no slot touched yet
  group_sync(bar);

  // items: (32-column group, run of rows), a warp each; the column groups
  // are cut into enough runs to give every warp one
  const int cgs = (x1 - x0 + 31) / 32, nrows = y1 - y0;
  const int per = (nrows * cgs + NWARP - 1) / NWARP;  // rows a run
  const int items = cgs * ((nrows + per - 1) / per);
  for (int item = warp; item < items; item += NWARP) {  // warp-uniform
    const int x = x0 + (item % cgs) * 32 + lane;
    const int ys = y0 + (item / cgs) * per, ye = min(y1, ys + per);
    const bool col = x < x1;
    const int cx = gcis::slic_cell_of(x, g.fx, g.gw);
    const int gx0 = max(cx - 1, 0) - gx_lo, gx1 = min(cx + 1, g.gw - 1) - gx_lo;
    // the local columns of the 3x3 cells, clamped at the grid's edge
    const int c0 = gx0, c1 = min(gx0 + 1, gx1), c2 = min(gx0 + 2, gx1);
    const float z4 = __fmul_rn(g.sw, (float)x);
    int cur = -1, nrec = 0, sy = 0, cnt = 0;
    double s0 = 0.0, s1 = 0.0, s2 = 0.0;
    // pixel (y, x) with Lab z and id s into the run's moments: extend the
    // open record, or close it and open another
    auto add = [&](int s, float z0, float z1, float z2, int y) {
      const bool change = col && s != cur && cnt > 0;
      if (__any_sync(FULL, change && nrec == REC)) {
        flush<true>(stage, wslots, wmask, nrec, lane);
        nrec = 0;
      }
      if (change) {
        stage[nrec * 32 + lane] = Rec{{s0, s1, s2}, cur, x * cnt, cnt, sy};
        ++nrec;
        s0 = s1 = s2 = 0.0;
        sy = cnt = 0;
      }
      if (col) {
        cur = s;
        s0 += (double)z0;
        s1 += (double)z1;
        s2 += (double)z2;
        sy += y;
        ++cnt;
      }
    };
    auto label = [&](int y, int s) {
      if (ob != nullptr) ob[(long)y * g.w + x] = lo + (s / ncw) * g.gw + gx_lo + s % ncw;
    };
    for (int y = ys; y < ye; y += 2) {  // two rows a step, the same in every lane
      const bool two = y + 1 < ye;
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, b0 = 0.f, b1 = 0.f, b2 = 0.f;
      if (col) {
        lab_at(lb, (long)y * g.w + x, a0, a1, a2);
        if (two) lab_at(lb, (long)(y + 1) * g.w + x, b0, b1, b2);
      }
      const int cya = gcis::slic_cell_of(y, g.fy, g.gh);
      const int cyb = two ? gcis::slic_cell_of(y + 1, g.fy, g.gh) : cya;
      const float za = __fmul_rn(g.sw, (float)y), zb = __fmul_rn(g.sw, (float)(y + 1));
      int sa = -1, sb = -1;
      if (col) {
        // the local rows of the 3x3 cells, clamped at the grid's edge
        int gy0 = max(cya - 1, 0) - rb, gy1 = min(cya + 1, g.gh - 1) - rb;
        int r0 = gy0 * ncw, r1 = min(gy0 + 1, gy1) * ncw, r2 = min(gy0 + 2, gy1) * ncw;
        float besta = 0.f, bestb = 0.f;
        if (cyb == cya) {  // one read of each candidate for both rows
#pragma unroll
          for (int k = 0; k < 9; ++k) {  // the 3x3 cells, ascending ids
            const int j = (k < 3 ? r0 : k < 6 ? r1 : r2) + (k % 3 == 0 ? c0 : k % 3 == 1 ? c1 : c2);
            const Cand& c = cand[j];
            const float scorea = gcis::slic_score(c, a0, a1, a2, za, z4);
            const float scoreb = gcis::slic_score(c, b0, b1, b2, zb, z4);
            if (k == 0 || scorea < besta) {  // a strict <: the first minimum
              besta = scorea;
              sa = j;
            }
            if (k == 0 || scoreb < bestb) {
              bestb = scoreb;
              sb = j;
            }
          }
        } else {
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const int j = (k < 3 ? r0 : k < 6 ? r1 : r2) + (k % 3 == 0 ? c0 : k % 3 == 1 ? c1 : c2);
            const float score = gcis::slic_score(cand[j], a0, a1, a2, za, z4);
            if (k == 0 || score < besta) {
              besta = score;
              sa = j;
            }
          }
          gy0 = max(cyb - 1, 0) - rb, gy1 = min(cyb + 1, g.gh - 1) - rb;
          r0 = gy0 * ncw, r1 = min(gy0 + 1, gy1) * ncw, r2 = min(gy0 + 2, gy1) * ncw;
#pragma unroll
          for (int k = 0; k < 9; ++k) {
            const int j = (k < 3 ? r0 : k < 6 ? r1 : r2) + (k % 3 == 0 ? c0 : k % 3 == 1 ? c1 : c2);
            const float score = gcis::slic_score(cand[j], b0, b1, b2, zb, z4);
            if (k == 0 || score < bestb) {
              bestb = score;
              sb = j;
            }
          }
        }
        label(y, sa);
        if (two) label(y + 1, sb);
      }
      if (!want) continue;
      add(sa, a0, a1, a2, y);
      if (two) add(sb, b0, b1, b2, y + 1);
    }
    if (!want) continue;
    // the run's open record, then the warp's flush
    if (__any_sync(FULL, cnt > 0 && nrec == REC)) {
      flush<true>(stage, wslots, wmask, nrec, lane);
      nrec = 0;
    }
    if (cnt > 0) stage[nrec++ * 32 + lane] = Rec{{s0, s1, s2}, cur, x * cnt, cnt, sy};
    flush<true>(stage, wslots, wmask, nrec, lane);
  }
  if (!want) return;
  group_sync(bar);
  for (int j = tid; j < nloc; j += NT) {  // the piece's candidates, warp order, touched slots
    double v0 = 0.0, v1 = 0.0, v2 = 0.0;
    long sx = 0, sy = 0, c = 0;
    for (int q = 0; q < NWARP; ++q) {
      if (!((masks[q * MASKW + (j >> 5)] >> (j & 31)) & 1u)) continue;
      const Slot& o = slots[q * nmax + j];
      v0 += o.s[0];
      v1 += o.s[1];
      v2 += o.s[2];
      sx += o.sx;
      sy += o.sy;
      c += o.cnt;
    }
    double* out = parts + (long)j * 6;
    out[0] = v0;
    out[1] = v1;
    out[2] = v2;
    out[3] = (double)sy;
    out[4] = (double)sx;
    out[5] = (double)c;
  }
}

// K12's plan table (int32, slic_fused.w5_layout's "table"): first[0 ..
// ctas], each CTA's first piece and then the image's piece count; (ctas, 2)
// the grid rows [ty0, ty1) of each CTA's candidate table; (gh, 2) the bands
// [t_lo, t_hi] whose window holds each grid row (t_lo > t_hi where none
// does); (nb,) each band's first window row rb; (ncp, 2) the cell columns
// [lo, hi] each column piece reaches. Each CTA copies it into its shared
// memory first. A CTA is NG groups of NT threads; group g passes the CTA's pieces g, g +
// NG, ... with a scratch and a named barrier (1 + g) of its own.
template <int NG>
__global__ void __launch_bounds__(NG * NT, 4 / NG) slic_w5_kernel(
    const float* __restrict__ lab, const float* __restrict__ cent, int* labels, double* gparts,
    const int* __restrict__ plan, int P, int kmax, int tmax, int nmax, int nb, int ncp,
    int n_iter, W5Geom g) {
  extern __shared__ __align__(16) char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int b = blockIdx.y, tid = threadIdx.x, group = tid / NT, gw = g.gw;
  const bool local = gparts == nullptr;  // partials in shared memory, read through DSMEM
  double* sparts = reinterpret_cast<double*>(smem);  // (2, kmax, nmax, 6) when local
  Cand* table = reinterpret_cast<Cand*>(sparts + (local ? 12L * kmax * nmax : 0));  // (nt,)
  char* scratch = reinterpret_cast<char*>(table + (long)tmax * gw);  // NG band passes'
  int* first = reinterpret_cast<int*>(scratch + NG * pass_smem(nmax, true));  // the plan
  const int len = w5_table_len(ctas, g.gh, nb, ncp);
  for (int e = tid; e < len; e += NG * NT) first[e] = plan[e];
  scratch += group * pass_smem(nmax, true);  // the group's
  const int p0 = plan[rank], p1 = plan[rank + 1];
  const int ty0 = plan[ctas + 1 + 2 * rank], nt = (plan[ctas + 2 + 2 * rank] - ty0) * gw;
  const int* bands = first + 3 * ctas + 1;
  const int* rbs = bands + 2 * g.gh;
  const int* cols = rbs + nb;
  // piece q's partials of buffer par: in CTA `owner`'s shared memory, or in
  // the image's global scratch
  auto slot = [&](int par, int owner, int q) -> double* {
    if (local)
      return cluster.map_shared_rank(sparts, owner) + (long)(par * kmax + q - first[owner]) * nmax * 6;
    return gparts + (((long)b * 2 + par) * P + q) * nmax * 6;
  };

  for (int e = tid; e < nt; e += NG * NT)
    table[e] = gcis::slic_cand(cent + ((long)b * g.gh * gw + (long)ty0 * gw + e) * 5, g.sw);
  __syncthreads();  // the table and the plan are in shared memory
  for (int it = 0; it <= n_iter; ++it) {
    const bool last = it == n_iter;  // the last pass only assigns
    const int par = it & 1;
    for (int q = p0 + group; q < p1; q += NG) {
      const int t = q / ncp, cp = q - t * ncp;
      double* out = last ? nullptr
                         : (local ? sparts + (long)(par * kmax + q - p0) * nmax * 6
                                  : slot(par, rank, q));
      w5_pass(lab, table, ty0, last ? labels : nullptr, out, scratch, nmax, b, t, cp, rbs[t],
              cols[2 * cp], cols[2 * cp + 1] - cols[2 * cp] + 1, g, 1 + group);
    }
    if (last) break;
    cluster.sync();  // the iteration's barrier: every piece's partials are written
    for (int e = tid; e < nt; e += NG * NT) {  // the table's new centroids, a thread each
      const int gy = ty0 + e / gw, gx = e - (e / gw) * gw;
      // the column pieces whose window holds column gx: a run [cp0, cp1]
      // (their cell columns are nondecreasing in cp); pieces outside it
      // hold 0 for this superpixel
      int cp0 = 0, cp1 = ncp - 1;
      while (cols[2 * cp0 + 1] < gx) ++cp0;
      while (cols[2 * cp1] > gx) --cp1;
      double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
      int owner = 0;
      for (int t = bands[2 * gy]; t <= bands[2 * gy + 1]; ++t) {  // (band, piece) order
        for (int cp = cp0; cp <= cp1; ++cp) {
          const int lo = cols[2 * cp], hi = cols[2 * cp + 1];
          const int q = t * ncp + cp;
          while (q >= first[owner + 1]) ++owner;
          const double2* p = reinterpret_cast<const double2*>(
              slot(par, owner, q) + ((gy - rbs[t]) * (hi - lo + 1) + gx - lo) * 6);
#pragma unroll
          for (int k = 0; k < 3; ++k) {  // written by other SMs: past their L1s
            const double2 v = local ? p[k] : __ldcg(p + k);
            acc[2 * k] += v.x;
            acc[2 * k + 1] += v.y;
          }
        }
      }
      if (acc[5] > 0.0) {
        const float fc = (float)acc[5];
        float cs[5];
#pragma unroll
        for (int k = 0; k < 5; ++k) cs[k] = __fdiv_rn((float)acc[k], fc);
        table[e] = gcis::slic_cand(cs, g.sw);
      }
    }
    __syncthreads();  // the table is whole before any group's next pass
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

bool bad_plan(int B, int h, int w, int gh, int gw, int wr, int br, int cw) {
  return B < 1 || h < 1 || w < 1 || gh < 1 || gw < 1 || wr < 1 || wr > gh ||
         wr * gw > MAXC || br < 1 || cw < 1;
}

// 16-byte Lab and label rows: every row and column piece starts on a
// multiple of 4 pixels.
int vec_rows(const void* lab, const void* labels, int w, int cw) {
  return ((size_t)lab % 16 == 0 && (size_t)labels % 16 == 0 && w % 4 == 0 && cw % 4 == 0);
}

// A thread's run: the piece's width over the threads a band row gets
// (NT / band_rows), rounded up to a multiple of 4 pixels.
int run_length(int cw, int br) {
  const int tpr = NT / br > 0 ? NT / br : 1;
  return ((cw + tpr - 1) / tpr + 3) / 4 * 4;
}

// K12's shared memory: the partials' two buffers (when in shared memory),
// the candidate table, a band pass's scratch for each group and the plan
// table; mirrored by slic_fused.w5_layout.
size_t w5_smem(int kmax, int tmax, int gw, int nmax, int groups, bool local, int table_len) {
  return (local ? sizeof(double) * 12 * kmax * nmax : 0) + sizeof(Cand) * tmax * gw +
         groups * pass_smem(nmax, true) + sizeof(int) * table_len;
}

// K12's launch of B images over clusters of `ctas` CTAs of NG groups: the
// kernel's attributes set, cfg filled (cfg.attrs points at attr).
template <int NG>
cudaError_t w5_configure(int B, int ctas, int smem, cudaStream_t s, cudaLaunchConfig_t& cfg,
                         cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(slic_w5_kernel<NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && ctas > 8)
    err = cudaFuncSetAttribute(slic_w5_kernel<NG>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3(ctas, B);
  cfg.blockDim = dim3(NG * NT);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return err;
}

template <int NG>
cudaError_t w5_launch(int B, int ctas, int smem, cudaStream_t s, const float* lab,
                      const float* cent, int* labels, double* parts, const int* plan, int P,
                      int kmax, int tmax, int nmax, int nb, int ncp, int n_iter,
                      const W5Geom& g) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = w5_configure<NG>(B, ctas, smem, s, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, slic_w5_kernel<NG>, lab, cent, labels, parts, plan, P, kmax,
                            tmax, nmax, nb, ncp, n_iter, g);
}

template <int NG>
cudaError_t w5_active(int ctas, int smem, int* out, cudaStream_t s) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = w5_configure<NG>(1, ctas, smem, s, cfg, attr);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(out, (const void*)slic_w5_kernel<NG>, &cfg);
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
  const int nmax = max_local(w, cw, fx, gw, wr);
  const size_t smem = pass_smem(nmax, parts != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      slic_band_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  slic_band_pass_kernel<<<dim3(nb * ncp, B), NT, smem, (cudaStream_t)stream>>>(
      lab, cent, labels, parts, nmax, h, w, gh, gw, wr, br, nb, cw, ncp, run_length(cw, br), fy,
      fx, sw, vec_rows(lab, labels, w, cw));
  return (int)cudaGetLastError();
}

// K13's update: cent (B, gh * gw, 5) in place from the pass's partials of
// ncp column pieces, one warp a superpixel.
GCIS_API int gcis_slic_band_update(const double* parts, float* cent, int B, int h, int gh,
                                   int gw, int wr, int br, int ncp, void* stream) {
  if (bad_plan(B, h, 1, gh, gw, wr, br, ncp)) return (int)cudaErrorInvalidValue;
  const int nb = (h + br - 1) / br;
  const long warps = (long)B * gh * gw;
  slic_band_update_kernel<<<(unsigned)((warps + 3) / 4), 128, 0, (cudaStream_t)stream>>>(
      parts, cent, B, h, gh, gw, wr, br, nb, ncp);
  return (int)cudaGetLastError();
}

// K12: n_iter passes and updates and the last assignment in one launch of
// B clusters of `ctas` CTAs of `groups` (1, 2 or 4) groups of NT threads (an
// ordinary launch: clusters the card cannot hold at once wait for a later
// wave). lab, cent and labels as K13's; cent is read only. plan: the device
// copy of slic_w5_plan's int32 table; parts: null when the partials live in
// shared memory, else a (B, 2, pieces, nmax, 6) float64 scratch. kmax, tmax,
// nmax and smem are the plan's: the most pieces and table rows of a CTA,
// the most local candidates of a piece and the dynamic shared memory, each
// checked here against this file's arithmetic.
GCIS_API int gcis_slic_w5(const float* lab, const float* cent, int* labels, double* parts,
                          const int* plan, int B, int h, int w, int gh, int gw, int wr, int br,
                          int cw, int n_iter, int ctas, int groups, int kmax, int tmax, int nmax,
                          int smem, float fy, float fx, float sw, void* stream) {
  if (bad_plan(B, h, w, gh, gw, wr, br, cw) || n_iter < 0 || B > 65535 || ctas < 1 ||
      ctas > MAX_CTAS || tmax < 1 || (groups != 1 && groups != 2 && groups != 4))
    return (int)cudaErrorInvalidValue;
  const int nb = (h + br - 1) / br, ncp = (w + cw - 1) / cw, P = nb * ncp;
  int most = 0;  // the most pieces a CTA owns: first[r] = r P / ctas
  for (int r = 0; r < ctas; ++r) most = max(most, (r + 1) * P / ctas - r * P / ctas);
  if (kmax != most || nmax != max_local(w, cw, fx, gw, wr) ||
      (size_t)smem !=
          w5_smem(kmax, tmax, gw, nmax, groups, parts == nullptr, w5_table_len(ctas, gh, nb, ncp)) ||
      smem > W5_SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const W5Geom g{h, w, gh, gw, wr, br, cw, fy, fx, sw};
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      groups == 1   ? w5_launch<1>(B, ctas, smem, s, lab, cent, labels, parts, plan, P, kmax,
                                   tmax, nmax, nb, ncp, n_iter, g)
      : groups == 2 ? w5_launch<2>(B, ctas, smem, s, lab, cent, labels, parts, plan, P, kmax,
                                   tmax, nmax, nb, ncp, n_iter, g)
                    : w5_launch<4>(B, ctas, smem, s, lab, cent, labels, parts, plan, P, kmax,
                                   tmax, nmax, nb, ncp, n_iter, g);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// How many K12 clusters of `ctas` CTAs of `groups` groups with `smem` bytes
// of dynamic shared memory each the card holds at once (out: one int32 on
// the host).
GCIS_API int gcis_slic_w5_active_clusters(int ctas, int groups, int smem, int* out,
                                          void* stream) {
  if (ctas < 1 || ctas > MAX_CTAS || smem < 0 || smem > W5_SMEM_MAX ||
      (groups != 1 && groups != 2 && groups != 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(groups == 1   ? w5_active<1>(ctas, smem, out, s)
               : groups == 2 ? w5_active<2>(ctas, smem, out, s)
                             : w5_active<4>(ctas, smem, out, s));
}
