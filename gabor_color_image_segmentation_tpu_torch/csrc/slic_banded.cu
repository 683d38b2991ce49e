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

#include <cooperative_groups.h>

#include "slic_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NT = 256;  // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXC = 128;  // candidates per band window, w_rows * gw
constexpr int MASKW = MAXC / 32;  // words of a warp's touched-slot mask

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

__global__ void __launch_bounds__(NT) slic_w5_kernel(
    const float* __restrict__ lab, float* cent, int* labels, double* parts, int nmax, int B,
    int h, int w, int gh, int gw, int wr, int br, int nb, int cw, int ncp, int run, int n_iter,
    float fy, float fx, float sw, int vec) {
  extern __shared__ __align__(16) char smem[];
  cg::grid_group grid = cg::this_grid();
  const int per_image = nb * ncp, pieces = B * per_image, n_sp = gh * gw;
  const int warps = gridDim.x * NWARP, gwarp = blockIdx.x * NWARP + (threadIdx.x >> 5);
  for (int it = 0; it <= n_iter; ++it) {
    double* out = it < n_iter ? parts : nullptr;  // the last pass only assigns
    for (int q = blockIdx.x; q < pieces; q += gridDim.x) {
      const int r = q % per_image;
      band_pass(lab, cent, labels, out, smem, nmax, q / per_image, r / ncp, r % ncp, h, w, gh,
                gw, wr, br, nb, cw, ncp, run, fy, fx, sw, vec != 0);
    }
    if (it == n_iter) break;
    grid.sync();
    for (int i = gwarp; i < B * n_sp; i += warps)
      band_update(parts, cent, i / n_sp, i % n_sp, h, gh, gw, wr, br, nb, ncp);
    grid.sync();
  }
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

// K12: n_iter passes and updates and the last assignment in one cooperative
// launch; cent is updated in place, parts is scratch of K13's shape. The
// grid is as many blocks as fit on the card at once (a grid-wide barrier
// needs them all resident), at most one per piece.
GCIS_API int gcis_slic_w5(const float* lab, float* cent, int* labels, double* parts, int B,
                          int h, int w, int gh, int gw, int wr, int br, int cw, int n_iter,
                          float fy, float fx, float sw, void* stream) {
  if (bad_plan(B, h, w, gh, gw, wr, br, cw) || n_iter < 0) return (int)cudaErrorInvalidValue;
  int nb = (h + br - 1) / br, ncp = (w + cw - 1) / cw;
  int vec = vec_rows(lab, labels, w, cw), run = run_length(cw, br);
  int nmax = max_local(w, cw, fx, gw, wr);
  const size_t smem = pass_smem(nmax, true);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(slic_w5_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slic_w5_kernel, NT, smem);
  if (err != cudaSuccess) return (int)err;
  const int pieces = B * nb * ncp;
  const int grid = pieces < per_sm * sms ? pieces : per_sm * sms;
  if (grid < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&lab, &cent, &labels, &parts, &nmax, &B, &h, &w, &gh, &gw, &wr, &br,
                  &nb, &cw, &ncp, &run, &n_iter, &fy, &fx, &sw, &vec};
  err = cudaLaunchCooperativeKernel((const void*)slic_w5_kernel, dim3(grid), dim3(NT), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
