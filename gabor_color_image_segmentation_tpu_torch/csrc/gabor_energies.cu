// K1: Gabor energies of one scale group, with the 2x2-pooled twin.
//
// Replaces ops/fused_pallas.py::_group_kernel (the TPU kernel behind
// gabor_energies_fused). Same math, the modulated-separable form of
// ops/modulated.py: for each (image, kernel j, channel c)
//
//   modulate   M = I_pad * exp(-i w_j q)            (q: padded coordinates)
//   blur       G = envelope taps down the rows, then across the columns
//   demod      re + i im = exp(i w_j p) G;  re -= mu_j * box(I)
//   magnitude  mag = sqrt(re^2 + im^2)
//   smooth     out = Gaussian taps over the REFLECT_101-padded magnitude map
//   twin       the pooled smoothing (P_v S_v) mag (S_h P_h): 2r + 2 taps a
//              twin pixel at stride 2, down the rows, then across
//
// The TPU kernel cast the 1-D passes as banded-Toeplitz MXU matmuls over a
// whole image resident in VMEM. Here they are tap loops on the CUDA cores'
// float32 FMA pipes; TF32 stays off, and a 3xTF32 Toeplitz product at half
// band density would reach about the same rate.
//
// Bound on the H100: float32 operations (~2 ksize complex MACs per pixel,
// kernel and channel for the blur, 2 (2r + 1) for the smoothing; 2.65 ms
// at config1 at 67 TFLOP/s). The first version reached ~6 % of it: it
// evaluated the modulation again for every tap (~12 operations where 2
// FMAs do), fed every FMA with its own shared-memory load, ran 32 x 32
// tiles whose conv halo doubled the row pass, and sized static shared
// arrays for conv radius <= 15 and smoothing radius <= 24. This version:
//   - modulates each staged input element once per kernel, into shared
//     memory (the value depends on the element, not on the tap);
//   - register-blocks every tap loop (tap_run): a thread computes R = 8
//     consecutive outputs along the tap axis; each value it loads feeds
//     all 8 through a ring of the 8 taps in flight, so one shared load
//     (plus one broadcast tap) feeds 8 FMAs per channel, every output
//     still summing its taps in tap order;
//   - 32 x 64 output tiles (the row pass covers 64 + 2p columns, not
//     32 + 2p); the box sums stay in the registers of the thread whose
//     outputs they correct, and the magnitude tile reuses the strip buffer;
//   - stages every strip with cp.async, all of a strip's copies in flight
//     at once, and modulates it in shared memory;
//   - sizes tiles and halos at launch from p and r, in dynamic shared
//     memory: the input (and the smoothing's magnitude halo) is staged in
//     column strips of at most 64 padded columns, and the tile shrinks to
//     16 or 8 rows, or the strips to 32 or 16 columns, until a radius fits
//     227 KB. No radius is refused that fits the smallest tile (a conv
//     radius of several hundred pixels).
// Two launches per group remain, the magnitudes as a float32 intermediate
// in device memory: at config1 that is ~0.95 GB written and read per group
// (~0.28 ms at 3.35 TB/s, ~1.4 ms for the five groups), against a fused
// pass that keeps 2r + 1 magnitude rows on the SM but recomputes the
// smoothing's horizontal halo. All arithmetic is float32; only the stored
// energies are rounded, in bf16 mode.
//
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): ~24 ms at config1,
// 7 TFLOP/s, ~11 % of the bound, before the reference's rounding points
// and the twin's own pass below; ~31 ms, 6.6 TFLOP/s, ~10 % with them.
// The tap loops' SASS is ~75 % FFMA (64
// FFMA, 10 LDS a round of 8 taps), and switching any one phase off saves
// little (experiments/torch_k1_probes.py): each block's barrier-separated
// phases (stage a strip, row pass, column pass, store) form a critical
// path that the 2-4 co-resident blocks of an SM only partly hide.
// Double-buffering the strips, or a block walking down a column strip with
// its smoothing window on the SM, is the next step.
//
// Rounding follows the reference's bf16 kernel, which rounds each matmul
// operand to bfloat16 (RND, the bf16 instantiation): the image before the
// box sums, the box sums' and the blur's vertical passes, the modulated
// planes, the magnitude and the vertical smoothing; the host hands in the
// envelope and smoothing taps rounded. Sums stay float32. The smoothing's
// borders take the reference's folded Toeplitz rows (two taps that reach
// one source pixel add first, then round): in tiles that reach an edge,
// the outputs within r of it are summed again from a per-output tap table
// after the uniform tap loop. The twin is the reference's pooled smoothing,
// not the mean of four stored energies: 2r + 2 taps (the mean of two
// shifted smoothing rows, rounded once) at stride 2, down the staged
// magnitude rows and then across, each pass the even outputs of the same
// register-blocked tap loop (tap_run<.., 2>). With float32 storage nothing
// rounds but the folded taps' float32 sums.

#include "common.cuh"

#include <cuda_pipeline.h>

namespace {

using gcis::reflect101;
using gcis::round_to;
using gcis::st;

constexpr int NT = 256;
constexpr int R = 8;    // outputs per thread along the tap axis (tap_run loads taps 4 at a time)
static_assert(R == 8, "tap_run unpacks two float4 of taps");
constexpr int TW = 64;  // output tile width (the height TH is chosen at launch)
constexpr int OS = TW + 1;  // row stride of the output tiles: odd, so a warp's rows
                            // fall in different banks

// acc{0,1}[k] = sum over t < ntap, in t order, of taps[t] * s{0,1}[(k + t) * step],
// for k < R a multiple of KS (KS = 2: the even outputs only, which are the
// stride-2 outputs of the twin's pooled smoothing). Each loaded value feeds all R outputs; ring[] holds the R taps that
// meet it (zero outside [0, ntap), which adds exact zeros). taps is 16-byte
// aligned and holds ntap + 2 R entries, zero past ntap, and s0, s1 hold ntap + 2 R - 2 finite
// values along the tap axis (zero padding past the data), so no load is
// guarded.
template <int NC, int KS = 1>
__device__ __forceinline__ void tap_run(const float* taps, int ntap, const float* s0,
                                        const float* s1, int step, float (&a0)[R],
                                        float (&a1)[R]) {
  float ring[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    ring[k] = 0.f;
    a0[k] = 0.f;
    a1[k] = 0.f;
  }
  const int U = ntap + R - 1;  // inputs the R outputs touch
  for (int u0 = 0; u0 < U; u0 += R) {
    // four taps a load: a broadcast, and shared-memory wavefronts are what
    // the tap loop spends
    const float4 t0 = *reinterpret_cast<const float4*>(taps + u0);
    const float4 t1 = *reinterpret_cast<const float4*>(taps + u0 + 4);
    const float tq[R] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
    for (int du = 0; du < R; ++du) {
      const int u = u0 + du;
      ring[du] = tq[du];
      const float v0 = s0[u * step];
      const float v1 = NC == 2 ? s1[u * step] : 0.f;
#pragma unroll
      for (int k = 0; k < R; k += KS) {
        const float cf = ring[(du - k + R) % R];
        a0[k] = fmaf(cf, v0, a0[k]);
        if (NC == 2) a1[k] = fmaf(cf, v1, a1[k]);
      }
    }
  }
}

// v rounded to bfloat16 when RND (the reference's bf16 matmul operands).
template <bool RND>
__device__ __forceinline__ float rq(float v) {
  return RND ? gcis::round_to<__nv_bfloat16>(v) : v;
}

struct MagSmem {
  float *ev, *on, *cy, *sy, *cx, *sx, *mr, *mi, *vr, *vi, *ot;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared-memory layout of the magnitude pass, carved from ``base``; returns
// its size in bytes. The magnitude tile ot reuses mr, which the column
// pass no longer reads.
__host__ __device__ inline size_t mag_layout(int th, int cw, int p, float* base, MagSmem& m) {
  const size_t ntap = round4(2 * p + 1 + 2 * R), hp = round4(th + 2 * p + R);
  const size_t wp = round4(TW + 2 * p), vs = (TW + 2 * p + R) | 1;
  const size_t strip = hp * cw > (size_t)th * OS ? hp * cw : (size_t)th * OS;
  float* q = base;
  m.ev = q; q += ntap;
  m.on = q; q += ntap;
  m.cy = q; q += hp;
  m.sy = q; q += hp;
  m.cx = q; q += wp;
  m.sx = q; q += wp;
  m.mr = m.ot = q; q += strip;
  m.mi = q; q += hp * cw;
  m.vr = q; q += th * vs;
  m.vi = q; q += th * vs;
  return (size_t)(q - base) * sizeof(float);
}

// The smoothing pass: its taps and the twin's, the staged magnitude strip,
// the vertical pass (vt), the output tile (ot, then the twin's) and, with a
// twin, the twin's vertical pass (pv).
__host__ __device__ inline size_t smooth_layout(int th, int cw, int r, bool twin) {
  const int vs = (TW + 2 * r + R) | 1;
  return ((size_t)round4(2 * r + 1 + 2 * R) + (size_t)round4(2 * r + 2 + 2 * R) +
          (size_t)round4(th + 2 * r + R) * cw + (size_t)th * vs + (size_t)th * OS +
          (twin ? (size_t)(th / 2) * vs : 0)) * sizeof(float);
}

// Zero the padding that tap_run reads past the data: rows [hp, hp + R) of
// the row pass's source and columns [wp, vs) of the column pass's.
__device__ void zero_pads(float* src0, float* src1, int hp, int cw_max, float* dst0,
                          float* dst1, int th, int wp, int vs) {
  for (int e = threadIdx.x; e < R * cw_max; e += NT) {
    src0[hp * cw_max + e] = 0.f;
    if (src1) src1[hp * cw_max + e] = 0.f;
  }
  for (int e = threadIdx.x; e < th * (vs - wp); e += NT) {
    const int i = e / (vs - wp), c = wp + e % (vs - wp);
    dst0[i * vs + c] = 0.f;
    if (dst1) dst1[i * vs + c] = 0.f;
  }
}

// Padded columns [cs, cs + cw) of the tile's (th + 2p) padded rows, from
// device memory (the L2), modulated by the kernel's plane waves (cy, sy,
// cx, sx) into mr, mi, or raw (MOD false) into mr; then the row pass over
// them into columns [cs, cs + cw) of vr (and vi). RND rounds the staged or
// modulated values and the pass's outputs.
template <bool MOD, bool RND>
__device__ void stage_rows(const float* __restrict__ xp, const MagSmem& s, const float* taps,
                           int ntap, int H, int W, int i0, int j0, int p, int th, int cw_max,
                           int cs, int cw) {
  const int tid = threadIdx.x, lane = tid & 31, hp = th + 2 * p;
  const int vs = (TW + 2 * p + R) | 1;
  // every copy of the strip in flight at once (cp.async), then each thread
  // modulates the elements it copied
  for (int t = tid >> 5; t < hp; t += NT / 32) {
    const float* row = xp + (long)reflect101(i0 - p + t, H) * W;
    for (int c = lane; c < cw; c += 32)
      __pipeline_memcpy_async(s.mr + t * cw_max + c, row + reflect101(j0 - p + cs + c, W), 4);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  if (MOD) {
    for (int t = tid >> 5; t < hp; t += NT / 32) {
      const float cyt = s.cy[t], syt = s.sy[t];
      for (int c = lane; c < cw; c += 32) {
        const float v = s.mr[t * cw_max + c], cxs = s.cx[cs + c], sxs = s.sx[cs + c];
        s.mr[t * cw_max + c] = rq<RND>(v * (cyt * cxs) - v * (syt * sxs));
        s.mi[t * cw_max + c] = rq<RND>(-v * (syt * cxs) - v * (cyt * sxs));
      }
    }
  } else if (RND) {
    for (int t = tid >> 5; t < hp; t += NT / 32)
      for (int c = lane; c < cw; c += 32) s.mr[t * cw_max + c] = rq<RND>(s.mr[t * cw_max + c]);
  }
  __syncthreads();
  for (int item = tid; item < cw * (th / R); item += NT) {
    const int c = item % cw, ib = item / cw;
    float a0[R], a1[R];
    tap_run<MOD ? 2 : 1>(taps, ntap, s.mr + ib * R * cw_max + c,
                         s.mi + ib * R * cw_max + c, cw_max, a0, a1);
#pragma unroll
    for (int k = 0; k < R; ++k) {
      s.vr[(ib * R + k) * vs + cs + c] = rq<RND>(a0[k]);
      if (MOD) s.vi[(ib * R + k) * vs + cs + c] = rq<RND>(a1[k]);
    }
  }
  __syncthreads();
}

template <bool RND>
__global__ void __launch_bounds__(NT, 3) gabor_mag_kernel(
    const float* __restrict__ x, float* __restrict__ mag, const float* __restrict__ env,
    const float* __restrict__ freqs, const float* __restrict__ mus, int C, int H, int W,
    int n, int p, int th, int cw_max, int tiles_w) {
  extern __shared__ float smem[];
  MagSmem s;
  mag_layout(th, cw_max, p, smem, s);
  const int tid = threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  const int i0 = (blockIdx.x / tiles_w) * th, j0 = (blockIdx.x % tiles_w) * TW;
  const int ntap = 2 * p + 1, hp = th + 2 * p, wp = TW + 2 * p, vs = (wp + R) | 1;
  const long plane = (long)H * W;
  const float* xp = x + ((long)b * C + c) * plane;

  for (int e = tid; e < ntap + 2 * R; e += NT) {
    s.ev[e] = e < ntap ? env[e] : 0.f;
    s.on[e] = e < ntap ? 1.f : 0.f;
  }
  zero_pads(s.mr, s.mi, hp, cw_max, s.vr, s.vi, th, wp, vs);
  __syncthreads();
  // the column pass: one run of R outputs a thread (th * TW / R <= NT)
  const bool cols = tid < th * (TW / R);
  const int i = tid % th, jb = tid / th;
  // DC-correction box sums of this channel, shared by the group's kernels,
  // kept in the registers of the thread whose outputs they correct
  for (int cs = 0; cs < wp; cs += cw_max)
    stage_rows<false, RND>(xp, s, s.on, ntap, H, W, i0, j0, p, th, cw_max, cs,
                      min(cw_max, wp - cs));
  float box[R], unused[R];
  if (cols) tap_run<1>(s.on, ntap, s.vr + i * vs + jb * R, nullptr, 1, box, unused);

  for (int jj = 0; jj < n; ++jj) {
    const float wx = freqs[2 * jj], wy = freqs[2 * jj + 1], mu = mus[jj];
    __syncthreads();  // the previous kernel is done with the plane waves and ot
    // the plane wave cos(wy y + wx x) is rank 2 in these padded-coordinate vectors
    for (int e = tid; e < hp; e += NT) {
      const float ph = wy * (float)(i0 + e);
      s.cy[e] = cosf(ph);
      s.sy[e] = sinf(ph);
    }
    for (int e = tid; e < wp; e += NT) {
      const float ph = wx * (float)(j0 + e);
      s.cx[e] = cosf(ph);
      s.sx[e] = sinf(ph);
    }
    __syncthreads();
    for (int cs = 0; cs < wp; cs += cw_max)
      stage_rows<true, RND>(xp, s, s.ev, ntap, H, W, i0, j0, p, th, cw_max, cs,
                       min(cw_max, wp - cs));
    // blur across the columns, demodulate, DC-correct, magnitude
    if (cols) {
      float gr[R], gi[R];
      tap_run<2>(s.ev, ntap, s.vr + i * vs + jb * R, s.vi + i * vs + jb * R, 1, gr, gi);
      const float cyp = s.cy[i + p], syp = s.sy[i + p];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int j = jb * R + k;
        const float cxp = s.cx[j + p], sxp = s.sx[j + p];
        const float cp = cyp * cxp - syp * sxp, sp = syp * cxp + cyp * sxp;
        const float re = cp * gr[k] - sp * gi[k] - mu * box[k];
        const float im = sp * gr[k] + cp * gi[k];
        s.ot[i * OS + j] = rq<RND>(sqrtf(re * re + im * im));
      }
    }
    __syncthreads();
    float* mp = mag + (((long)b * n + jj) * C + c) * plane;
    for (int e = tid; e < th * TW; e += NT) {
      const int y = e / TW, xo = e % TW;
      if (i0 + y < H && j0 + xo < W) mp[(long)(i0 + y) * W + j0 + xo] = s.ot[y * OS + xo];
    }
  }
}

// sum over t < ntap, in t order, of tab[t] * src[t * step]
__device__ __forceinline__ float table_sum(const float* __restrict__ tab, int ntap,
                                           const float* src, int step) {
  float acc = 0.f;
  for (int t = 0; t < ntap; ++t) acc = fmaf(tab[t], src[t * step], acc);
  return acc;
}

// taps (2r+1) and taps2 (2r+2): the plain smoothing taps and the twin's, of
// rows clear of the borders. tabv (H, 2r+1), tabh (W, 2r+1): each output's
// taps over the padded axis (fused.py::smooth_table); outputs within r of
// an edge are summed again from them. tabv2 (H/2, 2r+2), tabh2 (W/2, 2r+2):
// the twin's, at stride 2. taps2, tabv2, tabh2 are null without a twin.
template <typename T>
__global__ void __launch_bounds__(NT) smooth_kernel(
    const float* __restrict__ mag, T* __restrict__ out, T* __restrict__ twin,
    const float* __restrict__ taps, const float* __restrict__ taps2,
    const float* __restrict__ tabv, const float* __restrict__ tabh,
    const float* __restrict__ tabv2, const float* __restrict__ tabh2, int P, int H, int W,
    int r, int E, int goff, int th, int cw_max, int tiles_w) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int pl = blockIdx.y, b = blockIdx.z;
  const int i0 = (blockIdx.x / tiles_w) * th, j0 = (blockIdx.x % tiles_w) * TW;
  const int ntap = 2 * r + 1, ntap2 = ntap + 1, hp = th + 2 * r, wp = TW + 2 * r;
  const int vs = (wp + R) | 1;
  const int lane = tid & 31;
  float* g = smem;
  float* g2 = g + round4(ntap + 2 * R);
  float* reg = g2 + round4(ntap2 + 2 * R);
  float* vt = reg + (size_t)round4(hp + R) * cw_max;
  float* ot = vt + (size_t)th * vs;
  float* pv = ot + (size_t)th * OS;
  const int h2 = H / 2, w2 = W / 2;
  const long plane = (long)H * W;
  const float* mp = mag + ((long)b * P + pl) * plane;
  // tiles that reach within r (the twin: r + 1) of an edge redo those outputs
  const bool edge_rows = i0 < r || i0 + th + r + 1 > H;
  const bool edge_cols = j0 < r || j0 + TW + r + 1 > W;

  for (int e = tid; e < ntap2 + 2 * R; e += NT) {
    if (e < ntap + 2 * R) g[e] = e < ntap ? taps[e] : 0.f;
    if (twin != nullptr) g2[e] = e < ntap2 ? taps2[e] : 0.f;
  }
  zero_pads(reg, nullptr, hp, cw_max, vt, nullptr, th, wp, vs);
  if (twin != nullptr)
    for (int e = tid; e < (th / 2) * (vs - wp); e += NT)
      pv[(e / (vs - wp)) * vs + wp + e % (vs - wp)] = 0.f;
  // the border contract: reflect the MAGNITUDE map, not the complex response
  for (int cs = 0; cs < wp; cs += cw_max) {
    const int cw = min(cw_max, wp - cs);
    __syncthreads();  // the previous strip's passes are done with reg
    for (int t = tid >> 5; t < hp; t += NT / 32) {  // every copy in flight at once
      const float* row = mp + (long)reflect101(i0 - r + t, H) * W;
      for (int c = lane; c < cw; c += 32)
        __pipeline_memcpy_async(reg + t * cw_max + c, row + reflect101(j0 - r + cs + c, W), 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    for (int item = tid; item < cw * (th / R); item += NT) {
      const int c = item % cw, ib = item / cw;
      float a0[R], a1[R];
      tap_run<1>(g, ntap, reg + ib * R * cw_max + c, nullptr, cw_max, a0, a1);
#pragma unroll
      for (int k = 0; k < R; ++k) vt[(ib * R + k) * vs + cs + c] = round_to<T>(a0[k]);
      if (twin != nullptr) {
        tap_run<1, 2>(g2, ntap2, reg + ib * R * cw_max + c, nullptr, cw_max, a0, a1);
#pragma unroll
        for (int k = 0; k < R; k += 2) pv[(ib * R + k) / 2 * vs + cs + c] = round_to<T>(a0[k]);
      }
    }
    if (!edge_rows) continue;
    __syncthreads();
    // rows near the top or bottom edge: their folded taps
    for (int e = tid; e < th * cw; e += NT) {
      const int i = e / cw, c = e % cw, gi = i0 + i;
      if (gi >= H || (gi >= r && gi < H - r)) continue;
      vt[i * vs + cs + c] =
          round_to<T>(table_sum(tabv + (long)gi * ntap, ntap, reg + i * cw_max + c, cw_max));
    }
    if (twin == nullptr) continue;
    for (int e = tid; e < (th / 2) * cw; e += NT) {
      const int i2 = e / cw, c = e % cw, gi2 = i0 / 2 + i2;
      if (gi2 >= h2 || (2 * gi2 >= r && 2 * gi2 + 1 + r < H)) continue;
      pv[i2 * vs + cs + c] = round_to<T>(table_sum(tabv2 + (long)gi2 * ntap2, ntap2,
                                                   reg + 2 * i2 * cw_max + c, cw_max));
    }
  }
  __syncthreads();
  for (int item = tid; item < th * (TW / R); item += NT) {
    const int i = item % th, jb = item / th;
    float a0[R], a1[R];
    tap_run<1>(g, ntap, vt + i * vs + jb * R, nullptr, 1, a0, a1);
#pragma unroll
    for (int k = 0; k < R; ++k) ot[i * OS + jb * R + k] = a0[k];
  }
  __syncthreads();
  if (edge_cols) {
    // columns near the left or right edge: their folded taps
    for (int e = tid; e < th * TW; e += NT) {
      const int i = e / TW, j = e % TW, gj = j0 + j;
      if (gj >= W || (gj >= r && gj < W - r)) continue;
      ot[i * OS + j] = table_sum(tabh + (long)gj * ntap, ntap, vt + i * vs + j, 1);
    }
    __syncthreads();
  }
  T* op = out + ((long)b * E + goff + pl) * plane;
  for (int e = tid; e < th * TW; e += NT) {
    const int i = e / TW, j = e % TW;
    if (i0 + i < H && j0 + j < W) st(op, (long)(i0 + i) * W + (j0 + j), ot[i * OS + j]);
  }
  if (twin == nullptr) return;
  __syncthreads();  // ot now holds the twin's tile
  for (int item = tid; item < (th / 2) * (TW / R); item += NT) {
    const int i2 = item % (th / 2), jb = item / (th / 2);
    float a0[R], a1[R];
    tap_run<1, 2>(g2, ntap2, pv + i2 * vs + jb * R, nullptr, 1, a0, a1);
#pragma unroll
    for (int k = 0; k < R; k += 2) ot[i2 * OS + (jb * R + k) / 2] = a0[k];
  }
  __syncthreads();
  if (edge_cols) {
    for (int e = tid; e < (th / 2) * (TW / 2); e += NT) {
      const int i2 = e / (TW / 2), j2 = e % (TW / 2), gj2 = j0 / 2 + j2;
      if (gj2 >= w2 || (2 * gj2 >= r && 2 * gj2 + 1 + r < W)) continue;
      ot[i2 * OS + j2] = table_sum(tabh2 + (long)gj2 * ntap2, ntap2, pv + i2 * vs + 2 * j2, 1);
    }
    __syncthreads();
  }
  T* tp = twin + ((long)b * E + goff + pl) * ((long)h2 * w2);
  for (int e = tid; e < (th / 2) * (TW / 2); e += NT) {
    const int i2 = e / (TW / 2), j2 = e % (TW / 2);
    const int gi = i0 / 2 + i2, gj = j0 / 2 + j2;
    if (gi < h2 && gj < w2) st(tp, (long)gi * w2 + gj, ot[i2 * OS + j2]);
  }
}

// The first (tile rows, strip columns) whose shared memory fits ``limit``
// bytes: the largest tile first, narrower strips last. False if none.
template <typename F>
bool pick_tile(F bytes, size_t limit, int* th, int* cw, size_t* smem) {
  const int plans[5][2] = {{32, 64}, {16, 64}, {8, 64}, {8, 32}, {8, 16}};
  for (const auto& pc : plans) {
    const size_t need = bytes(pc[0], pc[1]);
    if (need <= limit) {
      *th = pc[0];
      *cw = pc[1];
      *smem = need;
      return true;
    }
  }
  return false;
}

template <typename T>
cudaError_t launch_smooth(const float* mag, void* out, void* twin, const float* taps,
                          const float* taps2, const float* tabv, const float* tabh,
                          const float* tabv2, const float* tabh2, int B, int P, int H, int W,
                          int r, int E, int goff, size_t limit, cudaStream_t s) {
  int th, cw;
  size_t smem;
  const bool has_twin = twin != nullptr;
  if (!pick_tile([r, has_twin](int t, int c) { return smooth_layout(t, c, r, has_twin); },
                 limit, &th, &cw, &smem))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      smooth_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TW - 1) / TW, tiles = ((H + th - 1) / th) * tiles_w;
  smooth_kernel<T><<<dim3(tiles, P, B), NT, smem, s>>>(
      mag, (T*)out, (T*)twin, taps, taps2, tabv, tabh, tabv2, tabh2, P, H, W, r, E, goff, th,
      cw, tiles_w);
  return cudaGetLastError();
}

}  // namespace

// x: (B, C, H, W) float32 image, centred per channel. mag: (B, n*C, H, W)
// float32 scratch. out: (B, E, H, W) and twin: (B, E, H/2, W/2) (or null),
// float32 or bfloat16; the group writes channels [goff, goff + n*C).
// env: (2p+1,) envelope taps; freqs: (n, 2) [wx, wy]; mus: (n,);
// taps: (2r+1,) smoothing taps and taps2 (2r+2,) the twin's, env, taps and
// taps2 rounded to bfloat16 in bf16 mode; tabv (H, 2r+1), tabh (W, 2r+1),
// tabv2 (H/2, 2r+2), tabh2 (W/2, 2r+2): the per-output smoothing tables
// (taps2, tabv2, tabh2 null without a twin). All device pointers. Any radii
// p, r >= 0 whose smallest tile fits the card's shared memory.
GCIS_API int gcis_gabor_group(const float* x, float* mag, void* out, void* twin,
                              const float* env, const float* freqs, const float* mus,
                              const float* taps, const float* taps2, const float* tabv,
                              const float* tabh, const float* tabv2, const float* tabh2,
                              int B, int C, int H, int W, int n, int p, int r, int E,
                              int goff, int bf16, void* stream) {
  if (p < 0 || r < 0 || n < 1 || C < 1 || n * C > 65535 || B > 65535 || H < 1 || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  int th, cw;
  size_t smem;
  MagSmem none;
  if (!pick_tile([p, &none](int t, int c) { return mag_layout(t, c, p, nullptr, none); },
                 (size_t)optin, &th, &cw, &smem))
    return (int)cudaErrorInvalidValue;
  if (twin != nullptr && (taps2 == nullptr || tabv2 == nullptr || tabh2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto mag_kernel = bf16 ? gabor_mag_kernel<true> : gabor_mag_kernel<false>;
  err = cudaFuncSetAttribute(mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW, tiles = ((H + th - 1) / th) * tiles_w;
  mag_kernel<<<dim3(tiles, C, B), NT, smem, s>>>(x, mag, env, freqs, mus, C, H, W, n, p, th,
                                                  cw, tiles_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = bf16 ? launch_smooth<__nv_bfloat16>(mag, out, twin, taps, taps2, tabv, tabh, tabv2,
                                            tabh2, B, n * C, H, W, r, E, goff, (size_t)optin,
                                            s)
             : launch_smooth<float>(mag, out, twin, taps, taps2, tabv, tabh, tabv2, tabh2, B,
                                    n * C, H, W, r, E, goff, (size_t)optin, s);
  return (int)err;
}

GCIS_API const char* gcis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
