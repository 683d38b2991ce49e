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
// Two launches per group, a magnitude pass and a smoothing pass, with the
// magnitudes as an intermediate in device memory in the stored dtype. Two
// routes, by that dtype, which share no tap logic.
//
// bfloat16 (namespace tc): every 1-D pass is a banded-Toeplitz product on
// the tensor cores, as the TPU kernel's MXU matmuls were: mma.sync m16n8k16,
// bf16 operands, float32 accumulators. The reference's bf16 kernel rounds
// each matmul operand to bfloat16 (the image before the box sums, the
// modulated planes, the vertical passes, the magnitude, the envelope and
// smoothing taps) and sums in float32, so the tensor cores compute its
// products, summed in another order (>= 0.9999 of the values equal the
// plain version's on the card). A pass out = T X is cut into 16-output row
// blocks; the host cuts T into 16 x 16 blocks (fused.py::band_tables): the
// envelope's and the box sums' are the same for every row block, the
// smoothing's and the twin's carry the folded REFLECT_101 rows near the
// edges, so the border is other A blocks and not a second pass. A warp
// holds a row block's K-blocks as A fragments (the first few in registers)
// and streams the data through ldmatrix: the vertical passes read the
// K-major staged planes (.trans), the horizontal passes read the vertical
// results row by row and give out^T = T V^T. Issued K-blocks per 16
// outputs are ceil((15 s + taps) / 16); the band fills 34 % (conv radius
// 5), 53 % (8), 52 % (12), 65 % (15) of them, the smoothing's 34-77 %
// (radius 5-24), the twin's stride-2 band 25-63 %. The modulated planes are
// staged as bf16 (exact: they are operands), the image strip once a tile
// for all the group's kernels; modulation, demodulation, the DC
// correction, the magnitude and the stores stay on the CUDA cores, on the
// accumulator fragments or in shared memory, at the same rounding points.
// The magnitude intermediate is bf16 (half the float32 one's 1.19 GB a
// config1 batch), its rows padded to a multiple of 8 elements: a warp
// writes 16 bytes a lane, and the smoothing stages 16-byte copies from a
// strip that starts on an 8-element boundary (the column bands carry that
// shift of up to 7 columns). Tiles are 64 x 64 where shared memory allows.
// What bounds it on the H100 (80GB HBM3, 700 W; experiments/torch_k1_tc.py):
// config1 (16 x 321 x 481, five groups) takes ~11.2 ms, the magnitude pass
// ~5.3, the smoothing ~5.8, against 30.3 ms for the FMA loops below on the
// same bf16 operands and a least time of 0.45 ms (bytes). Switching one
// phase off at a time: the products with their operand loads take ~3 ms
// (~0.6 TFLOP issued, ~200 TFLOP/s while they run), the modulation over
// the padded tiles ~1.3 ms, the final stores ~1.2 ms (out and twin, whose
// odd-width rows allow 2-byte stores only); the demodulation and
// magnitude, the staging and each tile's barrier-separated phases the
// rest. A pass that keeps the magnitude on the SM (no intermediate), or
// wgmma with TMA, is the next step.
//
// float32 (gabor_mag_kernel<false>, smooth_kernel<float>): tap loops on
// the CUDA cores' float32 FMA pipes. Its operands on the tensor cores would
// be TF32 (about three digits, past float32's 1e-4 contract), and a 3xTF32
// split at half band density would reach about the FMA loops' rate. The
// first version reached ~6 % of the FMA bound (~2 ksize complex MACs per
// pixel, kernel and channel for the blur, 2 (2r + 1) for the smoothing;
// 2.65 ms at config1 at 67 TFLOP/s): it evaluated the modulation again for
// every tap, fed every FMA with its own shared-memory load, ran 32 x 32
// tiles whose conv halo doubled the row pass, and sized static shared
// arrays for fixed radii. This version:
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
//     radius of several hundred pixels; the tensor-core route's plans
//     reach as far).
// The smoothing's borders take the reference's folded Toeplitz rows (two
// taps that reach one source pixel add first): in tiles that reach an
// edge, the outputs within r of it are summed again from a per-output tap
// table after the uniform tap loop. The twin is the reference's pooled
// smoothing, not the mean of four stored energies: 2r + 2 taps (the mean of
// two shifted smoothing rows) at stride 2, down the staged magnitude rows
// and then across, each pass the even outputs of the same register-blocked
// tap loop (tap_run<.., 2>). Nothing rounds but the folded taps' float32
// sums: only RND = false is built (bf16 takes the tensor-core route).

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

// The bf16 route: every 1-D pass a banded product on the tensor cores
// (mma.sync m16n8k16, bf16 operands, float32 accumulators). A pass
// out = T X over an axis is cut into 16-output row blocks; block m of T,
// at K-offset stride * 16 m + 16 k, is the 16 x 16 block (m, k) of a table
// the host builds from the taps (fused.py::_band_blocks_np): the envelope's
// and the box sums' are the same for every m, the smoothing's and the
// twin's carry the folded REFLECT_101 rows near the edges. A warp holds a
// row block's blocks as A fragments and streams the data through ldmatrix
// as B: the vertical passes read the K-major staged planes (.trans), the
// horizontal passes read the vertical results row by row and give
// out^T = T V^T.
namespace tc {

using bf16 = __nv_bfloat16;

// The A fragment of a 16 x 16 row-major bf16 block (mma.m16n8k16's layout:
// rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9).
__device__ __forceinline__ void load_a(unsigned (&a)[4], const bf16* blk, int lane) {
  const unsigned* q = reinterpret_cast<const unsigned*>(blk);
  const int g = lane >> 2, t = lane & 3;
  a[0] = __ldg(q + g * 8 + t);
  a[1] = __ldg(q + (g + 8) * 8 + t);
  a[2] = __ldg(q + g * 8 + t + 4);
  a[3] = __ldg(q + (g + 8) * 8 + t + 4);
}

// One row block of a band: its first NKR K-blocks as A fragments in
// registers, the rest read from the table when used.
template <int NKR>
struct Band {
  unsigned a[NKR][4];
  const bf16* tab;
  int nk;
  __device__ __forceinline__ void load(const bf16* t, int n, int lane) {
    tab = t;
    nk = n;
#pragma unroll
    for (int k = 0; k < NKR; ++k) {
      if (k < n) {
        load_a(a[k], t + k * 256, lane);
      } else {
        a[k][0] = a[k][1] = a[k][2] = a[k][3] = 0u;
      }
    }
  }
};

template <bool TRANS>
__device__ __forceinline__ void ldsm4(unsigned (&b)[4], const bf16* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                 : "r"(s));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
                 : "r"(s));
}

// c[0], c[1]: the band product's 16 outputs of the row block at output
// columns [n0, n0 + 8) and [n0 + 8, n0 + 16), summed over the K-blocks at
// src's K-offsets u0 + 16 k. TRANS: src is K-major (row u, column n: the
// vertical passes); otherwise N-major (row n, column u: the horizontal
// passes, which give out^T). ld (elements) is a multiple of 8.
template <bool TRANS, int NKR>
__device__ __forceinline__ void band_mma(const Band<NKR>& bd, const bf16* src, int ld, int u0,
                                         int n0, int lane, float (&c)[2][4]) {
  const bf16* q = TRANS ? src + (u0 + (lane & 15)) * ld + n0 + (lane >> 4) * 8
                        : src + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + u0 +
                              ((lane >> 3) & 1) * 8;
  const int step = TRANS ? 16 * ld : 16;
#pragma unroll
  for (int e = 0; e < 4; ++e) c[0][e] = c[1][e] = 0.f;
#pragma unroll
  for (int k = 0; k < NKR; ++k) {
    if (k < bd.nk) {
      unsigned b[4];
      ldsm4<TRANS>(b, q + k * step);
      gcis::mma_bf16(c[0], bd.a[k][0], bd.a[k][1], bd.a[k][2], bd.a[k][3], b[0], b[1]);
      gcis::mma_bf16(c[1], bd.a[k][0], bd.a[k][1], bd.a[k][2], bd.a[k][3], b[2], b[3]);
    }
  }
  for (int k = NKR; k < bd.nk; ++k) {
    unsigned a[4], b[4];
    load_a(a, bd.tab + k * 256, lane);
    ldsm4<TRANS>(b, q + k * step);
    gcis::mma_bf16(c[0], a[0], a[1], a[2], a[3], b[0], b[1]);
    gcis::mma_bf16(c[1], a[0], a[1], a[2], a[3], b[2], b[3]);
  }
}

// A vertical pass's 16 x 16 outputs (rows m0.., columns n0..), rounded to
// bf16 (the reference's rounding point), into dst.
__device__ __forceinline__ void put_rows(bf16* dst, int ld, int m0, int n0, int lane,
                                         const float (&c)[2][4]) {
  const int g = lane >> 2, t = lane & 3;
  bf16* r0 = dst + (m0 + g) * ld + n0 + 2 * t;
  bf16* r1 = r0 + 8 * ld;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    *reinterpret_cast<__nv_bfloat162*>(r0 + 8 * h) = __floats2bfloat162_rn(c[h][0], c[h][1]);
    *reinterpret_cast<__nv_bfloat162*>(r1 + 8 * h) = __floats2bfloat162_rn(c[h][2], c[h][3]);
  }
}

// A horizontal pass's block out^T (output rows i0 + 2t (+1) (+8), columns
// j0 + g (+8)), rounded to bf16, into the output tile ot (row pitch ld).
__device__ __forceinline__ void put_cols(bf16* ot, int ld, int i0, int j0, int lane,
                                         const float (&c)[2][4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      ot[(i0 + 8 * h + 2 * t + (e & 1)) * ld + j0 + g + 8 * (e >> 1)] =
          __float2bfloat16(c[h][e]);
}

// Shared memory of the magnitude pass for th-row tiles (th <= 64), nk
// K-blocks (conv radius p: nk = ceil((2p + 16) / 16)) and strips of cw
// padded columns: the staged rows (rx), the columns the horizontal pass
// reads (vc), byte offsets of each buffer. The raw strip xs is kept across
// the group's kernels only when one strip covers vc. The plane waves
// (cos, sin down the rows, then across the columns) are double-buffered,
// so a kernel's can be written while the one before still reads its own.
// ot: each warp's 16 x 16 magnitudes on their way to device memory.
struct MagTc {
  int rx, vc, ldm, ldv;
  bool keep;
  size_t mr, mi, vr, vi, ot, xs, wv, bytes;
};

__host__ __device__ inline MagTc mag_tc_layout(int th, int nk, int cw) {
  MagTc m;
  m.rx = th - 16 + 16 * nk;
  m.vc = TW - 16 + 16 * nk;
  m.ldm = cw + 8;
  m.ldv = m.vc + 8;
  m.keep = cw >= m.vc;
  size_t q = 0;
  m.mr = q; q += (size_t)m.rx * m.ldm * 2;
  m.mi = q; q += (size_t)m.rx * m.ldm * 2;
  m.vr = q; q += (size_t)th * m.ldv * 2;
  m.vi = q; q += (size_t)th * m.ldv * 2;
  m.ot = q; q += (size_t)(NT / 32) * 256 * 2;
  m.xs = q; q += m.keep ? (size_t)m.rx * cw * 4 : 0;
  m.wv = q; q += (size_t)2 * 2 * (m.rx + m.vc) * 4;
  m.bytes = q;
  return m;
}

// The magnitude pass of one (image, channel) tile for every kernel of the
// group: box sums, then per kernel modulate, blur (vertical then
// horizontal band products), demodulate, DC-correct, magnitude, rounded to
// bf16 where the reference rounds, into mag's rows of mag_pitch(W)
// elements. envb, oneb: (1, nk, 16, 16) bands of the envelope taps and of
// ones. Three barriers a kernel. UPW: the horizontal pass's units a warp
// (th <= 32: 1; th = 64: 2).
template <int UPW>
__global__ void __launch_bounds__(NT, 3 - UPW / 2) gabor_mag_kernel(
    const float* __restrict__ x, bf16* __restrict__ mag, const bf16* __restrict__ envb,
    const bf16* __restrict__ oneb, const float* __restrict__ freqs,
    const float* __restrict__ mus, int C, int H, int W, int n, int p, int nk, int th, int cw,
    int tiles_w) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const MagTc L = mag_tc_layout(th, nk, cw);
  bf16* mr = reinterpret_cast<bf16*>(tc_smem + L.mr);
  bf16* mi = reinterpret_cast<bf16*>(tc_smem + L.mi);
  bf16* vr = reinterpret_cast<bf16*>(tc_smem + L.vr);
  bf16* vi = reinterpret_cast<bf16*>(tc_smem + L.vi);
  float* xs = reinterpret_cast<float*>(tc_smem + L.xs);
  float* wv = reinterpret_cast<float*>(tc_smem + L.wv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bf16* ot = reinterpret_cast<bf16*>(tc_smem + L.ot) + warp * 256;
  const int ldw = (W + 7) & ~7;
  const int c = blockIdx.y, b = blockIdx.z;
  const int i0 = (blockIdx.x / tiles_w) * th, j0 = (blockIdx.x % tiles_w) * TW;
  const long plane = (long)H * W;
  const float* xp = x + ((long)b * C + c) * plane;
  // the horizontal pass's (column block, row pair) units: warp + 8 q for q < UPW
  const int nstrips = (L.vc + cw - 1) / cw, mbs = th / 16, hunits = (TW / 16) * mbs;
  const int wsz = 2 * (L.rx + L.vc);  // one buffer of plane waves: cy, sy, cx, sx

  // the raw image at padded (row t, column col): staged once when one strip
  // covers the tile, else read from the L2 for each kernel
  auto xval = [&](int t, int col) {
    return xp[(long)reflect101(i0 - p + t, H) * W + reflect101(j0 - p + col, W)];
  };
  // the plane waves of kernel jj at the padded rows and columns
  auto waves = [&](int jj) {
    const float wx = freqs[2 * jj], wy = freqs[2 * jj + 1];
    float* w = wv + (jj & 1) * wsz;
    for (int e = tid; e < L.rx; e += NT) {
      sincosf(wy * (float)(i0 + e), &w[L.rx + e], &w[e]);
    }
    for (int e = tid; e < L.vc; e += NT) {
      sincosf(wx * (float)(j0 + e), &w[2 * L.rx + L.vc + e], &w[2 * L.rx + e]);
    }
  };
  // the vertical pass of the strip at cs over np planes (mr, then mi)
  Band<4> bd;
  auto vertical = [&](int cs, int ncols, int np) {
    const int units = np * mbs * (ncols / 16);
    for (int u = warp; u < units; u += NT / 32) {
      const int pl = u % np, m = (u / np) % mbs, q = u / (np * mbs);
      float acc[2][4];
      band_mma<true>(bd, pl ? mi : mr, L.ldm, 16 * m, 16 * q, lane, acc);
      put_rows(pl ? vi : vr, L.ldv, 16 * m, cs + 16 * q, lane, acc);
    }
  };

  // DC-correction box sums of this channel, shared by the group's kernels,
  // kept in the registers of the warp whose outputs they correct
  bd.load(oneb, nk, lane);
  if (L.keep) {  // every copy in flight at once
    for (int t = warp; t < L.rx; t += NT / 32) {
      const float* row = xp + (long)reflect101(i0 - p + t, H) * W;
      for (int cc = lane; cc < L.vc; cc += 32)
        __pipeline_memcpy_async(xs + t * cw + cc, row + reflect101(j0 - p + cc, W), 4);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  }
  waves(0);
  for (int s = 0; s < nstrips; ++s) {
    const int cs = s * cw, ncols = min(cw, L.vc - cs);
    __syncthreads();  // the strip in place; the previous strip's vertical pass is done with mr
    for (int t = warp; t < L.rx; t += NT / 32)
      for (int cc = 2 * lane; cc < ncols; cc += 64) {
        const float2 v = L.keep ? *reinterpret_cast<const float2*>(xs + t * cw + cc)
                                : make_float2(xval(t, cs + cc), xval(t, cs + cc + 1));
        *reinterpret_cast<__nv_bfloat162*>(mr + t * L.ldm + cc) = __floats2bfloat162_rn(v.x, v.y);
      }
    __syncthreads();
    vertical(cs, ncols, 1);
  }
  __syncthreads();
  float box[UPW][2][4];
#pragma unroll
  for (int q = 0; q < UPW; ++q) {
    const int u = warp + 8 * q;
    if (u < hunits) band_mma<false>(bd, vr, L.ldv, 16 * (u / mbs), 16 * (u % mbs), lane, box[q]);
  }

  bd.load(envb, nk, lane);
  const int g = lane >> 2, t4 = lane & 3;
  for (int jj = 0; jj < n; ++jj) {
    const float* w = wv + (jj & 1) * wsz;
    const float *cy = w, *sy = w + L.rx, *cx = w + 2 * L.rx, *sx = cx + L.vc;
    for (int s = 0; s < nstrips; ++s) {
      const int cs = s * cw, ncols = min(cw, L.vc - cs);
      __syncthreads();  // the waves in place; the vertical pass is done with mr, mi
      // a warp's lanes walk its rows' column pairs (row-major, lane l takes
      // pairs l, l + 32, ...) without idling at the row ends
      const int np2 = ncols / 2;
      int t = warp, q = lane;
      for (; q >= np2; q -= np2) t += NT / 32;
      while (t < L.rx) {
        const int cc = 2 * q;
        const float cyt = cy[t], syt = sy[t];
        const float2 v = L.keep ? *reinterpret_cast<const float2*>(xs + t * cw + cc)
                                : make_float2(xval(t, cs + cc), xval(t, cs + cc + 1));
        const float2 cxs = *reinterpret_cast<const float2*>(cx + cs + cc);
        const float2 sxs = *reinterpret_cast<const float2*>(sx + cs + cc);
        *reinterpret_cast<__nv_bfloat162*>(mr + t * L.ldm + cc) = __floats2bfloat162_rn(
            v.x * (cyt * cxs.x) - v.x * (syt * sxs.x), v.y * (cyt * cxs.y) - v.y * (syt * sxs.y));
        *reinterpret_cast<__nv_bfloat162*>(mi + t * L.ldm + cc) =
            __floats2bfloat162_rn(-v.x * (syt * cxs.x) - v.x * (cyt * sxs.x),
                                  -v.y * (syt * cxs.y) - v.y * (cyt * sxs.y));
        for (q += 32; q >= np2; q -= np2) t += NT / 32;
      }
      __syncthreads();
      vertical(cs, ncols, 2);
    }
    __syncthreads();  // vr, vi in place
    // blur across the columns, demodulate, DC-correct, magnitude, straight
    // to the plane
#pragma unroll
    for (int q = 0; q < UPW; ++q) {
      const int u = warp + 8 * q, jb = u / mbs, ib = u % mbs;
      if (u >= hunits) break;
      float gr[2][4], gi[2][4];
      band_mma<false>(bd, vr, L.ldv, 16 * jb, 16 * ib, lane, gr);
      band_mma<false>(bd, vi, L.ldv, 16 * jb, 16 * ib, lane, gi);
      const float mu = mus[jj];
      float cxp[2], sxp[2], cyp[2][2], syp[2][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        cxp[e] = cx[16 * jb + g + 8 * e + p];
        sxp[e] = sx[16 * jb + g + 8 * e + p];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          cyp[h][e] = cy[16 * ib + 8 * h + 2 * t4 + e + p];
          syp[h][e] = sy[16 * ib + 8 * h + 2 * t4 + e + p];
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float cyv = cyp[h][e & 1], syv = syp[h][e & 1];
          const float cxv = cxp[e >> 1], sxv = sxp[e >> 1];
          const float cp = cyv * cxv - syv * sxv, sp = syv * cxv + cyv * sxv;
          const float re = cp * gr[h][e] - sp * gi[h][e] - mu * box[q][h][e];
          const float im = sp * gr[h][e] + cp * gi[h][e];
          ot[(8 * h + 2 * t4 + (e & 1)) * 16 + g + 8 * (e >> 1)] =
              __float2bfloat16(sqrtf(re * re + im * im));
        }
      __syncwarp();
      // a row of 16 a lane pair, 16 bytes a lane: rows start 16-byte aligned
      const int oi = i0 + 16 * ib + (lane >> 1), oj = j0 + 16 * jb + 8 * (lane & 1);
      if (oi < H && oj < ldw)
        *reinterpret_cast<uint4*>(mag + (((long)b * n + jj) * C + c) * H * ldw +
                                  (long)oi * ldw + oj) =
            *reinterpret_cast<const uint4*>(ot + 16 * (lane >> 1) + 8 * (lane & 1));
      __syncwarp();
    }
    if (jj + 1 < n) waves(jj + 1);
  }
}

// The smoothing's bands: the staged strip starts `shift` columns before the
// padded axis (on an 8-element boundary of the magnitude rows), so the
// bands across the columns carry the shift; their K-blocks down the rows
// (v), across (h), and the twin's (v2, h2).
struct SmoothBands {
  int shift, nkv, nkv2, nkh, nkh2;
};

__host__ __device__ inline SmoothBands smooth_bands(int r) {
  SmoothBands s;
  s.shift = (8 - r % 8) % 8;
  s.nkv = (2 * r + 31) / 16;
  s.nkv2 = (2 * r + 47) / 16;
  s.nkh = (2 * r + 31 + s.shift) / 16;
  s.nkh2 = (2 * r + 47 + s.shift) / 16;
  return s;
}

// Shared memory of the smoothing pass (th rows, th a multiple of 32): the
// staged magnitude strip (s), the vertical passes' outputs (v, and the
// twin's pv), the output tiles (ot, then the twin's; rows of OTL), the
// staged rows' offsets (idx).
constexpr int OTL = TW + 8;
struct SmoothTc {
  int rx, vc, lds, ldv;
  size_t s, v, pv, ot, idx, bytes;
};

__host__ __device__ inline SmoothTc smooth_tc_layout(int th, const SmoothBands& bn, bool twin,
                                                     int cw) {
  SmoothTc m;
  m.rx = th - 16 + 16 * bn.nkv;
  m.vc = TW - 16 + 16 * bn.nkh;
  if (twin) {
    const int rx2 = th - 32 + 16 * bn.nkv2, vc2 = TW - 32 + 16 * bn.nkh2;
    m.rx = rx2 > m.rx ? rx2 : m.rx;
    m.vc = vc2 > m.vc ? vc2 : m.vc;
  }
  m.lds = cw + 8;
  m.ldv = m.vc + 8;
  size_t q = 0;
  m.s = q; q += (size_t)m.rx * m.lds * 2;
  m.v = q; q += (size_t)th * m.ldv * 2;
  m.pv = q; q += twin ? (size_t)(th / 2) * m.ldv * 2 : 0;
  m.ot = q; q += (size_t)(th + th / 2) * OTL * 2;
  m.idx = q; q += (size_t)m.rx * 4;
  m.bytes = q;
  return m;
}

// The smoothing of one bf16 magnitude plane's tile (rows of mag_pitch(W)
// elements) and its twin, each pass a band product whose row blocks come
// from the folded tables: bv (ceil(H / 16), nkv, 16, 16), bh (over W,
// shifted), bv2, bh2 the twin's (stride 2; null without a twin).
__global__ void __launch_bounds__(NT, 3) smooth_kernel(
    const bf16* __restrict__ mag, bf16* __restrict__ out, bf16* __restrict__ twin,
    const bf16* __restrict__ bv, const bf16* __restrict__ bh, const bf16* __restrict__ bv2,
    const bf16* __restrict__ bh2, int P, int H, int W, int r, int E, int goff, int th, int cw,
    int tiles_w) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  const bool tw = twin != nullptr;
  const SmoothBands bn = smooth_bands(r);
  const SmoothTc L = smooth_tc_layout(th, bn, tw, cw);
  bf16* sm = reinterpret_cast<bf16*>(tc_smem + L.s);
  bf16* v = reinterpret_cast<bf16*>(tc_smem + L.v);
  bf16* pv = reinterpret_cast<bf16*>(tc_smem + L.pv);
  bf16* ot = reinterpret_cast<bf16*>(tc_smem + L.ot);
  bf16* ot2 = ot + th * OTL;
  int* rowoff = reinterpret_cast<int*>(tc_smem + L.idx);  // a staged row's offset in the plane
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pl = blockIdx.y, b = blockIdx.z;
  const int i0 = (blockIdx.x / tiles_w) * th, j0 = (blockIdx.x % tiles_w) * TW;
  const int ldw = (W + 7) & ~7, h2 = H / 2, w2 = W / 2;
  const bf16* mp = mag + ((long)b * P + pl) * H * ldw;
  const int nstrips = (L.vc + cw - 1) / cw, mbs = th / 16, mbs2 = tw ? th / 32 : 0;
  const int js = j0 - r - bn.shift;  // the staged strip's first column
  // the tables' row blocks: a block past them holds only outputs past the image
  const int nmv = (H + 15) / 16, nmh = (W + 15) / 16, nmv2 = (h2 + 15) / 16,
            nmh2 = (w2 + 15) / 16;
  Band<5> bd;
  int cur = -1;  // the row block whose fragments bd holds

  // the border contract: reflect the MAGNITUDE map, not the complex response
  for (int e = tid; e < L.rx; e += NT) rowoff[e] = reflect101(i0 - r + e, H) * ldw;
  for (int s = 0; s < nstrips; ++s) {
    const int cs = s * cw, ncols = min(cw, L.vc - cs), npairs = ncols / 16;
    __syncthreads();  // the offsets in place; the previous strip's passes are done with sm
    // 16 bytes a copy, all in flight, where 8 columns lie inside the image;
    // element by element, reflected, where they do not
    for (int e = tid; e < L.rx * (ncols / 8); e += NT) {
      const int t = e / (ncols / 8), q = e % (ncols / 8), gc = js + cs + 8 * q;
      bf16* dst = sm + t * L.lds + 8 * q;
      if (gc >= 0 && gc + 8 <= W) {
        gcis::cp_async16(dst, mp + rowoff[t] + gc, 16);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) dst[k] = mp[rowoff[t] + reflect101(gc + k, W)];
      }
    }
    gcis::cp_commit();
    gcis::cp_wait<0>();
    __syncthreads();
    // row blocks [0, mbs) the smoothing's, [mbs, mbs + mbs2) the twin's; a
    // warp takes a run of units, so it loads one or two row blocks' bands
    const int units = (mbs + mbs2) * npairs, nw = NT / 32;
    for (int u = warp * units / nw; u < (warp + 1) * units / nw; ++u) {
      const int rb = u / npairs, q = u % npairs;
      const bool second = rb >= mbs;
      const int m = second ? rb - mbs : rb, gm = second ? i0 / 32 + m : i0 / 16 + m;
      if (gm >= (second ? nmv2 : nmv)) continue;
      if (rb != cur) {
        if (second)
          bd.load(bv2 + (long)gm * bn.nkv2 * 256, bn.nkv2, lane);
        else
          bd.load(bv + (long)gm * bn.nkv * 256, bn.nkv, lane);
        cur = rb;
      }
      float acc[2][4];
      band_mma<true>(bd, sm, L.lds, second ? 32 * m : 16 * m, 16 * q, lane, acc);
      put_rows(second ? pv : v, L.ldv, 16 * m, cs + 16 * q, lane, acc);
    }
  }
  __syncthreads();
  // across the columns: (column block, row pair) units, the smoothing's
  // then the twin's, into the output tiles
  const int hu1 = (TW / 16) * mbs, hu2 = (TW / 32) * mbs2;
  for (int u = warp; u < hu1 + hu2; u += NT / 32) {
    const bool second = u >= hu1;
    const int uu = second ? u - hu1 : u, rows = second ? mbs2 : mbs;
    const int jb = uu / rows, ib = uu % rows, gm = second ? j0 / 32 + jb : j0 / 16 + jb;
    if (gm >= (second ? nmh2 : nmh)) continue;
    if (second)
      bd.load(bh2 + (long)gm * bn.nkh2 * 256, bn.nkh2, lane);
    else
      bd.load(bh + (long)gm * bn.nkh * 256, bn.nkh, lane);
    float acc[2][4];
    band_mma<false>(bd, second ? pv : v, L.ldv, (second ? 32 : 16) * jb, 16 * ib, lane, acc);
    put_cols(second ? ot2 : ot, OTL, 16 * ib, 16 * jb, lane, acc);
  }
  __syncthreads();
  // whole tile rows to the planes (their rows are 2-byte aligned only)
  bf16* op = out + ((long)b * E + goff + pl) * H * W + (long)i0 * W + j0;
  const int oh = min(th, H - i0), ow = min(TW, W - j0);
  for (int i = warp; i < oh; i += NT / 32)
    for (int j = lane; j < ow; j += 32) op[(long)i * W + j] = ot[i * OTL + j];
  if (!tw) return;
  bf16* tp = twin + ((long)b * E + goff + pl) * h2 * w2 + (long)(i0 / 2) * w2 + j0 / 2;
  const int oh2 = min(th / 2, h2 - i0 / 2), ow2 = min(TW / 2, w2 - j0 / 2);
  for (int i = warp; i < oh2; i += NT / 32)
    for (int j = lane; j < ow2; j += 32) tp[(long)i * w2 + j] = ot2[i * OTL + j];
}

// The first plan (tile rows, strip columns; 0: one strip) whose shared
// memory fits ``limit``; the strip is at most vc wide. False if none.
template <typename F>
bool pick_plan(F layout, const int (&plans)[4][2], int vc, size_t limit, int* th, int* cw,
               size_t* bytes) {
  for (const auto& pc : plans) {
    const int w = pc[1] == 0 || pc[1] > vc ? vc : pc[1];
    const size_t need = layout(pc[0], w);
    if (need <= limit) {
      *th = pc[0];
      *cw = w;
      *bytes = need;
      return true;
    }
  }
  return false;
}

cudaError_t launch(const float* x, bf16* mag, bf16* out, bf16* twin, const bf16* envb,
                   const bf16* oneb, const float* freqs, const float* mus, const bf16* bv,
                   const bf16* bh, const bf16* bv2, const bf16* bh2, int B, int C, int H, int W,
                   int n, int p, int r, int E, int goff, size_t limit, cudaStream_t s) {
  const bool has_twin = twin != nullptr;
  if (envb == nullptr || oneb == nullptr || bv == nullptr || bh == nullptr ||
      (has_twin && (bv2 == nullptr || bh2 == nullptr)))
    return cudaErrorInvalidValue;
  const int nk = (2 * p + 31) / 16;
  const SmoothBands bn = smooth_bands(r);
  int th, cw;
  size_t bytes;
  const int mag_plans[4][2] = {{64, 0}, {32, 0}, {16, 0}, {16, 16}};
  if (!pick_plan([nk](int t, int w) { return mag_tc_layout(t, nk, w).bytes; }, mag_plans,
                 mag_tc_layout(16, nk, 16).vc, limit, &th, &cw, &bytes))
    return cudaErrorInvalidValue;
  const auto mag_kernel = th > 32 ? gabor_mag_kernel<2> : gabor_mag_kernel<1>;
  cudaError_t err =
      cudaFuncSetAttribute(mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  int tiles_w = (W + TW - 1) / TW;
  mag_kernel<<<dim3(((H + th - 1) / th) * tiles_w, C, B), NT, bytes, s>>>(
      x, mag, envb, oneb, freqs, mus, C, H, W, n, p, nk, th, cw, tiles_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int smooth_plans[4][2] = {{64, 0}, {32, 0}, {32, 32}, {32, 16}};
  if (!pick_plan([=](int t, int w) { return smooth_tc_layout(t, bn, has_twin, w).bytes; },
                 smooth_plans, smooth_tc_layout(32, bn, has_twin, 16).vc, limit, &th, &cw,
                 &bytes))
    return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(smooth_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err != cudaSuccess) return err;
  smooth_kernel<<<dim3(((H + th - 1) / th) * tiles_w, n * C, B), NT, bytes, s>>>(
      mag, out, twin, bv, bh, bv2, bh2, n * C, H, W, r, E, goff, th, cw, tiles_w);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x: (B, C, H, W) float32 image, centred per channel. mag: (B, n*C, H, W)
// scratch in the stored dtype. out: (B, E, H, W) and twin: (B, E, H/2, W/2)
// (or null), float32 or bfloat16 (bf16 != 0); the group writes channels
// [goff, goff + n*C). freqs: (n, 2) [wx, wy]; mus: (n,).
// float32 (the FMA tap loops): env (2p+1,) envelope taps; taps (2r+1,)
// smoothing taps and taps2 (2r+2,) the twin's; tabv (H, 2r+1), tabh
// (W, 2r+1), tabv2 (H/2, 2r+2), tabh2 (W/2, 2r+2): the per-output smoothing
// tables (taps2, tabv2, tabh2 null without a twin). The band tables null.
// bfloat16 (the tensor cores): the band tables, bf16, (row blocks, K-blocks,
// 16, 16): envb and oneb (1, ceil((2p + 16) / 16)) the envelope's and the
// box sums'; bv, bh (ceil(H / 16) and ceil(W / 16), ceil((2r + 16) / 16))
// the smoothing's; bv2, bh2 (ceil((H/2) / 16) and ceil((W/2) / 16),
// ceil((2r + 32) / 16)) the twin's (null without a twin). env and the tap
// tables null. All device pointers. Any radii p, r >= 0 whose smallest
// tile fits the card's shared memory.
GCIS_API int gcis_gabor_group(const float* x, void* mag, void* out, void* twin,
                              const float* env, const float* freqs, const float* mus,
                              const float* taps, const float* taps2, const float* tabv,
                              const float* tabh, const float* tabv2, const float* tabh2,
                              const void* envb, const void* oneb, const void* bv,
                              const void* bh, const void* bv2, const void* bh2,
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
  if (bf16) {
    using T = __nv_bfloat16;
    return (int)tc::launch(x, (T*)mag, (T*)out, (T*)twin, (const T*)envb, (const T*)oneb,
                           freqs, mus, (const T*)bv, (const T*)bh, (const T*)bv2,
                           (const T*)bh2, B, C, H, W, n, p, r, E, goff, (size_t)optin, s);
  }
  int th, cw;
  size_t smem;
  MagSmem none;
  if (!pick_tile([p, &none](int t, int c) { return mag_layout(t, c, p, nullptr, none); },
                 (size_t)optin, &th, &cw, &smem))
    return (int)cudaErrorInvalidValue;
  if (twin != nullptr && (taps2 == nullptr || tabv2 == nullptr || tabh2 == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto mag_kernel = gabor_mag_kernel<false>;
  err = cudaFuncSetAttribute(mag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_w = (W + TW - 1) / TW, tiles = ((H + th - 1) / th) * tiles_w;
  mag_kernel<<<dim3(tiles, C, B), NT, smem, s>>>(x, (float*)mag, env, freqs, mus, C, H, W, n,
                                                  p, th, cw, tiles_w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = launch_smooth<float>((const float*)mag, out, twin, taps, taps2, tabv, tabh, tabv2,
                             tabh2, B, n * C, H, W, r, E, goff, (size_t)optin, s);
  return (int)err;
}

GCIS_API const char* gcis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
