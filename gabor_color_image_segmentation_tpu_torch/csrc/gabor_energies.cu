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
//   twin       2x2 block means of the float32 smoothed map
//
// The TPU kernel cast the 1-D passes as banded-Toeplitz MXU matmuls over a
// whole image resident in VMEM. Here they are direct tap loops on 32x32
// output tiles in shared memory, in two launches per group:
//   gabor_mag_kernel  one block per (tile, channel, image) loads the input
//                     tile with its conv halo once, computes the channel's
//                     box sums once, then loops over the group's kernels and
//                     writes float32 magnitudes to a global intermediate;
//   smooth_kernel     one block per (tile, plane, image) reflects the
//                     magnitude halo while loading, smooths rows then columns
//                     and stores the energies (bf16 or f32) straight into
//                     the group's channel slice of the (B, E, H, W) output,
//                     plus the twin.
// All arithmetic is float32; only the stored energies are rounded, in bf16
// mode.
//
// Bound on the H100: float32 FMAs on the CUDA cores (the tap loops cost
// ~2 ksize complex MACs per pixel, kernel and channel, plus 2(2r+1) for the
// smoothing) and the float32 magnitude intermediate, written once and read
// back with its halo. The tiles keep each input element's reuse inside
// shared memory; tensor cores, TMA and a fused single pass are later work.

#include "common.cuh"

namespace {

using gcis::reflect101;
using gcis::st;

constexpr int NT = 256;
constexpr int TH = 32, TW = 32;   // output tile
constexpr int PMAX = 15;          // conv radius (ksize <= 31)
constexpr int RMAX = 24;          // smoothing radius
constexpr int IN = TH + 2 * PMAX;
constexpr int SIN = TH + 2 * RMAX;

__global__ void __launch_bounds__(NT) gabor_mag_kernel(
    const float* __restrict__ x, float* __restrict__ mag,
    const float* __restrict__ env, const float* __restrict__ freqs,
    const float* __restrict__ mus, int C, int H, int W, int n, int p,
    int tiles_w) {
  __shared__ float xs[IN * IN];
  __shared__ float vr[TH * IN];
  __shared__ float vi[TH * IN];
  __shared__ float box[TH * TW];
  __shared__ float ev[2 * PMAX + 1];
  __shared__ float cy[IN], sy[IN], cx[IN], sx[IN];

  const int tid = threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z;
  const int i0 = (blockIdx.x / tiles_w) * TH;
  const int j0 = (blockIdx.x % tiles_w) * TW;
  const int ks = 2 * p + 1, ih = TH + 2 * p, iw = TW + 2 * p;
  const long plane = (long)H * W;
  const float* xp = x + ((long)b * C + c) * plane;

  for (int e = tid; e < ks; e += NT) ev[e] = env[e];
  // input tile with the conv halo; padded row i0 + t is image row i0 - p + t
  for (int e = tid; e < ih * iw; e += NT) {
    const int t = e / iw, s = e % iw;
    const int yy = reflect101(i0 - p + t, H), xx = reflect101(j0 - p + s, W);
    xs[e] = xp[(long)yy * W + xx];
  }
  __syncthreads();
  // DC-correction box sums of this channel, shared by the group's kernels
  for (int e = tid; e < TH * iw; e += NT) {
    const int i = e / iw, s = e % iw;
    float acc = 0.f;
    for (int t = 0; t < ks; ++t) acc += xs[(i + t) * iw + s];
    vr[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < TH * TW; e += NT) {
    const int i = e / TW, j = e % TW;
    float acc = 0.f;
    for (int s = 0; s < ks; ++s) acc += vr[i * iw + j + s];
    box[e] = acc;
  }

  for (int jj = 0; jj < n; ++jj) {
    const float wx = freqs[2 * jj], wy = freqs[2 * jj + 1], mu = mus[jj];
    __syncthreads();  // the previous kernel (or the box pass) is done with vr/vi
    // plane wave cos(wy y + wx x) is rank 2 in these padded-coordinate vectors
    for (int e = tid; e < ih; e += NT) {
      const float ph = wy * (float)(i0 + e);
      cy[e] = cosf(ph);
      sy[e] = sinf(ph);
    }
    for (int e = tid; e < iw; e += NT) {
      const float ph = wx * (float)(j0 + e);
      cx[e] = cosf(ph);
      sx[e] = sinf(ph);
    }
    __syncthreads();
    // modulate and blur down the rows
    for (int e = tid; e < TH * iw; e += NT) {
      const int i = e / iw, s = e % iw;
      const float cxs = cx[s], sxs = sx[s];
      float ar = 0.f, ai = 0.f;
      for (int t = 0; t < ks; ++t) {
        const float v = xs[(i + t) * iw + s];
        const float cyt = cy[i + t], syt = sy[i + t];
        const float mr = v * (cyt * cxs) - v * (syt * sxs);
        const float mi = -v * (syt * cxs) - v * (cyt * sxs);
        ar += ev[t] * mr;
        ai += ev[t] * mi;
      }
      vr[e] = ar;
      vi[e] = ai;
    }
    __syncthreads();
    // blur across the columns, demodulate, DC-correct, magnitude
    for (int e = tid; e < TH * TW; e += NT) {
      const int i = e / TW, j = e % TW;
      if (i0 + i >= H || j0 + j >= W) continue;
      float gr = 0.f, gi = 0.f;
      for (int s = 0; s < ks; ++s) {
        gr += ev[s] * vr[i * iw + j + s];
        gi += ev[s] * vi[i * iw + j + s];
      }
      const float cyp = cy[i + p], syp = sy[i + p];
      const float cxp = cx[j + p], sxp = sx[j + p];
      const float cp = cyp * cxp - syp * sxp, sp = syp * cxp + cyp * sxp;
      const float re = cp * gr - sp * gi - mu * box[e];
      const float im = sp * gr + cp * gi;
      mag[(((long)b * n + jj) * C + c) * plane + (long)(i0 + i) * W + (j0 + j)] =
          sqrtf(re * re + im * im);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) smooth_kernel(
    const float* __restrict__ mag, T* __restrict__ out, T* __restrict__ twin,
    const float* __restrict__ taps, int P, int H, int W, int r, int E,
    int goff, int tiles_w) {
  __shared__ float reg[SIN * SIN];
  __shared__ float tv[TH * SIN];
  __shared__ float sm[TH * TW];
  __shared__ float g[2 * RMAX + 1];

  const int tid = threadIdx.x;
  const int pl = blockIdx.y, b = blockIdx.z;
  const int i0 = (blockIdx.x / tiles_w) * TH;
  const int j0 = (blockIdx.x % tiles_w) * TW;
  const int nt = 2 * r + 1, rh = TH + 2 * r, rw = TW + 2 * r;
  const long plane = (long)H * W;
  const float* mp = mag + ((long)b * P + pl) * plane;

  for (int e = tid; e < nt; e += NT) g[e] = taps[e];
  // the border contract: reflect the MAGNITUDE map, not the complex response
  for (int e = tid; e < rh * rw; e += NT) {
    const int t = e / rw, s = e % rw;
    const int yy = reflect101(i0 - r + t, H), xx = reflect101(j0 - r + s, W);
    reg[e] = mp[(long)yy * W + xx];
  }
  __syncthreads();
  for (int e = tid; e < TH * rw; e += NT) {
    const int i = e / rw, s = e % rw;
    float acc = 0.f;
    for (int t = 0; t < nt; ++t) acc += g[t] * reg[(i + t) * rw + s];
    tv[e] = acc;
  }
  __syncthreads();
  T* op = out + ((long)b * E + goff + pl) * plane;
  for (int e = tid; e < TH * TW; e += NT) {
    const int i = e / TW, j = e % TW;
    float acc = 0.f;
    for (int s = 0; s < nt; ++s) acc += g[s] * tv[i * rw + j + s];
    sm[e] = acc;
    if (i0 + i < H && j0 + j < W) st(op, (long)(i0 + i) * W + (j0 + j), acc);
  }
  if (twin == nullptr) return;
  __syncthreads();
  const int h2 = H / 2, w2 = W / 2;
  T* tp = twin + ((long)b * E + goff + pl) * ((long)h2 * w2);
  for (int e = tid; e < (TH / 2) * (TW / 2); e += NT) {
    const int i2 = e / (TW / 2), j2 = e % (TW / 2);
    const int gi = i0 / 2 + i2, gj = j0 / 2 + j2;
    if (gi >= h2 || gj >= w2) continue;
    const float* s0 = sm + 2 * i2 * TW + 2 * j2;
    st(tp, (long)gi * w2 + gj, 0.25f * ((s0[0] + s0[1]) + (s0[TW] + s0[TW + 1])));
  }
}

}  // namespace

// x: (B, C, H, W) float32 image, centred per channel. mag: (B, n*C, H, W)
// float32 scratch. out: (B, E, H, W) and twin: (B, E, H/2, W/2) (or null),
// float32 or bfloat16; the group writes channels [goff, goff + n*C).
// env: (2p+1,) envelope taps; freqs: (n, 2) [wx, wy]; mus: (n,);
// taps: (2r+1,) smoothing taps. All device pointers.
GCIS_API int gcis_gabor_group(const float* x, float* mag, void* out, void* twin,
                              const float* env, const float* freqs,
                              const float* mus, const float* taps, int B, int C,
                              int H, int W, int n, int p, int r, int E,
                              int goff, int bf16, void* stream) {
  if (p > PMAX || r > RMAX || n * C > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles_h = (H + TH - 1) / TH, tiles_w = (W + TW - 1) / TW;
  gabor_mag_kernel<<<dim3(tiles_h * tiles_w, C, B), NT, 0, s>>>(
      x, mag, env, freqs, mus, C, H, W, n, p, tiles_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(tiles_h * tiles_w, n * C, B);
  if (bf16) {
    smooth_kernel<__nv_bfloat16><<<grid, NT, 0, s>>>(
        mag, (__nv_bfloat16*)out, (__nv_bfloat16*)twin, taps, n * C, H, W, r,
        E, goff, tiles_w);
  } else {
    smooth_kernel<float><<<grid, NT, 0, s>>>(mag, (float*)out, (float*)twin,
                                             taps, n * C, H, W, r, E, goff,
                                             tiles_w);
  }
  return (int)cudaGetLastError();
}

GCIS_API const char* gcis_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
