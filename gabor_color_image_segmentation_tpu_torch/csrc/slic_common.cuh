// The per-pixel arithmetic of the SLIC kernels (K11 in slic.cu, K12 and
// K13 in slic_banded.cu): a pixel's grid cell and its exact-float32
// assignment, as models/slic.py::slic_plain computes them.
#pragma once

#include "common.cuh"

namespace gcis {

// Pixels added on each side of a superpixel's 3x3-cell window, so rounding
// at a cell edge cannot drop a member.
constexpr int SLIC_MARGIN = 2;

// clip(int(f32(i) * f32(g / n)), 0, g - 1): the reference's cell arithmetic.
static __device__ __forceinline__ int slic_cell_of(int i, float scale, int g) {
  const int c = (int)__fmul_rn((float)i, scale);
  return c < 0 ? 0 : (c > g - 1 ? g - 1 : c);
}

// First pixel row (or column) whose cell is >= g, from the exact ratio.
static __device__ __forceinline__ int slic_first_in_cell(int g, int n, int cells) {
  return (int)(((long)g * n + cells - 1) / cells);
}

// The superpixel id a pixel (y, x) of Lab px[0..2] takes: the argmin of
// cs.cs - 2 z.cs over the centroids cs = [L, a, b, sw y, sw x] of its 3x3
// neighbour cells (cent: this image's (gh * gw, 5) [L, a, b, y, x] table),
// z = [L, a, b, sw y, sw x]; both sums left to right with no fused
// multiply-add, ties to the lowest id.
static __device__ __forceinline__ int slic_assign_pixel(const float* px, int y, int x,
                                                        const float* cent, int gh, int gw,
                                                        float fy, float fx, float sw) {
  const float z0 = px[0], z1 = px[1], z2 = px[2];
  const float z3 = __fmul_rn(sw, (float)y), z4 = __fmul_rn(sw, (float)x);
  const int cy = slic_cell_of(y, fy, gh), cx = slic_cell_of(x, fx, gw);
  float best = 0.f;
  int arg = -1;
  for (int gy = max(cy - 1, 0); gy <= min(cy + 1, gh - 1); ++gy) {
    for (int gx = max(cx - 1, 0); gx <= min(cx + 1, gw - 1); ++gx) {
      const int s = gy * gw + gx;
      const float* cs = cent + s * 5;
      const float c0 = cs[0], c1 = cs[1], c2 = cs[2];
      const float c3 = __fmul_rn(sw, cs[3]), c4 = __fmul_rn(sw, cs[4]);
      float csq = __fmul_rn(c0, c0);
      csq = __fadd_rn(csq, __fmul_rn(c1, c1));
      csq = __fadd_rn(csq, __fmul_rn(c2, c2));
      csq = __fadd_rn(csq, __fmul_rn(c3, c3));
      csq = __fadd_rn(csq, __fmul_rn(c4, c4));
      float dot = __fmul_rn(z0, c0);
      dot = __fadd_rn(dot, __fmul_rn(z1, c1));
      dot = __fadd_rn(dot, __fmul_rn(z2, c2));
      dot = __fadd_rn(dot, __fmul_rn(z3, c3));
      dot = __fadd_rn(dot, __fmul_rn(z4, c4));
      const float score = __fsub_rn(csq, __fmul_rn(2.f, dot));
      if (arg < 0 || score < best) {  // ascending ids: the first minimum wins
        best = score;
        arg = s;
      }
    }
  }
  return arg;
}

}  // namespace gcis
