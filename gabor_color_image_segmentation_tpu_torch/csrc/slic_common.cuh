// The per-pixel arithmetic of the SLIC kernels (K11 in slic.cu, K12 and
// K13 in slic_banded.cu), as models/slic.py::slic_plain computes it: a
// pixel's grid cell, a hoisted candidate's table entry and the pixel's
// exact-float32 score against it (a pixel takes the argmin over the
// candidates of its 3x3 neighbour cells, ties to the lowest id); and the
// pieces of their passes with partial moments: the float64 records of runs
// of one id and the warp's flush of them into its slots.
#pragma once

#include "common.cuh"

namespace gcis {

// clip(int(f32(i) * f32(g / n)), 0, g - 1): the reference's cell arithmetic.
static __device__ __forceinline__ int slic_cell_of(int i, float scale, int g) {
  const int c = (int)__fmul_rn((float)i, scale);
  return c < 0 ? 0 : (c > g - 1 ? g - 1 : c);
}

constexpr int REC = 1;  // closed records a lane holds before a flush
constexpr unsigned FULL = 0xffffffffu;

struct Cand {  // a hoisted candidate as a pixel scores it
  float c0, c1, c2, c3, c4, csq, pad0, pad1;
};

struct Rec {  // moments of a closed run of one id
  double s[3];
  int id, sx, cnt, y;  // y: the run's row, or the sum of its rows (flush's SUM_Y)
};

struct Slot {  // a warp's moments of one candidate
  double s[3];
  int sx, sy, cnt, pad;
};

// The table entry of centroid cs = [L, a, b, y, x]: c = [L, a, b, sw y,
// sw x] and |c|^2 formed once, summed left to right with no fused
// multiply-add, as slic_plain forms them.
static __device__ __forceinline__ Cand slic_cand(const float* cs, float sw) {
  Cand c;
  c.c0 = cs[0];
  c.c1 = cs[1];
  c.c2 = cs[2];
  c.c3 = __fmul_rn(sw, cs[3]);
  c.c4 = __fmul_rn(sw, cs[4]);
  float q = __fmul_rn(c.c0, c.c0);
  q = __fadd_rn(q, __fmul_rn(c.c1, c.c1));
  q = __fadd_rn(q, __fmul_rn(c.c2, c.c2));
  q = __fadd_rn(q, __fmul_rn(c.c3, c.c3));
  c.csq = __fadd_rn(q, __fmul_rn(c.c4, c.c4));
  c.pad0 = c.pad1 = 0.f;
  return c;
}

// The score csq - 2 z.c of pixel z = [z0, z1, z2, z3, z4] against table
// entry c, the dot summed left to right with no fused multiply-add.
static __device__ __forceinline__ float slic_score(const Cand& c, float z0, float z1,
                                                   float z2, float z3, float z4) {
  const float4 ca = *reinterpret_cast<const float4*>(&c.c0);
  const float2 cb = *reinterpret_cast<const float2*>(&c.c4);
  float dot = __fmul_rn(z0, ca.x);
  dot = __fadd_rn(dot, __fmul_rn(z1, ca.y));
  dot = __fadd_rn(dot, __fmul_rn(z2, ca.z));
  dot = __fadd_rn(dot, __fmul_rn(z3, ca.w));
  dot = __fadd_rn(dot, __fmul_rn(z4, cb.x));
  return __fsub_rn(cb.y, __fmul_rn(2.f, dot));
}

// The warp adds its lanes' staged records (nrec each) into its slots; a
// slot's first record is stored, and its bit set in the warp's mask. A
// record of a run along a row holds the row in y (K11, K13); with SUM_Y, a
// record of a run down a column holds its rows' sum there (K12).
template <bool SUM_Y = false>
static __device__ __forceinline__ void flush(Rec* stage, Slot* slots, unsigned* mask,
                                             int nrec, int lane) {
  __syncwarp();
#pragma unroll
  for (int r = 0; r < REC; ++r) {
    const int id = r < nrec ? stage[r * 32 + lane].id : -1;
    const unsigned grp = __match_any_sync(FULL, id);
    if (id >= 0 && __ffs(grp) - 1 == lane) {
      double s0 = 0.0, s1 = 0.0, s2 = 0.0;
      int sx = 0, sy = 0, cnt = 0;
      for (unsigned m = grp; m; m &= m - 1) {
        const Rec& q = stage[r * 32 + __ffs(m) - 1];
        s0 += q.s[0];
        s1 += q.s[1];
        s2 += q.s[2];
        sx += q.sx;
        sy += SUM_Y ? q.y : q.y * q.cnt;
        cnt += q.cnt;
      }
      Slot& o = slots[id];
      const unsigned bit = 1u << (id & 31);
      if (mask[id >> 5] & bit) {
        o.s[0] += s0;
        o.s[1] += s1;
        o.s[2] += s2;
        o.sx += sx;
        o.sy += sy;
        o.cnt += cnt;
      } else {  // other leaders may set other bits of the word meanwhile
        o = Slot{{s0, s1, s2}, sx, sy, cnt, 0};
        atomicOr(mask + (id >> 5), bit);
      }
    }
    __syncwarp();  // the next step's leader of an id may be another lane
  }
}

}  // namespace gcis
