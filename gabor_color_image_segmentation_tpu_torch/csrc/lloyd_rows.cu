// K7: one Lloyd pass on a row-major (B, N, D) feature buffer, one launch.
//
// Replaces models/kmeans_pallas.py::_lloyd_kernel (wrapper _lloyd_pass), the
// pass behind the reference's kmeans_fused, its drop-in for a vmapped
// kmeans. Pixel x scores ||c||^2 - 2 round(c) . x for each of k <= 8
// centres: the norm from the float32 centres, the cross term with the
// centres rounded to the storage type, as the TPU kernel's operands were
// and as models/kmeans.py::_assign does. The first minimum wins; the pass
// writes int32 labels, the member sums and the counts. The TPU kernel's
// ones column (the counts) and padding of D to 128 lanes and of k to 8
// sublanes are not built.
//
// Bound on the H100: bytes, one read of the buffer (config1's standardised
// features, 16 x 154,401 x 243 bf16: 1.2 GB, 0.36 ms at 3.35 TB/s). The
// design reads every value from device memory once and keeps the SM's
// issue slots for the copies (models/kmeans_fused.py::lloyd_rows_plan
// sets its launch):
//   - persistent CTAs of 512 threads, one an SM: `ctas` CTAs an image
//     (about one wave), each walking `tpc` consecutive tiles of P pixels
//     (256 threads read 0.6216 / 0.0715 / 0.1427 ms where 512 read 0.6132
//     / 0.0600 / 0.1220 at config1's rows and (2, 20000, 1000) bf16 / f32:
//     experiments/torch_k2_k7.py --probes);
//   - P consecutive pixels are one contiguous span of P * D values, staged
//     by one TMA bulk copy into a ring of S stages (P = 128, S = 3 at
//     config1: two 62 KB tiles in flight while one is used), completing on
//     the slot's mbarrier. An image starts at (b N + p0) D es bytes, which
//     is not 16-byte aligned when N and D are odd (config1): the copy
//     starts at the aligned address below and a pixel's first value lies
//     at its offset in rowb. The last tiles of the buffer, whose rounded
//     copy would pass its end, take cp.async copies with the bytes past
//     the end zero-filled. Rows are D * es bytes apart (486 at config1, not
//     a multiple of 4), so fragments are built from 16-bit (bf16) or
//     32-bit (float32) shared loads;
//   - scores on the tensor cores from the staged tile: X . round(C)^T, bf16
//     mma.sync m16n8k16 of 16 pixels x 16 values by 16 values x 8 centres
//     (zero past k and past D). A warp takes a group of 16 pixels, and the
//     group's warps (2 at P = 128, 16 at P = 16) split its 16-value chunks
//     and add their sums in warp order through shared memory. Products are exact: a bf16 value is one bf16 part, a float32
//     value three (hi + mid + lo), as are the centres; the part products
//     with i + j <= 2 are kept (the dropped ones are below 2^-24 of the
//     product) and accumulate in float32. The first minimum over the
//     quad's lanes gives the label; no per-pixel butterfly;
//   - sums from the same staged tile on the tensor cores: X^T . onehot,
//     16 values x 16 pixels by 16 pixels x 8 clusters (the one-hot factor
//     is 0 or 1: exact); value D of the operand is 1 (the counts). Each
//     warp adds its 16-value M-tiles tile after tile in pixel order, the
//     CTA's fragments kept in shared memory;
//   - one launch: each CTA writes its (k, D + 1) partial to the caller's
//     scratch and counts itself done on its group's int counter (groups of
//     GS consecutive CTAs, one acquire-release add, common.cuh's
//     count_done); the group's last CTA adds the group's partials in CTA
//     order (float64, rounded once) and, past one group, counts the group
//     done on the image's counter, whose last adds the groups' sums in
//     group order. Every counter is reset for the next launch. Two levels
//     keep the last CTA's reads short where an image has many CTAs (66 at
//     batch 2). No float atomics: two launches give the same bits.
//
// Measured (experiments/torch_k2_k7.py, H100 80GB HBM3 at 700 W): 0.61 ms
// at config1's rows, 59 % of the bound, where the warp-a-pixel kernel
// before it read 1.87 ms; 0.061 / 0.122 ms at (2, 20000, 1000) bf16 / f32
// (0.44 / 0.41). With the copies gone the pass still reads 0.599 ms at
// config1, without the scores' chunks 0.440 and without the sums 0.478:
// the fragments' shared loads and packing (16-bit loads, the rows being
// 486 bytes apart), not the bytes, hold it; more stages or smaller tiles
// read no faster (P 64: 0.79 ms). At (2, 20000, 1000) the ordered
// reduction takes 11 / 15 us of it (0.051 / 0.107 ms without).
//
// Any D: past what the ring holds with the fragments, a tile's values are
// staged in column blocks of vb values (a multiple of 16): each pixel's
// segment of the block is one bulk copy from its aligned address (its
// offset in rowb). The scores accumulate across the blocks (each block's
// centre fragments built with it); once the labels are known the blocks
// are staged again for the sums, and the CTA's fragments, too large for
// shared memory, live in its slot of the scratch (each entry read and
// written by one thread, tile after tile).

#include "common.cuh"

namespace {

using gcis::bulk_copy;
using gcis::count_done;
using gcis::cp_async16;
using gcis::cp_commit;
using gcis::cp_wait_upto;
using gcis::mbar_expect;
using gcis::mbar_wait;
using gcis::mma_bf16;
using gcis::Pair;
using gcis::round_to;
using gcis::warp_sum;

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int KMAX = 8;
constexpr int GS = 8;        // CTAs a group of the ordered reduction
constexpr int MT_GROUP = 2;  // 16-value M-tiles a warp sums at once
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// The plan's quantities, shared by the host-side checks and the kernel.
struct Plan {
  int d, p, s, es, vb;  // values a pixel, pixels a tile, stages, bytes a value, values a block
  int sc;               // bf16 parts of a value: 1 (bf16) or 3 (float32)
  int nrb;              // blocks a tile (1: a tile staged whole)
  int rsb;              // bytes a pixel's staged segment of a block
  int stage;            // bytes of a ring slot
  int nkc;              // 16-value chunks of a block
  int nmt;              // 16-value M-tiles of the sums, values 0..D
};

__host__ __device__ inline Plan make_plan(int d, int p, int s, int es, int vb) {
  Plan g;
  g.d = d;
  g.p = p;
  g.s = s;
  g.es = es;
  g.vb = vb;
  g.sc = es == 2 ? 1 : 3;
  g.nrb = (d + vb - 1) / vb;
  g.rsb = 16 * ((vb * es + 30) / 16);
  g.stage = g.nrb > 1 ? p * g.rsb : 16 * ((p * d * es + 15) / 16 + 1);
  g.nkc = (vb + 15) / 16;
  g.nmt = (d + 16) / 16;
  return g;
}

// Dynamic shared memory of one CTA (models/kmeans_fused.py::_rows_smem): the
// ring, a block's centre fragments (256 bytes a 16-value chunk and part),
// the CTA's sums fragments (512 bytes an M-tile) unless staged in blocks,
// the split scores' exchange, the ring's mbarriers (four), each slot's
// pixel offsets, the tile's labels and the centres' norms.
__host__ __device__ inline size_t smem_bytes(const Plan& g) {
  return (size_t)g.s * g.stage + 256 * (size_t)g.nkc * g.sc +
         (g.nrb > 1 ? 0 : 512 * (size_t)g.nmt) + 16 * 32 * NWARP + 8 * 4 +
         4 * ((size_t)(g.s + 1) * g.p + KMAX);
}

// A float32 value rounded to T, as the raw bits Pair<T>::make packs.
template <typename T>
__device__ __forceinline__ unsigned bits(float v) {
  return sizeof(T) == 2 ? __float_as_uint(round_to<T>(v)) >> 16 : __float_as_uint(v);
}

// BLK: a tile's values staged in blocks (a template, so that a tile staged
// whole keeps its sums in shared memory and no block arithmetic).
template <typename T, bool BLK>
__global__ void __launch_bounds__(NT, 1) lloyd_rows_kernel(
    const T* __restrict__ x, const float* __restrict__ centers, int* __restrict__ labels,
    float* __restrict__ sums, float* __restrict__ part, float* __restrict__ gpart,
    float* __restrict__ accs, unsigned* __restrict__ counters, int D, int N, int K, int P,
    int S, int VB, int tpc, long total) {
  extern __shared__ __align__(16) char smem[];
  __shared__ int last;
  constexpr int SC = Pair<T>::SPLIT;
  const Plan g = make_plan(D, P, S, (int)sizeof(T), BLK ? VB : D);
  const int es = g.es;
  char* tiles = smem;
  uint2* cfrag = reinterpret_cast<uint2*>(tiles + (size_t)S * g.stage);  // (nkc, SC, 32)
  float* sacc = reinterpret_cast<float*>(cfrag + g.nkc * SC * 32);  // (nmt, 32, 4) unless BLK
  float4* red = reinterpret_cast<float4*>(sacc + (BLK ? 0 : g.nmt * 128));  // (NWARP, 32)
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(red + NWARP * 32);  // (4,)
  int* rowb = reinterpret_cast<int*>(mbar + 4);  // (S, P) a pixel's first byte in its slot
  int* lab = rowb + S * P;  // (P,)
  float* csq = reinterpret_cast<float*>(lab + P);  // (KMAX,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int cta = blockIdx.x, b = blockIdx.y, ctas = gridDim.x;
  const int ntiles = (N + P - 1) / P;
  const int t0 = cta * tpc, nt = max(0, min(ntiles, t0 + tpc) - t0);
  const int W = K * (D + 1), W4 = (W + 3) & ~3;
  // the sums fragments: in shared memory, or BLK in this CTA's scratch slot
  float* acc = BLK ? accs + ((long)b * ctas + cta) * g.nmt * 128 : sacc;
  const char* xb = reinterpret_cast<const char*>(x);
  const char* end = reinterpret_cast<const char*>(x + total);
  const float* cb = centers + (long)b * K * D;

  // the centres' values [v0, v0 + vs) as B fragments of the scores: lane
  // (gid, tig) of chunk kc holds centre gid at values kc*16 + 2 tig (+1)
  // and + 8 (+9), rounded to T, part by part
  auto centre_frags = [&](int v0, int vs) {
    for (int e = tid; e < ((vs + 15) / 16) * 32; e += NT) {
      const int kc = e >> 5, ln = e & 31, q = ln >> 2, vv = kc * 16 + 2 * (ln & 3);
      unsigned u[4];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int v = vv + (h & 1) + 8 * (h >> 1);
        u[h] = bits<T>(q < K && v < vs ? cb[(long)q * D + v0 + v] : 0.f);
      }
      unsigned lo[SC], hi[SC];
      Pair<T>::make(u[0], u[1], lo);
      Pair<T>::make(u[2], u[3], hi);
#pragma unroll
      for (int s = 0; s < SC; ++s) cfrag[(kc * SC + s) * 32 + ln] = make_uint2(lo[s], hi[s]);
    }
  };
  if (!BLK) centre_frags(0, D);
  if (warp < K) {
    float s = 0.f;
    for (int ch = lane; ch < D; ch += 32) s = fmaf(cb[warp * D + ch], cb[warp * D + ch], s);
    s = warp_sum(s);
    if (lane == 0) csq[warp] = s;
  }
  for (int e = tid; e < g.nmt * 128; e += NT) acc[e] = 0.f;
  if (tid < S) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
        (unsigned)__cvta_generic_to_shared(mbar + tid)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // jobs: a tile staged whole is one job (scores, then sums); BLK, its nrb
  // blocks are staged in turn for the scores, then again for the sums
  const int jpt = BLK ? 2 * g.nrb : 1;
  const int nj = nt * jpt;
  // a tile is bulk-copied unless its copies could pass the buffer's end
  // (the last tiles of the last image): they stay within 32 bytes of the
  // tile's last value
  auto tile_bulk = [&](int t) {
    const long p1 = min((long)N, (long)(t0 + t + 1) * P);
    return xb + ((long)b * N + p1) * D * es + 32 <= end;
  };
  auto stage = [&](int j) {  // job j of this CTA into its ring slot
    if (j < nj) {
      const int t = j / jpt, slot = j % S;
      const int v0 = BLK ? (j % jpt % g.nrb) * VB : 0, vs = BLK ? min(VB, D - v0) : D;
      const long p0 = (long)(t0 + t) * P;
      const int nv = (int)min((long)P, (long)N - p0);
      char* dst = tiles + (size_t)slot * g.stage;
      int* rb = rowb + slot * P;
      const bool bulk = tile_bulk(t);
      if (!BLK) {  // the tile's span, from its aligned start
        const char* src = xb + ((long)b * N + p0) * D * es;
        const char* a0 = reinterpret_cast<const char*>((size_t)src & ~(size_t)15);
        const int sh = (int)(src - a0), bytes = 16 * ((sh + nv * D * es + 15) / 16);
        for (int p = tid; p < P; p += NT) rb[p] = sh + min(p, nv - 1) * D * es;
        if (bulk) {
          if (tid == 0) {
            mbar_expect(mbar + slot, bytes);
            bulk_copy(dst, a0, bytes, mbar + slot);
          }
        } else {
          for (int c = tid; c < bytes / 16; c += NT) {
            const char* s16 = a0 + 16 * c;
            const long rem = end - s16;
            const int valid = rem <= 0 ? 0 : rem >= 16 ? 16 : (int)rem;
            cp_async16(dst + 16 * c, valid ? s16 : a0, valid);
          }
        }
      } else {  // each pixel's segment of the block, from its aligned start
        const int m = (vs * es + 30) / 16;  // chunks a segment
        for (int p = tid; p < P; p += NT) {
          const int pp = min(p, nv - 1);
          const char* src = xb + (((long)b * N + p0 + pp) * D + v0) * es;
          const char* a0 = reinterpret_cast<const char*>((size_t)src & ~(size_t)15);
          rb[p] = pp * g.rsb + (int)(src - a0);
          if (bulk && p < nv) bulk_copy(dst + p * g.rsb, a0, 16 * m, mbar + slot);
        }
        if (bulk) {
          if (tid == 0) mbar_expect(mbar + slot, nv * 16 * m);
        } else {
          for (int e = tid; e < nv * m; e += NT) {
            const int p = e / m, c = e - p * m;
            const char* src = xb + (((long)b * N + p0 + p) * D + v0) * es;
            const char* a0 = reinterpret_cast<const char*>((size_t)src & ~(size_t)15);
            const char* s16 = a0 + 16 * c;
            const long rem = end - s16;
            const int valid = rem <= 0 ? 0 : rem >= 16 ? 16 : (int)rem;
            cp_async16(dst + p * g.rsb + 16 * c, valid ? s16 : a0, valid);
          }
        }
      }
    }
    cp_commit();  // an empty group past the last job keeps the count uniform
  };

  for (int j = 0; j < S - 1; ++j) stage(j);

  // scores: warp w takes pixel group w % G (16 pixels) and, when the tile
  // has G < NWARP groups, the group's 16-value chunks w / G, + ks, ...
  const int G = P / 16, ks = NWARP / G, pg = warp % G, split = warp / G;
  unsigned phase = 0;  // each slot's mbarrier parity
  float c[2][4];       // two chains of score chunks, BLK kept across a tile's blocks
  for (int j = 0; j < nj; ++j) {
    const int t = j / jpt, ji = j - t * jpt, slot = j % S;
    const long p0 = (long)(t0 + t) * P;
    const int nv = (int)min((long)P, (long)N - p0);
    if (tile_bulk(t)) {
      mbar_wait(mbar + slot, (phase >> slot) & 1);
      phase ^= 1u << slot;
    } else {
      cp_wait_upto(S - 2);
    }
    __syncthreads();  // job j is in shared memory; slot (j - 1) % S is free
    stage(j + S - 1);
    const char* buf = tiles + (size_t)slot * g.stage;
    const int* rb = rowb + slot * P;
    const int bi = BLK ? ji % g.nrb : 0, v0 = bi * VB, vs = BLK ? min(VB, D - v0) : D;
    const bool scores = !BLK || ji < g.nrb;

    if (scores) {
      if (BLK) {
        centre_frags(v0, vs);
        __syncthreads();
      }
      if (bi == 0) {
#pragma unroll
        for (int ch = 0; ch < 2; ++ch)
#pragma unroll
          for (int h = 0; h < 4; ++h) c[ch][h] = 0.f;
      }
      // A: pixels pg*16 + gid (row xr0) and + 8 (xr1), values of the chunk
      const char* xr0 = buf + rb[pg * 16 + gid];
      const char* xr1 = buf + rb[pg * 16 + gid + 8];
      const int nkc = (vs + 15) / 16;
      auto chunk = [&](int kc, float(&cc)[4]) {
        int o[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) o[h] = kc * 16 + 2 * tig + (h & 1) + 8 * (h >> 1);
        if ((kc + 1) * 16 > vs)  // past the block's values: any staged value, times 0
#pragma unroll
          for (int h = 0; h < 4; ++h) o[h] = min(o[h], vs - 1);
        unsigned a0[SC], a1[SC], a2[SC], a3[SC];
        Pair<T>::make(Pair<T>::raw(xr0 + o[0] * es), Pair<T>::raw(xr0 + o[1] * es), a0);
        Pair<T>::make(Pair<T>::raw(xr1 + o[0] * es), Pair<T>::raw(xr1 + o[1] * es), a1);
        Pair<T>::make(Pair<T>::raw(xr0 + o[2] * es), Pair<T>::raw(xr0 + o[3] * es), a2);
        Pair<T>::make(Pair<T>::raw(xr1 + o[2] * es), Pair<T>::raw(xr1 + o[3] * es), a3);
#pragma unroll
        for (int s = 0; s < SC; ++s) {
          const uint2 bf = cfrag[(kc * SC + s) * 32 + lane];
#pragma unroll
          for (int i = 0; i < SC; ++i)
            if (i + s <= 2) mma_bf16(cc, a0[i], a1[i], a2[i], a3[i], bf.x, bf.y);
        }
      };
      for (int kc = split; kc < nkc; kc += 2 * ks) {
        chunk(kc, c[0]);
        if (kc + ks < nkc) chunk(kc + ks, c[1]);
      }
      if (bi == g.nrb - 1) {
        // the pixels' dots (c0, c1: pixel gid, centres 2 tig and + 1; c2,
        // c3: pixel gid + 8), the group's warps added in warp order
        float dt[4];
#pragma unroll
        for (int h = 0; h < 4; ++h) dt[h] = c[0][h] + c[1][h];
        if (ks > 1) {
          red[warp * 32 + lane] = make_float4(dt[0], dt[1], dt[2], dt[3]);
          __syncthreads();
          if (split == 0)
            for (int s = 1; s < ks; ++s) {
              const float4 v = red[(pg + s * G) * 32 + lane];
              dt[0] += v.x;
              dt[1] += v.y;
              dt[2] += v.z;
              dt[3] += v.w;
            }
        }
        if (split == 0) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // the first minimum over the quad's 8 centres: ties to the lower id
            const int q0 = 2 * tig;
            float v = q0 < K ? csq[q0] - 2.f * dt[2 * h] : __int_as_float(0x7f800000);
            int q = q0;
            if (q0 + 1 < K) {
              const float v1 = csq[q0 + 1] - 2.f * dt[2 * h + 1];
              if (v1 < v) {
                v = v1;
                q = q0 + 1;
              }
            }
#pragma unroll
            for (int sh = 1; sh < 4; sh <<= 1) {
              const float ov = __shfl_xor_sync(FULL, v, sh);
              const int oq = __shfl_xor_sync(FULL, q, sh);
              if (ov < v || (ov == v && oq < q)) {
                v = ov;
                q = oq;
              }
            }
            const int p = pg * 16 + gid + 8 * h;
            if (tig == h) {
              const bool valid = p < nv;
              if (valid) labels[(long)b * N + p0 + p] = q;
              lab[p] = valid ? q : -1;
            }
          }
        }
        __syncthreads();  // the tile's labels
      }
      if (BLK) continue;
    }

    // sums of the staged values [v0, v0 + vs) and, with the last, value D
    // (1: the counts): this warp's M-tiles (w, w + NWARP, ...), MT_GROUP at
    // a time in registers, each over the tile's 16-pixel chunks in order
    const bool lastb = v0 + vs == D;
    const int nmt = BLK ? (vs + (lastb ? 1 : 0) + 15) / 16 : g.nmt;
    float4* accb = reinterpret_cast<float4*>(acc) + (v0 / 16) * 32;  // VB is a multiple of 16
    for (int m0 = warp; m0 < nmt; m0 += NWARP * MT_GROUP) {
      float cs[MT_GROUP][4];
      int vo[MT_GROUP][2];  // the lane's two values: byte offset, or -1 (a 1), -2 (a 0)
      bool edge[MT_GROUP];  // an M-tile past the staged values
#pragma unroll
      for (int i = 0; i < MT_GROUP; ++i) {
        const int mt = m0 + i * NWARP;
        edge[i] = mt * 16 + 16 > vs;
        if (mt < nmt) {
          const float4 v = accb[mt * 32 + lane];
          cs[i][0] = v.x;
          cs[i][1] = v.y;
          cs[i][2] = v.z;
          cs[i][3] = v.w;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int vv = mt * 16 + gid + 8 * h;
            vo[i][h] = vv < vs ? vv * es : (vv == vs && lastb ? -1 : -2);
          }
        }
      }
      auto val = [&](int rowp, int o) {
        const unsigned u = Pair<T>::raw(buf + rowp + max(o, 0));
        return o >= 0 ? u : o == -1 ? Pair<T>::ONE : 0u;
      };
#pragma unroll 2
      for (int kc = 0; kc < P / 16; ++kc) {
        const int px = kc * 16 + 2 * tig;
        const int2 ra = *reinterpret_cast<const int2*>(rb + px);
        const int2 rc = *reinterpret_cast<const int2*>(rb + px + 8);
        const int2 la = *reinterpret_cast<const int2*>(lab + px);
        const int2 lc = *reinterpret_cast<const int2*>(lab + px + 8);
        const unsigned b0 = (la.x == gid ? 0x3F80u : 0u) | (la.y == gid ? 0x3F800000u : 0u);
        const unsigned b1 = (lc.x == gid ? 0x3F80u : 0u) | (lc.y == gid ? 0x3F800000u : 0u);
#pragma unroll
        for (int i = 0; i < MT_GROUP; ++i) {
          if (m0 + i * NWARP < nmt) {
            // A: values gid (a0, a2) and gid + 8 (a1, a3) of pixels px, px + 1
            // (a0, a1) and px + 8, px + 9 (a2, a3)
            unsigned a0[SC], a1[SC], a2[SC], a3[SC];
            if (!edge[i]) {
              Pair<T>::make(Pair<T>::raw(buf + ra.x + vo[i][0]),
                            Pair<T>::raw(buf + ra.y + vo[i][0]), a0);
              Pair<T>::make(Pair<T>::raw(buf + ra.x + vo[i][1]),
                            Pair<T>::raw(buf + ra.y + vo[i][1]), a1);
              Pair<T>::make(Pair<T>::raw(buf + rc.x + vo[i][0]),
                            Pair<T>::raw(buf + rc.y + vo[i][0]), a2);
              Pair<T>::make(Pair<T>::raw(buf + rc.x + vo[i][1]),
                            Pair<T>::raw(buf + rc.y + vo[i][1]), a3);
            } else {
              Pair<T>::make(val(ra.x, vo[i][0]), val(ra.y, vo[i][0]), a0);
              Pair<T>::make(val(ra.x, vo[i][1]), val(ra.y, vo[i][1]), a1);
              Pair<T>::make(val(rc.x, vo[i][0]), val(rc.y, vo[i][0]), a2);
              Pair<T>::make(val(rc.x, vo[i][1]), val(rc.y, vo[i][1]), a3);
            }
#pragma unroll
            for (int s = 0; s < SC; ++s) mma_bf16(cs[i], a0[s], a1[s], a2[s], a3[s], b0, b1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT_GROUP; ++i) {
        const int mt = m0 + i * NWARP;
        if (mt < nmt) accb[mt * 32 + lane] = make_float4(cs[i][0], cs[i][1], cs[i][2], cs[i][3]);
      }
    }
  }
  cp_wait_upto(0);
  __syncthreads();

  // this CTA's partial (k, D + 1), padded to W4: fragment entry (mt, lane,
  // i) is value mt*16 + gid (+ 8 for i >= 2), cluster 2*tig + (i & 1)
  float* mine = part + ((long)b * ctas + cta) * W4;
  for (int e = tid; e < g.nmt * 128; e += NT) {
    const int mt = e >> 7, ln = (e >> 2) & 31, i = e & 3;
    const int r = mt * 16 + (ln >> 2) + 8 * (i >> 1), q = 2 * (ln & 3) + (i & 1);
    if (r <= D && q < K) mine[q * (D + 1) + r] = acc[e];
  }
  for (int e = W + tid; e < W4; e += NT) mine[e] = 0.f;

  // the image's sums: the last CTA of each group adds the group's partials
  // in CTA order; past one group, the last group adds the groups' sums in
  // group order. One acquire-release add a count (ordered after every
  // thread's stores by the barrier before it), the reads through L2.
  const int ngrp = (ctas + GS - 1) / GS, grp = cta / GS, r0 = grp * GS;
  const int gsz = min(GS, ctas - r0);
  unsigned* cnt = counters + (long)b * (ngrp + 1);
  auto add_rows = [&](const float* in, int rows, float* out) {
    for (int e = tid; e < W4 / 4; e += NT) {
      double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
#pragma unroll 8
      for (int r = 0; r < rows; ++r) {
        const float4 v = __ldcg(reinterpret_cast<const float4*>(in + (long)r * W4) + e);
        s0 += v.x;
        s1 += v.y;
        s2 += v.z;
        s3 += v.w;
      }
      reinterpret_cast<float4*>(out)[e] = make_float4((float)s0, (float)s1, (float)s2, (float)s3);
    }
  };
  __syncthreads();
  if (tid == 0) last = count_done(cnt + 1 + grp) == (unsigned)gsz - 1;
  __syncthreads();
  if (!last) return;
  add_rows(part + ((long)b * ctas + r0) * W4, gsz,
           ngrp == 1 ? sums + (long)b * W4 : gpart + ((long)b * ngrp + grp) * W4);
  if (tid == 0) cnt[1 + grp] = 0u;  // every CTA of the group has counted
  if (ngrp == 1) return;
  __syncthreads();
  if (tid == 0) last = count_done(cnt) == (unsigned)ngrp - 1;
  __syncthreads();
  if (!last) return;
  add_rows(gpart + (long)b * ngrp * W4, ngrp, sums + (long)b * W4);
  if (tid == 0) cnt[0] = 0u;  // every group has counted
}

template <typename T>
int launch(const void* x, const float* centers, int* labels, float* sums, float* part,
           float* gpart, float* accs, unsigned* counters, int B, int D, int N, int k, int ctas,
           int tpc, int p, int s, int vb, cudaStream_t st) {
  const size_t smem = smem_bytes(make_plan(D, p, s, sizeof(T), vb));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  auto kernel = vb < D ? lloyd_rows_kernel<T, true> : lloyd_rows_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(ctas, B), NT, smem, st>>>((const T*)x, centers, labels, sums, part, gpart, accs,
                                          counters, D, N, k, p, s, vb, tpc, (long)B * N * D);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (B, N, D) float32 or bfloat16 (bf16 != 0), row-major. centers: (B, k, D)
// float32. labels: (B, N) int32 out. sums: (B, W4) float32 out, W4 = k (D +
// 1) rounded up to a multiple of 4, entry q (D + 1) + c the sum of value c
// over cluster q's members (c = D: the count). The plan
// (models/kmeans_fused.py::lloyd_rows_plan): ctas CTAs an image walking tpc
// tiles of p pixels (16, 32, 64 or 128) through s stages (2 to 4), vb
// values a staged block (D: a tile staged whole; else a multiple of 16).
// Scratch: part (B, ctas, W4) float32; gpart (B, ceil(ctas / 8), W4)
// float32 when ctas > 8; accs (B, ctas, 128 ceil((D + 1) / 16)) float32
// when vb < D; counters (B, ceil(ctas / 8) + 1) uint32, 0 on entry and
// left 0 (launches on one stream at a time may share them).
GCIS_API int gcis_lloyd_rows(const void* x, const float* centers, int* labels, float* sums,
                             float* part, float* gpart, float* accs, unsigned* counters, int B,
                             int D, int N, int k, int bf16, int ctas, int tpc, int p, int s,
                             int vb, void* stream) {
  if (k < 1 || k > KMAX || D < 1 || N < 1 || B < 1 || B > 65535 || ctas < 1 || tpc < 1 ||
      (long)ctas * tpc * p < (long)N || (p != 16 && p != 32 && p != 64 && p != 128) || s < 2 ||
      s > 4 || vb > D || (vb < D && (vb < 16 || vb % 16 || !accs)) || (ctas > GS && !gpart) ||
      (vb == D && (long)p * D * (bf16 ? 2 : 4) > SMEM_MAX))  // a whole tile in one stage
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return bf16 ? launch<__nv_bfloat16>(x, centers, labels, sums, part, gpart, accs, counters, B,
                                      D, N, k, ctas, tpc, p, s, vb, st)
              : launch<float>(x, centers, labels, sums, part, gpart, accs, counters, B, D, N, k,
                              ctas, tpc, p, s, vb, st);
}
