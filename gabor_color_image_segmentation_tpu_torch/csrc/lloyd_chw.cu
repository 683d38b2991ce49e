// K2: one Lloyd pass on the raw channel-major feature rows.
//
// Replaces models/kmeans_chw.py::_lloyd_chw_kernel (wrapper _lloyd_chw_pass).
// The per-image standardisation affine x = a*r + b is folded into the
// centres by the caller: pixel r scores offs_c - 2 * wc_c . r with
// wc_c = a*(c - b) and offs_c = ||c - b||^2, the first minimum over k <= 8
// centres wins, and the pass writes int32 labels plus raw-space member sums
// and counts. assign_only skips the sums.
//
// Layout: features are E energy planes (B, E, N) and the colour rows
// (B, 4, N) of color4 (rows 0..2 are L, a, b; row 3 is not read: counts are
// counted). D = E + 3 rows a pixel.
//
// Bound on the H100: HBM bandwidth. A pass must read the D rows once
// (config1: 16 x 243 x 154401 bf16 = 1.21 GB, 0.36 ms at 3.35 TB/s). The
// design reads every value from device memory once a pass and keeps the
// SM's issue slots free for the copies:
//   - persistent CTAs of 512 threads, one an SM: `ctas` CTAs an image
//     (models/kmeans_chw.py::lloyd_plan: about one wave), each walking
//     `tpc` consecutive tiles of P pixels x D rows in order;
//   - each tile is staged in shared memory in a ring of S stages (P = 128
//     pixels and S = 3 at config1: two tiles, 130 KB, in flight while one
//     is used), by TMA bulk copies, one a row, completing on
//     the slot's mbarrier. The rows of an odd N are not 16-byte aligned: a
//     row's copy starts at its aligned address (one 16-byte chunk more than
//     the tile's row) and a per-row shift (rowoff) finds pixel 0. The last
//     tiles of an image, whose rounded rows would pass the image's end, take
//     cp.async 16-byte copies with the bytes past the image zero-filled;
//   - scores on the tensor cores from the staged tile: W . X, a bf16
//     mma.sync (m16n8k16) of the (up to 8) centre rows by 16 feature rows x
//     8 pixels, one warp a group of 8 pixels over all rows. Each product is
//     exact: a bf16 value is one bf16 part, a float32 value is split exactly
//     into three (hi + mid + lo), and so are the centre rows (one part when
//     the caller rounded them to bf16, as the pipeline does); the products
//     of parts i, j with i + j <= 2 are kept (the dropped ones are below
//     2^-24 of the product) and accumulate in float32. The warp then takes
//     the first minimum of offs - 2 dot over its lanes' clusters;
//   - sums from the same staged tile on the tensor cores: X . onehot(labels),
//     16 feature rows x 16 pixels by 16 pixels x 8 clusters; the one-hot
//     factor is 0 or 1, so each product is exact (three parts in float32).
//     Row D of the operand is a row of ones kept in each stage: its sums are
//     the counts, and it reads nothing from device memory. Each warp keeps
//     the sums of its 16-row M-tiles across all of its CTA's tiles, adding
//     in pixel order;
//   - one (k, D + 1) partial a CTA; a second launch adds an image's `ctas`
//     partials, a warp an entry (lanes over the CTAs in order, then a fixed
//     butterfly). No float atomics: the same inputs give the same bits on
//     every run.
// The TPU kernel's block-diagonal expanded weights, padding of k to 8
// sublanes, ones-row loads and one-hot matmuls on the vector unit are gone.
//
// Any D: where not even one stage of 16 pixels fits (D past 1,650 bf16 or
// 1,344 float32 rows; the fragments grow with D whatever the tile), a tile
// of 128 pixels is staged in blocks of rb rows (a multiple of 16) through
// three stages, each block's centre fragments built with it. The score
// chains stay in registers across the blocks; once the tile's labels are
// known its blocks are staged again for the sums, whose fragments live in
// the CTA's slot of the caller's scratch (each entry read and written by
// one thread, tile after tile). The same fixed orders: two launches give
// the same bits. Staging twice reads a tile twice, so this form runs at
// about half the one-stage form's share of its bound (E = 2,688 bf16 at
// 1x321x481: 1.23 ms with sums, 0.58 labels only, against a 0.25 ms bound;
// experiments/torch_k2_k7.py). Up to those rows the plan and the bits are
// the one-stage form's.

#include "common.cuh"

namespace {

using gcis::bulk_copy;
using gcis::cp_async16;
using gcis::cp_commit;
using gcis::cp_wait_upto;
using gcis::mbar_expect;
using gcis::mbar_wait;
using gcis::mma_bf16;
using gcis::Pair;
using gcis::split3;

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int KMAX = 8;
constexpr int MT_GROUP = 4;  // M-tiles a warp holds in registers at once
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// The plan's quantities, shared by the host-side checks and the kernel.
struct Plan {
  int d, p, s, es;  // rows, pixels a tile, stages, bytes a value
  int rb;           // rows a staged block (d: the tile's rows in one stage)
  int nrb;          // blocks a tile
  int rs;           // bytes of a staged row (the tile's row + 16)
  int nkc;          // 16-row K-chunks of the scores (a block's rows)
  int nmt;          // 16-row M-tiles of the sums (rows 0..D)
};

__host__ __device__ inline Plan make_plan(int d, int p, int s, int es, int rb) {
  Plan g;
  g.d = d;
  g.p = p;
  g.s = s;
  g.es = es;
  g.rb = rb;
  g.nrb = (d + rb - 1) / rb;
  g.rs = p * es + 16;
  g.nkc = (rb + 15) / 16;
  g.nmt = (d + 1 + 15) / 16;
  return g;
}

// Dynamic shared memory of one CTA (models/kmeans_chw.py::_lloyd_smem): the
// ring (a stage holds the D staged rows, then a row of ones and a row of
// zeros), the centre rows as score fragments (three parts), the sums
// fragments, the rows' source addresses, the tile's labels, the rows'
// offsets, the ring's mbarriers (four) and the score offsets. Staged in
// blocks (nrb > 1), a stage holds a block's rb rows (then the ones and the
// zeros), the fragments a block's centre rows and the rows' offsets a block
// a stage; the sums fragments live in the CTA's slot of the scratch and the
// rows' addresses are computed where they are used.
__host__ __device__ inline size_t smem_bytes(const Plan& g) {
  if (g.nrb > 1)
    return (size_t)g.s * (g.rb + 2) * g.rs + 768 * (size_t)g.nkc + 8 * 4 +
           4 * ((size_t)g.p + (size_t)g.s * g.rb + KMAX);
  return (size_t)g.s * (g.d + 2) * g.rs + 768 * (size_t)g.nkc + 512 * (size_t)g.nmt +
         8 * (size_t)g.d + 8 * 4 + 4 * ((size_t)g.p + 16 * g.nkc + KMAX);
}

// BLK: the tile's rows staged in blocks of rb (a template, so that a tile
// staged in one go keeps its code and its shared-memory sums).
template <typename T, bool BLK>
__global__ void __launch_bounds__(NT, 1) lloyd_kernel(
    const T* __restrict__ xe, const T* __restrict__ xc, const float* __restrict__ wc,
    const float* __restrict__ offs, int* __restrict__ labels, float* __restrict__ partial,
    float* __restrict__ accs, int E, int N, int K, int p_tile, int stages, int rb, int tpc,
    int assign_only) {
  extern __shared__ __align__(16) char smem[];
  constexpr int SX = Pair<T>::SPLIT;
  const Plan g = make_plan(E + 3, p_tile, stages, (int)sizeof(T), BLK ? rb : E + 3);
  const int D = g.d, P = g.p, S = g.s, es = g.es, RB = g.rb;
  const int stage_bytes = (RB + 2) * g.rs;
  char* tiles = smem;
  uint2* wfrag = reinterpret_cast<uint2*>(tiles + (size_t)S * stage_bytes);  // (nkc, 3, 32)
  float* sacc = reinterpret_cast<float*>(wfrag + g.nkc * 96);  // (nmt, 32, 4) unless BLK
  unsigned long long* abase =  // (D,) unless BLK
      reinterpret_cast<unsigned long long*>(sacc + (BLK ? 0 : g.nmt * 128));
  unsigned long long* mbar = abase + (BLK ? 0 : D);  // (4,) one a ring slot
  int* lab = reinterpret_cast<int*>(mbar + 4);  // (P,)
  // pixel 0 of each row in a stage: (16 nkc,), or BLK (S, rb), a stage's block
  int* rowoff = lab + P;
  float* offs_s = reinterpret_cast<float*>(rowoff + (BLK ? S * RB : 16 * g.nkc));  // (KMAX,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int cta = blockIdx.x, b = blockIdx.y, ctas = gridDim.x;
  const long n = N;
  const int ntiles = (N + P - 1) / P;
  const int t0 = cta * tpc, nt = max(0, min(ntiles, t0 + tpc) - t0);
  // the sums fragments: in shared memory, or BLK in this CTA's scratch slot
  // (each entry read and written by one thread, tile after tile)
  float* acc = BLK ? accs + ((long)b * ctas + cta) * g.nmt * 128 : sacc;
  auto row_ptr = [&](int r) -> unsigned long long {
    return (unsigned long long)(r < E ? xe + ((long)b * E + r) * n
                                      : xc + ((long)b * 4 + r - E) * n);
  };

  // per-row source addresses (aligned down) and the shifts that find pixel 0
  if (!BLK)
    for (int r = tid; r < 16 * g.nkc; r += NT) {
      const int rr = r < D ? r : 0;
      const unsigned long long addr = row_ptr(rr);
      if (r < D) abase[r] = addr & ~15ull;
      rowoff[r] = rr * g.rs + (int)(addr & 15);
    }
  // the centre rows [r0, r0 + rows) as A fragments of the scores: lane (gid,
  // tig) of chunk kc holds centre gid at rows kc*16 + 2 tig (+1) and + 8
  // (+9), part by part; whether a part past the first is not 0
  auto centre_frags = [&](int r0, int rows) {
    bool multi = false;
    for (int e = tid; e < ((rows + 15) / 16) * 32; e += NT) {
      const int kc = e >> 5, ln = e & 31, q = ln >> 2, rr0 = kc * 16 + 2 * (ln & 3);
      unsigned u[4][3];
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = rr0 + (h & 1) + 8 * (h >> 1);
        split3(q < K && r < rows ? wc[((long)b * K + q) * D + r0 + r] : 0.f, u[h]);
        multi |= (u[h][1] | u[h][2]) != 0u;
      }
#pragma unroll
      for (int s = 0; s < 3; ++s)
        wfrag[(kc * 3 + s) * 32 + ln] =
            make_uint2(u[0][s] | (u[1][s] << 16), u[2][s] | (u[3][s] << 16));
    }
    return multi;
  };
  bool multi = false;
  if (BLK)  // the blocks' fragments are built as they are scored
    for (int e = tid; e < K * D; e += NT) {
      const float v = wc[(long)b * K * D + e];
      multi |= __bfloat162float(__float2bfloat16_rn(v)) != v;
    }
  else
    multi = centre_frags(0, D);
  if (tid < KMAX) offs_s[tid] = tid < K ? offs[b * K + tid] : 0.f;
  for (int e = tid; e < S * 2 * g.rs / 4; e += NT) {  // each stage's ones and zeros rows
    const int st = e / (2 * g.rs / 4), i = e - st * (2 * g.rs / 4);
    const unsigned one = sizeof(T) == 2 ? 0x3F803F80u : 0x3F800000u;
    reinterpret_cast<unsigned*>(tiles + (size_t)st * stage_bytes + RB * g.rs)[i] =
        i < g.rs / 4 ? one : 0u;
  }
  if (!assign_only)
    for (int e = tid; e < g.nmt * 128; e += NT) acc[e] = 0.f;
  if (tid < S) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
        (unsigned)__cvta_generic_to_shared(mbar + tid)));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  // centre parts a product needs: 1 when the caller rounded them to bf16
  const int nw = __syncthreads_or(multi) ? 3 : 1;

  // jobs: a tile staged in one go is one job (scores, then sums); BLK, its
  // nrb blocks are staged in turn for the scores, then again for the sums
  const int jpt = BLK ? (assign_only ? g.nrb : 2 * g.nrb) : 1;
  const int nj = nt * jpt;
  // staging. A tile whose rows, read from their aligned starts in whole
  // 16-byte chunks (m = P * es / 16 + 1 a row), stay inside their rows is
  // bulk-copied by TMA, one copy a row, completing on its slot's mbarrier;
  // the last tiles of an image take cp.async copies of the same chunks, the
  // bytes past the image zero-filled (m lanes a row).
  const int m = P * es / 16 + 1;
  auto bulk = [&](long p0) { return p0 + P + 16 / es <= n; };
  auto stage = [&](int j) {  // job j of this CTA into its ring slot
    if (j < nj) {
      const int slot = j % S, r0 = BLK ? (j % jpt % g.nrb) * RB : 0;
      const int rows = BLK ? min(RB, D - r0) : D;
      char* dst = tiles + (size_t)slot * stage_bytes;
      const long p0 = (long)(t0 + j / jpt) * P;
      int* ro = rowoff + (BLK ? slot * RB : 0);
      if (BLK)
        for (int r = tid; r < 16 * ((rows + 15) / 16); r += NT) {
          const int rr = r < rows ? r : 0;
          ro[r] = rr * g.rs + (int)(row_ptr(r0 + rr) & 15);
        }
      auto src_row = [&](int r) {  // row r's aligned start
        return reinterpret_cast<const char*>(BLK ? row_ptr(r0 + r) & ~15ull : abase[r]);
      };
      if (bulk(p0)) {
        if (tid == 0) mbar_expect(mbar + slot, rows * 16 * m);
        for (int r = tid; r < rows; r += NT)
          bulk_copy(dst + r * g.rs, src_row(r) + p0 * es, 16 * m, mbar + slot);
      } else {
        const int bytes = (int)(min((long)P, n - p0) * es);
        for (int e = tid; e < rows * m; e += NT) {
          const int r = e / m, c = e - r * m;
          const char* src = src_row(r) + p0 * es;
          const int sh = BLK ? (int)(row_ptr(r0 + r) & 15) : rowoff[r] - r * g.rs;
          const int valid = max(0, min(16, sh + bytes - 16 * c));
          cp_async16(dst + r * g.rs + 16 * c, valid ? src + 16 * c : src, valid);
        }
      }
    }
    cp_commit();  // an empty group past the last job keeps the count uniform
  };

  for (int j = 0; j < S - 1; ++j) stage(j);

  float c[4][4];  // the score chains, BLK kept across a tile's blocks
  for (int j = 0; j < nj; ++j) {
    const int t = j / jpt, ji = j - t * jpt;
    if (S == 1) {
      __syncthreads();  // the one slot is free again
      stage(j);
    }
    if (bulk((long)(t0 + t) * P))
      mbar_wait(mbar + j % S, (j / S) & 1);
    else
      cp_wait_upto(S - 2);
    __syncthreads();  // job j is in shared memory; slot (j - 1) % S is free
    if (S > 1) stage(j + S - 1);
    const char* buf = tiles + (size_t)(j % S) * stage_bytes;
    const long p0 = (long)(t0 + t) * P;
    const int bi = BLK ? ji % g.nrb : 0, r0 = bi * RB, rows = BLK ? min(RB, D - r0) : D;
    const int* ro = rowoff + (BLK ? (j % S) * RB : 0);
    const int nkc = BLK ? (rows + 15) / 16 : g.nkc;
    const bool scores = !BLK || ji < g.nrb;

    // scores: warp w takes pixels 8w .. 8w + 7 over all rows (four chains of
    // K-chunks, added pairwise at the end), then the first minimum over the
    // lanes' clusters; lanes gid 0 label pixels 8w + 2 tig and + 1
    if (scores && BLK) {
      centre_frags(r0, rows);
      __syncthreads();
    }
    if (scores && warp < P / 8) {
      const int px = 8 * warp + gid;
      if (bi == 0) {
#pragma unroll
        for (int ch = 0; ch < 4; ++ch)
#pragma unroll
          for (int h = 0; h < 4; ++h) c[ch][h] = 0.f;
      }
      for (int k0 = 0; k0 < nkc; k0 += 4) {
        unsigned b0[4][SX], b1[4][SX];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {  // chain ch takes the chunks kc = k0 + ch
          const int kc = min(k0 + ch, nkc - 1);
          const int2 oa = *reinterpret_cast<const int2*>(ro + kc * 16 + 2 * tig);
          const int2 ob = *reinterpret_cast<const int2*>(ro + kc * 16 + 2 * tig + 8);
          Pair<T>::pack(buf + oa.x + px * es, buf + oa.y + px * es, b0[ch]);
          Pair<T>::pack(buf + ob.x + px * es, buf + ob.y + px * es, b1[ch]);
        }
        for (int i = 0; i < nw; ++i) {
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            if (k0 + ch < nkc) {
              const uint2 a = wfrag[((k0 + ch) * 3 + i) * 32 + lane];
#pragma unroll
              for (int jj = 0; jj < SX; ++jj)
                if (i + jj <= 2) mma_bf16(c[ch], a.x, 0u, a.y, 0u, b0[ch][jj], b1[ch][jj]);
            }
          }
        }
      }
      if (bi == g.nrb - 1) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dot = (c[0][h] + c[1][h]) + (c[2][h] + c[3][h]);
          float v = gid < K ? offs_s[gid] - 2.f * dot : __int_as_float(0x7f800000);
          int q = gid;
#pragma unroll
          for (int sh = 4; sh < 32; sh <<= 1) {  // first minimum: ties to the lower id
            const float ov = __shfl_xor_sync(FULL, v, sh);
            const int oq = __shfl_xor_sync(FULL, q, sh);
            if (ov < v || (ov == v && oq < q)) {
              v = ov;
              q = oq;
            }
          }
          const int pp = 8 * warp + 2 * tig + h;
          if (gid == 0) {
            const bool valid = p0 + pp < n;
            if (valid) labels[(long)b * n + p0 + pp] = q;
            lab[pp] = valid ? q : -1;
          }
        }
      }
    }
    if (assign_only || (BLK && scores)) continue;
    if (!BLK) __syncthreads();  // the tile's labels (BLK: written a job before)

    // sums of the staged rows [r0, r0 + rows) and, with the last, the ones
    // row (the counts): this warp's M-tiles (w, w + NWARP, ...), MT_GROUP at
    // a time in registers, each over the tile's 16-pixel chunks in order
    const bool last_rows = r0 + rows == D;
    const int nmt = BLK ? (rows + (last_rows ? 1 : 0) + 15) / 16 : g.nmt;
    float4* accb = reinterpret_cast<float4*>(acc) + (r0 / 16) * 32;  // RB is a multiple of 16
    for (int m0 = warp; m0 < nmt; m0 += NWARP * MT_GROUP) {
      float cs[MT_GROUP][4];
      int off[MT_GROUP][2];
#pragma unroll
      for (int i = 0; i < MT_GROUP; ++i) {
        const int mt = m0 + i * NWARP;
        if (mt < nmt) {
          const float4 v = accb[mt * 32 + lane];
          cs[i][0] = v.x;
          cs[i][1] = v.y;
          cs[i][2] = v.z;
          cs[i][3] = v.w;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mt * 16 + gid + 8 * h;
            off[i][h] = (r < rows ? ro[r] : (r == rows && last_rows ? RB : RB + 1) * g.rs) +
                        2 * tig * es;
          }
        }
      }
#pragma unroll 4
      for (int kc = 0; kc < P / 16; ++kc) {
        const int px = kc * 16 + 2 * tig;
        const int2 l0 = *reinterpret_cast<const int2*>(lab + px);
        const int2 l1 = *reinterpret_cast<const int2*>(lab + px + 8);
        const unsigned b0 = (l0.x == gid ? 0x3F80u : 0u) | (l0.y == gid ? 0x3F800000u : 0u);
        const unsigned b1 = (l1.x == gid ? 0x3F80u : 0u) | (l1.y == gid ? 0x3F800000u : 0u);
#pragma unroll
        for (int i = 0; i < MT_GROUP; ++i) {
          if (m0 + i * NWARP < nmt) {
            unsigned a[4][SX];
            Pair<T>::row2(buf, off[i][0] + kc * 16 * es, a[0]);
            Pair<T>::row2(buf, off[i][1] + kc * 16 * es, a[1]);
            Pair<T>::row2(buf, off[i][0] + (kc * 16 + 8) * es, a[2]);
            Pair<T>::row2(buf, off[i][1] + (kc * 16 + 8) * es, a[3]);
#pragma unroll
            for (int s = 0; s < SX; ++s)
              mma_bf16(cs[i], a[0][s], a[1][s], a[2][s], a[3][s], b0, b1);
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
  if (assign_only) return;
  __syncthreads();

  // this CTA's partial: fragment entry (mt, lane, i) is row mt*16 + gid
  // (+ 8 for i >= 2), cluster 2*tig + (i & 1)
  const int width = K * (D + 1);
  float* out = partial + ((long)b * ctas + cta) * width;
  for (int e = tid; e < g.nmt * 128; e += NT) {
    const int mt = e >> 7, ln = (e >> 2) & 31, i = e & 3;
    const int r = mt * 16 + (ln >> 2) + 8 * (i >> 1), q = 2 * (ln & 3) + (i & 1);
    if (r <= D && q < K) out[q * (D + 1) + r] = acc[e];
  }
}

// sums[b, e] = the image's `ctas` partials of entry e added in CTA order: a
// warp an entry, lane l adding partials l, l + 32, ... in order, then a
// fixed butterfly over the lanes. The same bits on every run.
__global__ void partial_sum_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                                   int B, int ctas, int width) {
  const long i = ((long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  if (i >= (long)B * width) return;
  const int lane = threadIdx.x & 31;
  const long b = i / width, e = i - b * width;
  float v = 0.f;
  for (int c = lane; c < ctas; c += 32) v += partial[(b * ctas + c) * width + e];
  v = gcis::warp_sum(v);
  if (lane == 0) sums[i] = v;
}

template <typename T>
cudaError_t launch(const void* xe, const void* xc, const float* wc, const float* offs,
                   int* labels, float* partial, float* accs, int B, int E, int N, int k, int p,
                   int s, int rb, int ctas, int tpc, int assign_only, size_t smem,
                   cudaStream_t st) {
  auto kern = rb < E + 3 ? lloyd_kernel<T, true> : lloyd_kernel<T, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(ctas, B), NT, smem, st>>>((const T*)xe, (const T*)xc, wc, offs, labels, partial,
                                        accs, E, N, k, p, s, rb, tpc, assign_only);
  return cudaGetLastError();
}

}  // namespace

// xe: (B, E, N) and xc: (B, 4, N), float32 or bfloat16 (bf16 != 0).
// wc: (B, k, E + 3) and offs: (B, k) float32. labels: (B, N) int32.
// The plan (models/kmeans_chw.py::lloyd_plan): p pixels a tile (a power of
// 2, 16 to 128: one score warp a group of 8), s stages (1..4), rb rows a
// staged block (E + 3: the tile's rows in one stage; else a multiple of 16),
// ctas CTAs an image walking tpc tiles each. partial: (B, ctas, k, E + 4)
// float32 scratch; sums: (B, k, E + 4) float32, column E + 3 = member
// counts; accs: (B, ctas, 128 ceil((E + 4) / 16)) float32 scratch when
// rb < E + 3 (the CTAs' sums fragments), else unused. partial, sums and accs
// are untouched when assign_only != 0.
GCIS_API int gcis_lloyd_chw(const void* xe, const void* xc, const float* wc,
                            const float* offs, int* labels, float* partial, float* sums,
                            float* accs, int B, int E, int N, int k, int bf16, int p, int s,
                            int rb, int ctas, int tpc, int assign_only, void* stream) {
  const int es = bf16 ? 2 : 4;
  if (k < 1 || k > KMAX || E < 1 || N < 1 || B < 1 || B > 65535 || p < 16 || (p & (p - 1)) ||
      p > 8 * NWARP || s < 1 || s > 4 || ctas < 1 || tpc < 1 || (long)ctas * tpc * p < (long)N ||
      rb > E + 3 || (rb < E + 3 && (rb < 16 || rb % 16 || (!assign_only && !accs))))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(make_plan(E + 3, p, s, es, rb));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(xe, xc, wc, offs, labels, partial, accs, B, E, N, k, p, s,
                                   rb, ctas, tpc, assign_only, smem, st)
           : launch<float>(xe, xc, wc, offs, labels, partial, accs, B, E, N, k, p, s, rb, ctas,
                           tpc, assign_only, smem, st);
  if (err != cudaSuccess || assign_only) return (int)err;
  const long warps = (long)B * k * (E + 4);
  partial_sum_kernel<<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(partial, sums, B, ctas,
                                                                  k * (E + 4));
  return (int)cudaGetLastError();
}
