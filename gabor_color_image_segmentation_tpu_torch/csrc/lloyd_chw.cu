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

#include "common.cuh"

namespace {

constexpr int NT = 512;
constexpr int NWARP = NT / 32;
constexpr int KMAX = 8;
constexpr int MT_GROUP = 4;  // M-tiles a warp holds in registers at once
constexpr int SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

// The plan's quantities, shared by the host-side checks and the kernel.
struct Plan {
  int d, p, s, es;  // rows, pixels a tile, stages, bytes a value
  int rs;           // bytes of a staged row (the tile's row + 16)
  int nkc;          // 16-row K-chunks of the scores (rows 0..D-1)
  int nmt;          // 16-row M-tiles of the sums (rows 0..D)
};

__host__ __device__ inline Plan make_plan(int d, int p, int s, int es) {
  Plan g;
  g.d = d;
  g.p = p;
  g.s = s;
  g.es = es;
  g.rs = p * es + 16;
  g.nkc = (d + 15) / 16;
  g.nmt = (d + 1 + 15) / 16;
  return g;
}

// Dynamic shared memory of one CTA (models/kmeans_chw.py::_lloyd_smem): the
// ring (a stage holds the D staged rows, then a row of ones and a row of
// zeros), the centre rows as score fragments (three parts), the sums
// fragments, the rows' source addresses, the tile's labels, the rows'
// offsets, the ring's mbarriers (four) and the score offsets.
__host__ __device__ inline size_t smem_bytes(const Plan& g) {
  return (size_t)g.s * (g.d + 2) * g.rs + 768 * (size_t)g.nkc + 512 * (size_t)g.nmt +
         8 * (size_t)g.d + 8 * 4 + 4 * ((size_t)g.p + 16 * g.nkc + KMAX);
}

// 16 bytes to shared memory, of which the first `valid` come from src and the
// rest are zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_wait(int pending) {
  if (pending <= 0)
    asm volatile("cp.async.wait_group 0;\n");
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n");
  else
    asm volatile("cp.async.wait_group 2;\n");
}

// TMA: a 1-D bulk copy of `bytes` (a multiple of 16) that completes its
// bytes on the mbarrier; the mbarrier's arrival with the expected bytes; the
// wait for a phase's parity.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes, void* mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"((unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"((unsigned)__cvta_generic_to_shared(mbar))
      : "memory");
}
__device__ __forceinline__ void mbar_expect(void* mbar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(mbar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(void* mbar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE%=;\nbra WAIT%=;\nDONE%=:\n}\n" ::"r"((unsigned)__cvta_generic_to_shared(mbar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x = hi + mid + lo exactly: each part is the bf16 rounding of what the
// parts before it left (bits in the low half of each word).
__device__ __forceinline__ void split3(float x, unsigned (&p)[3]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    p[s] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
    x -= __uint_as_float(p[s] << 16);
  }
}

// Two staged values (the first in the low half) as SPLIT packed bf16 pairs.
template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  static constexpr int SPLIT = 1;
  __device__ __forceinline__ static void pack(const char* p0, const char* p1, unsigned (&a)[1]) {
    a[0] = (unsigned)*reinterpret_cast<const unsigned short*>(p0) |
           ((unsigned)*reinterpret_cast<const unsigned short*>(p1) << 16);
  }
  // two neighbouring pixels of a row at byte offset off (even): one word
  // when off is a multiple of 4, else the halves of two words
  __device__ __forceinline__ static void row2(const char* buf, int off, unsigned (&a)[1]) {
    const unsigned* w = reinterpret_cast<const unsigned*>(buf + (off & ~3));
    a[0] = __byte_perm(w[0], w[1], (off & 2) ? 0x5432 : 0x3210);
  }
};

template <>
struct Pair<float> {
  static constexpr int SPLIT = 3;
  __device__ __forceinline__ static void pack(const char* p0, const char* p1, unsigned (&a)[3]) {
    unsigned u[3], v[3];
    split3(*reinterpret_cast<const float*>(p0), u);
    split3(*reinterpret_cast<const float*>(p1), v);
#pragma unroll
    for (int s = 0; s < 3; ++s) a[s] = u[s] | (v[s] << 16);
  }
  __device__ __forceinline__ static void row2(const char* buf, int off, unsigned (&a)[3]) {
    pack(buf + off, buf + off + 4, a);
  }
};

template <typename T>
__global__ void __launch_bounds__(NT, 1) lloyd_kernel(
    const T* __restrict__ xe, const T* __restrict__ xc, const float* __restrict__ wc,
    const float* __restrict__ offs, int* __restrict__ labels, float* __restrict__ partial,
    int E, int N, int K, int p_tile, int stages, int tpc, int assign_only) {
  extern __shared__ __align__(16) char smem[];
  constexpr int SX = Pair<T>::SPLIT;
  const Plan g = make_plan(E + 3, p_tile, stages, (int)sizeof(T));
  const int D = g.d, P = g.p, S = g.s, es = g.es;
  const int stage_bytes = (D + 2) * g.rs;
  char* tiles = smem;
  uint2* wfrag = reinterpret_cast<uint2*>(tiles + (size_t)S * stage_bytes);  // (nkc, 3, 32)
  float* acc = reinterpret_cast<float*>(wfrag + g.nkc * 96);  // (nmt, 32, 4) sums fragments
  unsigned long long* abase = reinterpret_cast<unsigned long long*>(acc + g.nmt * 128);  // (D,)
  unsigned long long* mbar = abase + D;  // (4,) one a ring slot
  int* lab = reinterpret_cast<int*>(mbar + 4);  // (P,)
  int* rowoff = lab + P;  // (16 nkc,) pixel 0 of each row in a stage
  float* offs_s = reinterpret_cast<float*>(rowoff + 16 * g.nkc);  // (KMAX,)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int cta = blockIdx.x, b = blockIdx.y, ctas = gridDim.x;
  const long n = N;
  const int ntiles = (N + P - 1) / P;
  const int t0 = cta * tpc, nt = max(0, min(ntiles, t0 + tpc) - t0);

  // per-row source addresses (aligned down) and the shifts that find pixel 0
  for (int r = tid; r < 16 * g.nkc; r += NT) {
    const int rr = r < D ? r : 0;
    const T* row = rr < E ? xe + ((long)b * E + rr) * n : xc + ((long)b * 4 + rr - E) * n;
    const unsigned long long addr = (unsigned long long)row;
    if (r < D) abase[r] = addr & ~15ull;
    rowoff[r] = rr * g.rs + (int)(addr & 15);
  }
  // the centre rows as A fragments of the scores: lane (gid, tig) of chunk kc
  // holds centre gid at rows kc*16 + 2 tig (+1) and + 8 (+9), part by part
  bool multi = false;
  for (int e = tid; e < g.nkc * 32; e += NT) {
    const int kc = e >> 5, ln = e & 31, q = ln >> 2, r0 = kc * 16 + 2 * (ln & 3);
    unsigned u[4][3];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = r0 + (h & 1) + 8 * (h >> 1);
      split3(q < K && r < D ? wc[((long)b * K + q) * D + r] : 0.f, u[h]);
      multi |= (u[h][1] | u[h][2]) != 0u;
    }
#pragma unroll
    for (int s = 0; s < 3; ++s)
      wfrag[(kc * 3 + s) * 32 + ln] =
          make_uint2(u[0][s] | (u[1][s] << 16), u[2][s] | (u[3][s] << 16));
  }
  if (tid < KMAX) offs_s[tid] = tid < K ? offs[b * K + tid] : 0.f;
  for (int e = tid; e < S * 2 * g.rs / 4; e += NT) {  // each stage's ones and zeros rows
    const int st = e / (2 * g.rs / 4), i = e - st * (2 * g.rs / 4);
    const unsigned one = sizeof(T) == 2 ? 0x3F803F80u : 0x3F800000u;
    reinterpret_cast<unsigned*>(tiles + (size_t)st * stage_bytes + D * g.rs)[i] =
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

  // staging. A tile whose rows, read from their aligned starts in whole
  // 16-byte chunks (m = P * es / 16 + 1 a row), stay inside their rows is
  // bulk-copied by TMA, one copy a row, completing on its slot's mbarrier;
  // the last tiles of an image take cp.async copies of the same chunks, the
  // bytes past the image zero-filled (m lanes a row).
  const int m = P * es / 16 + 1;
  auto bulk = [&](long p0) { return p0 + P + 16 / es <= n; };
  auto stage = [&](int t) {  // tile t of this CTA into its ring slot
    if (t < nt) {
      char* dst = tiles + (size_t)(t % S) * stage_bytes;
      const long p0 = (long)(t0 + t) * P;
      if (bulk(p0)) {
        if (tid == 0) mbar_expect(mbar + t % S, D * 16 * m);
        for (int r = tid; r < D; r += NT)
          bulk_copy(dst + r * g.rs, reinterpret_cast<const char*>(abase[r]) + p0 * es, 16 * m,
                    mbar + t % S);
      } else {
        const int bytes = (int)(min((long)P, n - p0) * es);
        for (int e = tid; e < D * m; e += NT) {
          const int r = e / m, c = e - r * m;
          const char* src = reinterpret_cast<const char*>(abase[r]) + p0 * es;
          const int valid = max(0, min(16, rowoff[r] - r * g.rs + bytes - 16 * c));
          cp_async16(dst + r * g.rs + 16 * c, valid ? src + 16 * c : src, valid);
        }
      }
    }
    cp_commit();  // an empty group past the last tile keeps the count uniform
  };

  for (int t = 0; t < S - 1; ++t) stage(t);

  for (int t = 0; t < nt; ++t) {
    if (S == 1) {
      __syncthreads();  // the one slot is free again
      stage(t);
    }
    if (bulk((long)(t0 + t) * P))
      mbar_wait(mbar + t % S, (t / S) & 1);
    else
      cp_wait(S - 2);
    __syncthreads();  // tile t is in shared memory; slot (t - 1) % S is free
    if (S > 1) stage(t + S - 1);
    const char* buf = tiles + (size_t)(t % S) * stage_bytes;
    const long p0 = (long)(t0 + t) * P;

    // scores: warp w takes pixels 8w .. 8w + 7 over all rows (four chains of
    // K-chunks, added pairwise at the end), then the first minimum over the
    // lanes' clusters; lanes gid 0 label pixels 8w + 2 tig and + 1
    if (warp < P / 8) {
      const int px = 8 * warp + gid;
      float c[4][4] = {};
      for (int k0 = 0; k0 < g.nkc; k0 += 4) {
        unsigned b0[4][SX], b1[4][SX];
#pragma unroll
        for (int ch = 0; ch < 4; ++ch) {  // chain ch takes the chunks kc = k0 + ch
          const int kc = min(k0 + ch, g.nkc - 1);
          const int2 oa = *reinterpret_cast<const int2*>(rowoff + kc * 16 + 2 * tig);
          const int2 ob = *reinterpret_cast<const int2*>(rowoff + kc * 16 + 2 * tig + 8);
          Pair<T>::pack(buf + oa.x + px * es, buf + oa.y + px * es, b0[ch]);
          Pair<T>::pack(buf + ob.x + px * es, buf + ob.y + px * es, b1[ch]);
        }
        for (int i = 0; i < nw; ++i) {
#pragma unroll
          for (int ch = 0; ch < 4; ++ch) {
            if (k0 + ch < g.nkc) {
              const uint2 a = wfrag[((k0 + ch) * 3 + i) * 32 + lane];
#pragma unroll
              for (int j = 0; j < SX; ++j)
                if (i + j <= 2) mma_bf16(c[ch], a.x, 0u, a.y, 0u, b0[ch][j], b1[ch][j]);
            }
          }
        }
      }
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
    if (assign_only) continue;
    __syncthreads();

    // sums: this warp's M-tiles (w, w + NWARP, ...), MT_GROUP at a time in
    // registers, each over the tile's 16-pixel chunks in order
    for (int m0 = warp; m0 < g.nmt; m0 += NWARP * MT_GROUP) {
      float c[MT_GROUP][4];
      int off[MT_GROUP][2];
#pragma unroll
      for (int i = 0; i < MT_GROUP; ++i) {
        const int mt = m0 + i * NWARP;
        if (mt < g.nmt) {
          const float4 v = reinterpret_cast<const float4*>(acc)[mt * 32 + lane];
          c[i][0] = v.x;
          c[i][1] = v.y;
          c[i][2] = v.z;
          c[i][3] = v.w;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = mt * 16 + gid + 8 * h;
            off[i][h] = (r < D ? rowoff[r] : min(r, D + 1) * g.rs) + 2 * tig * es;
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
          if (m0 + i * NWARP < g.nmt) {
            unsigned a[4][SX];
            Pair<T>::row2(buf, off[i][0] + kc * 16 * es, a[0]);
            Pair<T>::row2(buf, off[i][1] + kc * 16 * es, a[1]);
            Pair<T>::row2(buf, off[i][0] + (kc * 16 + 8) * es, a[2]);
            Pair<T>::row2(buf, off[i][1] + (kc * 16 + 8) * es, a[3]);
#pragma unroll
            for (int s = 0; s < SX; ++s)
              mma_bf16(c[i], a[0][s], a[1][s], a[2][s], a[3][s], b0, b1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MT_GROUP; ++i) {
        const int mt = m0 + i * NWARP;
        if (mt < g.nmt)
          reinterpret_cast<float4*>(acc)[mt * 32 + lane] =
              make_float4(c[i][0], c[i][1], c[i][2], c[i][3]);
      }
    }
  }
  cp_wait(0);
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
                   int* labels, float* partial, int B, int E, int N, int k, int p, int s,
                   int ctas, int tpc, int assign_only, size_t smem, cudaStream_t st) {
  auto kern = lloyd_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3(ctas, B), NT, smem, st>>>((const T*)xe, (const T*)xc, wc, offs, labels, partial,
                                        E, N, k, p, s, tpc, assign_only);
  return cudaGetLastError();
}

}  // namespace

// xe: (B, E, N) and xc: (B, 4, N), float32 or bfloat16 (bf16 != 0).
// wc: (B, k, E + 3) and offs: (B, k) float32. labels: (B, N) int32.
// The plan (models/kmeans_chw.py::lloyd_plan): p pixels a tile (a power of
// 2, 16 to 128: one score warp a group of 8), s stages (1..4), ctas CTAs an
// image walking tpc tiles each. partial: (B, ctas, k, E + 4) float32 scratch;
// sums: (B, k, E + 4) float32, column E + 3 = member counts. partial and
// sums are untouched when assign_only != 0.
GCIS_API int gcis_lloyd_chw(const void* xe, const void* xc, const float* wc,
                            const float* offs, int* labels, float* partial, float* sums,
                            int B, int E, int N, int k, int bf16, int p, int s, int ctas,
                            int tpc, int assign_only, void* stream) {
  const int es = bf16 ? 2 : 4;
  if (k < 1 || k > KMAX || E < 1 || N < 1 || B < 1 || B > 65535 || p < 16 || (p & (p - 1)) ||
      p > 8 * NWARP || s < 1 || s > 4 || ctas < 1 || tpc < 1 || (long)ctas * tpc * p < (long)N)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(make_plan(E + 3, p, s, es));
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err =
      bf16 ? launch<__nv_bfloat16>(xe, xc, wc, offs, labels, partial, B, E, N, k, p, s, ctas,
                                   tpc, assign_only, smem, st)
           : launch<float>(xe, xc, wc, offs, labels, partial, B, E, N, k, p, s, ctas, tpc,
                           assign_only, smem, st);
  if (err != cudaSuccess || assign_only) return (int)err;
  const long warps = (long)B * k * (E + 4);
  partial_sum_kernel<<<(unsigned)((warps + 7) / 8), 256, 0, st>>>(partial, sums, B, ctas,
                                                                  k * (E + 4));
  return (int)cudaGetLastError();
}
