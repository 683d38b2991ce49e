// The standardisation of the labels-only path: per-row moments, the affine
// (a, b) with the coherence weights folded in, 2x2 mean pools and the
// normalised buffers, on raw channel-major rows.
//
// Replaces no TPU kernel: in the JAX package these are XLA ops
// (models/kmeans_chw.py::_affine_params, ops/features.py::_pool2x2_cm,
// coherence_weights_cm, assemble_xp_from_affine). In plain PyTorch they
// cost ~136 launches a config1 batch and float32 copies of every full-size
// tensor (a float32 copy of the energies, its square, the pools' float32
// temporaries), ~10.8 ms of an H100 where the bytes the stage must move
// take ~0.5 ms. Three kernels, each reading its input once and keeping no
// full-size float32 copy; ops/standardise.py has their wrappers and plain
// twins.
//
// Rows: row r < E of image b is plane (b, r) of the energies xe (B, E, h, w);
// rows E .. E + nc - 1 (nc = 3, or 0 for a single tensor) are planes 0 .. 2
// of the colour buffer xc (B, C, h, w), C >= 3. The colour is stored as the
// energies are, or in float32 beside bf16 energies (config2).
//
// std_moments_kernel: per row, the sum and the sum of squares of the row's
// values pooled LV times (LV = 0, 2 or 3) over the crop [0, hc) x [0, wc) of
// the pooled plane. Grid (B * R, nsplit): a block takes a fixed share of
// the row. On a whole plane (LV = 0, wc = w) the share is one contiguous
// run, read as 16-byte vectors from its first aligned address (the planes
// of an odd frame start at any 2-byte offset); each vector's 4 (float32)
// or 8 (bf16) values are added in float32 (a bf16 square is exact in
// float32), and the vector's two sums into the thread's float64 pair.
// Elsewhere each thread computes its pooled values from the source as the
// pools round them (see std_apply_kernel) and adds them in float64. The
// block adds its threads' pairs in a fixed order into its float64 partial;
// std_affine_kernel adds the partials in block order. No atomics: two
// launches give the same bits.
//
// std_affine_kernel: one thread a row. From the partials, in float64:
//   m = S1 / n, s = sqrt(max(S2 / n - m^2, 0)),
//   a = scale / (s + eps), b = -m a    (scale 1, or cw on the colour rows),
//   or a = scale, b = 0 without normalisation; then with the coherence
//   statistics of the 8x8 block means (sp, and s over the 8x8-divisible
//   crop without normalisation):
//   c = a sp / (a s + eps), a *= c^p, b *= c^p,
// rounded to float32 once: kmeans_chw's formulas, summed in float64 where
// the plain version sums in float32.
//
// std_apply_kernel: pools rows `lv` times (0 <= lv <= 5) in
// ops/features.py::_pool2x2_cm's order (row pairs 0.5 a + 0.5 b in float32,
// rounded to the storage type, then column pairs, rounded again), and
// writes them raw (a single tensor: _pool2x2_cm applied lv times) or
// normalised (a v + b in float32, each step rounded, no FMA, then rounded
// to the energies' type: assemble_xp_from_affine's rounding points). The
// normalised form can write the full-resolution rows too, from the same
// read: config2's normalised buffer and its fit grid in one pass. Colour
// values are rounded to the energies' type before they are pooled, as
// build_color4(color, dtype) rounds them. Grid (B * R, X): a block walks
// tiles of 2,048 values (2^lv or more rows by a power-of-two width),
// loads each tile once (the full-resolution rows written as they come),
// then pools it level by level in shared memory.
//
// Bound on the H100: device memory. config1 (16 x 321 x 481 bf16, 240
// energy rows): the moments read the energies (1.186 GB) and the 2x2 twin
// for the coherence statistics (0.295 GB), the coarse buffer reads the
// twin again and writes 0.075 GB; config2 (50 frames, 36 rows): the
// moments read 0.556 GB of energies and 0.093 GB of colour, the apply the
// same and writes 0.602 GB of normalised rows and 0.037 GB of fit grid.

#include "common.cuh"

namespace {

constexpr int NT = 256;       // threads a block, all three kernels
constexpr int TILE = 2048;    // values a tile of std_apply_kernel
constexpr int MAX_APPLY_LEVELS = 5;
constexpr int MAX_MOMENT_LEVELS = 3;

__device__ __forceinline__ long lmin(long a, long b) { return a < b ? a : b; }

// 0.5 a + 0.5 b in float32, rounded to T: one step of _pool2x2_cm.
template <typename T>
__device__ __forceinline__ float half_sum(float a, float b) {
  return gcis::round_to<T>(__fadd_rn(__fmul_rn(0.5f, a), __fmul_rn(0.5f, b)));
}

// The value at (i, j) of a plane of width w pooled L times, rounded to T at
// every step (rows first, then columns).
template <typename T, int L>
struct Pooled {
  static __device__ __forceinline__ float at(const T* __restrict__ p, int w, int i, int j) {
    const float a = Pooled<T, L - 1>::at(p, w, 2 * i, 2 * j);
    const float b = Pooled<T, L - 1>::at(p, w, 2 * i + 1, 2 * j);
    const float c = Pooled<T, L - 1>::at(p, w, 2 * i, 2 * j + 1);
    const float d = Pooled<T, L - 1>::at(p, w, 2 * i + 1, 2 * j + 1);
    return half_sum<T>(half_sum<T>(a, b), half_sum<T>(c, d));
  }
};
template <typename T>
struct Pooled<T, 0> {
  static __device__ __forceinline__ float at(const T* __restrict__ p, int w, int i, int j) {
    return gcis::ld(p, (long)i * w + j);
  }
};

// A 16-byte vector's values added into (s, q) in float32, in order.
__device__ __forceinline__ void add_vec(const uint4& u, const float*, float& s, float& q) {
  const float v[4] = {__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                      __uint_as_float(u.w)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s = __fadd_rn(s, v[k]);
    q = __fmaf_rn(v[k], v[k], q);
  }
}
__device__ __forceinline__ void add_vec(const uint4& u, const __nv_bfloat16*, float& s,
                                        float& q) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lo = __uint_as_float(w[k] << 16), hi = __uint_as_float(w[k] & 0xffff0000u);
    s = __fadd_rn(__fadd_rn(s, lo), hi);
    q = __fmaf_rn(hi, hi, __fmaf_rn(lo, lo, q));
  }
}

__device__ __forceinline__ void add_one(float v, double& s1, double& s2) {
  s1 += (double)v;
  s2 = fma((double)v, (double)v, s2);
}

// Sum and sum of squares of the n values at p, by the block's threads.
template <typename T>
__device__ void run_moments(const T* __restrict__ p, long n, double& s1, double& s2) {
  constexpr int VEC = 16 / (int)sizeof(T);
  long head = (long)((16 - ((size_t)p & 15)) & 15) / (long)sizeof(T);
  if (head > n) head = n;
  if (threadIdx.x < head) add_one(gcis::ld(p, threadIdx.x), s1, s2);
  const uint4* __restrict__ pv = reinterpret_cast<const uint4*>(p + head);
  const long nv = (n - head) / VEC;
  long k = threadIdx.x;
  for (; k + 3 * NT < nv; k += 4 * NT) {
    uint4 u[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) u[t] = __ldg(pv + k + t * NT);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      float s = 0.f, q = 0.f;
      add_vec(u[t], p, s, q);
      s1 += (double)s;
      s2 += (double)q;
    }
  }
  for (; k < nv; k += NT) {
    float s = 0.f, q = 0.f;
    add_vec(__ldg(pv + k), p, s, q);
    s1 += (double)s;
    s2 += (double)q;
  }
  const long done = head + nv * VEC;
  if (threadIdx.x < n - done) add_one(gcis::ld(p, done + threadIdx.x), s1, s2);
}

// A block's share of one plane's moments: the values pooled LV times over
// the crop [0, hc) x [0, wc).
template <typename T, int LV>
__device__ void plane_moments(const T* __restrict__ p, int w, int hc, int wc, int split,
                              int nsplit, double& s1, double& s2) {
  if (LV == 0 && wc == w) {
    const long n = (long)hc * w;
    const long chunk = ((n + nsplit - 1) / nsplit + 7) & ~7L;
    const long p0 = lmin(n, (long)split * chunk), p1 = lmin(n, p0 + chunk);
    run_moments(p + p0, p1 - p0, s1, s2);
    return;
  }
  const long n = (long)hc * wc;
  const long chunk = (n + nsplit - 1) / nsplit;
  const long p0 = lmin(n, (long)split * chunk), p1 = lmin(n, p0 + chunk);
  for (long k = p0 + threadIdx.x; k < p1; k += NT) {
    const int i = (int)(k / wc), j = (int)(k - (long)i * wc);
    add_one(Pooled<T, LV>::at(p, w, i, j), s1, s2);
  }
}

template <typename Te, typename Tc, int LV>
__global__ void __launch_bounds__(NT)
    std_moments_kernel(const Te* __restrict__ xe, const Tc* __restrict__ xc, double* out,
                       int E, int R, int C, int h, int w, int hc, int wc) {
  const int row = blockIdx.x, split = blockIdx.y, nsplit = gridDim.y;
  const int b = row / R, r = row - b * R;
  const long hw = (long)h * w;
  double s1 = 0.0, s2 = 0.0;
  if (r < E)
    plane_moments<Te, LV>(xe + ((long)b * E + r) * hw, w, hc, wc, split, nsplit, s1, s2);
  else
    plane_moments<Tc, LV>(xc + ((long)b * C + (r - E)) * hw, w, hc, wc, split, nsplit, s1,
                          s2);
  __shared__ double red[2][NT / 32];
  s1 = gcis::warp_sum(s1);
  s2 = gcis::warp_sum(s2);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    double t1 = 0.0, t2 = 0.0;
    for (int i = 0; i < NT / 32; ++i) {
      t1 += red[0][i];
      t2 += red[1][i];
    }
    double* o = out + ((long)row * nsplit + split) * 2;
    o[0] = t1;
    o[1] = t2;
  }
}

// mean and one-pass std of a row from its ns float64 partials (block order)
__device__ void row_stats(const double* p, int ns, double n, double& m, double& s) {
  double s1 = 0.0, s2 = 0.0;
  for (int i = 0; i < ns; ++i) {
    s1 += p[2 * i];
    s2 += p[2 * i + 1];
  }
  m = s1 / n;
  s = sqrt(fmax(s2 / n - m * m, 0.0));
}

__global__ void std_affine_kernel(const double* full, int ns0, double n0, const double* coh,
                                  int ns1, double n1, const double* crop, int ns2, double n2,
                                  int rows, int E, int R, double cw, double eps, double pw,
                                  float* A, float* Bo) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= rows) return;
  const double scale = row % R < E ? 1.0 : cw;
  double a = scale, b = 0.0, m = 0.0, s = 0.0;
  if (full) {
    row_stats(full + (long)row * ns0 * 2, ns0, n0, m, s);
    a = scale / (s + eps);
    b = -m * a;
  }
  if (coh) {
    double mp, sp;
    row_stats(coh + (long)row * ns1 * 2, ns1, n1, mp, sp);
    if (!full) row_stats(crop + (long)row * ns2 * 2, ns2, n2, m, s);
    const double c = (a * sp) / (a * s + eps);
    const double wgt = pw == 1.0 ? c : pow(c, pw);
    a *= wgt;
    b *= wgt;
  }
  A[row] = (float)a;
  Bo[row] = (float)b;
}

template <typename T>
__device__ __forceinline__ void put(T* __restrict__ o, long i, float v, int raw, float a,
                                    float b) {
  gcis::st(o, i, raw ? v : __fadd_rn(__fmul_rn(v, a), b));
}

// One row of std_apply_kernel: source type Ts, pools and output in Te.
template <typename Ts, typename Te>
__device__ void apply_row(const Ts* __restrict__ src, int w, float a, float b, int raw,
                          Te* __restrict__ full, Te* __restrict__ pooled, int lv, int logtw,
                          int wl, int hl, int rows_lim, int cols_lim, int ntx, int ntiles,
                          float* s0, float* s1) {
  const int tw = 1 << logtw, sr = TILE >> logtw;
  for (int t = blockIdx.y; t < ntiles; t += gridDim.y) {
    const int ty = t / ntx, tx = t - ty * ntx;
    const int i0 = ty * sr, j0 = tx * tw;
    float v[TILE / NT];
#pragma unroll
    for (int k = 0; k < TILE / NT; ++k) {
      const int e = threadIdx.x + k * NT;
      const int gi = i0 + (e >> logtw), gj = j0 + (e & (tw - 1));
      v[k] = gi < rows_lim && gj < cols_lim ? gcis::ld(src, (long)gi * w + gj) : 0.f;
    }
    if (full) {
#pragma unroll
      for (int k = 0; k < TILE / NT; ++k) {
        const int e = threadIdx.x + k * NT;
        const int gi = i0 + (e >> logtw), gj = j0 + (e & (tw - 1));
        if (gi < rows_lim && gj < cols_lim) put(full, (long)gi * w + gj, v[k], 0, a, b);
      }
    }
    if (lv == 0) continue;
#pragma unroll
    for (int k = 0; k < TILE / NT; ++k) s0[threadIdx.x + k * NT] = gcis::round_to<Te>(v[k]);
    __syncthreads();
    const float* prev = s0;
    float* next = s1;
    int pr = sr, pc = tw;
    for (int l = 1; l <= lv; ++l) {
      const int nr = pr >> 1, nc = pc >> 1, lnc = logtw - l;
      for (int o = threadIdx.x; o < nr * nc; o += NT) {
        const int ri = o >> lnc, ci = o & (nc - 1);
        const float* q = prev + 2 * ri * pc + 2 * ci;
        const float u = half_sum<Te>(half_sum<Te>(q[0], q[pc]), half_sum<Te>(q[1], q[pc + 1]));
        if (l < lv) {
          next[o] = u;
        } else {
          const int pi = (i0 >> lv) + ri, pj = (j0 >> lv) + ci;
          if (pi < hl && pj < wl) put(pooled, (long)pi * wl + pj, u, raw, a, b);
        }
      }
      __syncthreads();
      float* was = const_cast<float*>(prev);
      prev = next;
      next = was;
      pr = nr;
      pc = nc;
    }
  }
}

template <typename Te, typename Tc>
__global__ void __launch_bounds__(NT)
    std_apply_kernel(const Te* __restrict__ xe, const Tc* __restrict__ xc, int C,
                     const float* __restrict__ A, const float* __restrict__ Bv, int raw,
                     Te* __restrict__ full, Te* __restrict__ pooled, int E, int R, int h,
                     int w, int lv, int logtw, int rows_lim, int cols_lim, int ntx,
                     int ntiles) {
  __shared__ float s0[TILE];
  __shared__ float s1[TILE / 4];
  const int row = blockIdx.x;
  const int b = row / R, r = row - b * R;
  const long hw = (long)h * w;
  const int hl = h >> lv, wl = w >> lv;
  const float a = raw ? 1.f : A[row], bb = raw ? 0.f : Bv[row];
  Te* fo = full ? full + (long)row * hw : nullptr;
  Te* po = pooled ? pooled + (long)row * hl * wl : nullptr;
  if (r < E)
    apply_row<Te, Te>(xe + ((long)b * E + r) * hw, w, a, bb, raw, fo, po, lv, logtw, wl, hl,
                      rows_lim, cols_lim, ntx, ntiles, s0, s1);
  else
    apply_row<Tc, Te>(xc + ((long)b * C + (r - E)) * hw, w, a, bb, raw, fo, po, lv, logtw, wl,
                      hl, rows_lim, cols_lim, ntx, ntiles, s0, s1);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Te, typename Tc>
cudaError_t moments_t(const void* xe, const void* xc, double* out, int B, int E, int nc,
                      int C, int h, int w, int lv, int hc, int wc, int nsplit,
                      cudaStream_t s) {
  const dim3 grid(B * (E + nc), nsplit);
  const Te* pe = static_cast<const Te*>(xe);
  const Tc* pc = static_cast<const Tc*>(xc);
  const int R = E + nc;
  switch (lv) {
    case 0:
      std_moments_kernel<Te, Tc, 0><<<grid, NT, 0, s>>>(pe, pc, out, E, R, C, h, w, hc, wc);
      break;
    case 2:
      std_moments_kernel<Te, Tc, 2><<<grid, NT, 0, s>>>(pe, pc, out, E, R, C, h, w, hc, wc);
      break;
    default:
      std_moments_kernel<Te, Tc, 3><<<grid, NT, 0, s>>>(pe, pc, out, E, R, C, h, w, hc, wc);
  }
  return cudaGetLastError();
}

template <typename Te, typename Tc>
cudaError_t apply_t(const void* xe, const void* xc, int C, const float* A, const float* Bv,
                    int raw, void* full, void* pooled, int B, int E, int nc, int h, int w,
                    int lv, int logtw, int rows_lim, int cols_lim, int ntx, int ntiles, int X,
                    cudaStream_t s) {
  const int R = E + nc;
  std_apply_kernel<Te, Tc><<<dim3(B * R, X), NT, 0, s>>>(
      static_cast<const Te*>(xe), static_cast<const Tc*>(xc), C, A, Bv, raw,
      static_cast<Te*>(full), static_cast<Te*>(pooled), E, R, h, w, lv, logtw, rows_lim,
      cols_lim, ntx, ntiles);
  return cudaGetLastError();
}

}  // namespace

// Per-row float64 partials (B * (E + nc), nsplit, 2) of the values pooled lv
// (0, 2 or 3) times over the crop [0, hc) x [0, wc). te, tc: 1 for bf16
// storage; float32 energies take float32 colour.
GCIS_API int gcis_std_moments(const void* xe, const void* xc, double* out, int B, int E,
                              int nc, int C, int h, int w, int lv, int hc, int wc, int nsplit,
                              int te, int tc, void* stream) {
  if (B < 1 || E < 0 || (nc != 0 && nc != 3) || E + nc < 1 || (nc && C < 3) || h < 1 ||
      w < 1 || lv < 0 || lv == 1 || lv > MAX_MOMENT_LEVELS || hc < 1 || wc < 1 ||
      ((long)hc << lv) > h || ((long)wc << lv) > w || nsplit < 1 || nsplit > 65535 ||
      (!te && tc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!te)
    return (int)moments_t<float, float>(xe, xc, out, B, E, nc, C, h, w, lv, hc, wc, nsplit, s);
  return (int)(tc ? moments_t<__nv_bfloat16, __nv_bfloat16>(xe, xc, out, B, E, nc, C, h, w, lv,
                                                            hc, wc, nsplit, s)
                  : moments_t<__nv_bfloat16, float>(xe, xc, out, B, E, nc, C, h, w, lv, hc, wc,
                                                    nsplit, s));
}

// (a, b) float32 (B, E + 3) from the partials of gcis_std_moments: `full`
// (the whole planes, or null without normalisation), `coh` (the 8x8 block
// means, or null without coherence weights) and `crop` (the 8x8-divisible
// crop; read only with coh and without full).
GCIS_API int gcis_std_affine(const double* full, const double* coh, const double* crop,
                             float* A, float* Bo, int B, int E, int ns0, int ns1, int ns2,
                             double n0, double n1, double n2, double cw, double eps,
                             double pw, void* stream) {
  if (B < 1 || E < 0 || (full && ns0 < 1) || (coh && ns1 < 1) || (coh && !full && !crop) ||
      (coh && !full && ns2 < 1))
    return (int)cudaErrorInvalidValue;
  const int rows = B * (E + 3);
  std_affine_kernel<<<(rows + NT - 1) / NT, NT, 0, (cudaStream_t)stream>>>(
      full, ns0, n0, coh, ns1, n1, crop, ns2, n2, rows, E, E + 3, cw, eps, pw, A, Bo);
  return (int)cudaGetLastError();
}

// Rows pooled lv times, raw (nc = 0, a single tensor) into `pooled`, or
// normalised (a v + b) into `pooled` and, where `full` is not null, at full
// resolution into `full`; written in the energies' type. The tiles: 2^logtw
// values wide, ntx across, ntiles in all, over [0, rows_lim) x [0,
// cols_lim); X blocks a row walk them. float32 energies take float32 colour.
GCIS_API int gcis_std_apply(const void* xe, const void* xc, const float* A, const float* Bv,
                            void* full, void* pooled, int B, int E, int nc, int C, int h,
                            int w, int lv, int raw, int logtw, int rows_lim, int cols_lim,
                            int ntx, int ntiles, int X, int te, int tc, void* stream) {
  if (B < 1 || E < 0 || (nc != 0 && nc != 3) || E + nc < 1 || (nc && C < 3) || h < 1 ||
      w < 1 || lv < 0 || lv > MAX_APPLY_LEVELS || logtw < lv || (TILE >> logtw) < (1 << lv) ||
      X < 1 || X > 65535 || ntiles < 1 || ntx < 1 || (raw && nc) || (!raw && (!A || !Bv)) ||
      (!full && !pooled) || (pooled && lv == 0) || (full && raw) || rows_lim > h ||
      cols_lim > w || (nc && !te && tc))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (!te)
    return (int)apply_t<float, float>(xe, xc, C, A, Bv, raw, full, pooled, B, E, nc, h, w, lv,
                                      logtw, rows_lim, cols_lim, ntx, ntiles, X, s);
  return (int)(tc ? apply_t<__nv_bfloat16, __nv_bfloat16>(xe, xc, C, A, Bv, raw, full, pooled,
                                                          B, E, nc, h, w, lv, logtw, rows_lim,
                                                          cols_lim, ntx, ntiles, X, s)
                  : apply_t<__nv_bfloat16, float>(xe, xc, C, A, Bv, raw, full, pooled, B, E,
                                                  nc, h, w, lv, logtw, rows_lim, cols_lim, ntx,
                                                  ntiles, X, s));
}
