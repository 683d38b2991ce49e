// Shared helpers of the port's Hopper kernels: typed loads and stores
// (float32 or bfloat16 storage, float32 arithmetic), REFLECT_101 indexing,
// the deterministic warp/block reductions the kernels use in place of
// float atomics, cp.async and TMA staging, and exact bf16 tensor-core
// products (K2, K7).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

#define GCIS_API extern "C" __attribute__((visibility("default")))

namespace gcis {

static __device__ __forceinline__ float ld(const float* p, long i) { return p[i]; }
static __device__ __forceinline__ float ld(const __nv_bfloat16* p, long i) {
  return __bfloat162float(p[i]);
}
static __device__ __forceinline__ void st(float* p, long i, float v) { p[i] = v; }
static __device__ __forceinline__ void st(__nv_bfloat16* p, long i, float v) {
  p[i] = __float2bfloat16(v);
}

// A float32 value rounded through the storage type T and back.
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

static __device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// REFLECT_101 (... 2 1 | 0 1 2 ... n-1 | n-2 n-3 ...), folded as often as
// the offset needs.
static __device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  while (i < 0 || i >= n) {
    if (i < 0) i = -i;
    if (i >= n) i = 2 * (n - 1) - i;
  }
  return i;
}

// (value, flat index): the larger value wins, the smaller index on ties.
// The rule is associative and commutative, so any reduction order gives
// the first index of the maximum.
struct ArgMax {
  float v;
  int i;
};

static __device__ __forceinline__ ArgMax better(ArgMax a, ArgMax b) {
  return (b.v > a.v || (b.v == a.v && b.i < a.i)) ? b : a;
}

static __device__ __forceinline__ ArgMax warp_argmax(ArgMax a) {
  for (int off = 16; off > 0; off >>= 1) {
    ArgMax o;
    o.v = __shfl_xor_sync(0xffffffffu, a.v, off);
    o.i = __shfl_xor_sync(0xffffffffu, a.i, off);
    a = better(a, o);
  }
  return a;
}

// Block-wide argmax; every thread gets the result. blockDim.x is a
// multiple of 32; scratch holds 32 entries.
static __device__ ArgMax block_argmax(ArgMax a, ArgMax* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  a = warp_argmax(a);
  __syncthreads();  // scratch may still be read from a previous call
  if (lane == 0) scratch[warp] = a;
  __syncthreads();
  if (warp == 0) {
    ArgMax b = lane < nw ? scratch[lane] : ArgMax{neg_inf(), INT_MAX};
    b = warp_argmax(b);
    if (lane == 0) scratch[0] = b;
  }
  __syncthreads();
  return scratch[0];
}

// 16 bytes to shared memory, of which the first `valid` come from src and the
// rest are zeros.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src, int valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(valid));
}
static __device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// The same with the count known at run time: at most `pending` (0, 1, or 2
// for 2 and more) groups left in flight.
static __device__ __forceinline__ void cp_wait_upto(int pending) {
  if (pending <= 0)
    cp_wait<0>();
  else if (pending == 1)
    cp_wait<1>();
  else
    cp_wait<2>();
}

// A staged row: tp pixels of esize bytes and up to 15 bytes before the
// first, in 16-byte chunks.
__host__ __device__ inline int row_bytes(int tp, int esize) { return tp * esize + 16; }

// Copy `rows` rows of pixels [base, base + nv), the first at xr and each n
// elements after the one before, into buf (rs bytes a row), each row from
// its 16-byte-aligned start, and the rows' shifts (the offset of pixel base
// in its staged row) into sh. Bytes at or past `end` (the end of x) are
// zero-filled, so odd n (rows 2-byte aligned in bf16) takes the same
// copies. One commit group. NT threads.
template <typename T, int NT>
__device__ void stage_rows(const T* __restrict__ xr, char* buf, int* sh, long n, int rows,
                           int base, int nv, int rs, const char* end) {
  const int cpr = (15 + nv * (int)sizeof(T) + 15) / 16;  // chunks a row, at most rs / 16
  for (int e = threadIdx.x; e < rows * cpr; e += NT) {
    const int row = e / cpr, cc = e - row * cpr;
    const char* addr = reinterpret_cast<const char*>(xr + row * n + base);
    const char* a0 = reinterpret_cast<const char*>((size_t)addr & ~(size_t)15);
    const char* src = a0 + cc * 16;
    const long rem = end - src;
    const int valid = rem <= 0 ? 0 : rem >= 16 ? 16 : (int)rem;
    cp_async16(buf + row * rs + cc * 16, valid ? src : a0, valid);
    if (cc == 0) sh[row] = (int)(addr - a0) / (int)sizeof(T);
  }
  cp_commit();
}

// TMA: a 1-D bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes its bytes on the mbarrier; the mbarrier's arrival
// with the expected bytes; the wait for a phase's parity.
static __device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                                 void* mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"((unsigned)__cvta_generic_to_shared(dst)),
      "l"(src), "r"(bytes), "r"((unsigned)__cvta_generic_to_shared(mbar))
      : "memory");
}
static __device__ __forceinline__ void mbar_expect(void* mbar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(mbar)),
               "r"(bytes)
               : "memory");
}
static __device__ __forceinline__ void mbar_wait(void* mbar, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE%=;\nbra WAIT%=;\nDONE%=:\n}\n" ::"r"((unsigned)__cvta_generic_to_shared(mbar)),
      "r"(parity)
      : "memory");
}

// c += A B on the tensor cores: m16n8k16, bf16 operands (A four registers,
// B two, each a packed pair, the first value in the low half), float32
// accumulators.
static __device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1,
                                                unsigned a2, unsigned a3, unsigned b0,
                                                unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x = hi + mid + lo exactly: each part is the bf16 rounding of what the
// parts before it left (bits in the low half of each word).
static __device__ __forceinline__ void split3(float x, unsigned (&p)[3]) {
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    p[s] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(x));
    x -= __uint_as_float(p[s] << 16);
  }
}

// Two staged values of storage type T as SPLIT packed bf16 pairs (the first
// in the low half): bf16 values as they are, float32 values split exactly
// into three parts (split3). `raw` reads a value's bits, `make` packs two.
template <typename T>
struct Pair;

template <>
struct Pair<__nv_bfloat16> {
  static constexpr int SPLIT = 1;
  static constexpr unsigned ONE = 0x3F80u;  // 1.0
  __device__ __forceinline__ static unsigned raw(const char* p) {
    return (unsigned)*reinterpret_cast<const unsigned short*>(p);
  }
  __device__ __forceinline__ static void make(unsigned u, unsigned v, unsigned (&a)[1]) {
    a[0] = u | (v << 16);
  }
  __device__ __forceinline__ static void pack(const char* p0, const char* p1, unsigned (&a)[1]) {
    make(raw(p0), raw(p1), a);
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
  static constexpr unsigned ONE = 0x3F800000u;  // 1.0
  __device__ __forceinline__ static unsigned raw(const char* p) {
    return *reinterpret_cast<const unsigned*>(p);
  }
  __device__ __forceinline__ static void make(unsigned u, unsigned v, unsigned (&a)[3]) {
    unsigned x[3], y[3];
    split3(__uint_as_float(u), x);
    split3(__uint_as_float(v), y);
#pragma unroll
    for (int s = 0; s < 3; ++s) a[s] = x[s] | (y[s] << 16);
  }
  __device__ __forceinline__ static void pack(const char* p0, const char* p1, unsigned (&a)[3]) {
    make(raw(p0), raw(p1), a);
  }
  __device__ __forceinline__ static void row2(const char* buf, int off, unsigned (&a)[3]) {
    pack(buf + off, buf + off + 4, a);
  }
};

// counter += 1 at device scope with acquire-release order; the old value.
// A CTA counts itself done on its image's counter once its results are
// stored: the release orders them before the count, and the last CTA's
// acquire orders its reads of every CTA's results after it.
static __device__ __forceinline__ unsigned count_done(unsigned* counter) {
  unsigned old;
  asm volatile("atom.add.acq_rel.gpu.global.u32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(counter)
               : "memory");
  return old;
}

// Butterfly sum over a warp. The order is fixed, so lane 0's result is the
// same on every run.
static __device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}
static __device__ __forceinline__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// out[b, e] = sum over blocks i, in block order, of partial[b, i, e]: the
// second launch of every kernel that writes per-block partials instead of
// using float atomics. Grid ((width + 255) / 256, B), 256 threads.
static __global__ void block_order_sum_kernel(const float* __restrict__ partial,
                                              float* __restrict__ out, int nblk,
                                              int width) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  const float* pp = partial + (long)b * nblk * width + e;
  float acc = 0.f;
  for (int i = 0; i < nblk; ++i) acc += pp[(long)i * width];
  out[(long)b * width + e] = acc;
}

static inline cudaError_t block_order_sum(const float* partial, float* out, int B,
                                          int nblk, int width, cudaStream_t s) {
  block_order_sum_kernel<<<dim3((width + 255) / 256, B), 256, 0, s>>>(partial, out,
                                                                      nblk, width);
  return cudaGetLastError();
}

// The same over float64 partials, rounded to float32 once: the sums whose
// terms run to millions a row (K8's EM moments), where float32 partials
// would carry the rounding of every block.
static __global__ void block_order_sum_f64_kernel(const double* __restrict__ partial,
                                                  float* __restrict__ out, int nblk,
                                                  int width) {
  const int b = blockIdx.y;
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= width) return;
  const double* pp = partial + (long)b * nblk * width + e;
  double acc = 0.0;
  for (int i = 0; i < nblk; ++i) acc += pp[(long)i * width];
  out[(long)b * width + e] = (float)acc;
}

static inline cudaError_t block_order_sum(const double* partial, float* out, int B,
                                          int nblk, int width, cudaStream_t s) {
  block_order_sum_f64_kernel<<<dim3((width + 255) / 256, B), 256, 0, s>>>(partial, out,
                                                                          nblk, width);
  return cudaGetLastError();
}

}  // namespace gcis
