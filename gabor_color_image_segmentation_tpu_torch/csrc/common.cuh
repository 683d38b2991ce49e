// Shared helpers of the port's Hopper kernels: typed loads and stores
// (float32 or bfloat16 storage, float32 arithmetic), REFLECT_101 indexing
// and the deterministic warp/block reductions the kernels use in place of
// float atomics.
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

}  // namespace gcis
