// K15: per-image table lookup, out[b, n] = table[b, idx[b, n]].
//
// Replaces ops/lookup.py::_lookup_kernel (wrapper _lookup_tpu). The TPU
// kernel gathered through a one-hot matmul against the table in VMEM,
// because a TPU's dynamic gather is slow; it needed the table's values to be
// exact in bf16. Here each thread moves one 16-byte vector of four pixels:
// one load of idx, four reads of the table through the read-only (L1) path,
// one store. Any int32 table of any size S >= 1 works: an image's table
// (3.7 KB at config3, 1.6 KB at config4) stays resident in L1 whatever
// block reads it, and nothing is staged in shared memory.
//
// Bound on the H100: HBM bytes. Each pixel is 4 B read and 4 B written
// (idx (8, 154401) and the labels out, 9.9 MB at config3, 0.003 ms at
// 3.35 TB/s), the tables are 30 KB. Every access of idx and out is a full
// 16-byte vector except the few at the ends of an image's row that are not
// aligned to 16 bytes (N odd), which threads past the row's last vector
// take one by one. The grid covers every vector of every image (1,208
// blocks of 256 at config3), so at these sizes the time is mostly the
// launch's.

#include "common.cuh"

#include <cstdint>

namespace {

constexpr int NT = 256;
constexpr int EDGE = 6;  // at most 3 unaligned pixels at each end of a row

__global__ void __launch_bounds__(NT) lookup_kernel(const int* __restrict__ idx,
                                                    const int* __restrict__ table,
                                                    int* __restrict__ out, int n, int s) {
  const long b = blockIdx.y;
  const int* src = idx + b * n;
  int* dst = out + b * n;
  const int* tab = table + b * s;
  // idx and out start 16-byte aligned, so row b of both is misaligned alike
  const int head = min(n, (int)(((16 - ((uintptr_t)src & 15)) & 15) / 4));
  const int nvec = (n - head) / 4;
  const int i = blockIdx.x * NT + threadIdx.x;
  if (i < nvec) {
    const int4 q = reinterpret_cast<const int4*>(src + head)[i];
    reinterpret_cast<int4*>(dst + head)[i] =
        make_int4(__ldg(tab + q.x), __ldg(tab + q.y), __ldg(tab + q.z), __ldg(tab + q.w));
    return;
  }
  const int j = i - nvec;  // the unaligned head, then the tail
  const int tail0 = head + 4 * nvec;
  if (j < head + (n - tail0)) {
    const int p = j < head ? j : tail0 + (j - head);
    dst[p] = __ldg(tab + src[p]);
  }
}

}  // namespace

// idx: (B, N) int32 in [0, s), 16-byte aligned. table: (B, s) int32.
// out: (B, N) int32, 16-byte aligned.
GCIS_API int gcis_table_lookup(const int* idx, const int* table, int* out, int B, int n,
                               int s, void* stream) {
  if (B < 1 || B > 65535 || n < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long)n / 4 + EDGE + NT - 1) / NT), B);
  lookup_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(idx, table, out, n, s);
  return (int)cudaGetLastError();
}
