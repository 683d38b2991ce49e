// K14: SLIC connectivity enforcement over the whole card.
//
// Replaces models/connectivity_pallas.py::_enforce_kernel (wrapper
// enforce_connectivity_fused), cv2's enforceLabelConnectivity as the JAX
// package's enforce_connectivity_device defines it, bit for bit:
//
//   1. 4-connected components of equal labels, each identified by the
//      smallest flat index it contains;
//   2. components of >= min_size pixels survive and are renumbered in
//      raster order of those roots, capped at s_max;
//   3. every pixel takes its component's new id (-1 when absorbed);
//   4. Jacobi adoption: an absorbed pixel takes the id of its first kept
//      neighbour in the order up, left, right, down, every step reading the
//      previous step's map, at most h + w steps; leftovers clamp to 0.
//
// The output must match exactly, but the algorithm may differ. The TPU
// kernel held the whole image in VMEM and ran run-min prefix-doubling
// sweeps and a capped BFS subtree count. Run as dependent steps in one
// block per image, the pass is latency-bound on 8 of 132 SMs at batch 8,
// and its adoption takes up to h + w whole-image sweeps (config4 absorbs
// ~91 % of its pixels).
//
// Bound on the H100: bytes, the labels read once and written once (33 MB
// at config4's 8 x 540 x 960, 0.01 ms at 3.35 TB/s). The pass is a fixed
// schedule of small launches, each spread over the whole card, with no
// fixpoint loop and no host sync:
//
//   components  32 x 32 tiles in shared memory, one block each, hook the
//               larger root to the smaller with shared-memory atomicMin
//               (tile-raster order is global raster order, so a local root
//               is its piece's smallest flat index); one launch then joins
//               the equal-label edges that cross tile borders with
//               atomicMin on the global roots (Playne and Hawick's
//               lock-free union), one more compresses every path. The root
//               stays the component's smallest index.
//   sizes       integer atomicAdd at the roots, one per warp and root
//               (__match_any_sync): exact in any order.
//   renumbering a multi-block exclusive scan written here: survivor counts
//               per 1,024-pixel chunk, a scan of each image's chunk totals,
//               then the ranks inside each chunk; a rank >= s_max is
//               absorbed.
//   adoption    the Jacobi loop sets a pixel at step dist(p), its distance
//               to the nearest kept pixel in the full 4-connected grid (no
//               pixel blocks the spread: every unset pixel can be set), and
//               it takes the id of its first neighbour, up, left, right,
//               down, with dist one less. That distance is the city-block
//               distance transform of the kept set, exact from two 1-D
//               min-plus scans (down and up each column, then a warp's
//               prefix- and suffix-min along each row); each pixel points
//               to that neighbour, and ceil(log2(h + w)) rounds of pointer
//               jumping give every pixel its kept pixel's id. dist <= h +
//               w - 2 whenever the image keeps a pixel, so the h + w cap
//               binds only where nothing is kept, and there every pixel
//               ends at 0, as the loop's clamp leaves it.
//
// models/slic.py::enforce_connectivity_bfs_plain is this algorithm in
// PyTorch; the tests hold it bit-equal to the Jacobi form.

#include "common.cuh"

namespace {

constexpr int NT = 256;
constexpr int T = 32;             // component tile side
constexpr int CH = 1024;          // pixels per renumbering chunk (4 a thread)
constexpr int INF = 0x3fffffff;   // no kept pixel in reach
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int find_shared(volatile int* par, int a) {
  int q = par[a];
  while (q != a) {
    a = q;
    q = par[a];
  }
  return a;
}

__device__ __forceinline__ int find_global(const int* par, int a) {
  int q = __ldcg(par + a);
  while (q != a) {
    a = q;
    q = __ldcg(par + a);
  }
  return a;
}

// Hook the larger of the two roots under the smaller; when another thread
// moved the root first, join the root it moved to (no link is lost).
template <bool SHARED>
__device__ __forceinline__ void unite(int* par, int a, int b) {
  for (;;) {
    if constexpr (SHARED) {
      a = find_shared(par, a);
      b = find_shared(par, b);
    } else {
      a = find_global(par, a);
      b = find_global(par, b);
    }
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(par + b, a);
    if (old == b) return;
    b = old;
  }
}

// Components inside each 32 x 32 tile; par gets the flat index (over the
// batch) of the pixel's local root, cnt is zeroed. Grid (tiles_w, tiles_h, B).
__global__ void __launch_bounds__(NT) cc_tile_kernel(const int* __restrict__ labels,
                                                     int* __restrict__ par,
                                                     int* __restrict__ cnt, int h, int w) {
  __shared__ int lab[T * T];
  __shared__ int lp[T * T];
  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * T, y0 = blockIdx.y * T;
  const int tw = min(T, w - x0), th = min(T, h - y0);
  const long off = (long)blockIdx.z * h * w;
  for (int i = tid; i < T * T; i += NT) {
    const int r = i / T, c = i % T;
    lab[i] = (r < th && c < tw) ? labels[off + (long)(y0 + r) * w + x0 + c] : 0;
    lp[i] = i;
  }
  __syncthreads();
  for (int i = tid; i < T * T; i += NT) {
    const int r = i / T, c = i % T;
    if (r >= th || c >= tw) continue;
    if (c + 1 < tw && lab[i + 1] == lab[i]) unite<true>(lp, i, i + 1);
    if (r + 1 < th && lab[i + T] == lab[i]) unite<true>(lp, i, i + T);
  }
  __syncthreads();
  for (int i = tid; i < T * T; i += NT) {
    const int r = i / T, c = i % T;
    if (r >= th || c >= tw) continue;
    const int root = find_shared(lp, i);
    const long p = off + (long)(y0 + r) * w + x0 + c;
    par[p] = (int)(off + (long)(y0 + root / T) * w + x0 + root % T);
    cnt[p] = 0;
  }
}

// The equal-label edges across the right and bottom borders of each tile.
// Grid (tiles_w, tiles_h, B), 2 T threads.
__global__ void cc_border_kernel(const int* __restrict__ labels, int* par, int h, int w) {
  const int x0 = blockIdx.x * T, y0 = blockIdx.y * T;
  const long off = (long)blockIdx.z * h * w;
  const int k = threadIdx.x % T;
  long p, q;
  if (threadIdx.x < T) {  // right border, row y0 + k
    if (x0 + T >= w || y0 + k >= h) return;
    p = off + (long)(y0 + k) * w + x0 + T - 1;
    q = p + 1;
  } else {  // bottom border, column x0 + k
    if (y0 + T >= h || x0 + k >= w) return;
    p = off + (long)(y0 + T - 1) * w + x0 + k;
    q = p + w;
  }
  if (labels[p] == labels[q]) unite<false>(par, (int)p, (int)q);
}

// Every pixel points at its root; the sizes add up at the roots.
__global__ void __launch_bounds__(NT) cc_flatten_kernel(int* par, int* cnt, int total) {
  const int p = blockIdx.x * NT + threadIdx.x;
  const bool ok = p < total;
  const int root = ok ? find_global(par, p) : -1 - (int)(threadIdx.x & 31);
  if (ok) par[p] = root;
  const unsigned same = __match_any_sync(FULL, root);
  if (ok && (threadIdx.x & 31) == __ffs(same) - 1) atomicAdd(cnt + root, __popc(same));
}

// Inclusive sum over the block (NT threads); every thread gets its own
// prefix and, through *total, the block's sum.
__device__ int block_inclusive_sum(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, v, d);
    if (lane >= d) v += u;
  }
  __syncthreads();  // warp_sums may still be read from a previous call
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NT / 32 ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, s, d);
      if (lane >= d) s += u;
    }
    if (lane < NT / 32) warp_sums[lane] = s;
  }
  __syncthreads();
  *total = warp_sums[NT / 32 - 1];
  return v + (warp > 0 ? warp_sums[warp - 1] : 0);
}

// The survivors among a thread's four consecutive pixels of chunk
// blockIdx.x of image blockIdx.y: bit k set when pixel k is a root of
// >= min_size pixels.
__device__ __forceinline__ int survivors(const int* par, const int* cnt, int n, int min_size,
                                         long& first) {
  const int p0 = blockIdx.x * CH + 4 * threadIdx.x;
  first = (long)blockIdx.y * n + p0;
  int bits = 0;
  for (int k = 0; k < 4; ++k) {
    const long p = first + k;
    if (p0 + k < n && par[p] == p && cnt[p] >= min_size) bits |= 1 << k;
  }
  return bits;
}

// Survivor count of each chunk. Grid (chunks, B).
__global__ void __launch_bounds__(NT) chunk_count_kernel(const int* __restrict__ par,
                                                         const int* __restrict__ cnt,
                                                         int* __restrict__ tot, int n,
                                                         int min_size) {
  __shared__ int warp_sums[NT / 32];
  long first;
  const int mine = __popc(survivors(par, cnt, n, min_size, first));
  int sum;
  block_inclusive_sum(mine, warp_sums, &sum);
  if (threadIdx.x == 0) tot[blockIdx.y * gridDim.x + blockIdx.x] = sum;
}

// Exclusive scan of each image's chunk totals, in place. Grid (B), NT
// threads, chunks of NT at a time.
__global__ void __launch_bounds__(NT) chunk_scan_kernel(int* tot, int chunks) {
  __shared__ int warp_sums[NT / 32];
  int* t = tot + (long)blockIdx.x * chunks;
  int carry = 0;
  for (int s = 0; s < chunks; s += NT) {
    const int i = s + threadIdx.x;
    const int v = i < chunks ? t[i] : 0;
    int sum;
    const int incl = block_inclusive_sum(v, warp_sums, &sum);
    if (i < chunks) t[i] = carry + incl - v;
    carry += sum;
  }
}

// Each root's seed in cnt: its new id (raster rank among the survivors)
// when it survives and the rank is < s_max, else -1. Grid (chunks, B).
__global__ void __launch_bounds__(NT) seed_kernel(const int* __restrict__ par, int* cnt,
                                                  const int* __restrict__ tot, int n,
                                                  int min_size, int s_max) {
  __shared__ int warp_sums[NT / 32];
  long first;
  const int bits = survivors(par, cnt, n, min_size, first);
  const int mine = __popc(bits);
  int sum;
  int id = tot[blockIdx.y * gridDim.x + blockIdx.x] +
           block_inclusive_sum(mine, warp_sums, &sum) - mine;
  const int p0 = blockIdx.x * CH + 4 * threadIdx.x;
  for (int k = 0; k < 4; ++k) {
    const long p = first + k;
    if (p0 + k >= n || par[p] != p) continue;
    const bool keep = (bits >> k) & 1;
    cnt[p] = keep && id < s_max ? id : -1;
    id += keep;
  }
}

// out = the root's seed (-1 on absorbed pixels).
__global__ void __launch_bounds__(NT) gather_kernel(const int* __restrict__ par,
                                                    const int* __restrict__ cnt,
                                                    int* __restrict__ out, int total) {
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p < total) out[p] = cnt[par[p]];
}

// Distance to the nearest kept pixel of the same column, down then up.
// One thread per (image, column).
__global__ void __launch_bounds__(128) dist_cols_kernel(const int* __restrict__ out,
                                                        int* __restrict__ dist, int B, int h,
                                                        int w) {
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i >= B * w) return;
  const long base = (long)(i / w) * h * w + i % w;
  int run = INF;
  for (int y = 0; y < h; ++y) {
    const long p = base + (long)y * w;
    run = out[p] >= 0 ? 0 : min(run + 1, INF);
    dist[p] = run;
  }
  run = INF;
  for (int y = h - 1; y >= 0; --y) {
    const long p = base + (long)y * w;
    run = min(dist[p], min(run + 1, INF));
    dist[p] = run;
  }
}

// dist[x] = min over x' of (g[x'] + |x - x'|) along each row, g the column
// distances: a prefix min of g - x' left to right, then a suffix min of
// f + x' right to left on the forward result f. One warp per row,
// 32 pixels at a time.
__global__ void __launch_bounds__(NT) dist_rows_kernel(int* dist, int h, int w) {
  const int lane = threadIdx.x & 31;
  const int y = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (y >= h) return;  // whole warps
  int* row = dist + ((long)blockIdx.y * h + y) * w;
  int carry = INT_MAX;
  for (int s = 0; s < w; s += 32) {
    const int x = s + lane;
    int v = x < w ? row[x] - x : INT_MAX;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(FULL, v, d);
      if (lane >= d) v = min(v, u);
    }
    v = min(v, carry);
    if (x < w) row[x] = min(v + x, INF);
    carry = __shfl_sync(FULL, v, 31);
  }
  carry = INT_MAX;
  for (int s = ((w - 1) / 32) * 32; s >= 0; s -= 32) {
    const int x = s + lane;
    int v = x < w ? row[x] + x : INT_MAX;
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_down_sync(FULL, v, d);
      if (lane + d < 32) v = min(v, u);
    }
    v = min(v, carry);
    if (x < w) row[x] = min(v - x, INF);
    carry = __shfl_sync(FULL, v, 0);
  }
}

// ptr: a kept pixel points at itself; an absorbed pixel within the step
// cap at its first neighbour, up, left, right, down, one step nearer; any
// other pixel at -1.
__global__ void __launch_bounds__(NT) parent_kernel(const int* __restrict__ out,
                                                    const int* __restrict__ dist,
                                                    int* __restrict__ ptr, int h, int w,
                                                    int total) {
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p >= total) return;
  if (out[p] >= 0) {
    ptr[p] = p;
    return;
  }
  const int d = dist[p];
  int q = -1;
  if (d <= h + w) {
    const int x = p % w, y = (p / w) % h;
    if (y > 0 && dist[p - w] == d - 1) q = p - w;
    else if (x > 0 && dist[p - 1] == d - 1) q = p - 1;
    else if (x + 1 < w && dist[p + 1] == d - 1) q = p + 1;
    else if (y + 1 < h && dist[p + w] == d - 1) q = p + w;
  }
  ptr[p] = q;
}

// One round of pointer jumping, in place: every pointer moves to its
// target's target (a value another thread already moved is only further
// along the same chain).
__global__ void __launch_bounds__(NT) jump_kernel(int* ptr, int total) {
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p >= total) return;
  const int q = ptr[p];
  if (q >= 0) ptr[p] = __ldcg(ptr + q);
}

// Absorbed pixels take their kept pixel's id, or 0.
__global__ void __launch_bounds__(NT) final_kernel(const int* __restrict__ ptr, int* out,
                                                   int total) {
  const int p = blockIdx.x * NT + threadIdx.x;
  if (p >= total || out[p] >= 0) return;
  const int q = ptr[p];
  out[p] = q >= 0 ? out[q] : 0;
}

}  // namespace

// labels: (B, H, W) int32 in. out: (B, H, W) int32. comp, count, buf:
// (B, H, W) int32 scratch; tot: (B, ceil(H * W / 1024)) int32 scratch.
GCIS_API int gcis_enforce_connectivity(const int* labels, int* out, int* comp, int* count,
                                       int* buf, int* tot, int B, int h, int w,
                                       int min_size, int s_max, void* stream) {
  if (B < 1 || B > 65535 || h < 1 || w < 1 || min_size < 1 || s_max < 0 ||
      (long)B * h * w + 2L * (h + w) >= INT_MAX || h > 65535 * T || w > 65535 * T)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w, total = B * n, chunks = (n + CH - 1) / CH;
  const dim3 tiles((w + T - 1) / T, (h + T - 1) / T, B);
  const int flat = (total + NT - 1) / NT;
  cc_tile_kernel<<<tiles, NT, 0, s>>>(labels, comp, count, h, w);
  cc_border_kernel<<<tiles, 2 * T, 0, s>>>(labels, comp, h, w);
  cc_flatten_kernel<<<flat, NT, 0, s>>>(comp, count, total);
  chunk_count_kernel<<<dim3(chunks, B), NT, 0, s>>>(comp, count, tot, n, min_size);
  chunk_scan_kernel<<<B, NT, 0, s>>>(tot, chunks);
  seed_kernel<<<dim3(chunks, B), NT, 0, s>>>(comp, count, tot, n, min_size, s_max);
  gather_kernel<<<flat, NT, 0, s>>>(comp, count, out, total);
  dist_cols_kernel<<<(B * w + 127) / 128, 128, 0, s>>>(out, buf, B, h, w);
  dist_rows_kernel<<<dim3((h + NT / 32 - 1) / (NT / 32), B), NT, 0, s>>>(buf, h, w);
  parent_kernel<<<flat, NT, 0, s>>>(out, buf, comp, h, w, total);
  for (int span = 1; span < h + w; span *= 2) jump_kernel<<<flat, NT, 0, s>>>(comp, total);
  final_kernel<<<flat, NT, 0, s>>>(comp, out, total);
  return (int)cudaGetLastError();
}
