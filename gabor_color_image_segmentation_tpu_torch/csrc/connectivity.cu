// K14: SLIC connectivity enforcement, one thread block per image.
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
// sweeps and a capped BFS subtree count (no scatter on the TPU). A 617 KB
// int32 image does not fit 227 KB of shared memory, so here each image's
// maps live in device memory, which the 50 MB L2 holds, and one 1024-thread
// block runs every step and every fixpoint loop (`__syncthreads_or` says
// whether anything changed), so the pass needs no host sync:
//
//   1. union-find: each edge of equal labels hooks the larger of its two
//      roots to the smaller (atomicMin), then every pixel's path is
//      compressed, until no edge joins two roots. Parents only ever move to
//      smaller indices of the same component, so the one root left is the
//      component's smallest index, the reference's id;
//   2. sizes by integer atomicAdd at the roots (exact in any order); the
//      raster renumbering is a block prefix sum over contiguous chunks;
//   3. a gather through the root;
//   4. two buffers, swapped after each step.
//
// Values other threads change within a step are read with __ldcg (from L2),
// since the atomics are performed there; every step is monotone, so a stale
// read only delays convergence.
//
// Bound on the H100: latency and one SM per image. The pass touches each
// pixel a few dozen times, all in L2; the time is the dependent steps (a
// few union-find rounds, then the adoption steps, about the width of the
// largest absorbed fragment), each a block barrier apart, on 8 of 132 SMs
// at config3's batch 8. Spreading an image over several blocks (block-local
// union-find plus a global merge) is later work.

#include "common.cuh"

namespace {

constexpr int NT = 1024;

__device__ __forceinline__ int find_root(const int* par, int p) {
  int q = __ldcg(par + p);
  while (q != p) {
    p = q;
    q = __ldcg(par + p);
  }
  return p;
}

__global__ void __launch_bounds__(NT) enforce_kernel(const int* __restrict__ labels,
                                                     int* out, int* comp, int* count,
                                                     int* buf, int h, int w, int min_size,
                                                     int s_max) {
  __shared__ int scan[NT];
  const int tid = threadIdx.x;
  const int n = h * w;
  const long off = (long)blockIdx.x * n;
  const int* lab = labels + off;
  int* par = comp + off;
  int* cnt = count + off;
  int* cur = out + off;
  int* nxt = buf + off;

  for (int p = tid; p < n; p += NT) {
    par[p] = p;
    cnt[p] = 0;
  }
  __syncthreads();

  // 1. components: hook roots across equal-label edges, compress, repeat
  for (;;) {
    int changed = 0;
    for (int p = tid; p < n; p += NT) {
      const int l = lab[p];
      const int x = p % w;
      const int nb[2] = {x + 1 < w ? p + 1 : -1, p + w < n ? p + w : -1};
      for (int k = 0; k < 2; ++k) {
        const int q = nb[k];
        if (q < 0 || lab[q] != l) continue;
        const int rp = find_root(par, p), rq = find_root(par, q);
        if (rp != rq) {
          atomicMin(par + max(rp, rq), min(rp, rq));
          changed = 1;
        }
      }
    }
    changed = __syncthreads_or(changed);
    for (int p = tid; p < n; p += NT) par[p] = find_root(par, p);
    __syncthreads();
    if (!changed) break;
  }

  // 2. sizes at the roots, then survivors numbered in raster order
  for (int p = tid; p < n; p += NT) atomicAdd(cnt + __ldcg(par + p), 1);
  __syncthreads();
  const int chunk = (n + NT - 1) / NT;
  const int p0 = min(n, tid * chunk), p1 = min(n, p0 + chunk);
  int mine = 0;
  for (int p = p0; p < p1; ++p) mine += (__ldcg(par + p) == p && __ldcg(cnt + p) >= min_size);
  scan[tid] = mine;
  __syncthreads();
  for (int d = 1; d < NT; d <<= 1) {  // inclusive Hillis-Steele scan
    const int v = tid >= d ? scan[tid - d] : 0;
    __syncthreads();
    scan[tid] += v;
    __syncthreads();
  }
  int id = scan[tid] - mine;  // survivors before this chunk
  for (int p = p0; p < p1; ++p) {
    // cnt[p] becomes the root's seed: its new id, or -1 (only this thread
    // reads or writes cnt[p] here)
    const bool root = __ldcg(par + p) == p && __ldcg(cnt + p) >= min_size;
    cnt[p] = root && id < s_max ? id : -1;
    id += root;
  }
  __syncthreads();

  // 3. every pixel takes its root's seed
  int unkept = 0;
  for (int p = tid; p < n; p += NT) {
    const int v = __ldcg(cnt + __ldcg(par + p));
    cur[p] = v;
    unkept |= v < 0;
  }
  unkept = __syncthreads_or(unkept);

  // 4. Jacobi adoption, priority up, left, right, down
  for (int t = 0; unkept && t < h + w; ++t) {
    unkept = 0;
    for (int p = tid; p < n; p += NT) {
      int v = __ldcg(cur + p);
      if (v < 0) {
        const int y = p / w, x = p - y * w;
        const int nb[4] = {y > 0 ? p - w : -1, x > 0 ? p - 1 : -1, x + 1 < w ? p + 1 : -1,
                           y + 1 < h ? p + w : -1};
        for (int k = 0; k < 4 && v < 0; ++k)
          if (nb[k] >= 0) v = __ldcg(cur + nb[k]);
        unkept |= v < 0;
      }
      nxt[p] = v;
    }
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
    unkept = __syncthreads_or(unkept);
  }
  int* dst = out + off;
  for (int p = tid; p < n; p += NT) dst[p] = max(__ldcg(cur + p), 0);
}

}  // namespace

// labels: (B, H, W) int32 in. out: (B, H, W) int32. comp, count, buf:
// (B, H, W) int32 scratch.
GCIS_API int gcis_enforce_connectivity(const int* labels, int* out, int* comp, int* count,
                                       int* buf, int B, int h, int w, int min_size,
                                       int s_max, void* stream) {
  if (B < 1 || h < 1 || w < 1 || min_size < 1 || s_max < 0)
    return (int)cudaErrorInvalidValue;
  enforce_kernel<<<B, NT, 0, (cudaStream_t)stream>>>(labels, out, comp, count, buf, h, w,
                                                     min_size, s_max);
  return (int)cudaGetLastError();
}
