"""Per-superpixel feature sums and counts, kernels K16, K17 and K18
(counterpart of the JAX package's models/graph_pallas.py).

    sums[b, s, c] = sum of feature c over the pixels of superpixel s
    counts[b, s]  = the number of those pixels

The reference wrote this segmented sum three times for the TPU, as one-hot
matmuls in three layouts, and kept all three off its path. Here one kernel
(csrc/superpixel_moments.cu) reads the features through a channel and a
pixel stride, and three entry points keep the reference's names and
contracts, each with its own launch counter:

- ``superpixel_moments_fused`` (K16, ``_moments_kernel``): (B, N, D) in;
- ``superpixel_moments_fused_t`` (K17, ``_moments_t_kernel``): the
  channel-major (B, D, N) buffer, the reference's pre-transposed input. The
  graph stage's ``superpixel_means`` (models/graph.py) calls it with the
  features' own dtype;
- ``superpixel_moments_fused_nhwc`` (K18, ``_moments_nhwc_kernel``):
  (B, N, D) in, the reference's pad-only staging (nothing to stage here).

Like the reference wrappers they round the features to bfloat16 first
(K17 unless given another ``dtype``). Labels outside [0, S) add to no
bucket, and S may be any size >= 1. Sums are taken in float64 and rounded
once to float32, in the kernel and in ``superpixel_moments_plain`` alike,
so the two agree bit for bit in bfloat16 and within one float32 ulp in
float32; two launches on the same input give the same bits.

The kernel splits each image's pixels into chunks of ``chunk_plan``'s
size, one block per (chunk, group of 40 channels, image); each block
writes float64 partials for the label range [lo, hi] its chunk holds, and
a second launch adds them in chunk order (csrc/superpixel_moments.cu).
``chunk_ranges`` is the plain version of those ranges.
"""

from __future__ import annotations

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels

# pixels per block: 151 chunks an image at config3, 1,208 blocks at batch 8
# (experiments/torch_moments_chunks.py: of 768 to 4,096, the fastest at
# config3 and within 6 % of the fastest at config4)
CHUNK = 1024
TILE = 256  # pixels the kernel stages at a time; a chunk is a whole number of tiles
WINDOW = 128  # labels a block accumulates at a time; wider chunk ranges take more walks
PARTIAL_BYTES = 512 << 20  # the float64 partials' buffer at most, but for one chunk an image


def chunk_plan(b: int, n: int, n_sp: int, d: int) -> tuple:
    """(pixels per chunk, chunks per image) of the kernel for B images of N
    pixels, S superpixels and D channels: chunks of ``CHUNK`` pixels, fewer
    and larger where the (B, n_chunks, S, D + 1) float64 partials would
    pass ``PARTIAL_BYTES``."""
    most = max(1, PARTIAL_BYTES // (b * n_sp * (d + 1) * 8))
    chunk = _ceil_div(_ceil_div(n, min(_ceil_div(n, CHUNK), most)), TILE) * TILE
    return chunk, _ceil_div(n, chunk)


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def chunk_ranges(idx: torch.Tensor, n_sp: int, chunk: int) -> torch.Tensor:
    """Plain version of the kernel's chunk ranges: (B, n_chunks, 2) int32,
    the least and greatest label in [0, S) of each chunk of ``chunk``
    pixels, (2^31 - 1, -1) for a chunk without one."""
    b, n = idx.shape
    n_chunks = _ceil_div(n, chunk)
    lab = torch.full((b, n_chunks * chunk), -1, dtype=torch.int64, device=idx.device)
    lab[:, :n] = idx
    lab = lab.reshape(b, n_chunks, chunk)
    valid = (lab >= 0) & (lab < n_sp)
    big = torch.iinfo(torch.int32).max
    lo = torch.where(valid, lab, big).amin(dim=2)
    hi = torch.where(valid, lab, -1).amax(dim=2)
    return torch.stack([lo, hi], dim=2).to(torch.int32)


def superpixel_moments_plain(idx: torch.Tensor, feats: torch.Tensor, n_sp: int,
                             channel_major: bool = False):
    """Plain PyTorch version of K16-K18: a float64 ``index_add_`` rounded to
    float32. feats (B, N, D), or (B, D, N) with ``channel_major``."""
    if channel_major:
        feats = feats.transpose(1, 2)
    b, _, d = feats.shape
    idx = idx.long()
    valid = (idx >= 0) & (idx < n_sp)
    flat = (idx + n_sp * torch.arange(b, device=idx.device)[:, None])[valid]
    sums = torch.zeros((b * n_sp, d), dtype=torch.float64, device=feats.device)
    sums.index_add_(0, flat, feats[valid].to(torch.float64))
    counts = torch.bincount(flat, minlength=b * n_sp)
    return (sums.to(torch.float32).reshape(b, n_sp, d),
            counts.to(torch.float32).reshape(b, n_sp))


def _moments(idx: torch.Tensor, feats: torch.Tensor, n_sp: int, channel_major: bool,
             wrapper):
    """Check, then run the plain version (CPU tensors) or launch the kernel
    and count it on ``wrapper``."""
    _kernels.check(idx.dim() == 2 and idx.dtype == torch.int32,
                   f"idx must be (B, N) int32, got {idx.dtype} {tuple(idx.shape)}")
    _kernels.check(feats.dim() == 3, f"feats must be 3-d, got {tuple(feats.shape)}")
    _kernels.storage_code(feats.dtype)
    b, n = idx.shape
    d = feats.shape[1] if channel_major else feats.shape[2]
    want = (b, d, n) if channel_major else (b, n, d)
    _kernels.check(tuple(feats.shape) == want,
                   f"feats must be {want} for idx {tuple(idx.shape)}, got {tuple(feats.shape)}")
    _kernels.check(n_sp >= 1, f"n_sp must be >= 1, got {n_sp}")
    if _kernels.use_plain(idx, feats):
        return superpixel_moments_plain(idx, feats, n_sp, channel_major)
    idx, feats = idx.contiguous(), feats.contiguous()
    dev = feats.device
    sums = torch.empty((b, n_sp, d), dtype=torch.float32, device=dev)
    counts = torch.empty((b, n_sp), dtype=torch.float32, device=dev)
    chunk, n_chunks = chunk_plan(b, n, n_sp, d)
    # only each chunk's [lo, hi] rows of the partials are written and read
    part = torch.empty((b, n_chunks, n_sp, d + 1), dtype=torch.float64, device=dev)
    ranges = torch.empty((b, n_chunks, 2), dtype=torch.int32, device=dev)
    ch_stride, px_stride = (n, 1) if channel_major else (1, d)
    _kernels.launch("gcis_superpixel_moments", feats.data_ptr(), idx.data_ptr(),
                    sums.data_ptr(), counts.data_ptr(), part.data_ptr(), ranges.data_ptr(),
                    b, d, n, n_sp, chunk, n_chunks, ch_stride, px_stride,
                    _kernels.storage_code(feats.dtype), outputs=(sums, counts))
    wrapper.launches += 1
    return sums, counts


def superpixel_moments_fused(idx: torch.Tensor, feats: torch.Tensor, n_sp: int):
    """K16. (B, N) int32 labels + (B, N, D) features -> ((B, S, D) float32
    sums, (B, S) float32 counts), the features rounded to bfloat16 first."""
    return _moments(idx, feats.to(torch.bfloat16), n_sp, False, superpixel_moments_fused)


def superpixel_moments_fused_t(idx: torch.Tensor, feats_t: torch.Tensor, n_sp: int,
                               dtype: torch.dtype = torch.bfloat16):
    """K17. (B, N) int32 labels + channel-major (B, D, N) features -> ((B, S,
    D) float32 sums, (B, S) float32 counts), the features rounded to
    ``dtype`` (float32 or bfloat16) first."""
    return _moments(idx, feats_t.to(dtype), n_sp, True, superpixel_moments_fused_t)


def superpixel_moments_fused_nhwc(idx: torch.Tensor, feats: torch.Tensor, n_sp: int):
    """K18. The contract of K16 (the reference's pad-only staging has no
    counterpart: the kernel reads (B, N, D) as it is)."""
    return _moments(idx, feats.to(torch.bfloat16), n_sp, False,
                    superpixel_moments_fused_nhwc)


superpixel_moments_fused.launches = 0
superpixel_moments_fused_t.launches = 0
superpixel_moments_fused_nhwc.launches = 0
