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
bucket. Sums are taken in float64 and rounded once to float32, in the
kernel and in ``superpixel_moments_plain`` alike, so the two agree bit for
bit in bfloat16 and in all but a vanishing share of values in float32.
"""

from __future__ import annotations

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels

S_MAX = 3632  # superpixels the kernel holds: 8 float64 columns of S in 227 KB


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
    _kernels.check(n_sp <= S_MAX, f"the CUDA kernel takes n_sp <= {S_MAX}, got {n_sp}")
    idx, feats = idx.contiguous(), feats.contiguous()
    sums = torch.empty((b, n_sp, d), dtype=torch.float32, device=feats.device)
    counts = torch.empty((b, n_sp), dtype=torch.float32, device=feats.device)
    ch_stride, px_stride = (n, 1) if channel_major else (1, d)
    _kernels.launch("gcis_superpixel_moments", feats.data_ptr(), idx.data_ptr(),
                    sums.data_ptr(), counts.data_ptr(), b, d, n, n_sp, ch_stride, px_stride,
                    _kernels.storage_code(feats.dtype))
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
