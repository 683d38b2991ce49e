"""The feature stage in plain PyTorch (counterpart of the JAX package's
ops/features.py). In the JAX package these are XLA ops outside any Pallas
kernel, so no kernel is owed for them.

The direct energies (``gabor_energies``, the only route for a bank with
``gamma`` != 1): per scale group a REFLECT_101 pad, a depthwise complex
correlation, the magnitude and a separable Gaussian smoothing over the
REFLECT_101-padded magnitude map. The reference's rounding points: in
float32 the convolutions run at full precision (TF32 off, ops/precision.py,
as the reference pins HIGHEST); in bfloat16 their operands are rounded to
bf16 and the products summed in float32 with a float32 output (its
``preferred_element_type``), and the magnitudes are rounded again before
each smoothing pass. Energies come out float32 in both modes, in the
feature contract's order (scale-group blocks, kernel-major, channel-minor).

The NHWC features (``assemble_features``, ``coherence_weights``,
``gabor_features``): energies ++ colour in ``out_dtype`` (bf16 when the
energies are bf16, else float32), one-pass float32 moments, ``(f - mean) /
(std + eps) * scale`` with the sqrt(E/3) colour balance, then the
coherence weights ``^ coherence_pow``, then the cast. The buffer is built
channel-major (B, D, H, W), the solver buffer the Lloyd kernels read, and
returned as its (B, H, W, D) view, so the NHWC tensor is never copied.

The labels-only helpers (coherence_weights_cm, fold_coherence_affine,
assemble_xp_from_affine, _pool2x2_cm; the reference's _norm_affine and
assemble_features_t are kmeans_chw._affine_params and
assemble_xp_from_affine at full resolution) take energies as one
channel-major (B, E, H, W) tensor (the feature kernel writes every scale
group into it), where the reference took a tuple of per-group buffers;
every statistic here is per channel, so the two forms give the same
numbers.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from gabor_color_image_segmentation_tpu_torch.config import ClusterConfig
from gabor_color_image_segmentation_tpu_torch.ops.fused import _reflect_pad

_COH_BLOCK = 8  # coherence pooling window (pixels per side)


# ---------------------------------------------------------------------------
# direct energies
# ---------------------------------------------------------------------------


def _as_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 values rounded to ``dtype`` (exact again in float32, so a
    float32 convolution of them sums bf16 x bf16 products in float32)."""
    return x.to(dtype).to(torch.float32)


def _depthwise_conv(x: torch.Tensor, filt, dtype: torch.dtype) -> torch.Tensor:
    """VALID depthwise correlation. x: (B, C, H, W) float32; filt: (k, k, 1,
    F) numpy, tiled over the C channels -> (B, C * F, H', W'), channel-major
    groups (output c * F + f reads input channel c)."""
    c = x.shape[1]
    w = torch.from_numpy(filt[:, :, 0, :]).permute(2, 0, 1)[:, None].repeat(c, 1, 1, 1)
    return torch.nn.functional.conv2d(_as_operand(x, dtype), _as_operand(w.to(x.device), dtype),
                                      groups=c)


def _separable_smooth(x: torch.Tensor, taps, dtype: torch.dtype) -> torch.Tensor:
    """Depthwise separable Gaussian with REFLECT_101 borders, rows then
    columns, each pass on operands rounded to ``dtype``. x: (B, C, H, W)."""
    c = x.shape[1]
    r = taps.shape[0] // 2
    t = _as_operand(torch.from_numpy(taps).to(x.device), dtype)
    conv = torch.nn.functional.conv2d
    x = conv(_as_operand(_reflect_pad(x, r, 2), dtype), t.reshape(1, 1, -1, 1).repeat(c, 1, 1, 1),
             groups=c)
    return conv(_as_operand(_reflect_pad(x, r, 3), dtype), t.reshape(1, 1, 1, -1).repeat(c, 1, 1, 1),
                groups=c)


def _group_energies(img: torch.Tensor, group, dtype: torch.dtype) -> torch.Tensor:
    """One scale group's energies. img: (B, C, H, W) float32 -> (B, n_g * C,
    H, W) float32 in the contract's order (kernel-major, channel-minor)."""
    b, c, h, w = img.shape
    n = len(group.kernel_indices)
    r = group.ksize // 2
    resp = _depthwise_conv(_reflect_pad(_reflect_pad(img, r, 2), r, 3),
                           group.filters_hwio, dtype)  # (B, C * 2n, H, W)
    re, im = resp[:, 0::2], resp[:, 1::2]
    mag = torch.sqrt(re * re + im * im)  # (B, C * n, H, W), channel-major
    sm = _separable_smooth(mag, group.smooth_taps, dtype)
    return sm.reshape(b, c, n, h, w).transpose(1, 2).reshape(b, n * c, h, w)


def energy_index(bank, n_channels: int, kernel_idx: int, ch: int) -> int:
    """Contract-order position of (global kernel index, channel) in the
    energy axis: group blocks in bank.groups order, kernel-major within."""
    offset = 0
    for g in bank.groups:
        if kernel_idx in g.kernel_indices:
            return offset + g.kernel_indices.index(kernel_idx) * n_channels + ch
        offset += len(g.kernel_indices) * n_channels
    raise IndexError(kernel_idx)


def gabor_energies(img: torch.Tensor, bank, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) image (Lab or RGB channels) -> (B, H, W, N * C) float32
    smoothed energies in the contract's order, every scale group of
    ``bank`` (the port's or the JAX package's, read duck-typed); any
    envelope ``gamma``. The (B, H, W, N * C) tensor is the view of a
    channel-major buffer."""
    x = img.to(torch.float32).permute(0, 3, 1, 2)
    return torch.cat([_group_energies(x, g, dtype) for g in bank.groups],
                     dim=1).permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# NHWC features
# ---------------------------------------------------------------------------


def _coherence(f: torch.Tensor, eps: float) -> torch.Tensor:
    """(D, H, W) float32 standardised features of one image -> (D,) std of
    the 8x8 block means over the std, on the 8x8-divisible crop; ones when
    the image has fewer than two blocks a side."""
    n = _COH_BLOCK
    d, h, w = f.shape
    hb, wb = h // n, w // n
    if hb < 2 or wb < 2:
        return torch.ones(d, dtype=torch.float32, device=f.device)
    f = f[:, : hb * n, : wb * n]
    p = f.reshape(d, hb, n, wb, n).mean(dim=(2, 4))

    def std(v):
        m = v.mean(dim=(1, 2))
        return torch.sqrt(torch.clamp(v.square().mean(dim=(1, 2)) - m.square(), min=0.0))

    return std(p) / (std(f) + eps)


def coherence_weights(feats: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """(B, H, W, D) -> (B, 1, 1, D) float32 per-image region-scale
    coherence weights: std of 8x8 block means over std. Ones when the image
    is too small to pool (< 2 blocks a side)."""
    b, _, _, d = feats.shape
    out = torch.stack([_coherence(f.permute(2, 0, 1).to(torch.float32), eps) for f in feats])
    return out.reshape(b, 1, 1, d)


def assemble_features(energies: torch.Tensor, color: torch.Tensor, cluster_cfg,
                      eps: float = 1e-6) -> torch.Tensor:
    """Pixel feature vectors: energies ++ colour, standardised per image.

    energies: (B, E, H, W) channel-major; color: (B, H, W, 3). Returns
    (B, H, W, D) in ``out_dtype`` (bf16 when the energies are bf16, else
    float32), the view of a channel-major (B, D, H, W) buffer:
    ``.permute(0, 3, 1, 2)`` gives it back without a copy.
    ``cluster_cfg.feature_set`` "color" drops the energies (unit colour
    scale), "texture" the colour. The colour rows carry sqrt(E/3) *
    ``color_weight``; ``cue_weight="coherence"`` multiplies each row by its
    coherence weight ^ ``coherence_pow``. Computed image by image, so the
    float32 temporaries hold one image."""
    fs = getattr(cluster_cfg, "feature_set", "full")
    if fs not in ("full", "color", "texture"):
        raise ValueError(f"unknown feature_set {fs!r}")
    b, e, h, w = energies.shape
    e = 0 if fs == "color" else e
    nc = 0 if fs == "texture" else color.shape[-1]
    out_dtype = torch.bfloat16 if energies.dtype == torch.bfloat16 else torch.float32
    cw = cluster_cfg.color_weight * math.sqrt(e / 3.0) if e else 1.0
    scale = torch.cat([torch.ones(e), torch.full((nc,), cw)]).to(energies.device)[:, None, None]
    coherence = getattr(cluster_cfg, "cue_weight", "static") == "coherence"
    pw = float(getattr(cluster_cfg, "coherence_pow", 1.0))
    out = torch.empty((b, e + nc, h, w), dtype=out_dtype, device=energies.device)
    for i in range(b):
        f = torch.cat([energies[i, :e].to(out_dtype),
                       color[i].permute(2, 0, 1)[:nc].to(out_dtype)]).to(torch.float32)
        if cluster_cfg.normalize:
            mean = f.mean(dim=(1, 2))
            var = torch.clamp(f.square().mean(dim=(1, 2)) - mean.square(), min=0.0)
            f.sub_(mean[:, None, None]).div_((torch.sqrt(var) + eps)[:, None, None])
        f.mul_(scale)
        if coherence:
            c = _coherence(f, eps)
            f.mul_((c if pw == 1.0 else c**pw)[:, None, None])
        out[i] = f
    return out.permute(0, 2, 3, 1)


def gabor_features(lab: torch.Tensor, bank, cluster_cfg=None,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) colour-space image -> (B, H, W, 3N + 3) features of the
    direct energies."""
    if cluster_cfg is None:
        cluster_cfg = ClusterConfig()
    return assemble_features(gabor_energies(lab, bank, dtype).permute(0, 3, 1, 2), lab,
                             cluster_cfg)


# ---------------------------------------------------------------------------
# labels-only helpers
# ---------------------------------------------------------------------------


def _pool2x2_cm(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H//2, W//2) 2x2 means in the reference's
    order: row pairs first, rounded to the storage dtype, then column pairs
    (the reference's two pooling matmuls, 0.5 weights, f32 accumulation)."""
    h2, w2 = x.shape[2] // 2, x.shape[3] // 2
    xf = x[:, :, : 2 * h2].to(torch.float32)
    v = (0.5 * xf[:, :, 0::2] + 0.5 * xf[:, :, 1::2]).to(x.dtype).to(torch.float32)
    v = v[..., : 2 * w2]
    return (0.5 * v[..., 0::2] + 0.5 * v[..., 1::2]).to(x.dtype)


def _std(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, C) one-pass float32 std over the plane."""
    xf = x.to(torch.float32)
    m = xf.mean(dim=(2, 3))
    return torch.sqrt(torch.clamp(xf.square().mean(dim=(2, 3)) - m.square(), min=0.0))


def coherence_weights_cm(
    energies: torch.Tensor, color_cm: torch.Tensor, a: torch.Tensor,
    eps: float = 1e-6,
    pooled: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    s_full: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, D) region-scale coherence weights from raw channel-major buffers:
    std of 8x8 block means over std, carried through the standardisation
    multiplier ``a`` (B, D) so the eps keeps the standardised formula's
    scale. ``pooled`` = (energy twin, colour twin) seeds the block means
    with the 2x2 twins; ``s_full`` (B, D) reuses the full-resolution stds.
    Ones when the image has fewer than two blocks per side."""
    n = _COH_BLOCK
    bufs = [energies, color_cm[:, :3]]
    b, _, h, w = energies.shape
    hb, wb = h // n, w // n
    d = energies.shape[1] + 3
    if hb < 2 or wb < 2:
        return torch.ones((b, d), dtype=torch.float32, device=energies.device)
    if pooled is not None:
        pbufs = [pooled[0], pooled[1][:, :3]]
    else:
        pbufs = [_pool2x2_cm(x) for x in bufs]
    sp = torch.cat(
        [_std(_pool2x2_cm(_pool2x2_cm(q[:, :, : 4 * hb, : 4 * wb]))) for q in pbufs],
        dim=1,
    )
    if s_full is None:
        s_full = torch.cat([_std(x[:, :, : hb * n, : wb * n]) for x in bufs], dim=1)
    return (a * sp) / (a * s_full + eps)


def fold_coherence_affine(
    a: torch.Tensor, b_aff: torch.Tensor, energies: torch.Tensor,
    color_cm: torch.Tensor, cluster_cfg, eps: float = 1e-6, pooled=None,
    s_full=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold cue_weight="coherence" into the affine (a, b): weighted features
    = raw * (a * c^p) + b * c^p. No-op for cue_weight="static"."""
    if getattr(cluster_cfg, "cue_weight", "static") != "coherence":
        return a, b_aff
    c = coherence_weights_cm(energies, color_cm, a, eps, pooled, s_full)
    p = float(getattr(cluster_cfg, "coherence_pow", 1.0))
    wgt = c if p == 1.0 else c**p
    return a * wgt, b_aff * wgt


def assemble_xp_from_affine(
    pe: torch.Tensor, pc4: torch.Tensor, a: torch.Tensor, b_aff: torch.Tensor,
    out_dtype: torch.dtype,
) -> torch.Tensor:
    """Raw channel-major rows (pooled or at full resolution) + the
    full-resolution affine -> normalised buffer (B, E + 3, m), m = H2 * W2:
    energy rows, then the three colour rows.

    The reference's xt layout also carried a ones-row (member counts) and
    zero padding to TPU tiles; the port's coarse kernel counts members
    itself, so neither is built. Pooling commutes with the per-row affine,
    so normalising pooled raw rows equals pooling normalised features."""
    b, e, h2, w2 = pe.shape
    m = h2 * w2
    rows = torch.cat(
        [pe.reshape(b, e, m).to(torch.float32),
         pc4[:, :3].reshape(b, 3, m).to(torch.float32)],
        dim=1,
    )
    return (rows * a[:, :, None] + b_aff[:, :, None]).to(out_dtype)
