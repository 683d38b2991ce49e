"""Feature assembly helpers of the labels-only paths (counterpart of the JAX
package's ops/features.py: coherence_weights_cm, fold_coherence_affine,
assemble_xp_from_affine, _pool2x2_cm; its _norm_affine and
assemble_features_t are kmeans_chw._affine_params and
assemble_xp_from_affine at full resolution).

Plain PyTorch: in the JAX package these are XLA ops outside any Pallas
kernel. Energies arrive as one channel-major (B, E, H, W) tensor (the
feature kernel writes every scale group into it), where the reference took
a tuple of per-group buffers; every statistic here is per channel, so the
two forms give the same numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_COH_BLOCK = 8  # coherence pooling window (pixels per side)


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
