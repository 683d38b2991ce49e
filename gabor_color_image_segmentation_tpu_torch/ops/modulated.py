"""Modulated-separable Gabor energies in plain PyTorch (counterpart of the
JAX package's ops/modulated.py).

A Gabor kernel is a modulated Gaussian, so correlation with it factors
exactly (gamma == 1) into

    resp(p) = exp(i w.p) * [ (I_pad(q) * exp(-i w.q)) (*) G_sigma ](p)

with (*) a separable 1-D envelope pass per axis; the DC-corrected real part
subtracts mu_j * boxsum(I). The energies are the magnitudes smoothed by a
separable Gaussian over the REFLECT_101-padded magnitude map.

This is the reference's own feature route where its graph stage leaves the
Pallas kernel (``feature_impl="auto"`` at batch 1 or in float32,
models/pipeline.py): the reference gives it to XLA, so plain PyTorch is its
form on the card too, not a fallback for K1. The rounding points are the
reference's: every 1-D pass casts its input and taps to ``dtype``, takes
each product in ``dtype``, casts it to float32 and accumulates tap by tap
in float32, so the output is float32 in both modes. Layout NHWC, as the
reference's, energies in the feature contract's order (kernel-major,
channel-minor within a group). The spatial-tiling hooks (``h_halo``, ``y0``)
serve parallel/tiling.py's strips: rows that carry real neighbour rows,
and plane waves in the image's global row coordinates.

The bank helpers (``_envelope_taps``, ``group_frequencies``, ``_dc_mu`` on
the port's own ``gabor_kernel``) are ops/bank.py's copies; the bank is read
duck-typed, so the JAX package's ``GaborBank`` works too.
"""

from __future__ import annotations

import torch

from gabor_color_image_segmentation_tpu_torch.ops.bank import (
    _dc_mu,
    _envelope_taps,
    group_frequencies,
)
from gabor_color_image_segmentation_tpu_torch.ops import fused

__all__ = ["_dc_mu", "_envelope_taps", "_sep_1d", "gabor_energies_mod",
           "group_frequencies", "modulated_group_energies", "modulated_group_magnitudes",
           "smooth_group_magnitudes"]


def _reflect_pad(x: torch.Tensor, rh: int, rw: int) -> torch.Tensor:
    """REFLECT_101 pad of NHWC along H by rh and W by rw."""
    if rh:
        x = fused._reflect_pad(x, rh, 1)
    if rw:
        x = fused._reflect_pad(x, rw, 2)
    return x


def _sep_1d(x: torch.Tensor, taps: torch.Tensor, axis: int,
            dtype: torch.dtype) -> torch.Tensor:
    """VALID 1-D correlation along H (axis=1) or W (axis=2) as an ordered
    shift-multiply-add: input and taps cast to ``dtype``, each product in
    ``dtype``, cast to float32 and accumulated tap by tap in float32."""
    k = taps.shape[0]
    n = x.shape[axis] - k + 1
    xs = x.to(dtype)
    tp = taps.to(device=x.device, dtype=dtype)
    acc = (tp[0] * xs.narrow(axis, 0, n)).to(torch.float32)
    for t in range(1, k):
        acc += tp[t] * xs.narrow(axis, t, n)  # the dtype product, added in float32
    return acc


def modulated_group_magnitudes(img: torch.Tensor, group, bank,
                               dtype: torch.dtype = torch.float32, h_halo: int = 0,
                               y0=0) -> torch.Tensor:
    """DC-corrected response magnitudes of one scale group, before the
    smoothing: (B, H_in, W, C) float32 -> (B, H, W, n_g * C) float32.

    ``h_halo`` > 0: the input carries h_halo >= p real neighbour rows on
    both sides (H = H_in - 2 h_halo) and H is not padded, so a strip's rows
    equal the whole image's; 0 reflect-pads H. ``y0``: the global row of
    output row 0. The plane waves take float32 arange(-p, H + p) + y0, the
    reference's arithmetic, so a strip's phases are the whole image's."""
    if bank.config.gamma != 1.0:
        raise ValueError("modulated path requires isotropic envelope gamma=1")
    b, h_in, w, c = img.shape
    n = len(group.kernel_indices)
    p = group.ksize // 2
    dev = img.device
    env = torch.from_numpy(_envelope_taps(group.sigma, p)).to(dev)
    freqs = group_frequencies(group, bank)  # (n, 2) [wx, wy] float64
    mus = torch.from_numpy(_dc_mu(group, bank)).to(dev)
    if h_halo:
        if h_halo < p:
            raise ValueError(f"h_halo {h_halo} < conv radius {p}")
        h = h_in - 2 * h_halo
        xpad = _reflect_pad(img[:, h_halo - p:h_in - (h_halo - p)].to(torch.float32), 0, p)
    else:
        h = h_in
        xpad = _reflect_pad(img.to(torch.float32), p, p)  # (B, H + 2p, W + 2p, C)

    # plane waves over the padded coordinates q, rows from y0 - p
    yy = torch.arange(-p, h + p, dtype=torch.float32, device=dev)
    if y0:
        yy = yy + torch.tensor(float(y0), dtype=torch.float32, device=dev)
    yy = yy.reshape(-1, 1)
    xx = torch.arange(-p, w + p, dtype=torch.float32, device=dev).reshape(1, -1)
    wx = torch.tensor(freqs[:, 0], dtype=torch.float32, device=dev).reshape(1, 1, -1)
    wy = torch.tensor(freqs[:, 1], dtype=torch.float32, device=dev).reshape(1, 1, -1)
    phase_q = wx * xx[..., None] + wy * yy[..., None]  # (Hp, Wp, n)
    cos_q, sin_q = torch.cos(phase_q), torch.sin(phase_q)

    # modulated channels, (B, Hp, Wp, C * 2n): [c0k0re, c0k0im, c0k1re, ...]
    mod = torch.stack([cos_q, -sin_q], dim=-1)  # (Hp, Wp, n, 2)
    m = (xpad[..., None, None] * mod[None, :, :, None]).reshape(b, h + 2 * p, w + 2 * p,
                                                                 c * 2 * n)
    g = _sep_1d(_sep_1d(m, env, 1, dtype), env, 2, dtype)  # (B, H, W, C * 2n)
    del m
    g = g.reshape(b, h, w, c, n, 2)

    # box sums for the DC correction, separable
    ones = torch.ones((group.ksize,), dtype=torch.float32, device=dev)
    box = _sep_1d(_sep_1d(xpad, ones, 1, dtype), ones, 2, dtype)  # (B, H, W, C)

    # demodulate at the pixel coordinates
    phase_p = phase_q[p:p + h, p:p + w]  # (H, W, n)
    cos_p = torch.cos(phase_p)[None, :, :, None, :]
    sin_p = torch.sin(phase_p)[None, :, :, None, :]
    re = cos_p * g[..., 0] - sin_p * g[..., 1]  # (B, H, W, C, n)
    im = sin_p * g[..., 0] + cos_p * g[..., 1]
    re = re - mus.reshape(1, 1, 1, 1, -1) * box[..., None]
    mag = torch.sqrt(re * re + im * im)
    # (B, H, W, C, n) -> the contract's order: kernel-major, channel-minor
    return mag.permute(0, 1, 2, 4, 3).reshape(b, h, w, n * c)


def smooth_group_magnitudes(mag: torch.Tensor, group, dtype: torch.dtype = torch.float32,
                            h_halo: int = 0) -> torch.Tensor:
    """Gaussian smoothing of a group's magnitude maps over the REFLECT_101
    padded magnitude map (the border contract), rows then columns.
    ``h_halo`` > 0: the rows carry h_halo >= r magnitude rows on both sides
    (real neighbour rows, or at a true border the caller's REFLECT_101 of
    its own), and H is not padded; W always reflect-pads."""
    r = group.smooth_radius
    smooth = torch.from_numpy(group.smooth_taps).to(mag.device)
    if h_halo:
        if h_halo < r:
            raise ValueError(f"h_halo {h_halo} < smooth radius {r}")
        m = mag[:, h_halo - r:mag.shape[1] - (h_halo - r)]
    else:
        m = _reflect_pad(mag, r, 0)
    s = _sep_1d(m, smooth, 1, dtype)
    return _sep_1d(_reflect_pad(s, 0, r), smooth, 2, dtype)


def modulated_group_energies(img: torch.Tensor, group, bank,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, n_g * C) float32 smoothed energies of one
    scale group."""
    return smooth_group_magnitudes(modulated_group_magnitudes(img, group, bank, dtype),
                                   group, dtype)


def gabor_energies_mod(img: torch.Tensor, bank,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, N * C) float32 energies in the contract's
    order, every scale group of ``bank``. Counts its calls in ``calls``."""
    gabor_energies_mod.calls += 1
    return torch.cat([modulated_group_energies(img, g, bank, dtype) for g in bank.groups],
                     dim=-1)


gabor_energies_mod.calls = 0
