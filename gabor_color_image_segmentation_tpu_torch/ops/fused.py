"""Fused Gabor energies, kernel K1 (counterpart of the JAX package's
ops/fused_pallas.py::gabor_energies_fused).

Replaces the TPU kernel ``ops/fused_pallas.py::_group_kernel``. The CUDA
kernel (``csrc/gabor_energies.cu``) runs two launches per scale group, a
magnitude pass and a smoothing pass, with a float32 magnitude intermediate
of (B, max n_g * C, H, W) in device memory that every group reuses. It
writes each group straight into its channel slice of one (B, E, H, W)
output and of its 2x2-pooled twin (B, E, H // 2, W // 2), so there is no
per-group tuple and no concatenation. It sizes its tiles and halos at
launch from each group's radii, so it takes any radius a bank gives. Its
note says what bounds it on the H100 and how its tap loops are
register-blocked.

Output order is the feature contract: groups in bank order, kernel-major,
channel-minor within a group (the reference's features.py energy_index).
Arithmetic is float32 throughout; in bf16 mode only the stored energies and
twin are rounded.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.ops.bank import GroupTensors

def _reflect_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Source indices of a REFLECT_101 pad of ``lo``/``hi`` samples around a
    length-``n`` axis (folded as often as needed)."""
    idx = np.arange(-lo, n + hi)
    if n == 1:
        return torch.zeros(idx.size, dtype=torch.long, device=device)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    idx = np.where(idx >= n, period - idx, idx)
    return torch.from_numpy(idx).to(device)


def _reflect_pad(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """REFLECT_101 pad of ``axis`` by r on both sides."""
    return x.index_select(axis, _reflect_index(x.shape[axis], r, r, x.device))


def _taps_1d(x: torch.Tensor, taps: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    """VALID correlation along ``axis`` as an ordered shift-multiply-add
    (tap 0 first), the accumulation order of the CUDA tap loops."""
    acc = None
    for t in range(taps.shape[0]):
        term = taps[t] * x.narrow(axis, t, n_out)
        acc = term if acc is None else acc + term
    return acc


def _centered(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) float32, each channel centred on its
    mean. The DC-corrected response is invariant to a constant shift (the
    mu * box correction absorbs it), and centring keeps the near-DC blur
    intermediates small."""
    x = img.permute(0, 3, 1, 2).to(torch.float32)
    return (x - x.mean(dim=(2, 3), keepdim=True)).contiguous()


def _group_plain(x: torch.Tensor, g: GroupTensors) -> torch.Tensor:
    """Smoothed float32 energies of one group, (B, n*C, H, W)."""
    b, c, h, w = x.shape
    p, dev = g.p, x.device
    xpad = _reflect_pad(_reflect_pad(x, p, 2), p, 3)[:, None]  # (B, 1, C, Hp, Wp)
    hp, wp = h + 2 * p, w + 2 * p
    wx = g.freqs[:, 0].reshape(1, -1, 1, 1, 1)
    wy = g.freqs[:, 1].reshape(1, -1, 1, 1, 1)
    yv = torch.arange(hp, dtype=torch.float32, device=dev).reshape(1, 1, 1, -1, 1)
    xv = torch.arange(wp, dtype=torch.float32, device=dev).reshape(1, 1, 1, 1, -1)
    cy, sy = torch.cos(wy * yv), torch.sin(wy * yv)  # (1, n, 1, Hp, 1)
    cx, sx = torch.cos(wx * xv), torch.sin(wx * xv)  # (1, n, 1, 1, Wp)
    m_re = xpad * (cy * cx) - xpad * (sy * sx)
    m_im = -xpad * (sy * cx) - xpad * (cy * sx)
    g_re = _taps_1d(_taps_1d(m_re, g.env, 3, h), g.env, 4, w)
    del m_re
    g_im = _taps_1d(_taps_1d(m_im, g.env, 3, h), g.env, 4, w)
    del m_im
    ones = torch.ones_like(g.env)
    box = _taps_1d(_taps_1d(xpad, ones, 3, h), ones, 4, w)  # (B, 1, C, H, W)
    cyp, syp = cy[:, :, :, p : p + h], sy[:, :, :, p : p + h]
    cxp, sxp = cx[..., p : p + w], sx[..., p : p + w]
    cos_p = cyp * cxp - syp * sxp
    sin_p = syp * cxp + cyp * sxp
    re = cos_p * g_re - sin_p * g_im - g.mus.reshape(1, -1, 1, 1, 1) * box
    im = sin_p * g_re + cos_p * g_im
    mag = torch.sqrt(re * re + im * im).reshape(b, g.n * c, h, w)
    del re, im, g_re, g_im
    r = g.r
    # the border contract: reflect the MAGNITUDE map; rows, then columns
    sm = _taps_1d(_reflect_pad(mag, r, 2), g.smooth, 2, h)
    return _taps_1d(_reflect_pad(sm, r, 3), g.smooth, 3, w)


def _twin(sm: torch.Tensor) -> torch.Tensor:
    """2x2 block means ((x00 + x01) + (x10 + x11)) / 4 of float32 maps."""
    h2, w2 = sm.shape[2] // 2, sm.shape[3] // 2
    s = sm[:, :, : 2 * h2, : 2 * w2]
    return 0.25 * ((s[:, :, 0::2, 0::2] + s[:, :, 0::2, 1::2])
                   + (s[:, :, 1::2, 0::2] + s[:, :, 1::2, 1::2]))


def gabor_energies_fused_plain(
    img: torch.Tensor, groups: Sequence[GroupTensors], dtype: torch.dtype,
    pooled: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K1: the same math in float32 tensor ops."""
    x = _centered(img)
    parts = [_group_plain(x, g) for g in groups]
    twins = [_twin(s) for s in parts] if pooled else None
    out = torch.cat(parts, dim=1).to(dtype)
    return out, (torch.cat(twins, dim=1).to(dtype) if pooled else None)


def gabor_energies_fused(
    img: torch.Tensor, groups: Sequence[GroupTensors], dtype: torch.dtype,
    pooled: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, H, W, C) float32 image -> ((B, E, H, W) energies, (B, E, H//2,
    W//2) 2x2-mean twin or None) in ``dtype`` (float32 or bfloat16).

    ``groups``: ops.bank.bank_tensors(bank, img.device). CPU tensors take
    the plain version; CUDA tensors launch the kernel, or raise."""
    _kernels.check(img.dim() == 4, f"img must be (B, H, W, C), got {tuple(img.shape)}")
    _kernels.check(img.dtype == torch.float32, f"img must be float32, got {img.dtype}")
    _kernels.storage_code(dtype)
    if _kernels.use_plain(img, *(g.env for g in groups)):
        return gabor_energies_fused_plain(img, groups, dtype, pooled)
    b, h, w, c = img.shape
    x = _centered(img)
    e = sum(g.n * c for g in groups)
    out = torch.empty((b, e, h, w), dtype=dtype, device=img.device)
    twin = (torch.empty((b, e, h // 2, w // 2), dtype=dtype, device=img.device)
            if pooled else None)
    mag = torch.empty((b, max(g.n for g in groups) * c, h, w),
                      dtype=torch.float32, device=img.device)
    goff = 0
    for g in groups:
        _kernels.launch(
            "gcis_gabor_group", x.data_ptr(), mag.data_ptr(), out.data_ptr(),
            twin.data_ptr() if pooled and twin.numel() else None,
            g.env.data_ptr(),
            g.freqs.data_ptr(), g.mus.data_ptr(), g.smooth.data_ptr(),
            b, c, h, w, g.n, g.p, g.r, e, goff, _kernels.storage_code(dtype),
            outputs=(out[:, goff:goff + g.n * c],)
            + ((twin[:, goff:goff + g.n * c],) if pooled else ()),
        )
        goff += g.n * c
    gabor_energies_fused.launches += 1
    return out, twin


gabor_energies_fused.launches = 0
