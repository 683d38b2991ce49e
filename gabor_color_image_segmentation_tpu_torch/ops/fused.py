"""Fused Gabor energies, kernel K1 (counterpart of the JAX package's
ops/fused_pallas.py::gabor_energies_fused).

Replaces the TPU kernel ``ops/fused_pallas.py::_group_kernel``. The CUDA
kernel (``csrc/gabor_energies.cu``) runs two launches per scale group, a
magnitude pass and a smoothing pass, with a magnitude intermediate of
(B, max n_g * C, H, W) in device memory, in the stored dtype (in bf16 its
rows padded to ``mag_pitch``), that every group reuses. It writes each
group straight into its channel slice of one (B, E, H, W) output and of
its 2x2-pooled twin (B, E, H // 2, W // 2), so there is no per-group tuple
and no concatenation. It sizes its tiles and halos at launch from each
group's radii, so it takes any radius a bank gives.

Two routes, by the stored dtype. bfloat16 runs every 1-D pass as a
banded-Toeplitz product on the tensor cores (``mma.sync``, bf16 operands,
float32 accumulators), the product ``_group_plain`` writes out; the
kernels read each band as 16 x 16 blocks (``band_tables``, cached on the
device). The band fills 34-77 % of the blocks it issues (65 % at a conv
radius of 15, 77 % at a smoothing radius of 24, 25-63 % for the twin's
stride-2 pooled smoothing). On the H100 that route takes ~11 ms for a
config1 batch of 16 frames, mostly the elementwise work and the stores
around the products. float32 keeps the register-blocked tap loops on the
FMA pipes: its operands on the tensor cores would be TF32 (about three
digits, past its 1e-4 contract) or a 3xTF32 split. The kernel's note says
what bounds each route.

Output order is the feature contract: groups in bank order, kernel-major,
channel-minor within a group (the reference's features.py energy_index).

Arithmetic is float32, rounded to bfloat16 in bf16 mode where the
reference's kernel rounds its matmul operands: the image before the box
sums and the box sums' vertical pass, the envelope taps, the modulated
planes, the vertical blur, the magnitude, the smoothing taps and the
vertical smoothing, then the stored energies and twin. Those are the
tensor-core route's operands, so its products are the reference's, summed
in another order. Labels turn on those bits: maximin seeding on bf16
features meets exact ties, and rounding only the stored values seeds other
pixels on some frames (config2 at 321x481 agreed 0.54 with the reference on
one mosaic).

The smoothing follows the reference's Toeplitz matrices: REFLECT_101
borders folded into each output's taps (two taps that reach the same
source pixel sum first, in float32, and round once), and the twin is the
pooled smoothing (P_v S_v) mag (S_h P_h), its taps the mean of two rows of
the folded matrix, not the mean of four stored energies. ``smooth_table``
gives each output's taps over the padded axis; ``band_tables`` cuts those
rows into the tensor-core route's blocks.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.ops.bank import GroupTensors

def _reflect_np(idx: np.ndarray, n: int) -> np.ndarray:
    """REFLECT_101 source indices of positions ``idx`` on a length-``n``
    axis (folded as often as needed)."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def _reflect_pad(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """REFLECT_101 pad of ``axis`` by r on both sides."""
    n = x.shape[axis]
    idx = torch.from_numpy(_reflect_np(np.arange(-r, n + r), n)).to(x.device)
    return x.index_select(axis, idx)


def _round_storage(x, bf16: bool):
    """x rounded to bfloat16 (kept in float32) in bf16 mode, else x."""
    if not bf16:
        return x
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    return x.to(torch.bfloat16).to(torch.float32)


@functools.lru_cache(maxsize=256)
def _smooth_matrix_np(taps: Tuple[float, ...], n: int, pooled: bool, bf16: bool) -> np.ndarray:
    """The reference's smoothing matrix over an axis of length n: (n, n)
    with REFLECT_101 folded in (T[i, reflect(i - r + t)] += taps[t], float32
    adds in tap order), or its pooled rows (n // 2, n), the mean of rows 2i
    and 2i + 1 in float64 rounded to float32; rounded to bfloat16 in bf16
    mode. Output i reads source j with weight M[i, j]."""
    taps32 = np.asarray(taps, np.float32)
    k = taps32.size
    rows = np.arange(n)
    m = np.zeros((n, n), np.float32)
    cols = _reflect_np(rows[:, None] - k // 2 + np.arange(k)[None, :], n)
    for t in range(k):
        np.add.at(m, (rows, cols[:, t]), taps32[t])
    if pooled:
        n2 = n // 2
        m = (0.5 * (m[0:2 * n2:2].astype(np.float64) + m[1:2 * n2:2])).astype(np.float32)
    return _round_storage(m, bf16)


@functools.lru_cache(maxsize=256)
def _smooth_table_np(taps: Tuple[float, ...], n: int, pooled: bool, bf16: bool) -> np.ndarray:
    m = _smooth_matrix_np(taps, n, pooled, bf16)
    r = len(taps) // 2
    stride, ntap = (2, 2 * r + 2) if pooled else (1, 2 * r + 1)
    n_out = m.shape[0]
    src = _reflect_np(stride * np.arange(n_out)[:, None] - r + np.arange(ntap)[None, :], n)
    # each source pixel's tap sits at the first padded position that reaches it
    first = (src[:, :, None] == src[:, None, :]).argmax(axis=2) == np.arange(ntap)[None, :]
    table = np.where(first, m[np.arange(n_out)[:, None], src], 0.0).astype(np.float32)
    assert np.count_nonzero(table) == np.count_nonzero(m), "a fold left the band"
    return table


def _smooth_taps_np(taps: Tuple[float, ...], pooled: bool, bf16: bool) -> np.ndarray:
    """The taps of outputs clear of the borders: the plain taps (2r + 1), or
    the twin's (2r + 2), the mean of two shifted copies in float64 rounded
    to float32; rounded to bfloat16 in bf16 mode."""
    t = np.asarray(taps, np.float64)
    if pooled:
        t = 0.5 * (np.append(t, 0.0) + np.insert(t, 0, 0.0))
    return _round_storage(t.astype(np.float32), bf16)


@functools.lru_cache(maxsize=256)
def _on_device(fn, device: str, *args, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.from_numpy(fn(*args)).to(device, dtype)


def smooth_taps(g: GroupTensors, pooled: bool, bf16: bool) -> torch.Tensor:
    """The smoothing taps the kernel's register-blocked loops read
    (``_smooth_taps_np``), on g's device."""
    return _on_device(_smooth_taps_np, str(g.smooth.device), g.smooth_host, pooled, bf16)


def smooth_table(g: GroupTensors, n: int, pooled: bool, bf16: bool) -> torch.Tensor:
    """Per-output smoothing taps over a REFLECT_101-padded axis of length
    ``n``, the kernel's input: (n, 2r + 1) for the smoothing, (n // 2,
    2r + 2) for the twin (``pooled``), output i reading padded positions
    stride * i + t (stride 2 for the twin; the pad is r). The rows of
    ``_smooth_matrix_np`` laid on the padded axis: a source pixel reached
    from two padded positions takes its folded tap at the first and zero at
    the other. Rows clear of the borders hold the plain taps."""
    return _on_device(_smooth_table_np, str(g.smooth.device), g.smooth_host, n, pooled, bf16)


def _band_blocks_np(tab: np.ndarray, stride: int) -> np.ndarray:
    """A per-output tap table as the tensor-core kernels read its band:
    (ceil(n_out / 16), nk, 16, 16) float32, nk = ceil((15 stride + ntap) /
    16). ``tab`` (n_out, ntap): output o reads padded position stride * o +
    t with weight tab[o, t]. Block (m, k) holds outputs 16 m + a (rows a)
    at padded positions stride * 16 m + 16 k + b (columns b): tab[16 m + a,
    16 k + b - stride * a] inside the band, zero outside it and past n_out."""
    n_out, ntap = tab.shape
    nk = (15 * stride + ntap + 15) // 16
    nm = -(-n_out // 16)
    rows = np.zeros((nm * 16, ntap), np.float32)
    rows[:n_out] = tab
    a = np.arange(16)
    t = 16 * np.arange(nk)[:, None, None] + a[None, None, :] - stride * a[None, :, None]
    inside = (t >= 0) & (t < ntap)  # (nk, 16, 16)
    blocks = rows.reshape(nm, 16, ntap)[:, a[:, None], np.clip(t, 0, ntap - 1)]
    return np.ascontiguousarray(np.where(inside[None], blocks, 0.0), np.float32)


@functools.lru_cache(maxsize=256)
def _envelope_blocks_np(env: Tuple[float, ...], ones: bool) -> np.ndarray:
    """The bands of the envelope taps, rounded to bfloat16, or of ones (the
    box sums), the same for every row block: (1, nk, 16, 16)."""
    taps = np.ones(len(env), np.float32) if ones else _round_storage(
        np.asarray(env, np.float32), True)
    return _band_blocks_np(np.tile(taps, (16, 1)), 1)


def column_shift(r: int) -> int:
    """How many columns before its padded axis the smoothing's staged strip
    starts, (-r) mod 8: the strip starts on an 8-element boundary of the
    bf16 magnitude rows (``mag_pitch``), so it is copied 16 bytes at a
    time, and the bands across the columns carry the shift."""
    return -r % 8


def mag_pitch(w: int) -> int:
    """Row pitch (elements) of the bf16 magnitude intermediate: w rounded up
    to a multiple of 8, so every tile's rows start 16-byte aligned."""
    return -(-w // 8) * 8


@functools.lru_cache(maxsize=256)
def _smooth_blocks_np(taps: Tuple[float, ...], n: int, pooled: bool, shift: int) -> np.ndarray:
    """The folded smoothing's band over an axis of length n (bf16 mode),
    at stride 2 for the twin, its padded axis read ``shift`` positions
    later (the band's taps moved right by shift)."""
    tab = _smooth_table_np(taps, n, pooled, True)
    return _band_blocks_np(np.pad(tab, ((0, 0), (shift, 0))), 2 if pooled else 1)


def band_tables(g: GroupTensors, h: int, w: int,
                pooled: bool) -> Tuple[Optional[torch.Tensor], ...]:
    """The bf16 band blocks of the tensor-core route, on g's device: the
    envelope's and the box sums' (one row block), the smoothing's down the
    rows and across the columns (shifted by ``column_shift``), and the
    twin's (None unless ``pooled``). Every value is a bfloat16 (the tables
    are rounded), so the cast is exact."""
    dev, shift, bf = str(g.env.device), column_shift(g.r), torch.bfloat16
    out = (_on_device(_envelope_blocks_np, dev, g.env_host, False, dtype=bf),
           _on_device(_envelope_blocks_np, dev, g.env_host, True, dtype=bf),
           _on_device(_smooth_blocks_np, dev, g.smooth_host, h, False, 0, dtype=bf),
           _on_device(_smooth_blocks_np, dev, g.smooth_host, w, False, shift, dtype=bf))
    if not pooled:
        return out + (None, None)
    return out + (_on_device(_smooth_blocks_np, dev, g.smooth_host, h, True, 0, dtype=bf),
                  _on_device(_smooth_blocks_np, dev, g.smooth_host, w, True, shift, dtype=bf))


def _smooth_matrix(g: GroupTensors, n: int, pooled: bool, bf16: bool) -> torch.Tensor:
    return _on_device(_smooth_matrix_np, str(g.smooth.device), g.smooth_host, n, pooled, bf16)


def _band_matrix(taps: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_out, n_out + len(taps) - 1) VALID correlation matrix, T[i, i + t]
    = taps[t] (the reference's _toeplitz)."""
    k = taps.shape[0]
    idx = torch.arange(n_out, device=taps.device)[:, None] + torch.arange(k, device=taps.device)
    t = taps.new_zeros((n_out, n_out + k - 1))
    return t.scatter_(1, idx, taps.expand(n_out, k).contiguous())


def _centered(img: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, C, H, W) float32, each channel centred on its
    mean. The DC-corrected response is invariant to a constant shift (the
    mu * box correction absorbs it), and centring keeps the near-DC blur
    intermediates small."""
    x = img.permute(0, 3, 1, 2).to(torch.float32)
    return (x - x.mean(dim=(2, 3), keepdim=True)).contiguous()


def _group_plain(x: torch.Tensor, g: GroupTensors, bf16: bool,
                 pooled: bool) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Smoothed float32 energies of one group, (B, n*C, H, W), and its
    twin (B, n*C, H//2, W//2) or None, as the reference computes them: each
    1-D pass a product with a banded matrix (float32, no TF32), ``bf16``
    rounding where the reference's bf16 kernel does (module docstring)."""
    b, c, h, w = x.shape
    p, dev = g.p, x.device

    def rq(v):
        return _round_storage(v, bf16)

    xpad = _reflect_pad(_reflect_pad(x, p, 2), p, 3)[:, None]  # (B, 1, C, Hp, Wp)
    hp, wp = h + 2 * p, w + 2 * p
    wx = g.freqs[:, 0].reshape(1, -1, 1, 1, 1)
    wy = g.freqs[:, 1].reshape(1, -1, 1, 1, 1)
    yv = torch.arange(hp, dtype=torch.float32, device=dev).reshape(1, 1, 1, -1, 1)
    xv = torch.arange(wp, dtype=torch.float32, device=dev).reshape(1, 1, 1, 1, -1)
    cy, sy = torch.cos(wy * yv), torch.sin(wy * yv)  # (1, n, 1, Hp, 1)
    cx, sx = torch.cos(wx * xv), torch.sin(wx * xv)  # (1, n, 1, 1, Wp)
    env = rq(g.env)
    ev, eh = _band_matrix(env, h), _band_matrix(env, w).T
    g_re = rq(ev @ rq(xpad * (cy * cx) - xpad * (sy * sx))) @ eh
    g_im = rq(ev @ rq(-xpad * (sy * cx) - xpad * (cy * sx))) @ eh
    ones = torch.ones_like(g.env)
    box = rq(_band_matrix(ones, h) @ rq(xpad)) @ _band_matrix(ones, w).T  # (B, 1, C, H, W)
    cyp, syp = cy[:, :, :, p : p + h], sy[:, :, :, p : p + h]
    cxp, sxp = cx[..., p : p + w], sx[..., p : p + w]
    cos_p = cyp * cxp - syp * sxp
    sin_p = syp * cxp + cyp * sxp
    re = cos_p * g_re - sin_p * g_im - g.mus.reshape(1, -1, 1, 1, 1) * box
    im = sin_p * g_re + cos_p * g_im
    del g_re, g_im
    mag = rq(torch.sqrt(re * re + im * im)).reshape(b, g.n * c, h, w)
    del re, im
    # the border contract: reflect the MAGNITUDE map; rows, then columns
    sm = rq(_smooth_matrix(g, h, False, bf16) @ mag) @ _smooth_matrix(g, w, False, bf16).T
    if not pooled:
        return sm, None
    if h < 2 or w < 2:
        return sm, sm.new_zeros((b, g.n * c, h // 2, w // 2))
    tw = rq(_smooth_matrix(g, h, True, bf16) @ mag) @ _smooth_matrix(g, w, True, bf16).T
    return sm, tw


def gabor_energies_fused_plain(
    img: torch.Tensor, groups: Sequence[GroupTensors], dtype: torch.dtype,
    pooled: bool = True,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K1: the same math in tensor ops."""
    x = _centered(img)
    bf16 = _kernels.storage_code(dtype) == 1
    parts = [_group_plain(x, g, bf16, pooled) for g in groups]
    out = torch.cat([s for s, _ in parts], dim=1).to(dtype)
    return out, (torch.cat([t for _, t in parts], dim=1).to(dtype) if pooled else None)


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
    bf16 = _kernels.storage_code(dtype) == 1
    mag = torch.empty((b, max(g.n for g in groups) * c, h, mag_pitch(w) if bf16 else w),
                      dtype=dtype, device=img.device)
    goff = 0
    has_twin = pooled and twin.numel() > 0
    for g in groups:
        if bf16:  # the tensor cores: band tables only
            taps, band = (None,) * 7, band_tables(g, h, w, has_twin)
        else:  # the FMA tap loops: the taps of the smoothing and the twin, their tables
            twin_in = ((smooth_taps(g, True, False), smooth_table(g, h, True, False),
                        smooth_table(g, w, True, False)) if has_twin else (None,) * 3)
            taps = (g.env, smooth_taps(g, False, False), twin_in[0],
                    smooth_table(g, h, False, False), smooth_table(g, w, False, False),
                    twin_in[1], twin_in[2])
            band = (None,) * 6
        ptr = [None if t is None else t.data_ptr() for t in taps + band]
        _kernels.launch(
            "gcis_gabor_group", x.data_ptr(), mag.data_ptr(), out.data_ptr(),
            twin.data_ptr() if has_twin else None, ptr[0], g.freqs.data_ptr(),
            g.mus.data_ptr(), *ptr[1:],
            b, c, h, w, g.n, g.p, g.r, e, goff, int(bf16),
            outputs=(out[:, goff:goff + g.n * c],)
            + ((twin[:, goff:goff + g.n * c],) if pooled else ()),
        )
        goff += g.n * c
    gabor_energies_fused.launches += 1
    if bf16:
        gabor_energies_fused.tc_groups += len(groups)
    return out, twin


gabor_energies_fused.launches = 0
gabor_energies_fused.tc_groups = 0  # groups launched on the tensor-core route
