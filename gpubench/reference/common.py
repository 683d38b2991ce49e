"""The plain front end shared by the configurations' references.

Plain PyTorch on the inputs' device, in float32 with TF32 off. It imports
nothing of the measured package: the filter bank, the CIELab transform,
the Gabor energies (each 1-D pass a product with a banded matrix, the
smoothing matrices with REFLECT_101 folded in), the pooled twin, the
per-image standardisation affine with the coherence fold and the
normalised buffer are worked out here again from the configuration.

Where the configuration stores a tensor in its dtype (bfloat16), the
reference rounds the float32 values to it (``Storage``); tensors stay
float32, holding the rounded values. The energies' inner rounding points
(the operands of the banded products) are bfloat16 as the configuration
states them. ``Storage("fp8")`` is the control of the comparison: every
stored tensor rounded to float8 e4m3 with one scale per image and channel
(per image for centre vectors) in place of bfloat16.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def set_policy() -> None:
    """Full float32 matrix products and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Storage:
    """Rounding of stored tensors: "bfloat16" (the configuration's) or
    "fp8" (the control: float8 e4m3, scaled per image and channel)."""

    def __init__(self, name: str):
        if name not in ("bfloat16", "fp8"):
            raise ValueError(f"unknown storage {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor, chan=None) -> torch.Tensor:
        """float32 x rounded to the storage format, as float32. ``chan``:
        the channel axis that has a scale of its own (fp8 only; the batch
        axis 0 always has its own)."""
        x = x.to(torch.float32)
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).to(torch.float32)
        dims = tuple(d for d in range(1, x.dim()) if d != chan)
        amax = x.abs().amax(dim=dims, keepdim=True) if dims else x.abs()
        scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def bf16(x):
    """float32 values rounded to bfloat16, as float32 (tensor or numpy)."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(torch.bfloat16).to(torch.float32).numpy()
    return x.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# the filter bank
# ---------------------------------------------------------------------------


def _ksize(bank: dict, sigma: float) -> int:
    k = 2 * int(math.ceil(bank["truncate"] * float(sigma))) + 1
    return min(k, bank["max_ksize"]) | 1


def kernel_params(bank: dict):
    """(sigma, theta, lambda, ksize) of every kernel: scale-major, then
    orientation, then frequency."""
    out = []
    for sigma in bank["scales"]:
        for o in range(bank["orientations"]):
            theta = math.pi * o / bank["orientations"]
            freqs = (0.56 / sigma,) if bank["frequencies"] is None else bank["frequencies"]
            for f in freqs:
                out.append((sigma, theta, 1.0 / f, _ksize(bank, sigma)))
    return out


def _gabor_real_mean(ksize, sigma, theta, lambd, gamma, psi) -> float:
    """Mean of the real part of the complex Gabor kernel (before its DC
    correction)."""
    half = ksize // 2
    y, x = (-g for g in np.mgrid[-half:half + 1, -half:half + 1].astype(np.float64))
    ct, st = math.cos(theta), math.sin(theta)
    xr, yr = x * ct + y * st, -x * st + y * ct
    env = np.exp(-(xr ** 2 + gamma ** 2 * yr ** 2) / (2.0 * sigma ** 2))
    return float((env * np.cos(2.0 * math.pi * xr / lambd + psi)).mean())


def bank_groups(bank: dict, device) -> list:
    """One dict a scale group, in scale order: n kernels, conv radius p,
    smoothing radius r, envelope taps, frequency vectors (n, 2) [wx, wy],
    DC means, smoothing taps (float32, and a host tuple)."""
    if bank["gamma"] != 1.0:
        raise ValueError("the reference's energies take an isotropic envelope (gamma 1)")
    params = kernel_params(bank)
    groups = []
    for sigma in bank["scales"]:
        idx = [i for i, p in enumerate(params) if p[0] == sigma]
        ksize = _ksize(bank, sigma)
        p = ksize // 2
        s_sigma = bank["smoothing"] * float(sigma)
        r = int(math.ceil(bank["smooth_truncate"] * s_sigma))
        t = np.arange(-r, r + 1, dtype=np.float64)
        smooth = np.exp(-0.5 * (t / s_sigma) ** 2)
        smooth = (smooth / smooth.sum()).astype(np.float32)
        tp = np.arange(-p, p + 1, dtype=np.float64)
        env = np.exp(-0.5 * (tp / sigma) ** 2).astype(np.float32)
        freqs, mus = [], []
        for i in idx:
            _, theta, lam, _ = params[i]
            wv = 2.0 * math.pi / lam
            freqs.append((wv * math.cos(theta), wv * math.sin(theta)))
            mus.append(_gabor_real_mean(ksize, sigma, theta, lam, bank["gamma"], bank["psi"]))

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(device)

        groups.append({"n": len(idx), "p": p, "r": r, "env": dev(env),
                       "freqs": dev(np.asarray(freqs).astype(np.float32)),
                       "mus": dev(mus), "smooth_host": tuple(float(v) for v in smooth)})
    return groups


# ---------------------------------------------------------------------------
# colour
# ---------------------------------------------------------------------------

_RGB2XYZ = ((0.4124564, 0.3575761, 0.1804375),
            (0.2126729, 0.7151522, 0.0721750),
            (0.0193339, 0.1191920, 0.9503041))
_WHITE = (0.95047, 1.0, 1.08883)
_DELTA = 6.0 / 29.0


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) uint8 sRGB (D65) -> (..., 3) float32 CIELab, L in [0, 100];
    the 3x3 product as explicit multiply-adds."""
    c = rgb.to(torch.float32) / 255.0
    lin = torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)
    r, g, b = lin[..., 0], lin[..., 1], lin[..., 2]

    def f(t):
        return torch.where(t > _DELTA ** 3, t.clamp(min=_DELTA ** 3) ** (1.0 / 3.0),
                           t / (3.0 * _DELTA ** 2) + 4.0 / 29.0)

    fx, fy, fz = (f((m[0] * r + m[1] * g + m[2] * b) / wt) for m, wt in zip(_RGB2XYZ, _WHITE))
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1)


# ---------------------------------------------------------------------------
# Gabor energies
# ---------------------------------------------------------------------------


def _reflect(idx: np.ndarray, n: int) -> np.ndarray:
    """REFLECT_101 source index of each position on a length-n axis."""
    if n == 1:
        return np.zeros_like(idx)
    period = 2 * (n - 1)
    idx = np.mod(idx, period)
    return np.where(idx >= n, period - idx, idx)


def _reflect_pad(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    n = x.shape[axis]
    return x.index_select(axis, torch.from_numpy(_reflect(np.arange(-r, n + r), n)).to(x.device))


@functools.lru_cache(maxsize=64)
def _smooth_matrix_np(taps: tuple, n: int, pooled: bool) -> np.ndarray:
    """(n, n) smoothing matrix with REFLECT_101 folded in (taps that reach
    one source pixel added in float32, in tap order), or its pooled rows
    (n // 2, n): the mean of rows 2i and 2i + 1 in float64, as float32;
    rounded to bfloat16."""
    taps32 = np.asarray(taps, np.float32)
    k = taps32.size
    rows = np.arange(n)
    m = np.zeros((n, n), np.float32)
    cols = _reflect(rows[:, None] - k // 2 + np.arange(k)[None, :], n)
    for t in range(k):
        np.add.at(m, (rows, cols[:, t]), taps32[t])
    if pooled:
        n2 = n // 2
        m = (0.5 * (m[0:2 * n2:2].astype(np.float64) + m[1:2 * n2:2])).astype(np.float32)
    return bf16(m)


def _smooth_matrix(g: dict, n: int, pooled: bool, device) -> torch.Tensor:
    return torch.from_numpy(_smooth_matrix_np(g["smooth_host"], n, pooled)).to(device)


def _band(taps: torch.Tensor, n_out: int) -> torch.Tensor:
    """(n_out, n_out + len(taps) - 1) VALID correlation matrix."""
    k = taps.shape[0]
    idx = torch.arange(n_out, device=taps.device)[:, None] + torch.arange(k, device=taps.device)
    t = taps.new_zeros((n_out, n_out + k - 1))
    return t.scatter_(1, idx, taps.expand(n_out, k).contiguous())


def _group_energies(x: torch.Tensor, g: dict, twin: bool):
    """One scale group's smoothed energies (B, n*C, H, W) float32 and, with
    ``twin``, the 2x2-pooled smoothing (B, n*C, H//2, W//2). x: the
    centred (B, C, H, W) float32 image. Rounded to bfloat16 where the
    configuration's kernel rounds its matrix operands."""
    b, c, h, w = x.shape
    p, dev = g["p"], x.device
    xpad = _reflect_pad(_reflect_pad(x, p, 2), p, 3)[:, None]  # (B, 1, C, Hp, Wp)
    hp, wp = h + 2 * p, w + 2 * p
    wx = g["freqs"][:, 0].reshape(1, -1, 1, 1, 1)
    wy = g["freqs"][:, 1].reshape(1, -1, 1, 1, 1)
    yv = torch.arange(hp, dtype=torch.float32, device=dev).reshape(1, 1, 1, -1, 1)
    xv = torch.arange(wp, dtype=torch.float32, device=dev).reshape(1, 1, 1, 1, -1)
    cy, sy = torch.cos(wy * yv), torch.sin(wy * yv)
    cx, sx = torch.cos(wx * xv), torch.sin(wx * xv)
    env = bf16(g["env"])
    ev, eh = _band(env, h), _band(env, w).T
    g_re = bf16(ev @ bf16(xpad * (cy * cx) - xpad * (sy * sx))) @ eh
    g_im = bf16(ev @ bf16(-xpad * (sy * cx) - xpad * (cy * sx))) @ eh
    ones = torch.ones_like(g["env"])
    box = bf16(_band(ones, h) @ bf16(xpad)) @ _band(ones, w).T
    cyp, syp = cy[:, :, :, p:p + h], sy[:, :, :, p:p + h]
    cxp, sxp = cx[..., p:p + w], sx[..., p:p + w]
    cos_p = cyp * cxp - syp * sxp
    sin_p = syp * cxp + cyp * sxp
    re = cos_p * g_re - sin_p * g_im - g["mus"].reshape(1, -1, 1, 1, 1) * box
    im = sin_p * g_re + cos_p * g_im
    del g_re, g_im, box
    mag = bf16(torch.sqrt(re * re + im * im)).reshape(b, g["n"] * c, h, w)
    del re, im
    sm = bf16(_smooth_matrix(g, h, False, dev) @ mag) @ _smooth_matrix(g, w, False, dev).T
    if not twin:
        return sm, None
    tw = bf16(_smooth_matrix(g, h, True, dev) @ mag) @ _smooth_matrix(g, w, True, dev).T
    return sm, tw


def gabor_energies(lab: torch.Tensor, groups: list, store: Storage, twin: bool):
    """(B, H, W, 3) float32 Lab -> (energies (B, E, H, W), twin (B, E, H//2,
    W//2) or None), stored: groups in scale order, kernel-major, channel
    minor. Each channel is centred on its mean first (the DC-corrected
    response does not see a constant)."""
    x = lab.permute(0, 3, 1, 2).to(torch.float32)
    x = (x - x.mean(dim=(2, 3), keepdim=True)).contiguous()
    parts = [_group_energies(x, g, twin) for g in groups]
    e = store(torch.cat([s for s, _ in parts], dim=1), chan=1)
    return e, (store(torch.cat([t for _, t in parts], dim=1), chan=1) if twin else None)


# ---------------------------------------------------------------------------
# standardisation and the normalised buffers
# ---------------------------------------------------------------------------


def color4(lab: torch.Tensor, store=None) -> torch.Tensor:
    """(B, H, W, 3) Lab -> (B, 3, H, W) channel-major colour rows, stored
    (float32 when ``store`` is None)."""
    cm = lab.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    return cm if store is None else store(cm, chan=1)


def pool2x2(x: torch.Tensor, store: Storage) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, H//2, W//2) means: row pairs, stored, then
    column pairs, stored (0.5 weights, float32 sums)."""
    h2, w2 = x.shape[2] // 2, x.shape[3] // 2
    xf = x[:, :, :2 * h2]
    v = store(0.5 * xf[:, :, 0::2] + 0.5 * xf[:, :, 1::2], chan=1)[..., :2 * w2]
    return store(0.5 * v[..., 0::2] + 0.5 * v[..., 1::2], chan=1)


def _std(x: torch.Tensor) -> torch.Tensor:
    """(B, C, h, w) -> (B, C) one-pass float32 standard deviation."""
    m = x.mean(dim=(2, 3))
    return torch.sqrt(torch.clamp(x.square().mean(dim=(2, 3)) - m.square(), min=0.0))


def affine(energies, col, cluster: dict, store: Storage, twins=None, eps: float = 1e-6):
    """Per-row standardisation x = a * raw + b over the raw rows (energies,
    then L, a, b): mean and std per image, the colour rows weighted by
    color_weight * sqrt(E / 3), and with cue_weight "coherence" each row
    multiplied by its coherence weight ^ coherence_pow: the std of 8x8
    block means (from the 2x2 twins ``twins``, pooled twice more) over the
    std, carried through a. Returns (a, b), each (B, E + 3)."""
    e = energies.shape[1]
    cw = cluster["color_weight"] * math.sqrt(e / 3.0)

    def moments(x):
        mean = x.mean(dim=(2, 3))
        return mean, torch.sqrt(torch.clamp(x.square().mean(dim=(2, 3)) - mean.square(),
                                            min=0.0))

    if not cluster["normalize"]:
        raise ValueError("the reference standardises the features (normalize true)")
    m_e, s_e = moments(energies)
    m_c, s_c = moments(col)
    a_e, a_c = 1.0 / (s_e + eps), cw / (s_c + eps)
    a = torch.cat([a_e, a_c], dim=1)
    b = torch.cat([-m_e * a_e, -m_c * a_c], dim=1)
    if cluster["cue_weight"] != "coherence":
        return a, b
    h, w = energies.shape[2:]
    hb, wb = h // 8, w // 8
    if hb < 2 or wb < 2:
        return a, b
    sp = torch.cat([_std(pool2x2(pool2x2(q[:, :, :4 * hb, :4 * wb], store), store))
                    for q in twins], dim=1)
    s_full = torch.cat([s_e, s_c], dim=1)
    c = (a * sp) / (a * s_full + eps)
    wgt = c ** float(cluster["coherence_pow"])
    return a * wgt, b * wgt


def normalised(pe, pc, a, b, store: Storage) -> torch.Tensor:
    """Raw channel-major rows + the affine -> the stored normalised buffer
    (B, E + 3, m): energy rows, then the colour rows."""
    bsz, e, h2, w2 = pe.shape
    rows = torch.cat([pe.reshape(bsz, e, h2 * w2), pc.reshape(bsz, 3, h2 * w2)], dim=1)
    return store(rows * a[:, :, None] + b[:, :, None], chan=1)


def raw_rows(xe, col) -> torch.Tensor:
    """(B, E + 3, N) raw rows: energies, then L, a, b."""
    bsz, e, h, w = xe.shape
    return torch.cat([xe.reshape(bsz, e, h * w), col.reshape(bsz, 3, h * w)], dim=1)
