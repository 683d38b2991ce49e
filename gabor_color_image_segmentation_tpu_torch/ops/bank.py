"""Gabor filter bank (counterpart of the JAX package's ops/bank.py and of the
bank helpers in ops/modulated.py).

The bank is this system's only set of parameters: per-scale-group filter
taps, smoothing taps, frequencies and DC means, all built once in numpy.
The reference's ``ops/bank.py`` cannot be imported without JAX (its
package ``ops/__init__.py`` loads JAX modules), so the port carries numpy
copies of the builders; :func:`make_bank` gives bitwise the arrays of the
reference's ``make_bank``, and the tests hold it to that.

:func:`bank_tensors` turns a bank (the port's, or the JAX package's
``GaborBank``, read duck-typed) into the per-group tensors the feature
kernel takes.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.config import BankConfig


def gabor_kernel(
    ksize: int,
    sigma: float,
    theta: float,
    lambd: float,
    gamma: float = 1.0,
    psi: float = 0.0,
) -> np.ndarray:
    """Complex Gabor kernel, shape (ksize, ksize), complex128. The real part
    equals cv2.getGaborKernel((ksize, ksize), sigma, theta, lambd, gamma,
    psi, CV_64F), point reflection included; the imaginary part uses sin."""
    half = ksize // 2
    y, x = (-g for g in np.mgrid[-half : half + 1, -half : half + 1].astype(np.float64))
    ct, st = math.cos(theta), math.sin(theta)
    xr = x * ct + y * st
    yr = -x * st + y * ct
    envelope = np.exp(-(xr**2 + (gamma**2) * yr**2) / (2.0 * sigma**2))
    phase = 2.0 * math.pi * xr / lambd + psi
    return envelope * (np.cos(phase) + 1j * np.sin(phase))


def gaussian_kernel_1d(sigma: float, radius: int) -> np.ndarray:
    """Normalized 1-D Gaussian taps, shape (2*radius+1,), float64 (scipy's
    gaussian_filter kernel for order 0)."""
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


@dataclass(frozen=True, eq=False)
class ScaleGroup:
    """All kernels sharing one envelope sigma (hence ksize and smoothing)."""

    sigma: float
    ksize: int
    smooth_sigma: float
    smooth_radius: int
    # (ksize, ksize, 1, 2*n) float32; output channel 2j = Re, 2j+1 = Im
    filters_hwio: np.ndarray
    # (2*smooth_radius+1,) float32 separable smoothing taps
    smooth_taps: np.ndarray
    # flat kernel indices (BankConfig.kernel_params order) of this group
    kernel_indices: Tuple[int, ...]


@dataclass(frozen=True, eq=False)  # eq=False: hash by identity (cache key)
class GaborBank:
    config: BankConfig
    groups: Tuple[ScaleGroup, ...]
    n_kernels: int


@functools.lru_cache(maxsize=64)
def make_bank(cfg: BankConfig) -> GaborBank:
    """Memoized per BankConfig, so one config maps to one bank object."""
    params = cfg.kernel_params()
    groups: List[ScaleGroup] = []
    for sigma in cfg.scales:
        idxs = [i for i, p in enumerate(params) if p[0] == sigma]
        if not idxs:
            continue
        ksize = cfg.ksize_for(sigma)
        filters = np.zeros((ksize, ksize, 1, 2 * len(idxs)), dtype=np.float32)
        for j, i in enumerate(idxs):
            _, theta, lam, _ = params[i]
            k = gabor_kernel(ksize, sigma, theta, lam, cfg.gamma, cfg.psi)
            re = np.real(k)
            re = re - re.mean()  # DC-correct the real part
            filters[:, :, 0, 2 * j] = re.astype(np.float32)
            filters[:, :, 0, 2 * j + 1] = np.imag(k).astype(np.float32)
        smooth_sigma = cfg.smooth_sigma_for(sigma)
        radius = cfg.smooth_radius_for(sigma)
        groups.append(
            ScaleGroup(
                sigma=float(sigma),
                ksize=ksize,
                smooth_sigma=smooth_sigma,
                smooth_radius=radius,
                filters_hwio=filters,
                smooth_taps=gaussian_kernel_1d(smooth_sigma, radius).astype(np.float32),
                kernel_indices=tuple(idxs),
            )
        )
    return GaborBank(config=cfg, groups=tuple(groups), n_kernels=len(params))


def _envelope_taps(sigma: float, radius: int) -> np.ndarray:
    """UNNORMALIZED 1-D envelope taps exp(-t^2 / 2 sigma^2), float32; the
    product of two equals the 2-D envelope of an isotropic kernel."""
    t = np.arange(-radius, radius + 1, dtype=np.float64)
    return np.exp(-0.5 * (t / sigma) ** 2).astype(np.float32)


def group_frequencies(group, bank) -> np.ndarray:
    """Angular frequency vectors w_j = (2 pi / lambda_j)(cos th_j, sin th_j)
    of the group's kernels, shape (n_g, 2) float64 [wx, wy]."""
    params = bank.config.kernel_params()
    out = []
    for idx in group.kernel_indices:
        _, theta, lam, _ = params[idx]
        w = 2.0 * math.pi / lam
        out.append((w * math.cos(theta), w * math.sin(theta)))
    return np.asarray(out)


def _dc_mu(group, bank) -> np.ndarray:
    """mu_j = mean(Re K_j) before the DC correction, (n_g,) float32."""
    params = bank.config.kernel_params()
    cfg = bank.config
    mus = []
    for idx in group.kernel_indices:
        sigma, theta, lam, ksize = params[idx]
        k = gabor_kernel(ksize, sigma, theta, lam, cfg.gamma, cfg.psi)
        mus.append(float(np.real(k).mean()))
    return np.asarray(mus, np.float32)


@dataclass(frozen=True)
class GroupTensors:
    """One scale group as the feature kernel takes it."""

    n: int  # kernels in the group
    p: int  # conv radius (ksize // 2)
    r: int  # smoothing radius
    env: torch.Tensor  # (2p+1,) float32 envelope taps
    freqs: torch.Tensor  # (n, 2) float32 [wx, wy]
    mus: torch.Tensor  # (n,) float32 DC means
    smooth: torch.Tensor  # (2r+1,) float32 smoothing taps
    smooth_host: Tuple[float, ...]  # the same taps on the host (fused.smooth_table's key)
    env_host: Tuple[float, ...]  # the envelope taps on the host (fused.band_tables' key)


@functools.lru_cache(maxsize=64)
def _bank_tensors(bank, device: str) -> Tuple[GroupTensors, ...]:
    if bank.config.gamma != 1.0:
        raise ValueError("the fused feature path requires isotropic envelope gamma=1")
    out = []
    for g in bank.groups:
        p = g.ksize // 2
        taps = np.asarray(g.smooth_taps, np.float32)
        env = _envelope_taps(g.sigma, p)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

        out.append(GroupTensors(
            n=len(g.kernel_indices), p=p, r=len(taps) // 2,
            env=t(env),
            freqs=t(group_frequencies(g, bank).astype(np.float32)),
            mus=t(_dc_mu(g, bank)),
            smooth=t(taps),
            smooth_host=tuple(float(v) for v in taps),
            env_host=tuple(float(v) for v in env),
        ))
    return tuple(out)


def bank_tensors(bank, device) -> Tuple[GroupTensors, ...]:
    """Per-group kernel inputs on ``device``, cached per (bank, device).

    ``bank`` is the port's GaborBank or the JAX package's (only its numpy
    fields are read: config, groups, sigma, ksize, smooth_taps,
    kernel_indices)."""
    return _bank_tensors(bank, str(torch.device(device)))


def from_jax_bank(bank, device) -> Tuple[GroupTensors, ...]:
    """The JAX package's ``GaborBank`` -> the port's per-group tensors; the
    bank is read duck-typed, so the port never imports the JAX module."""
    return bank_tensors(bank, device)
