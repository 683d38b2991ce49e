"""Eager k-means (counterpart of the JAX package's models/kmeans.py:
maximin_init, pool2x2, kmeans, kmeans_multigrid).

The semantic reference the port's Lloyd kernels are tested against, on one
image's (N, D) normalised features. Deterministic farthest-point seeding
(no PRNG), assignment by ||c||^2 - 2 x.c (the pixel's own ||x||^2 does not
change the argmin), first index on ties, an empty cluster keeps its centre,
and the fixed-point early exit.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def maximin_init(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """x: (N, D) -> (k, D) farthest-point centres, seeded from every
    ``stride``-th row: the row farthest from the mean, then the row
    farthest from the centres chosen so far."""
    if stride > 1:
        x = x[::stride]
    xf = x.to(torch.float32)
    xsq = xf.square().sum(dim=1)

    def dist_to(c):
        cf = c.to(torch.float32)
        return xsq - 2.0 * (xf @ cf) + cf.square().sum()

    mean = xf.mean(dim=0).to(x.dtype)
    centers = [x[torch.argmax(dist_to(mean))]]
    dmin = dist_to(centers[0])
    for _ in range(1, k - 1):
        c = x[torch.argmax(dmin)]
        centers.append(c)
        dmin = torch.minimum(dmin, dist_to(c))
    if k > 1:
        centers.append(x[torch.argmax(dmin)])
    return torch.stack(centers)


def pool2x2(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(..., N = h*w, D) -> (..., (h//2)*(w//2), D) exact 2x2 block means,
    ordered f32 sum ((x00 + x01) + (x10 + x11)) * 0.25, cast back."""
    h2, w2 = h // 2, w // 2
    lead, d = x.shape[:-2], x.shape[-1]
    g = x[..., : h * w, :].reshape(*lead, h, w, d)
    g = g[..., : 2 * h2, : 2 * w2, :].to(torch.float32)
    s = (g[..., 0::2, 0::2, :] + g[..., 0::2, 1::2, :]) + (
        g[..., 1::2, 0::2, :] + g[..., 1::2, 1::2, :]
    )
    return (0.25 * s).to(x.dtype).reshape(*lead, h2 * w2, d)


def _assign(x: torch.Tensor, centers: torch.Tensor, dtype) -> torch.Tensor:
    """(N, D), (k, D) -> (N,) first-minimum labels of ||c||^2 - 2 x.c, the
    dot over ``dtype``-rounded operands in f32."""
    c_sq = centers.square().sum(dim=1)
    cross = x.to(dtype).to(torch.float32) @ centers.to(dtype).to(torch.float32).T
    return torch.argmin(c_sq - 2.0 * cross, dim=1)


def kmeans(
    x: torch.Tensor,
    k: int,
    n_iter: int = 25,
    dtype: torch.dtype = torch.float32,
    init_stride: int = 1,
    centers0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means, x: (N, D) -> (labels (N,) int32, centres (k, D) f32)."""
    x_mm = x.to(dtype)
    if centers0 is None:
        centers0 = maximin_init(x_mm, k, init_stride)
    centers = centers0.to(torch.float32)
    xf = x_mm.to(torch.float32)
    for _ in range(n_iter):
        onehot = torch.nn.functional.one_hot(_assign(x_mm, centers, dtype), k)
        onehot = onehot.to(torch.float32)
        counts = onehot.sum(dim=0)
        new = (onehot.T @ xf) / torch.clamp(counts, min=1.0)[:, None]
        new = torch.where(counts[:, None] > 0, new, centers)
        changed = bool((new != centers).any())
        centers = new
        if not changed:
            break
    return _assign(x_mm, centers, dtype).to(torch.int32), centers


def _maximin_init_batched(x: torch.Tensor, k: int) -> torch.Tensor:
    """maximin_init over a batch: (B, N, D) float32 -> (B, k, D)."""
    xsq = x.square().sum(dim=2)

    def dist_to(c):  # c: (B, D)
        return xsq - 2.0 * (x @ c[:, :, None])[:, :, 0] + c.square().sum(dim=1)[:, None]

    def row(i):  # i: (B,) -> (B, D) rows of x
        return torch.gather(x, 1, i[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]

    centers = [row(torch.argmax(dist_to(x.mean(dim=1)), dim=1))]
    dmin = dist_to(centers[0])
    for _ in range(1, k - 1):
        c = row(torch.argmax(dmin, dim=1))
        centers.append(c)
        dmin = torch.minimum(dmin, dist_to(c))
    if k > 1:
        centers.append(row(torch.argmax(dmin, dim=1)))
    return torch.stack(centers, dim=1)


def kmeans_batched(x: torch.Tensor, k: int, n_iter: int = 25) -> torch.Tensor:
    """``kmeans`` in float32 on each image of a batch, without a host sync:
    x (B, N, D) -> labels (B, N) int32.

    Runs exactly ``n_iter`` Lloyd passes, then the labels pass. A pass at the
    Lloyd fixed point gives back its centres bit for bit, so this equals
    ``kmeans``'s early exit."""
    x = x.to(torch.float32)
    centers = _maximin_init_batched(x, k)

    def assign(c):
        return torch.argmin(c.square().sum(dim=2)[:, None, :] - 2.0 * (x @ c.transpose(1, 2)),
                            dim=2)

    for _ in range(n_iter):
        onehot = torch.nn.functional.one_hot(assign(centers), k).to(torch.float32)
        counts = onehot.sum(dim=1)  # (B, k)
        new = (onehot.transpose(1, 2) @ x) / torch.clamp(counts, min=1.0)[:, :, None]
        centers = torch.where(counts[:, :, None] > 0, new, centers)
    return assign(centers).to(torch.int32)


def kmeans_multigrid(
    x: torch.Tensor,
    k: int,
    hw: Tuple[int, int],
    coarse_iters: int,
    refine_iters: int,
    dtype: torch.dtype = torch.float32,
    coarse_levels: int = 1,
    mid_iters: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multigrid Lloyd: seed and ``coarse_iters`` passes on the grid pooled
    ``coarse_levels`` times, ``mid_iters`` passes on each intermediate
    level (coarse to fine), then up to ``refine_iters`` full-resolution
    passes and a full-resolution assignment."""
    levels = []
    xp, (h, w) = x, hw
    for _ in range(coarse_levels):
        xp = pool2x2(xp, h, w)
        h, w = h // 2, w // 2
        levels.append(xp)
    _, centers = kmeans(levels[-1], k, coarse_iters, dtype)
    if mid_iters > 0:
        for xl in reversed(levels[:-1]):
            _, centers = kmeans(xl, k, mid_iters, dtype, centers0=centers)
    return kmeans(x, k, refine_iters, dtype, centers0=centers)
