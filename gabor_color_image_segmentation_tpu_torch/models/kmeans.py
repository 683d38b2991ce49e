"""k-means in plain PyTorch (counterpart of the JAX package's
models/kmeans.py: maximin_init, pool2x2, kmeans, kmeans_fit_assign,
kmeans_multigrid, kmeans_batch, kmeans_image, and the fused-solver gate).

Deterministic farthest-point seeding (no PRNG), assignment by ||c||^2 -
2 x.c (the pixel's own ||x||^2 does not change the argmin) over operands
rounded to the solver's ``dtype``, first index on ties, an empty cluster
keeps its centre. The functions take one image (N, D) or a batch (B, N, D).
They run a fixed number of Lloyd passes where the reference stops at the
fixed point: a pass at the fixed point gives back its centres bit for bit,
so the labels and centres are the reference's, and the host never waits on
the card inside the solver.

``kmeans_batch`` is the with-features path's solver. It takes the
reference's route by k and N (``fused_solver_ready``: k <= 8 and 4,096 <=
N <= 10,000,000, the card in place of the TPU): there the transposed solver
of models/kmeans_fused.py (K6 seeds, K5 passes, on the CPU their plain
versions), elsewhere these plain solvers, on the card as on the CPU (the
reference computes them in XLA).
"""

from __future__ import annotations

import functools

from typing import Optional, Tuple

import torch

# The fused transposed solvers' gate, copied from the JAX package's
# models/kmeans.py and kmeans_pallas.fused_solver_eligible:
#  * SOLVER_N_MAX: the solver alone (admits 4K frames);
#  * PIPELINE_N_MAX: the labels-only transposed pipeline and the fused EM,
#    whose buffers coexist with the feature stage's tensors.
FUSED_K_MAX = 8
FUSED_N_MIN = 4096
SOLVER_N_MAX = 10_000_000
PIPELINE_N_MAX = 2_000_000


def fused_solver_ready(k: int, n: int, n_max: int = SOLVER_N_MAX) -> bool:
    """The reference's fused_solver_eligible with the card in place of the
    TPU: k <= 8 and FUSED_N_MIN <= n <= n_max. It reads no device, so the CPU
    walks the card's route on the kernels' plain versions."""
    return k <= FUSED_K_MAX and FUSED_N_MIN <= n <= n_max


def _first(out):
    """Image 0 of every tensor in ``out`` (a tensor or nested tuples)."""
    if isinstance(out, tuple):
        items = [_first(o) for o in out]
        return type(out)(*items) if hasattr(out, "_fields") else tuple(items)
    return out[0]


def _batched(fn):
    """Let ``fn(x (B, N, D), ...)`` take one image (N, D) too: the leading
    axis is added to x and to every tensor argument, and taken off every
    tensor it returns."""

    @functools.wraps(fn)
    def wrapper(x, *args, **kw):
        if x.dim() == 3:
            return fn(x, *args, **kw)
        args = [a[None] if isinstance(a, torch.Tensor) else a for a in args]
        kw = {n: a[None] if isinstance(a, torch.Tensor) else a for n, a in kw.items()}
        return _first(fn(x[None], *args, **kw))

    return wrapper


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, D), (B,) -> (B, D): row idx[b] of each image."""
    return torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]


@_batched
def maximin_init(x: torch.Tensor, k: int, stride: int = 1) -> torch.Tensor:
    """x: (B, N, D) or (N, D) -> (B, k, D) / (k, D) farthest-point centres
    in x's dtype, seeded from every ``stride``-th row: the row farthest from
    the mean, then the row farthest from the centres chosen so far."""
    if stride > 1:
        x = x[:, ::stride]
    xf = x.to(torch.float32)
    xsq = xf.square().sum(dim=2)

    def dist_to(c):
        cf = c.to(torch.float32)
        return xsq - 2.0 * torch.bmm(xf, cf[:, :, None])[:, :, 0] + cf.square().sum(1, True)

    centers = [_rows(x, torch.argmax(dist_to(xf.mean(dim=1).to(x.dtype)), dim=1))]
    dmin = dist_to(centers[0])
    for _ in range(1, k - 1):
        c = _rows(x, torch.argmax(dmin, dim=1))
        centers.append(c)
        dmin = torch.minimum(dmin, dist_to(c))
    if k > 1:
        centers.append(_rows(x, torch.argmax(dmin, dim=1)))
    return torch.stack(centers, dim=1)


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


def _assign(xf: torch.Tensor, centers: torch.Tensor, dtype) -> torch.Tensor:
    """(B, N, D) float32 values of ``dtype``, (B, k, D) -> (B, N)
    first-minimum labels of ||c||^2 - 2 x.c, the centres rounded to
    ``dtype`` for the dot, which sums in float32."""
    c_sq = centers.square().sum(dim=2)
    cross = torch.bmm(xf, centers.to(dtype).to(torch.float32).transpose(1, 2))
    return torch.argmin(c_sq[:, None, :] - 2.0 * cross, dim=2)


@_batched
def kmeans(
    x: torch.Tensor,
    k: int,
    n_iter: int = 25,
    dtype: torch.dtype = torch.float32,
    init_stride: int = 1,
    centers0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd k-means, x: (B, N, D) or (N, D) -> (labels int32, centres
    float32 (B, k, D) / (k, D)). The features are rounded to ``dtype``;
    ``centers0`` overrides the maximin seeds."""
    x_mm = x.to(dtype)
    if centers0 is None:
        centers0 = maximin_init(x_mm, k, init_stride)
    centers = centers0.to(torch.float32)
    xf = x_mm.to(torch.float32)
    for _ in range(n_iter):
        onehot = torch.nn.functional.one_hot(_assign(xf, centers, dtype), k)
        onehot = onehot.to(torch.float32)  # (B, N, k)
        counts = onehot.sum(dim=1)
        new = torch.bmm(onehot.transpose(1, 2), xf) / torch.clamp(counts, min=1.0)[:, :, None]
        centers = torch.where(counts[:, :, None] > 0, new, centers)
    return _assign(xf, centers, dtype).to(torch.int32), centers


@_batched
def kmeans_fit_assign(
    x: torch.Tensor,
    k: int,
    n_iter: int = 25,
    dtype: torch.dtype = torch.float32,
    subsample: int = 1,
    init_stride: int = 1,
    centers0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lloyd on every ``subsample``-th pixel, the labels of every pixel.
    subsample=1 is ``kmeans``; ``centers0`` seeds the subsampled view."""
    if subsample == 1:
        return kmeans(x, k, n_iter, dtype, init_stride, centers0)
    _, centers = kmeans(x[:, ::subsample], k, n_iter, dtype, init_stride, centers0)
    return _assign(x.to(dtype).to(torch.float32), centers, dtype).to(torch.int32), centers


def kmeans_batched(x: torch.Tensor, k: int, n_iter: int = 25) -> torch.Tensor:
    """``kmeans`` in float32 on each image of a batch (the n-cut's k-means on
    its spectral embedding): x (B, N, D) -> labels (B, N) int32."""
    return kmeans(x.to(torch.float32), k, n_iter)[0]


@_batched
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
    level (coarse to fine), then ``refine_iters`` full-resolution passes
    and a full-resolution assignment. x: (B, N, D) or (N, D), N = h * w."""
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


_INIT_ALONE_N = 1_000_000  # seed images one at a time past this many pixels


def kmeans_batch(
    x: torch.Tensor,
    k: int,
    n_iter: int = 25,
    dtype: torch.dtype = torch.float32,
    subsample: int = 1,
    init_stride: int = 1,
    hw: Optional[Tuple[int, int]] = None,
    coarse_iters: int = 0,
    refine_iters: int = 10,
    coarse_levels: int = 1,
    mid_iters: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-image k-means of a batch: (B, N, D) -> ((B, N) int32 labels,
    (B, k, D) float32 centres).

    Where ``fused_solver_ready(k, N')`` holds for the fitted view (N' the
    pixels of every ``subsample``-th one) it runs the transposed solver
    ``kmeans_fused.kmeans_fused_t`` (its multigrid schedule with ``hw`` and
    ``coarse_iters`` > 0, subsample and init_stride 1); with subsample > 1
    it fits there and labels every pixel. Elsewhere it runs the plain
    ``kmeans_multigrid`` or ``kmeans_fit_assign``, past 1,000,000 fitted
    pixels seeding one image at a time (one image's float32 copy live)."""
    multigrid = (coarse_iters > 0 and hw is not None and subsample == 1 and init_stride == 1
                 and hw[0] >= (1 << coarse_levels) and hw[1] >= (1 << coarse_levels))
    fit_view = x if subsample == 1 else x[:, ::subsample]
    if fused_solver_ready(k, fit_view.shape[1]):
        # the module, not its names: chip_smoke swaps the kernels' wrappers there
        from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf

        if multigrid:
            return kf.kmeans_fused_t(x, k, n_iter, dtype, init_stride, hw, coarse_iters,
                                     refine_iters, coarse_levels, mid_iters)
        labels, centers = kf.kmeans_fused_t(fit_view, k, n_iter, dtype, init_stride)
        if subsample == 1:
            return labels, centers
        return _assign(x.to(dtype).to(torch.float32), centers, dtype).to(torch.int32), centers
    if multigrid:
        return kmeans_multigrid(x, k, hw, coarse_iters, refine_iters, dtype, coarse_levels,
                                mid_iters)
    centers0 = None
    if fit_view.shape[1] > _INIT_ALONE_N:
        centers0 = torch.cat([maximin_init(xi[None].to(dtype), k, init_stride)
                              for xi in fit_view]).to(torch.float32)
    return kmeans_fit_assign(x, k, n_iter, dtype, subsample, init_stride, centers0)


def kmeans_image(features: torch.Tensor, k: int,
                 n_iter: int = 25) -> Tuple[torch.Tensor, torch.Tensor]:
    """(H, W, D) features -> ((H, W) int32 labels, (k, D) centres)."""
    h, w, d = features.shape
    labels, centers = kmeans(features.reshape(h * w, d), k, n_iter)
    return labels.reshape(h, w), centers
