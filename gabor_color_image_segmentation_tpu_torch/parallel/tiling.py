"""Spatial tiling with halo exchange, the large-frame path (counterpart of
the JAX package's parallel/tiling.py).

One frame's rows split over the mesh's ``space`` axis into equal strips,
driven in lockstep by one controller (parallel/mesh.py): a per-shard value
is a list indexed by the shard's position.

1. **Halo exchange** (``_halo_exchange_rows``): each shard receives its
   neighbours' edge rows by two ``ppermute``s; the two true borders take
   REFLECT_101 of the local strip. It runs at two levels: input rows by the
   conv radius before ``modulated_group_magnitudes(..., h_halo=p, y0=row0)``
   (plane waves in global rows), magnitude rows by the smoothing radius
   before ``smooth_group_magnitudes(..., h_halo=r)``. So a strip's energies
   are the whole frame's rows of the modulated route.
2. **Features** (``_standardize_strip``): psum'd two-pass mean and variance,
   the colour balance, and the coherence weights from strip-local 8x8 block
   means (strip rows % 8 == 0, else ValueError). Channel-major (D, rows, W)
   float32.
3. **k-means** (``kmeans_sharded``): the multigrid schedule with strip-local
   2x2 pooling (strip rows % 2^coarse_levels == 0, else ValueError), the
   global maximin seeding (local argmax, all-gathered candidates, the
   first-index argmax: ties go to the lowest shard) and a fixed number of
   Lloyd passes whose sums and counts are psum'd. Each shard's pass is
   kernel K5 (``kmeans_fused.lloyd_t_pass``) on its (1, D, N_local) float32
   strip for k <= 8 (K5's ``K_MAX``); past it the reference's one-hot pass
   in plain torch, a route chosen by k.
4. **Graph** (``cfg.graph.enabled``): parallel/tiled_graph.py on the strips
   pooled ``graph.pool`` times (strip rows % 2^pool == 0 keeps the blocks
   strip-local).

The strip energies, the standardisation and the seeding are plain torch,
as the reference leaves them to XLA. ``segment_tiled`` takes one frame on a
1-D ``space`` mesh; ``segment_tiled_batch`` a batch on a 2-D ``batch x
space`` mesh, each batch shard's images one after another on its space
shards. Labels come back on the mesh's first device.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import K_MAX
from gabor_color_image_segmentation_tpu_torch.models.kmeans_fused import _pool_xt, lloyd_t_pass
from gabor_color_image_segmentation_tpu_torch.models.pipeline import _color_transform
from gabor_color_image_segmentation_tpu_torch.ops.modulated import (
    modulated_group_magnitudes,
    smooth_group_magnitudes,
)
from gabor_color_image_segmentation_tpu_torch.ops.tiled import pool2x2_mean
from gabor_color_image_segmentation_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
    scatter_rows,
)

Shards = List[torch.Tensor]


def _halo_exchange_rows(xs: Shards, halo: int, mesh: Mesh, axis: str) -> Shards:
    """(rows, W, C) strips -> (rows + 2 halo, W, C) with the neighbours'
    rows; the first and last shard reflect (REFLECT_101) their own rows at
    the frame's border."""
    n = mesh.shape[axis]
    from_prev = mesh.ppermute([x[-halo:] for x in xs], axis,
                              [(i, (i + 1) % n) for i in range(n)])
    from_next = mesh.ppermute([x[:halo] for x in xs], axis,
                              [(i, (i - 1) % n) for i in range(n)])
    out = []
    for i, x in enumerate(xs):
        top = x[1:halo + 1].flip(0) if i == 0 else from_prev[i]
        bot = x[-halo - 1:-1].flip(0) if i == n - 1 else from_next[i]
        out.append(torch.cat([top, x, bot], dim=0))
    return out


def _strip_energies(rgb_strips: Shards, cfg, bank, mesh: Mesh, axis: str
                    ) -> Tuple[Shards, Shards]:
    """(rows, W, 3) sRGB strips -> ((rows, W, E) float32 energies, (rows,
    W, 3) colour) by the two-level halo exchange (module docstring)."""
    p = bank.config.max_conv_radius
    r = bank.config.max_smooth_radius
    rows = rgb_strips[0].shape[0]
    color = [_color_transform(s, cfg.color_space) for s in rgb_strips]
    colorh = _halo_exchange_rows(color, p, mesh, axis)
    mags = [[modulated_group_magnitudes(ch[None], g, bank, torch.float32, h_halo=p,
                                        y0=i * rows)[0] for g in bank.groups]
            for i, ch in enumerate(colorh)]
    magh = _halo_exchange_rows([torch.cat(m, dim=-1) for m in mags], r, mesh, axis)
    energies = []
    for mh, m in zip(magh, mags):
        outs, off = [], 0
        for g, mg in zip(bank.groups, m):
            e = mg.shape[-1]
            outs.append(smooth_group_magnitudes(mh[None, :, :, off:off + e], g,
                                                torch.float32, h_halo=r)[0])
            off += e
        energies.append(torch.cat(outs, dim=-1))
    return energies, color


def _standardize_strip(energies: Shards, color: Shards, cfg, mesh: Mesh, axis: str) -> Shards:
    """(rows, W, E) energies ++ (rows, W, 3) colour -> (D, rows, W) float32
    standardised features with psum'd global moments (the distributed
    ops/features.py::assemble_features, coherence weights included)."""
    c = cfg.cluster
    feats = [torch.cat([e, col], dim=-1).to(torch.float32).permute(2, 0, 1).contiguous()
             for e, col in zip(energies, color)]
    n = mesh.shape[axis]
    d, rows, w = feats[0].shape
    if c.normalize:
        total = n * rows * w
        mean = [m / total for m in mesh.psum([f.sum(dim=(1, 2)) for f in feats], axis)]
        ssq = mesh.psum([(f - m[:, None, None]).square().sum(dim=(1, 2))
                         for f, m in zip(feats, mean)], axis)
        feats = [(f - m[:, None, None]) / (torch.sqrt(v / total) + 1e-6)[:, None, None]
                 for f, m, v in zip(feats, mean, ssq)]
    e = energies[0].shape[-1]
    cw = c.color_weight * float(np.sqrt(e / 3.0))
    scale = torch.cat([torch.ones(e, dtype=torch.float32),
                       torch.full((3,), cw, dtype=torch.float32)])
    feats = [f * scale.to(f.device)[:, None, None] for f in feats]
    if c.cue_weight == "coherence":
        b = 8
        if rows % b:
            raise ValueError(f"cue_weight='coherence' needs strip rows % {b} == 0, got {rows}")
        hb, wb = rows // b, w // b
        fc = [f[:, :, :wb * b] for f in feats]
        pooled = [f.reshape(d, hb, b, wb, b).mean(dim=(2, 4)) for f in fc]
        nb = n * hb * wb
        pm = [s / nb for s in mesh.psum([q.sum(dim=(1, 2)) for q in pooled], axis)]
        pq = mesh.psum([q.square().sum(dim=(1, 2)) for q in pooled], axis)
        nf = n * rows * wb * b
        fm = [s / nf for s in mesh.psum([f.sum(dim=(1, 2)) for f in fc], axis)]
        fq = mesh.psum([f.square().sum(dim=(1, 2)) for f in fc], axis)
        pw = float(getattr(c, "coherence_pow", 1.0))
        out = []
        for f, m1, q1, m2, q2 in zip(feats, pm, pq, fm, fq):
            pv = torch.clamp(q1 / nb - m1.square(), min=0.0)
            fv = torch.clamp(q2 / nf - m2.square(), min=0.0)
            cwts = torch.sqrt(pv) / (torch.sqrt(fv) + 1e-6)
            out.append(f * (cwts if pw == 1.0 else cwts ** pw)[:, None, None])
        feats = out
    return feats


def _strip_features(rgb_strips: Shards, cfg, bank, mesh: Mesh, axis: str) -> Shards:
    """(rows, W, 3) sRGB strips -> (D, rows, W) float32 standardised
    features."""
    energies, color = _strip_energies(rgb_strips, cfg, bank, mesh, axis)
    return _standardize_strip(energies, color, cfg, mesh, axis)


def _strip_graph_inputs(rgb_strips: Shards, cfg, bank, mesh: Mesh, axis: str
                        ) -> Tuple[Shards, Shards]:
    """The pooled graph-branch inputs: strip energies, colour and Lab pooled
    ``graph.pool`` times by strip-local exact 2x2 means (bit-equal to the
    whole frame's pooling), standardised on the pooled grid. Returns
    ((D, rows_p, W_p) features, (rows_p, W_p, 3) pooled Lab)."""
    energies, color = _strip_energies(rgb_strips, cfg, bank, mesh, axis)
    same = cfg.color_space == "lab"
    lab = color if same else [_color_transform(s, "lab") for s in rgb_strips]
    for _ in range(cfg.graph.pool):
        energies = [pool2x2_mean(e, 0) for e in energies]
        color = [pool2x2_mean(c, 0) for c in color]
        lab = color if same else [pool2x2_mean(x, 0) for x in lab]
    return _standardize_strip(energies, color, cfg, mesh, axis), lab


# ---------------------------------------------------------------------------
# distributed k-means
# ---------------------------------------------------------------------------


def _global_maximin(xs: Shards, k: int, mesh: Mesh, axis: str) -> Shards:
    """Farthest-point seeds over row-sharded (1, D, N_local) float32 data:
    every shard returns the same (k, D) centres. The reference's matvec
    distance form |x|^2 - 2 x.c + |c|^2; each pick is the local first
    argmax, then the first argmax over the all-gathered candidates (ties
    go to the lowest shard)."""
    pts = [x[0].T for x in xs]  # (N_local, D) views
    mean = mesh.pmean([p.mean(dim=0) for p in pts], axis)
    xsq = [p.square().sum(dim=1) for p in pts]

    def dist_to(cs):
        return [q - 2.0 * (p @ c) + c.square().sum() for p, q, c in zip(pts, xsq, cs)]

    def global_argmax_point(scores):
        idx = [torch.argmax(s) for s in scores]
        all_x = mesh.all_gather([p[i] for p, i in zip(pts, idx)], axis)
        all_s = mesh.all_gather([s[i] for s, i in zip(scores, idx)], axis)
        return [ax[torch.argmax(a)] for ax, a in zip(all_x, all_s)]

    c = global_argmax_point(dist_to(mean))
    centers = [[ci] for ci in c]
    dmin = dist_to(c)
    for _ in range(1, k):
        c = global_argmax_point(dmin)
        for cl, ci in zip(centers, c):
            cl.append(ci)
        dmin = [torch.minimum(a, b) for a, b in zip(dmin, dist_to(c))]
    return [torch.stack(cl) for cl in centers]


def _local_pass(x: torch.Tensor, centers: torch.Tensor, assign_only: bool = False):
    """One shard's Lloyd pass on its (1, D, N) float32 strip: K5 for k <=
    K_MAX, the reference's one-hot pass in plain torch past it. Returns
    labels (N,) int32 and, unless assign_only, sums (k, D) and counts (k,)."""
    k = centers.shape[0]
    if k <= K_MAX:
        out = lloyd_t_pass(x, centers[None].contiguous(), assign_only)
        return out[0] if assign_only else tuple(t[0] for t in out)
    pts = x[0].T
    scores = centers.square().sum(dim=1) - 2.0 * (pts @ centers.T)
    labels = torch.argmin(scores, dim=1)
    if assign_only:
        return labels.to(torch.int32)
    onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)
    return labels.to(torch.int32), onehot.T @ pts, onehot.sum(dim=0)


def _lloyd_sharded(xs: Shards, centers: Shards, n_iter: int, mesh: Mesh, axis: str) -> Shards:
    """``n_iter`` Lloyd updates of the replicated centres: local passes,
    psum'd sums and counts, an empty cluster keeps its centre. A fixed
    count is the reference's: at the fixed point a step is the identity."""
    for _ in range(n_iter):
        parts = [_local_pass(x, c) for x, c in zip(xs, centers)]
        sums = mesh.psum([p[1] for p in parts], axis)
        counts = mesh.psum([p[2] for p in parts], axis)
        centers = [torch.where(n[:, None] > 0, s / torch.clamp(n, min=1.0)[:, None], c)
                   for s, n, c in zip(sums, counts, centers)]
    return centers


def kmeans_sharded(xs: Shards, k: int, n_iter: int, mesh: Mesh, axis: str,
                   init_stride: int = 1, hw_local=None, coarse_iters: int = 0,
                   refine_iters: int = 10, coarse_levels: int = 1, mid_iters: int = 0
                   ) -> Tuple[Shards, Shards]:
    """Distributed Lloyd over row-sharded (1, D, N_local) float32 strips ->
    (labels (N_local,) int32 per shard, the replicated (k, D) centres).

    With ``coarse_iters`` > 0 and ``hw_local`` = (rows, W): the multigrid
    schedule (seeds and ``coarse_iters`` passes on the strips pooled
    ``coarse_levels`` times, ``mid_iters`` on each intermediate level, then
    ``refine_iters`` at full resolution), pooling strip-local. Without it:
    seeds from every ``init_stride``-th local pixel, ``n_iter`` passes."""
    xs = [x.to(torch.float32) for x in xs]
    multigrid = coarse_iters > 0 and hw_local is not None and init_stride == 1
    if not multigrid:
        seeds = _global_maximin([x[:, :, ::init_stride] for x in xs], k, mesh, axis)
        centers = _lloyd_sharded(xs, seeds, n_iter, mesh, axis)
        return [_local_pass(x, c, True) for x, c in zip(xs, centers)], centers
    rows, w = hw_local
    if rows % (1 << coarse_levels):
        raise ValueError(
            f"multigrid coarse_levels={coarse_levels} needs strip rows divisible by "
            f"{1 << coarse_levels} for strip-local pooling to equal the untiled pooling, "
            f"got {rows}-row strips; use fewer devices or coarse_iters=0")
    levels, lv, h_, w_ = [], xs, rows, w
    for _ in range(coarse_levels):
        lv = [_pool_xt(x, h_, w_) for x in lv]
        h_, w_ = h_ // 2, w_ // 2
        levels.append(lv)
    centers = _global_maximin(levels[-1], k, mesh, axis)
    centers = _lloyd_sharded(levels[-1], centers, coarse_iters, mesh, axis)
    if mid_iters > 0:
        for lvl in reversed(levels[:-1]):
            centers = _lloyd_sharded(lvl, centers, mid_iters, mesh, axis)
    centers = _lloyd_sharded(xs, centers, refine_iters, mesh, axis)
    return [_local_pass(x, c, True) for x, c in zip(xs, centers)], centers


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _check_graph_strip(rows: int, w: int, cfg) -> None:
    p = cfg.graph.pool
    if p and (rows % (1 << p) or w % (1 << p)):
        raise ValueError(f"graph.pool={p} needs strip rows and W divisible by {1 << p}, "
                         f"got {rows}x{w} strips")


def _check_strip(rows: int, bank, axis: str) -> None:
    """The one-hop halo exchange needs strips taller than each halo."""
    halo = max(bank.config.max_conv_radius, bank.config.max_smooth_radius)
    if halo >= rows:
        raise ValueError(f"halo {halo} >= strip height {rows}: single-hop ppermute halo "
                         f"exchange needs taller strips; use fewer devices along "
                         f"{axis!r} or a smaller-scale bank")


def _check_frame(h: int, w: int, n_space: int, cfg, bank, axis: str) -> None:
    if h % n_space:
        raise ValueError(f"H={h} must divide over {n_space} devices")
    _check_strip(h // n_space, bank, axis)
    if cfg.graph.enabled:
        _check_graph_strip(h // n_space, w, cfg)


def _tiled_image(strips: Shards, cfg, bank, mesh: Mesh, axis: str, h: int, w: int) -> Shards:
    """One frame's (rows, W, 3) sRGB strips -> (rows, W) int32 label strips."""
    if cfg.graph.enabled:
        from gabor_color_image_segmentation_tpu_torch.parallel.tiled_graph import (
            graph_strip_fn,
        )

        return graph_strip_fn(strips, cfg, bank, h, w, mesh, axis)
    c = cfg.cluster
    feats = _strip_features(strips, cfg, bank, mesh, axis)
    d, rows, _ = feats[0].shape
    labels, _ = kmeans_sharded([f.reshape(1, d, rows * w) for f in feats], c.k, c.n_iter,
                               mesh, axis, c.init_stride, (rows, w), c.coarse_iters,
                               c.refine_iters, c.coarse_levels, c.mid_iters)
    return [lab.reshape(rows, w) for lab in labels]


def _prepare(rgb, cfg, bank):
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank
    from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy

    set_policy()
    if isinstance(rgb, np.ndarray):
        rgb = torch.from_numpy(rgb)
    return rgb, (make_bank(cfg.bank) if bank is None else bank)


def segment_tiled(rgb, cfg, bank, mesh: Mesh, axis_name: str = "space") -> torch.Tensor:
    """(H, W, 3) frame, rows split over mesh[axis_name] -> (H, W) int32
    labels on the mesh's first device. ``bank`` None builds it."""
    rgb, bank = _prepare(rgb, cfg, bank)
    h, w, _ = rgb.shape
    devs = mesh.axis_devices(axis_name)
    _check_frame(h, w, len(devs), cfg, bank, axis_name)
    labels = _tiled_image(scatter_rows(rgb, devs), cfg, bank, mesh, axis_name, h, w)
    return gather_rows(labels, devs[0])


def tiled_batch_fn(cfg, bank, mesh: Mesh, batch_axis: str = "batch",
                   space_axis: str = "space"):
    """Segmenter over a 2-D ``batch x space`` mesh: (B, H, W, 3) -> (B, H,
    W) int32 labels on the mesh's first device. Batch shard i takes images
    [i B/n_b, (i + 1) B/n_b), each split over its row of space shards."""
    def fn(rgb):
        rgb_, bank_ = _prepare(rgb, cfg, bank)
        b, h, w, _ = rgb_.shape
        n_b, n_s = mesh.shape[batch_axis], mesh.shape[space_axis]
        if b % n_b:
            raise ValueError(f"B={b} must divide over {n_b} batch shards")
        _check_frame(h, w, n_s, cfg, bank_, space_axis)
        bl = b // n_b
        first = mesh.devices.reshape(-1)[0]
        out = []
        for i in range(n_b):
            sub = mesh.along(space_axis, **{batch_axis: i})
            devs = sub.axis_devices(space_axis)
            for img in rgb_[i * bl:(i + 1) * bl]:
                labels = _tiled_image(scatter_rows(img, devs), cfg, bank_, sub, space_axis,
                                      h, w)
                out.append(gather_rows(labels, first))
        return torch.stack(out)

    return fn


def segment_tiled_batch(rgb, cfg, bank, mesh: Mesh, batch_axis: str = "batch",
                        space_axis: str = "space") -> torch.Tensor:
    """config4's execution shape: (B, H, W, 3) frames on a 2-D mesh, data
    parallel over ``batch_axis``, each frame's rows over ``space_axis``."""
    return tiled_batch_fn(cfg, bank, mesh, batch_axis, space_axis)(rgb)
