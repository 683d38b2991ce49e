"""The pipeline (counterpart of the JAX package's models/pipeline.py:
_color_transform, compute_energies, compute_features,
_can_segment_transposed, segment_chw_grouped, _segment_batch_transposed,
segment_batch, segment_image, segment_images).

uint8 sRGB (B, H, W, 3), a numpy array or a tensor on any device -> int32
label maps (B, H, W) and, with ``with_features`` (the default, as the
reference's), the (B, H, W, D) features, on the device the caller names
(the card unless ``device="cpu"``), through the reference's routes.

Labels only, where ``_can_segment_transposed`` holds (k-means or GMM with
k <= 8 on frames of 4,096 to 2,000,000 pixels that fit ``tile_hw``, K1's
energies, the full feature set, subsample 1):

k-means (config0, config1):
  1. Lab colour transform;
  2. Gabor energies and their 2x2 twin (kernel K1), one (B, E, H, W) tensor;
  3. the per-image standardisation affine with the coherence weights folded
     in;
  4. with a multigrid schedule (config1): the coarse buffer pooled from the
     twin, maximin seeding and coarse Lloyd in one launch (K3), mid-level
     Lloyd passes on the twin (K2), then at most ``refine_iters``
     full-resolution passes (K2);
     without one (config0): maximin seeding at full resolution (K4) and up
     to ``n_iter`` full-resolution passes (K2);
  5. one assign-only pass (K2) writes the labels.
  With ``init_stride`` > 1: the normalised (B, E + 3, N) buffer, strided
  maximin seeds (plain torch) and ``n_iter`` Lloyd passes (K5).

GMM (config2):
  1. Lab colour transform;
  2. Gabor energies without the twin (K1);
  3. the normalised (B, E + 3, N) buffer and, on the grid pooled
     ``gmm_fit_levels`` times, the fit buffer under the same affine;
  4. k-means init on the fit buffer (K6 seeds, K5 passes), EM iterations
     (K9 factors, K8 passes), the full-resolution refine passes (K8) and
     one labels-only pass (K8).

Everything else takes the reference's NHWC path, which also returns the
features:

pixel clustering (any k, frame size and option):
  1. Lab colour transform; the energies by ``feature_impl`` (K1; the
     modulated route; the direct convolutions, the only route for a bank
     with gamma != 1), window by window past ``tile_hw``;
  2. ``assemble_features``: the standardised features, channel-major
     (B, D, H, W), returned as their (B, H, W, D) view;
  3. k-means: ``kmeans_batch`` (K6 seeds and K5 passes, its multigrid
     schedule on the pooled buffer, where k <= 8 and 4,096 <= N <=
     10,000,000; the plain solvers elsewhere); GMM: ``gmm_fused_t`` (K6,
     K5, K9, K8) where k <= 8, 4,096 <= N <= 2,000,000 and subsample 1,
     ``gmm_predict`` (plain torch) elsewhere.

graph (config3, config4; ``segment_batch`` for the n-cut,
``segment_images`` for the min-cut too):
  1. Lab colour transform;
  2. Gabor energies without the twin, window by window when the frame
     exceeds ``tile_hw`` (ops/tiled.py), pooled ``graph.pool`` times by
     exact 2x2 means (per window on the tiled path), so the graph stage
     runs on the (H >> pool, W >> pool) grid with the colour and the Lab
     pooled alike. The reference's dispatch: the n-cut with
     ``feature_impl="auto"`` at batch 1 or in float32 takes the modulated
     route (ops/modulated.py, plain torch, float32 energies), production
     bf16 batches and the min-cut route K1;
  3. ``assemble_features`` on the pooled grid (the pooled features are
     what ``with_features`` returns), in the energies' dtype;
  4. SLIC superpixels on the float32 Lab (K11 under the reference's
     whole-image gate, the banded K13 above it, as models/slic_fused.py
     routes) and connectivity enforcement (K14);
  5. n-cut: ``graph.graph_segment_batch`` on the features and the Lab
     (steps 4 and 5 there: superpixel means, affinity, spectral embedding
     and k-means, batched over the images, then the region ids broadcast
     to pixels by K15); or min-cut: the greedy merge on the host per
     image;
  6. with pooling, each label repeated 2^pool times along both axes.

Spans (utils/trace.py; ``torch.profiler`` ranges named ``gcis.<stage>``,
recorded only while a profiler records): ``segment`` holds a whole call;
``features`` the colour transform (``color``) and the energies;
``assemble`` the standardisation (colour rows, 2x2 pools, the affine, the
normalised buffer and the GMM's fit buffer, ops/standardise.py);
``assemble_xp`` the coarse buffer; ``coarse``, ``mid`` and ``cluster`` the clustering's levels (the
EM on the GMM's route); ``superpixels`` and ``graph_cut`` the graph
stage. Every host read of a device value, and the upload of host frames,
runs in a ``sync.<site>`` range: ``upload``, ``lloyd_fixed_point``,
``mincut_download``, ``mincut_upload``.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.config import PipelineConfig
from gabor_color_image_segmentation_tpu_torch.models.gmm import gmm_fit_levels, gmm_predict
from gabor_color_image_segmentation_tpu_torch.models.gmm_fused import gmm_fused_t, gmm_fused_t_xt
from gabor_color_image_segmentation_tpu_torch.models.graph import (
    graph_segment_batch,
    mincut_segment,
    superpixels,
)
from gabor_color_image_segmentation_tpu_torch.models.kmeans import (
    PIPELINE_N_MAX,
    fused_solver_ready,
    kmeans_batch,
)
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import (
    build_color4,
    kmeans_fused_chw,
)
from gabor_color_image_segmentation_tpu_torch.models.kmeans_fused import (
    kmeans_coarse_centers_xp,
    kmeans_fused_t_xt,
)
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu_torch.ops.features import (
    assemble_features,
    gabor_energies,
)
from gabor_color_image_segmentation_tpu_torch.ops.fused import gabor_energies_fused
from gabor_color_image_segmentation_tpu_torch.ops.modulated import gabor_energies_mod
from gabor_color_image_segmentation_tpu_torch.ops.precision import (
    set_policy,
    storage_dtype,
)
from gabor_color_image_segmentation_tpu_torch.ops.standardise import (
    affine_params,
    normalised_rows,
    pool2x2,
)
from gabor_color_image_segmentation_tpu_torch.ops.tiled import (
    gabor_energies_tiled,
    pool2x2_mean,
)
from gabor_color_image_segmentation_tpu_torch.utils.trace import span, sync


def _color_transform(rgb: torch.Tensor, color_space: str) -> torch.Tensor:
    with span("color"):
        if rgb.dtype == torch.uint8:
            rgb = rgb.to(torch.float32) / 255.0
        if color_space == "lab":
            return rgb_to_lab(rgb)
        return rgb.to(torch.float32)


def segment_chw_grouped(
    color: torch.Tensor,
    energies_cm: torch.Tensor,
    pooled_e: Optional[torch.Tensor],
    cfg: PipelineConfig,
    fold_twin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k-means on precomputed channel-major energies (B, E, H, W).

    color: (B, H, W, 3); pooled_e: the 2x2 twin (B, E, H//2, W//2) to run
    the multigrid warm start on, or None for none; fold_twin: the twin for
    the coherence statistics when there is no warm start."""
    dtype = energies_cm.dtype
    c = cfg.cluster
    multigrid = pooled_e is not None
    # levels below full resolution; the coarsest is read only normalised
    # (the coarse buffer), pooled in the launch that writes it
    n_lv = max(c.coarse_levels, 1) if multigrid else 0
    with span("assemble"):
        xc4 = build_color4(color, dtype)
        twin = fold_twin if fold_twin is not None else pooled_e
        pc0 = pool2x2(xc4) if (multigrid or twin is not None) else None
        affine = affine_params(energies_cm, xc4, c, 1e-6,
                               pooled=(twin, pc0) if twin is not None else None)
        levels = [(pooled_e, pc0)] if multigrid else []  # raw pooled twins, finest first
        for _ in range(n_lv - 2):
            levels.append((pool2x2(levels[-1][0]), pool2x2(levels[-1][1])))
    c0 = None
    if multigrid:
        pe_l, pc_l = levels[-1]
        e = energies_cm.shape[1]
        with span("assemble_xp"):
            xp, = normalised_rows(pe_l, pc_l, affine[0], affine[1], (1 if n_lv >= 2 else 0,))
        with span("coarse"):
            c0 = kmeans_coarse_centers_xp(xp, c.k, e + 3, xp.shape[2], c.coarse_iters)
        if c.mid_iters > 0:
            with span("mid"):
                for pe_m, pc_m in reversed(levels[:n_lv - 1]):
                    _, c0 = kmeans_fused_chw(pe_m, pc_m, affine, c.k, 0, c.mid_iters,
                                             init_centers=c0, with_labels=False)
    with span("cluster"):
        labels, _ = kmeans_fused_chw(energies_cm, xc4, affine, c.k, c.n_iter,
                                     c.refine_iters, init_centers=c0)
    return labels


def _normalised_buffer(rgb: torch.Tensor, cfg: PipelineConfig, bank, fit_levels: int = 0):
    """(B, H, W, 3) sRGB -> (the normalised (B, E + 3, N) buffer in the
    storage dtype, the fit buffer of the rows pooled ``fit_levels`` times
    under the same affine or None for 0, the K1 energies (B, E, H, W), the
    float32 colour (B, H, W, 3), the affine (a, b)): the reference's
    assemble_features_t, whose affine reads the float32 colour. Both
    buffers come from one read of the energies (ops/standardise.py)."""
    dtype = storage_dtype(cfg.dtype)
    with span("features"):
        color = _color_transform(rgb, cfg.color_space)
        energies = _k1_energies(color, bank, dtype)
    with span("assemble"):
        c4 = build_color4(color, torch.float32)
        a, b_aff = affine_params(energies, c4, cfg.cluster, 1e-6)
        bufs = normalised_rows(energies, c4, a, b_aff, (0, fit_levels) if fit_levels else (0,))
    return bufs[0], (bufs[1] if fit_levels else None), energies, color, (a, b_aff)


def _segment_gmm(rgb: torch.Tensor, cfg: PipelineConfig, bank) -> torch.Tensor:
    """(B, H, W, 3) sRGB -> (B, H, W) int32 labels of the per-image GMM."""
    b, h, w, _ = rgb.shape
    c = cfg.cluster
    # One affine for both buffers, from the float32 colour as the JAX
    # package's _norm_affine reads it for the full-resolution buffer; its
    # fit buffer's affine reads the colour rounded to the storage dtype, so
    # in bfloat16 the colour rows' moments differ by that rounding. The fit
    # grid pools the colour rounded to the storage dtype, as the reference's.
    _, _, lv = gmm_fit_levels(h, w, c.gmm_fit_pool)
    x, fit_x = _normalised_buffer(rgb, cfg, bank, lv)[:2]
    with span("cluster"):
        labels = gmm_fused_t_xt(x, c.k, c.n_iter, c.gmm_reg_covar, 10, c.gmm_tol, fit_x,
                                c.gmm_refine_iters)
    return labels.reshape(b, h, w)


def _k1_energies(color: torch.Tensor, bank, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, C) -> (B, E, H, W) K1 energies in ``dtype``, no twin."""
    energies, _ = gabor_energies_fused(color, bank_tensors(bank, color.device), dtype,
                                       pooled=False)
    return energies


def _modulated_energies(color: torch.Tensor, bank, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, C) -> (B, E, H, W) float32 energies of the modulated route."""
    return gabor_energies_mod(color, bank, dtype).permute(0, 3, 1, 2).contiguous()


def _direct_energies(color: torch.Tensor, bank, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, C) -> (B, E, H, W) float32 energies of the direct
    convolutions (already channel-major underneath)."""
    return gabor_energies(color, bank, dtype).permute(0, 3, 1, 2)


_ENERGIES = {"pallas": _k1_energies, "modulated": _modulated_energies,
             "direct": _direct_energies}


def compute_energies(rgb: torch.Tensor, cfg: PipelineConfig, bank, pool: int = 0):
    """(B, H, W, 3) sRGB -> ((B, E, H >> pool, W >> pool) energies, (B, H, W,
    3) float32 colour), by ``cfg.feature_impl`` as the reference picks its
    energies function: "pallas" runs K1 in the storage dtype, "modulated"
    the modulated route and "direct" the direct convolutions, both float32;
    "auto" is K1 (the reference's choice on its accelerator), or "direct"
    for a bank with gamma != 1, which the other two do not take. Frames
    larger than ``cfg.tile_hw`` run window by window and pool per window;
    others run whole and pool the energies after."""
    impl = cfg.feature_impl
    if impl == "auto":
        impl = "pallas" if cfg.bank.gamma == 1.0 else "direct"
    if impl not in _ENERGIES:
        raise ValueError(f"unknown feature_impl {cfg.feature_impl!r}")
    fn = _ENERGIES[impl]
    dtype = storage_dtype(cfg.dtype)
    with span("features"):
        color = _color_transform(rgb, cfg.color_space)
        _, h, w, _ = color.shape
        tile = cfg.tile_hw
        if tile is not None and (h > tile[0] or w > tile[1]):
            return gabor_energies_tiled(color, None, dtype, tile, bank.config.max_halo, pool,
                                        energies_fn=lambda win: fn(win, bank, dtype)), color
        energies = fn(color, bank, dtype)
        for _ in range(pool):
            energies = pool2x2_mean(energies, 2)
        return energies, color


def compute_features(rgb: torch.Tensor, cfg: PipelineConfig, bank) -> torch.Tensor:
    """(B, H, W, 3) sRGB -> (B, H, W, D) standardised pixel features, the
    view of a channel-major buffer (ops/features.py::assemble_features)."""
    energies, color = compute_energies(rgb, cfg, bank)
    with span("assemble"):
        return assemble_features(energies, color, cfg.cluster)


def _graph_features(rgb: torch.Tensor, cfg: PipelineConfig, bank, ncut: bool = True):
    """(B, H, W, 3) sRGB -> ((B, hp, wp, D) standardised features, the
    (B, hp, wp, 3) float32 Lab), on the grid pooled ``graph.pool`` times
    (hp, wp = H >> pool, W >> pool). The features are the (B, hp, wp, D)
    view of ``assemble_features``' channel-major buffer.

    The energies follow the reference's graph dispatch: for the n-cut
    (``ncut``) with ``feature_impl="auto"``, batch 1 or float32 takes the
    modulated route and bf16 batches K1; the min-cut route takes
    ``cfg.feature_impl`` as it is. The features are ``assemble_features``
    on the pooled energies and the pooled float32 colour, in the energies'
    dtype (bf16 from K1 in bf16 mode, else float32)."""
    b, h, w, _ = rgb.shape
    p = cfg.graph.pool
    if p and (h % (1 << p) or w % (1 << p)):
        raise ValueError(f"graph.pool={p} needs H, W divisible by {1 << p}, got {h}x{w}")
    fcfg = cfg
    if ncut and cfg.feature_impl == "auto" and (b == 1 or cfg.dtype == "float32"):
        fcfg = cfg.replace(feature_impl="modulated")
    energies, color = compute_energies(rgb, fcfg, bank, p)
    with span("assemble"):
        same = cfg.color_space == "lab"
        lab = color if same else _color_transform(rgb, "lab")
        for _ in range(p):
            color = pool2x2_mean(color, 1)
            lab = color if same else pool2x2_mean(lab, 1)
        return assemble_features(energies, color, cfg.cluster), lab


def _graph_front(rgb: torch.Tensor, cfg: PipelineConfig, bank, ncut: bool = True):
    """(B, H, W, 3) sRGB -> ((B, D, n) standardised features, (B, n) int32
    connected superpixels of the float32 Lab, their count S), on the grid
    pooled ``graph.pool`` times (n = (H >> pool) * (W >> pool)): the
    min-cut's front end (``_graph_features``, then
    ``graph.superpixels``)."""
    b = rgb.shape[0]
    feats, lab = _graph_features(rgb, cfg, bank, ncut)
    _, hp, wp, _ = feats.shape
    sp, n_sp = superpixels(lab, cfg.graph)
    return feats.permute(0, 3, 1, 2).reshape(b, -1, hp * wp), sp.reshape(b, hp * wp), n_sp


def _unpool(labels: torch.Tensor, pool: int) -> torch.Tensor:
    """(B, h, w) labels of the pooled grid -> each repeated 2^pool times
    along both axes."""
    f = 1 << pool
    return labels.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2) if pool else labels


def _segment_ncut(rgb: torch.Tensor, cfg: PipelineConfig, bank):
    """(B, H, W, 3) sRGB -> ((B, H, W) int32 region labels of the n-cut,
    the pooled grid's (B, hp, wp, D) features): the graph features, then
    ``graph_segment_batch`` on them, as the reference's segment_batch."""
    g = cfg.graph
    if g.cut != "ncut":
        raise ValueError(f"cut={g.cut!r} is host-side (see mincut_segment); "
                         "use pipeline.segment_images")
    feats, lab = _graph_features(rgb, cfg, bank)
    return _unpool(graph_segment_batch(feats, lab, cfg), g.pool), feats


def _segment_mincut(rgb: torch.Tensor, cfg: PipelineConfig, bank) -> torch.Tensor:
    """(B, H, W, 3) sRGB -> (B, H, W) int32 region labels of the min-cut:
    the graph front end on the device, the greedy merge on the host."""
    b, h, w, _ = rgb.shape
    g = cfg.graph
    hp, wp = h >> g.pool, w >> g.pool
    feats, sp, _ = _graph_front(rgb, cfg, bank, ncut=False)
    feats = sync("mincut_download", torch.Tensor.cpu, feats.to(torch.float32)).numpy()
    sp = sync("mincut_download", torch.Tensor.cpu, sp).numpy()
    with span("graph_cut"):
        out = np.stack([mincut_segment(feats[i].T.reshape(hp, wp, -1), sp[i].reshape(hp, wp),
                                       g.mincut_k, g.mincut_min_size) for i in range(b)])
    out = sync("mincut_upload", torch.from_numpy(out).to, rgb.device)
    return _unpool(out, g.pool)


def _can_segment_transposed(cfg: PipelineConfig, h: int, w: int) -> bool:
    """The reference's gate of the labels-only transposed path (k-means or
    GMM on K1's channel-major energies), with the card in place of its TPU:
    k <= 8 and 4,096 <= H * W <= PIPELINE_N_MAX (``fused_solver_ready``),
    no graph stage, subsample 1, the full feature set, a gamma-1 bank, K1's
    energies and a frame that fits ``tile_hw``. Everything else takes the
    NHWC path."""
    c = cfg.cluster
    tile = cfg.tile_hw
    return (fused_solver_ready(c.k, h * w, n_max=PIPELINE_N_MAX)
            and c.method in ("kmeans", "gmm")
            and not cfg.graph.enabled
            and c.subsample == 1
            and c.feature_set == "full"
            and cfg.bank.gamma == 1.0
            and cfg.feature_impl in ("auto", "pallas")
            and (tile is None or (h <= tile[0] and w <= tile[1])))


def _segment_batch_transposed(rgb: torch.Tensor, cfg: PipelineConfig, bank) -> torch.Tensor:
    """(B, H, W, 3) sRGB -> (B, H, W) int32 labels, the labels-only path
    (see _can_segment_transposed)."""
    if cfg.cluster.method == "gmm":
        return _segment_gmm(rgb, cfg, bank)
    b, h, w, _ = rgb.shape
    dtype = storage_dtype(cfg.dtype)
    c = cfg.cluster
    if c.init_stride != 1:
        # the reference's transposed route off its CHW solver: the strided
        # seeding needs the normalised buffer
        x = _normalised_buffer(rgb, cfg, bank)[0]
        with span("cluster"):
            return kmeans_fused_t_xt(x, c.k, c.n_iter, c.init_stride)[0].reshape(b, h, w)
    lvl = c.coarse_levels
    multigrid = c.coarse_iters > 0 and h >= max(4, 1 << lvl) and w >= max(4, 1 << lvl)
    # the coherence fold's statistics want the twin even without a warm start
    want_twin = multigrid or (c.cue_weight == "coherence" and h >= 16 and w >= 16)
    with span("features"):
        color = _color_transform(rgb, cfg.color_space)
        energies, twin = gabor_energies_fused(color, bank_tensors(bank, rgb.device),
                                              dtype, pooled=want_twin)
    return segment_chw_grouped(color, energies, twin if multigrid else None, cfg,
                               fold_twin=twin)


def _segment_nhwc(rgb: torch.Tensor, cfg: PipelineConfig, bank):
    """(B, H, W, 3) sRGB -> ((B, H, W) int32 labels, the features the
    clustering read): the reference's NHWC path (module docstring)."""
    if cfg.graph.enabled:
        return _segment_ncut(rgb, cfg, bank)
    b, h, w, _ = rgb.shape
    c = cfg.cluster
    feats = compute_features(rgb, cfg, bank)
    flat = feats.reshape(b, h * w, feats.shape[3])  # a view: (B, N, D) over the (B, D, N) buffer
    with span("cluster"):
        if c.method == "kmeans":
            labels, _ = kmeans_batch(flat, c.k, c.n_iter, storage_dtype(cfg.dtype),
                                     c.subsample, c.init_stride, (h, w), c.coarse_iters,
                                     c.refine_iters, c.coarse_levels, c.mid_iters)
        elif fused_solver_ready(c.k, h * w, n_max=PIPELINE_N_MAX) and c.subsample == 1:
            labels = gmm_fused_t(flat, c.k, c.n_iter, c.gmm_reg_covar, 10, c.gmm_tol, (h, w),
                                 c.gmm_fit_pool, c.gmm_refine_iters)
        else:
            labels = gmm_predict(flat, c.k, c.n_iter, c.gmm_reg_covar, c.subsample, c.gmm_tol,
                                 (h, w), c.gmm_fit_pool, c.gmm_refine_iters)
    return labels.reshape(b, h, w), feats


def _resolve_device(device) -> torch.device:
    """``None`` means the card; no path moves to the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "segment_batch runs on the NVIDIA card by default and found none "
            "(torch.cuda.is_available() is False); pass device=\"cpu\" to run "
            "the plain PyTorch versions on the CPU"
        )
    return dev


def _prepare(rgb, cfg: PipelineConfig, bank, device):
    """The entry points' common start: (rgb on the device, the bank)."""
    dev = _resolve_device(device)
    set_policy()
    if bank is None:
        bank = make_bank(cfg.bank)
    if isinstance(rgb, np.ndarray):
        rgb = torch.from_numpy(rgb)
    if rgb.device.type == "cpu" and dev.type != "cpu":
        # from pageable memory: the host waits for the queue and the copy
        return sync("upload", rgb.to, dev), bank
    return rgb.to(dev), bank


def segment_batch(
    rgb: Union[np.ndarray, torch.Tensor], cfg: PipelineConfig, bank=None,
    with_features: bool = True, device=None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, H, W, 3) uint8 (or [0, 1] float) sRGB -> ((B, H, W) int32 labels,
    (B, H, W, D) features, or None with ``with_features=False``). With the
    graph stage the features are the pooled grid's (B, H >> pool,
    W >> pool, D), the tensor the cut read. ``rgb`` is a numpy array or a
    tensor on any device; it is moved to ``device`` and the results come
    back there. ``device`` None means the card, and raises RuntimeError
    when there is none: pass ``device="cpu"`` for the CPU. ``bank``: the
    port's or the JAX package's GaborBank for cfg.bank (built when None).
    Labels only, the reference's transposed path runs where
    ``_can_segment_transposed`` holds; every other call takes the NHWC
    path."""
    if not cfg.graph.enabled and cfg.cluster.method not in ("kmeans", "gmm"):
        raise ValueError(f"unknown cluster method {cfg.cluster.method!r}")
    with span("segment"):
        rgb, bank = _prepare(rgb, cfg, bank, device)
        _, h, w, _ = rgb.shape
        if not with_features and _can_segment_transposed(cfg, h, w):
            return _segment_batch_transposed(rgb, cfg, bank), None
        labels, feats = _segment_nhwc(rgb, cfg, bank)
        return labels, (feats if with_features else None)


def segment_image(rgb: Union[np.ndarray, torch.Tensor], cfg: PipelineConfig, bank=None,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One image (H, W, 3) -> ((H, W) int32 labels, (H, W, D) features):
    row 0 of ``segment_batch`` on the batch of one."""
    labels, feats = segment_batch(rgb[None], cfg, bank, True, device)
    return labels[0], feats[0]


def segment_images(rgb: Union[np.ndarray, torch.Tensor], cfg: PipelineConfig, bank=None,
                   device=None) -> torch.Tensor:
    """Batch entry point of eval and serving: (B, H, W, 3) -> (B, H, W) int32
    on ``device`` (the card unless ``device="cpu"``), labels only (the
    transposed path where it applies). Also runs the graph stage's
    host-side min-cut (``graph.cut="mincut"``)."""
    g = cfg.graph
    if not (g.enabled and g.cut == "mincut"):
        labels, _ = segment_batch(rgb, cfg, bank, False, device)
        return labels
    with span("segment"):
        rgb, bank = _prepare(rgb, cfg, bank, device)
        return _segment_mincut(rgb, cfg, bank)
