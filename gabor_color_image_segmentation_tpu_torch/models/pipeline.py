"""Labels-only pipeline (counterpart of the JAX package's
models/pipeline.py: _color_transform, segment_chw_grouped,
_segment_batch_transposed, segment_batch, segment_images).

uint8 sRGB (B, H, W, 3), a numpy array or a tensor on any device -> int32
label maps (B, H, W) on the device the caller names (the card unless
``device="cpu"``), through the reference's production paths:

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

GMM (config2):
  1. Lab colour transform;
  2. Gabor energies without the twin (K1);
  3. the normalised (B, E + 3, N) buffer and, on the grid pooled
     ``gmm_fit_levels`` times, the fit buffer under the same affine;
  4. k-means init on the fit buffer (K6 seeds, K5 passes), EM iterations
     (K9 factors, K8 passes), the full-resolution refine passes (K8) and
     one labels-only pass (K8).

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
  3. the standardised (B, E + 3, N) features in the energies' dtype (the
     storage dtype on K1, float32 on the modulated route);
  4. SLIC superpixels on the float32 Lab (K11 under the reference's
     whole-image gate, the banded K13 above it, as models/slic_fused.py
     routes) and connectivity enforcement (K14);
  5. n-cut: superpixel means, affinity, spectral embedding and k-means,
     batched over the images (models/graph.py), then the region ids
     broadcast to pixels (K15); or min-cut: the greedy merge on the host
     per image;
  6. with pooling, each label repeated 2^pool times along both axes.

Configurations outside these slices raise NotImplementedError naming the
ROADMAP queue-1 item that will bring them, before any work.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.config import PipelineConfig
from gabor_color_image_segmentation_tpu_torch.models.connectivity import (
    enforce_connectivity_fused,
)
from gabor_color_image_segmentation_tpu_torch.models.gmm import gmm_fit_levels
from gabor_color_image_segmentation_tpu_torch.models.gmm_fused import gmm_fused_t_xt
from gabor_color_image_segmentation_tpu_torch.models.graph import (
    mincut_segment,
    ncut_regions,
    resolve_eig_method,
)
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import (
    K_MAX,
    _affine_params,
    build_color4,
    kmeans_fused_chw,
)
from gabor_color_image_segmentation_tpu_torch.models.kmeans_fused import (
    kmeans_coarse_centers_xp,
)
from gabor_color_image_segmentation_tpu_torch.models.slic import grid_shape
from gabor_color_image_segmentation_tpu_torch.models.slic_fused import slic_batch
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu_torch.ops.features import (
    _pool2x2_cm,
    assemble_xp_from_affine,
)
from gabor_color_image_segmentation_tpu_torch.ops.fused import gabor_energies_fused
from gabor_color_image_segmentation_tpu_torch.ops.lookup import table_lookup
from gabor_color_image_segmentation_tpu_torch.ops.modulated import gabor_energies_mod
from gabor_color_image_segmentation_tpu_torch.ops.precision import (
    set_policy,
    storage_dtype,
)
from gabor_color_image_segmentation_tpu_torch.ops.tiled import (
    gabor_energies_tiled,
    pool2x2_mean,
)


# The reference's pixel-count range of its transposed pixel clustering:
# fused_solver_eligible's 4096 <= n and models/kmeans.py's PIPELINE_N_MAX
# (copied, not imported). Outside it the reference clusters on its NHWC path.
PIXELS_MIN = 4096
PIXELS_MAX = 2_000_000


def _check_supported(cfg: PipelineConfig, with_features: bool, hw: Tuple[int, int],
                     device: torch.device) -> None:
    """Raise NotImplementedError, naming the ROADMAP item or fault, for what
    the port does not run yet; ``hw`` is the frame's (H, W), ``device``
    where it would run. Allocates nothing."""
    c, g = cfg.cluster, cfg.graph
    tile = cfg.tile_hw
    nhwc = "queue 1 item 14 (the NHWC / with-features path)"
    features = "queue 1 item 13 (the rest of the feature stage)"
    # the graph stage replaces the pixel clustering, so the solver's own
    # options do not apply to it
    solver = not g.enabled
    unsupported = [
        (with_features, "with_features=True", nhwc),
        (g.enabled and c.cue_weight != "static",
         f"the graph stage with cue_weight={c.cue_weight!r}", nhwc),
        (solver and c.method not in ("kmeans", "gmm"), f"method={c.method!r}", nhwc),
        # the reference sends k > 8 to its NHWC solver (fused_solver_eligible)
        (solver and c.k > K_MAX, f"the pixel clustering with k={c.k} > {K_MAX}", nhwc),
        # a frame larger than the tile leaves the reference's transposed
        # clustering path for its NHWC one
        (solver and tile is not None and (hw[0] > tile[0] or hw[1] > tile[1]),
         "the pixel clustering on a frame larger than tile_hw (the NHWC path)", nhwc),
        (c.feature_set != "full", f"feature_set={c.feature_set!r}", nhwc),
        # gmm with subsample > 1 is the reference's gmm_predict (NHWC solver)
        (solver and c.subsample != 1, f"{c.method} with subsample={c.subsample}", nhwc),
        (cfg.bank.gamma != 1.0, f"bank gamma={cfg.bank.gamma}", features),
        (solver and c.method == "kmeans" and c.init_stride != 1,
         f"init_stride={c.init_stride}", nhwc),
        # the reference's transposed pixel clustering takes the fused
        # kernel's energies only; another impl leaves it for the NHWC path
        (solver and cfg.feature_impl not in ("auto", "pallas"),
         f"the pixel clustering with feature_impl={cfg.feature_impl!r}", nhwc),
        (cfg.feature_impl not in ("auto", "pallas", "modulated"),
         f"feature_impl={cfg.feature_impl!r}", features),
        # the reference's transposed pixel clustering takes frames of
        # [PIXELS_MIN, PIXELS_MAX] pixels; the graph stage has no such gate
        (solver and not PIXELS_MIN <= hw[0] * hw[1] <= PIXELS_MAX,
         f"the pixel clustering on a frame of {hw[0] * hw[1]} pixels, outside the "
         f"reference's transposed range [{PIXELS_MIN}, {PIXELS_MAX}] (the NHWC path)", nhwc),
    ]
    for bad, what, item in unsupported:
        if bad:
            raise NotImplementedError(
                f"the PyTorch port does not run {what} yet: ROADMAP {item}"
            )


def _color_transform(rgb: torch.Tensor, color_space: str) -> torch.Tensor:
    if rgb.dtype == torch.uint8:
        rgb = rgb.to(torch.float32) / 255.0
    if color_space == "lab":
        return rgb_to_lab(rgb)
    return rgb.to(torch.float32)


def segment_chw_grouped(
    color: torch.Tensor,
    energies: torch.Tensor,
    pooled_e: Optional[torch.Tensor],
    cfg: PipelineConfig,
    fold_twin: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """k-means on precomputed channel-major energies (B, E, H, W).

    color: (B, H, W, 3); pooled_e: the 2x2 twin (B, E, H//2, W//2) to run
    the multigrid warm start on, or None for none; fold_twin: the twin for
    the coherence statistics when there is no warm start."""
    _, h, w, _ = color.shape
    dtype = energies.dtype
    c = cfg.cluster
    multigrid = pooled_e is not None
    xc4 = build_color4(color, dtype)
    twin = fold_twin if fold_twin is not None else pooled_e
    pc0 = _pool2x2_cm(xc4) if (multigrid or twin is not None) else None
    affine = _affine_params(energies, xc4, c, 1e-6,
                            pooled=(twin, pc0) if twin is not None else None)
    c0 = None
    if multigrid:
        pe_l, pc_l = pooled_e, pc0
        levels = [(pe_l, pc_l)]  # pooled twins, finest first
        for _ in range(c.coarse_levels - 1):
            pe_l, pc_l = _pool2x2_cm(pe_l), _pool2x2_cm(pc_l)
            levels.append((pe_l, pc_l))
        e = energies.shape[1]
        m = pe_l.shape[2] * pe_l.shape[3]
        xp = assemble_xp_from_affine(pe_l, pc_l, affine[0], affine[1], dtype)
        c0 = kmeans_coarse_centers_xp(xp, c.k, e + 3, m, c.coarse_iters)
        if c.mid_iters > 0:
            for pe_m, pc_m in reversed(levels[:-1]):
                _, c0 = kmeans_fused_chw(pe_m, pc_m, affine, c.k, 0, c.mid_iters,
                                         init_centers=c0, with_labels=False)
    labels, _ = kmeans_fused_chw(energies, xc4, affine, c.k, c.n_iter,
                                 c.refine_iters, init_centers=c0)
    return labels


def _segment_gmm(rgb: torch.Tensor, cfg: PipelineConfig, bank) -> torch.Tensor:
    """(B, H, W, 3) sRGB -> (B, H, W) int32 labels of the per-image GMM."""
    b, h, w, _ = rgb.shape
    dtype = storage_dtype(cfg.dtype)
    c = cfg.cluster
    color = _color_transform(rgb, cfg.color_space)
    energies, _ = gabor_energies_fused(color, bank_tensors(bank, rgb.device), dtype,
                                       pooled=False)
    # One affine for both buffers, from the float32 colour as the JAX
    # package's _norm_affine reads it for the full-resolution buffer; its
    # fit buffer's affine reads the colour rounded to the storage dtype, so
    # in bfloat16 the colour rows' moments differ by that rounding.
    c4 = build_color4(color, torch.float32)
    a, b_aff = _affine_params(energies, c4, c, 1e-6)
    x = assemble_xp_from_affine(energies, c4, a, b_aff, dtype)
    fit_x = None
    _, _, lv = gmm_fit_levels(h, w, c.gmm_fit_pool)
    if lv > 0:
        pe, pc = energies, build_color4(color, dtype)
        for _ in range(lv):
            pe, pc = _pool2x2_cm(pe), _pool2x2_cm(pc)
        fit_x = assemble_xp_from_affine(pe, pc, a, b_aff, dtype)
    del energies
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


def compute_energies(rgb: torch.Tensor, cfg: PipelineConfig, bank, pool: int = 0):
    """(B, H, W, 3) sRGB -> ((B, E, H >> pool, W >> pool) energies, (B, H, W,
    3) float32 colour), by ``cfg.feature_impl`` as the reference picks its
    energies function: "auto" and "pallas" run K1 (the reference's choice
    on its accelerator) in the storage dtype, "modulated" the modulated
    route in float32. Frames larger than ``cfg.tile_hw`` run window by
    window and pool per window; others run whole and pool the stored
    energies after."""
    dtype = storage_dtype(cfg.dtype)
    color = _color_transform(rgb, cfg.color_space)
    fn = _modulated_energies if cfg.feature_impl == "modulated" else _k1_energies
    _, h, w, _ = color.shape
    tile = cfg.tile_hw
    if tile is not None and (h > tile[0] or w > tile[1]):
        return gabor_energies_tiled(color, bank_tensors(bank, rgb.device), dtype, tile,
                                    bank.config.max_halo, pool,
                                    energies_fn=lambda win: fn(win, bank, dtype)), color
    energies = fn(color, bank, dtype)
    for _ in range(pool):
        energies = pool2x2_mean(energies, 2)
    return energies, color


def _graph_front(rgb: torch.Tensor, cfg: PipelineConfig, bank, ncut: bool = True):
    """(B, H, W, 3) sRGB -> ((B, E + 3, n) standardised features, (B, n)
    int32 connected superpixels of the float32 Lab, their count S), n the
    pixels of the grid pooled ``graph.pool`` times.

    The energies follow the reference's graph dispatch: for the n-cut
    (``ncut``) with ``feature_impl="auto"``, batch 1 or float32 takes the
    modulated route and bf16 batches K1; the min-cut route takes
    ``cfg.feature_impl`` as it is. The features are the reference's
    assemble_features on the pooled energies and the pooled float32 colour,
    in the energies' dtype (bf16 from K1 in bf16 mode, else float32): the
    colour rounded to that dtype before the per-image moments, the
    sqrt(E/3) colour balance, static cue weights."""
    b, h, w, _ = rgb.shape
    g = cfg.graph
    p = g.pool
    if p and (h % (1 << p) or w % (1 << p)):
        raise ValueError(f"graph.pool={p} needs H, W divisible by {1 << p}, got {h}x{w}")
    fcfg = cfg
    if ncut and cfg.feature_impl == "auto" and (b == 1 or cfg.dtype == "float32"):
        fcfg = cfg.replace(feature_impl="modulated")
    energies, color = compute_energies(rgb, fcfg, bank, p)
    fdt = energies.dtype
    same = cfg.color_space == "lab"
    lab = color if same else _color_transform(rgb, "lab")
    for _ in range(p):
        color = pool2x2_mean(color, 1)
        lab = color if same else pool2x2_mean(lab, 1)
    c4 = build_color4(color, fdt)
    a, b_aff = _affine_params(energies, c4, cfg.cluster, 1e-6)
    feats = assemble_xp_from_affine(energies, c4, a, b_aff, fdt)
    del energies, c4
    hp, wp = h >> p, w >> p
    gh, gw, _ = grid_shape(hp, wp, g.n_superpixels)
    sp = slic_batch(lab, g.n_superpixels, g.slic_compactness, g.slic_iters)
    sp = enforce_connectivity_fused(sp, gh * gw)
    return feats, sp.reshape(b, hp * wp), gh * gw


def _unpool(labels: torch.Tensor, pool: int) -> torch.Tensor:
    """(B, h, w) labels of the pooled grid -> each repeated 2^pool times
    along both axes."""
    f = 1 << pool
    return labels.repeat_interleave(f, dim=1).repeat_interleave(f, dim=2) if pool else labels


def _segment_ncut(rgb: torch.Tensor, cfg: PipelineConfig, bank) -> torch.Tensor:
    """(B, H, W, 3) sRGB -> (B, H, W) int32 region labels of the n-cut."""
    b, h, w, _ = rgb.shape
    g = cfg.graph
    if g.cut != "ncut":
        raise ValueError(f"cut={g.cut!r} is host-side (see mincut_segment); "
                         "use pipeline.segment_images")
    feats, sp, n_sp = _graph_front(rgb, cfg, bank)
    regions = ncut_regions(feats, sp, n_sp, g.n_regions, g.affinity_sigma,
                           resolve_eig_method(g, cfg.dtype, rgb.device),
                           g.affinity_sigma_scale)
    return _unpool(table_lookup(sp, regions).reshape(b, h >> g.pool, w >> g.pool), g.pool)


def _segment_mincut(rgb: torch.Tensor, cfg: PipelineConfig, bank) -> torch.Tensor:
    """(B, H, W, 3) sRGB -> (B, H, W) int32 region labels of the min-cut:
    the graph front end on the device, the greedy merge on the host."""
    b, h, w, _ = rgb.shape
    g = cfg.graph
    hp, wp = h >> g.pool, w >> g.pool
    feats, sp, _ = _graph_front(rgb, cfg, bank, ncut=False)
    feats = feats.to(torch.float32).cpu().numpy()
    sp = sp.cpu().numpy()
    out = np.stack([mincut_segment(feats[i].T.reshape(hp, wp, -1), sp[i].reshape(hp, wp),
                                   g.mincut_k, g.mincut_min_size) for i in range(b)])
    return _unpool(torch.from_numpy(out).to(rgb.device), g.pool)


def _segment_batch_transposed(rgb: torch.Tensor, cfg: PipelineConfig, bank) -> torch.Tensor:
    """(B, H, W, 3) sRGB -> (B, H, W) int32 labels, the production path."""
    if cfg.graph.enabled:
        return _segment_ncut(rgb, cfg, bank)
    if cfg.cluster.method == "gmm":
        return _segment_gmm(rgb, cfg, bank)
    _, h, w, _ = rgb.shape
    dtype = storage_dtype(cfg.dtype)
    c = cfg.cluster
    lvl = c.coarse_levels
    multigrid = c.coarse_iters > 0 and h >= max(4, 1 << lvl) and w >= max(4, 1 << lvl)
    # the coherence fold's statistics want the twin even without a warm start
    want_twin = multigrid or (c.cue_weight == "coherence" and h >= 16 and w >= 16)
    color = _color_transform(rgb, cfg.color_space)
    energies, twin = gabor_energies_fused(color, bank_tensors(bank, rgb.device),
                                          dtype, pooled=want_twin)
    return segment_chw_grouped(color, energies, twin if multigrid else None, cfg,
                               fold_twin=twin)


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


def segment_batch(
    rgb: Union[np.ndarray, torch.Tensor], cfg: PipelineConfig, bank=None,
    with_features: bool = True, device=None,
) -> Tuple[torch.Tensor, None]:
    """(B, H, W, 3) uint8 (or [0, 1] float) sRGB -> ((B, H, W) int32 labels,
    None). ``rgb`` is a numpy array or a tensor on any device; it is moved
    to ``device`` and the labels come back there. ``device`` None means the
    card, and raises RuntimeError when there is none: pass ``device="cpu"``
    for the CPU. ``bank``: the port's or the JAX package's GaborBank for
    cfg.bank (built when None). Only the labels-only paths are ported: pass
    ``with_features=False``. The default, True as in the reference, raises
    NotImplementedError naming ROADMAP queue 1 item 14."""
    dev = _resolve_device(device)
    _check_supported(cfg, with_features, tuple(rgb.shape[1:3]), dev)
    set_policy()
    if bank is None:
        bank = make_bank(cfg.bank)
    if isinstance(rgb, np.ndarray):
        rgb = torch.from_numpy(rgb)
    return _segment_batch_transposed(rgb.to(dev), cfg, bank), None


def segment_images(rgb: Union[np.ndarray, torch.Tensor], cfg: PipelineConfig, bank=None,
                   device=None) -> torch.Tensor:
    """Batch entry point of eval and serving: (B, H, W, 3) -> (B, H, W) int32
    on ``device`` (the card unless ``device="cpu"``). Also runs the graph
    stage's host-side min-cut (``graph.cut="mincut"``)."""
    g = cfg.graph
    if not (g.enabled and g.cut == "mincut"):
        labels, _ = segment_batch(rgb, cfg, bank, False, device)
        return labels
    dev = _resolve_device(device)
    _check_supported(cfg, False, tuple(rgb.shape[1:3]), dev)
    set_policy()
    if bank is None:
        bank = make_bank(cfg.bank)
    if isinstance(rgb, np.ndarray):
        rgb = torch.from_numpy(rgb)
    return _segment_mincut(rgb.to(dev), cfg, bank)
