"""SLIC superpixels on the card: kernels K11, K12 and K13 (counterpart of the
JAX package's models/slic_pallas.py: _plan, slic_fused_eligible, the fuse
gate, slic_fused and slic_batch, with its ``impl``).

All three compute the exact-float32 SLIC of ``slic_plain`` (models/slic.py)
and give the same labels; the reference's band plan decides which one runs,
so each frame runs the counterpart of the kernel the reference runs there
(``slic_route``):

- K11 ``slic_w3`` (csrc/slic.cu) replaces ``_slic_all_kernel_w3``, the
  reference's default under its 8.5 MB whole-image gate: every iteration
  of a batch from one C call, 2 * n_iter + 1 launches: n_iter passes that
  assign the pixels of each tile of grid cells (``slic_w3_plan``) and
  write the tile's partial moments, each followed by an update of one warp
  a superpixel, then a pass that only assigns. ``slic_w3_pass`` and
  ``slic_w3_update`` launch one of each (their plain versions
  ``slic_w3_pass_plain`` and ``slic_w3_update_plain``).
- K12 ``slic_w5`` (csrc/slic_banded.cu) replaces ``_slic_all_kernel``, the
  whole-image kernel on uniform ``w_rows`` bands that ``plan="w5"``
  selects under the gate: every iteration in one launch, a thread-block
  cluster an image (``slic_w5_plan``) whose CTAs trade their pieces'
  partials through distributed shared memory.
- K13 ``slic_band_pass`` (csrc/slic_banded.cu) replaces ``_slic_kernel``,
  one banded pass per launch, which the reference runs above the gate
  (config4's pooled 540x960 grid): ``slic_banded`` drives n_iter + 1
  passes and a centroid update after each but the last.

A band is ``band_rows`` pixel rows; its pixels' candidates lie in the
``w_rows`` grid rows from the band's first candidate row ``rb``. The kernels
split each band further into column pieces of ``_BAND_COLS`` pixel columns
(so that config4's 136 (image, band) pieces become enough blocks to fill
the card), so a pass writes, per band, per column piece and per candidate
of the band's window, the float64 sums [L, a, b, y, x, count] of the pixels
that took it: the (B, n_bands, n_col_pieces, w_rows * gw, 6) partials, the
reference's psums split along the columns. The update adds the partials of
the bands whose window holds a superpixel, in band order and within a band
in column order, rounds once to float32 and keeps an empty superpixel's
centroid. On the
Lab of uint8 images (and its 2x2 means) every value lies on a 2^-31 grid,
so these float64 sums are exact at the sizes the presets run and any
summation order gives the same bits; the kernels sum in a fixed order all
the same, since the centroids decide the labels. The TPU kernels' bf16x3
scores, penalty dot and 128-lane window answered Mosaic, not the problem;
only the band plan is kept.

The wrappers launch the kernels for CUDA tensors and run the plain
versions for CPU tensors: ``slic_plain`` for K11, ``slic_band_pass_plain``
and ``slic_band_update_plain`` for K13, and ``slic_banded_plain``, the
banded loop on those, for K12 (whose one launch runs the same loop).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.models.slic import (
    _assign,
    _candidates,
    _f32,
    _pixel_rows,
    _weighted,
    cell_index,
    grid_shape,
    slic_geometry,
    slic_init_centroids,
    slic_plain,
    slic_update,
)

_C = 8  # the reference's packed z channels (its gate is sized on them)
_CAND = 128  # the reference's candidate window, one lane tile
# The reference's whole-image gate (slic_pallas.py:456): frames whose
# packed bf16x3 image 3 * _C * hp * wp * 2 bytes exceeds it take the
# banded launch-per-pass loop.
_SLIC_FUSE_BYTES = int(8.5 * 2**20)
_BAND_COLS = 128  # pixel columns of a K12/K13 column piece (csrc/slic_banded.cu)


def slic_plan(h: int, w: int, n_superpixels: int) -> Optional[dict]:
    """The reference's static band plan (slic_pallas.py::_plan), or None
    when no plan fits its 128-candidate window. ``w_rows`` 0 marks the
    w3-only geometry (no uniform bands)."""
    gh, gw, s = grid_shape(h, w, n_superpixels)
    w_rows = band_rows = None
    for wr in (5, 4):
        wr = min(wr, gh)
        if wr * gw > _CAND:
            continue
        if gh > wr:
            # every pixel's cell row +- 1 inside the window:
            # (band_rows - 1) * gh < (wr - 3) * h
            br = 32
            while br > 1 and (br - 1) * gh >= (wr - 3) * h:
                br -= 1
        else:
            br = 32  # the window covers the whole grid
        w_rows, band_rows = wr, br
        break
    if w_rows is None:
        if min(3, gh) * gw <= _CAND:
            w_rows, band_rows = 0, 1
        else:
            return None
    wp = -(-w // 128) * 128
    n_bands = -(-h // band_rows)
    hp = n_bands * band_rows
    rb = [max(0, min(int(t * band_rows * gh / h) - 1, gh - w_rows)) for t in range(n_bands)]
    w3 = min(3, gh)
    cy = np.minimum(gh - 1, (np.arange(hp, dtype=np.float32)
                             * np.float32(gh / h)).astype(np.int32))
    ys3 = [0] * (gh + 1)
    for g in range(1, gh):
        ys3[g] = int(np.searchsorted(cy, g, side="left"))
    ys3[gh] = hp
    rb3 = [max(0, min(g - 1, gh - w3)) for g in range(gh)]
    return dict(gh=gh, gw=gw, s=s, w_rows=w_rows, band_rows=band_rows, wp=wp, hp=hp,
                n_bands=n_bands, rb=np.asarray(rb, np.int32), n_sp=gh * gw, w3=w3,
                ys3=tuple(ys3), rb3=tuple(rb3))


def _fits_gate(bp: dict) -> bool:
    return 3 * _C * bp["hp"] * bp["wp"] * 2 <= _SLIC_FUSE_BYTES


def slic_fused_eligible(h: int, w: int, n_superpixels: int) -> bool:
    """Whether the reference runs one of its SLIC kernels on this frame
    (slic_pallas.py::slic_fused_eligible); otherwise its XLA ``slic``."""
    bp = slic_plan(h, w, n_superpixels)
    if bp is None:
        return False
    return bp["w_rows"] > 0 or _fits_gate(bp)


def slic_route(h: int, w: int, n_superpixels: int, plan: str = "auto") -> str:
    """Which kernel runs this frame: "w3" (K11), "w5" (K12) or "banded"
    (K13), as the reference's slic_fused chooses between its kernels.

    Under the gate ``plan`` "auto" or "w3" is K11 and "w5" K12; above it a
    uniform-band plan is K13, and an explicit plan raises (the banded loop
    is plan-free). Where the reference has no kernel (a w3-only frame above
    the gate, a grid too wide for any window) it runs its XLA ``slic``,
    and K11, which has the same semantics and no window, runs here. K11
    also takes a banded or w5 frame whose band plan misses a band's
    candidate rows (``band_plan_ok`` False), for "auto" and "w5" alike.

    The choice mirrors the reference's kernel choice; it is not a policy
    for the GPU. The gate is sized on the TPU's packed bf16x3 image in
    VMEM, which says nothing of this card, and all three kernels give the
    same labels: the route only keeps each preset on the counterpart of
    the kernel the reference runs there."""
    if plan not in ("auto", "w3", "w5"):
        raise ValueError(f"unknown SLIC plan {plan!r}")
    if not slic_fused_eligible(h, w, n_superpixels):
        return "w3"
    bp = slic_plan(h, w, n_superpixels)
    if bp["w_rows"] == 0:
        if plan == "w5":
            raise ValueError(f"plan='w5' ineligible at this geometry (5*{bp['gw']} grid "
                             "cols exceed the 128-candidate window; w3-only plan)")
        return "w3"
    if _fits_gate(bp):
        route = "w5" if plan == "w5" else "w3"
    elif plan != "auto":
        raise ValueError(f"plan={plan!r} requested but image ({h}x{w}) exceeds the "
                         "whole-image fuse gate; the banded loop is plan-free: pass "
                         "plan='auto'")
    else:
        route = "banded"
    # a band plan whose window misses a band's candidate rows: K11, with no
    # window, where the reference runs its kernel with the missing row
    # penalised or (f32, off the TPU) its XLA slic
    return route if route == "w3" or band_plan_ok(h, w, n_superpixels) else "w3"


def _band_missing_rows(h: int, w: int, n_superpixels: int) -> Optional[int]:
    """The first band of the uniform-band plan whose window misses one of
    its pixels' candidate rows (their float32 cell row +- 1), or None when
    every band holds them. The plan's ``rb`` is the reference's float64
    ``int(y0 * gh / h) - 1``; where y0 * gh / h is an exact integer the
    float32 cell can fall a row short of it (1288x481 at S = 900, band 23)."""
    bp = slic_plan(h, w, n_superpixels)
    gh, wr, br = bp["gh"], bp["w_rows"], bp["band_rows"]
    cy = cell_index(h, gh, "cpu").numpy()
    for t, rb in enumerate(bp["rb"]):
        rows = cy[t * br:(t + 1) * br]
        if not (max(int(rows.min()) - 1, 0) >= rb and min(int(rows.max()) + 1, gh - 1) < rb + wr):
            return t
    return None


@functools.lru_cache(maxsize=None)
def band_plan_ok(h: int, w: int, n_superpixels: int) -> bool:
    """Whether the frame has a uniform-band plan (K12, K13) whose every
    band's window holds its pixels' candidate rows. Cached: the check runs
    on the host, once a geometry."""
    bp = slic_plan(h, w, n_superpixels)
    return (bp is not None and bp["w_rows"] > 0
            and _band_missing_rows(h, w, n_superpixels) is None)


@functools.lru_cache(maxsize=None)
def _band_plan(h: int, w: int, n_superpixels: int) -> dict:
    """The uniform-band plan of K12 and K13, checked (``band_plan_ok``);
    raises where a direct ``slic_banded`` or ``slic_w5`` call meets a frame
    that ``slic_route`` sends to K11."""
    bp = slic_plan(h, w, n_superpixels)
    _kernels.check(bp is not None and bp["w_rows"] > 0,
                   f"no uniform-band SLIC plan at {h}x{w} with {n_superpixels} superpixels")
    t = _band_missing_rows(h, w, n_superpixels)
    _kernels.check(t is None, f"band {t} of the SLIC plan misses candidate rows")
    return bp


def _check_lab(lab: torch.Tensor) -> None:
    _kernels.check(lab.dim() == 4 and lab.shape[3] == 3, "lab must be (B, H, W, 3)")
    _kernels.check(lab.dtype == torch.float32, f"lab must be float32, got {lab.dtype}")


def _scales(h: int, w: int, bp: dict, sw: float):
    """The kernels' float32 cell scales gh / h, gw / w and spatial weight
    (``bp``: a band plan or K11's plan)."""
    return (float(np.float32(bp["gh"] / h)), float(np.float32(bp["gw"] / w)),
            float(np.float32(sw)))


# ---------------------------------------------------------------------------
# K11: cell-aligned whole-image SLIC
# ---------------------------------------------------------------------------

_W3_TILE_PX = (24, 48)  # pixel rows and columns a K11 pass block aims at
_W3_MAX_CELLS = 128  # hoisted cells a tile, (ty + 2)(tx + 2): csrc/slic.cu's LWMAX


@functools.lru_cache(maxsize=None)
def slic_w3_plan(h: int, w: int, n_superpixels: int) -> dict:
    """K11's geometry, mirrored by csrc/slic.cu. A pass block takes a tile
    of ``ty`` x ``tx`` grid cells (about ``_W3_TILE_PX`` pixels; the last
    tiles of a row or column take what is left): the pixels whose float32
    cell (``cell_index``) lies in it, pixel rows ``rows[a]`` ..
    ``rows[a + 1]`` by columns ``cols[c]`` .. ``cols[c + 1]``. It hoists the
    centroids of its cells +- 1, ``cells`` = (ty + 2)(tx + 2) of them
    (local index (gy - a ty + 1)(tx + 2) + gx - c tx + 1, those outside
    the grid unused), which hold every candidate of its pixels, and writes
    a partial [L, a, b, y, x, count] for each: (B,) + ``parts_shape``."""
    gh, gw, _ = grid_shape(h, w, n_superpixels)
    ty = max(1, min(gh, round(_W3_TILE_PX[0] * gh / h)))
    tx = max(1, min(gw, round(_W3_TILE_PX[1] * gw / w)))
    while (ty + 2) * (tx + 2) > _W3_MAX_CELLS:
        if tx > ty:
            tx -= 1
        else:
            ty -= 1
    nty, ntx = -(-gh // ty), -(-gw // tx)

    def bounds(n, g, t, nt):
        cells = cell_index(n, g, "cpu").numpy()
        return tuple(int(np.searchsorted(cells, a * t, side="left")) for a in range(nt)) + (n,)

    cells = (ty + 2) * (tx + 2)
    return dict(gh=gh, gw=gw, ty=ty, tx=tx, nty=nty, ntx=ntx,
                rows=bounds(h, gh, ty, nty), cols=bounds(w, gw, tx, ntx), cells=cells,
                parts_shape=(nty, ntx, cells, 6))


@functools.lru_cache(maxsize=None)
def _w3_bounds(h: int, w: int, n_superpixels: int, device: str):
    """The plan's tile rows and columns as int32 tensors on ``device``."""
    plan = slic_w3_plan(h, w, n_superpixels)
    return tuple(torch.tensor(plan[k], dtype=torch.int32, device=device)
                 for k in ("rows", "cols"))


def _w3_args(lab: torch.Tensor, plan: dict, n_superpixels: int, sw: float):
    """The plan's arguments of the C entry points, after the tensors."""
    b, h, w, _ = lab.shape
    rows, cols = _w3_bounds(h, w, n_superpixels, str(lab.device))
    return ((rows.data_ptr(), cols.data_ptr(), b, h, w, plan["gh"], plan["gw"], plan["ty"],
             plan["tx"]), _scales(h, w, plan, sw))


def slic_w3_pass_plain(lab: torch.Tensor, cent: torch.Tensor, plan: dict, sw: float,
                       partials: bool = True):
    """Plain version of one K11 pass: (labels (B, H, W) int32 of one
    assignment under ``cent`` (B, S, 5), partials (B,) + plan
    ``parts_shape`` float64 or None)."""
    b, h, w, _ = lab.shape
    gh, gw, dev = plan["gh"], plan["gw"], lab.device
    swt = _f32(sw, dev)
    rows = _pixel_rows(lab)
    cand, ok = _candidates(h, w, gh, gw, dev)
    labels = _assign(_weighted(rows, swt), cent, cand, ok, swt)  # (B, N) int64
    out = labels.to(torch.int32).reshape(b, h, w)
    if not partials:
        return out, None
    ty, tx, nty, ntx, cells = (plan[k] for k in ("ty", "tx", "nty", "ntx", "cells"))
    ta = (cell_index(h, gh, dev) // ty)[:, None].expand(h, w).reshape(-1)  # (N,)
    tc = (cell_index(w, gw, dev) // tx)[None, :].expand(h, w).reshape(-1)
    local = (labels // gw - ta * ty + 1) * (tx + 2) + labels % gw - tc * tx + 1
    slot = ((torch.arange(b, device=dev)[:, None] * nty + ta) * ntx + tc) * cells + local
    vals = torch.cat([rows.to(torch.float64),
                      torch.ones((b, h * w, 1), dtype=torch.float64, device=dev)], dim=2)
    sums = torch.zeros((b * nty * ntx * cells, 6), dtype=torch.float64, device=dev)
    sums.index_add_(0, slot.reshape(-1), vals.reshape(-1, 6))
    return out, sums.reshape((b,) + plan["parts_shape"])


def slic_w3_moments(parts: torch.Tensor, plan: dict) -> torch.Tensor:
    """(B, S, 6) float64 [L, a, b, y, x, count] of each superpixel: its
    partials added over the tiles that hoist it, tile rows then tile
    columns in order."""
    gh, gw, ty, tx = plan["gh"], plan["gw"], plan["ty"], plan["tx"]
    g = torch.zeros((parts.shape[0], gh * gw, 6), dtype=torch.float64, device=parts.device)
    for a in range(plan["nty"]):
        for c in range(plan["ntx"]):
            gy = torch.arange(a * ty - 1, a * ty + ty + 1)
            gx = torch.arange(c * tx - 1, c * tx + tx + 1)
            gy, gx = gy[(gy >= 0) & (gy < gh)], gx[(gx >= 0) & (gx < gw)]
            ids = (gy[:, None] * gw + gx[None, :]).reshape(-1)
            local = ((gy - a * ty + 1)[:, None] * (tx + 2) + gx - c * tx + 1).reshape(-1)
            g[:, ids.to(parts.device)] += parts[:, a, c, local.to(parts.device)]
    return g


def slic_w3_update_plain(cent: torch.Tensor, parts: torch.Tensor, plan: dict) -> torch.Tensor:
    """Plain version of K11's update: ``slic_w3_moments``, then the centroid
    step."""
    g = slic_w3_moments(parts, plan)
    return slic_update(cent, g[..., :5], g[..., 5])


def slic_w3_pass(lab: torch.Tensor, cent: torch.Tensor, n_superpixels: int, sw: float,
                 partials: bool = True):
    """One K11 pass: (B, H, W, 3) float32 Lab and (B, S, 5) float32
    centroids -> ((B, H, W) int32 labels, (B,) + ``slic_w3_plan``'s
    ``parts_shape`` float64 partials or None)."""
    _check_lab(lab)
    b, h, w, _ = lab.shape
    plan = slic_w3_plan(h, w, n_superpixels)
    n_sp = plan["gh"] * plan["gw"]
    _kernels.check(tuple(cent.shape) == (b, n_sp, 5) and cent.dtype == torch.float32,
                   f"cent must be ({b}, {n_sp}, 5) float32")
    if _kernels.use_plain(lab, cent):
        return slic_w3_pass_plain(lab, cent, plan, sw, partials)
    lab, cent = lab.contiguous(), cent.contiguous()
    labels = torch.empty((b, h, w), dtype=torch.int32, device=lab.device)
    parts = (torch.empty((b,) + plan["parts_shape"], dtype=torch.float64, device=lab.device)
             if partials else None)
    geom, scales = _w3_args(lab, plan, n_superpixels, sw)
    _kernels.launch("gcis_slic_w3_pass", lab.data_ptr(), cent.data_ptr(), labels.data_ptr(),
                    parts.data_ptr() if partials else None, *geom, *scales,
                    outputs=(parts,) if partials else ())
    slic_w3_pass.launches += 1
    return labels, parts


slic_w3_pass.launches = 0


def slic_w3_update(cent: torch.Tensor, parts: torch.Tensor, h: int, w: int,
                   n_superpixels: int) -> torch.Tensor:
    """One K11 update (one warp a superpixel): the new (B, S, 5) centroids
    from a pass's partials. On the card ``cent`` is updated in place and
    returned."""
    plan = slic_w3_plan(h, w, n_superpixels)
    b = cent.shape[0]
    _kernels.check(tuple(cent.shape) == (b, plan["gh"] * plan["gw"], 5)
                   and cent.dtype == torch.float32, "cent must be (B, S, 5) float32")
    _kernels.check(tuple(parts.shape) == (b,) + plan["parts_shape"]
                   and parts.dtype == torch.float64, "parts must be the pass's partials")
    if _kernels.use_plain(cent, parts):
        return slic_w3_update_plain(cent, parts, plan)
    _kernels.check(cent.is_contiguous() and parts.is_contiguous(),
                   "cent and parts must be contiguous")
    _kernels.launch("gcis_slic_w3_update", parts.data_ptr(), cent.data_ptr(), b, plan["gh"],
                    plan["gw"], plan["ty"], plan["tx"], outputs=(cent,))
    slic_w3_update.launches += 1
    return cent


slic_w3_update.launches = 0


def slic_w3(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
            n_iter: int = 10) -> torch.Tensor:
    """K11: (B, H, W, 3) float32 Lab -> (B, H, W) int32 superpixel labels in
    [0, gh * gw): n_iter passes with partials and updates and a last
    assignment, 2 n_iter + 1 launches from one C call."""
    _check_lab(lab)
    _kernels.check(n_iter >= 0, f"n_iter must be >= 0, got {n_iter}")
    if _kernels.use_plain(lab):
        return slic_plain(lab, n_superpixels, ruler, n_iter)
    b, h, w, _ = lab.shape
    plan = slic_w3_plan(h, w, n_superpixels)
    _, _, sw = slic_geometry(h, w, n_superpixels, ruler)
    lab = lab.contiguous()
    cent = slic_init_centroids(lab, plan["gh"], plan["gw"])  # updated in place
    labels = torch.empty((b, h, w), dtype=torch.int32, device=lab.device)
    parts = torch.empty((b,) + plan["parts_shape"], dtype=torch.float64, device=lab.device)
    geom, scales = _w3_args(lab, plan, n_superpixels, sw)
    _kernels.launch("gcis_slic", lab.data_ptr(), cent.data_ptr(), labels.data_ptr(),
                    parts.data_ptr(), *geom, n_iter, *scales, outputs=(cent,))
    slic_w3.launches += 1
    return labels


slic_w3.launches = 0


# ---------------------------------------------------------------------------
# K13: one banded pass per launch, and the loop around it
# ---------------------------------------------------------------------------


def _n_col_pieces(w: int, cols: int) -> int:
    _kernels.check(cols >= 1, f"cols must be >= 1, got {cols}")
    return -(-w // cols)


def slic_band_pass_plain(lab: torch.Tensor, cent: torch.Tensor, bp: dict, sw: float,
                         partials: bool = True, cols: int = _BAND_COLS):
    """Plain version of K13: (labels (B, H, W) int32 of one assignment
    under ``cent`` (B, S, 5), partials (B, n_bands, ceil(W / cols),
    w_rows * gw, 6) float64 or None)."""
    b, h, w, _ = lab.shape
    gh, gw, dev = bp["gh"], bp["gw"], lab.device
    swt = _f32(sw, dev)
    rows = _pixel_rows(lab)
    cand, ok = _candidates(h, w, gh, gw, dev)
    labels = _assign(_weighted(rows, swt), cent, cand, ok, swt)  # (B, N) int64
    out = labels.to(torch.int32).reshape(b, h, w)
    if not partials:
        return out, None
    nb, ncp, ncr = bp["n_bands"], _n_col_pieces(w, cols), bp["w_rows"] * gw
    band = (torch.arange(h, device=dev) // bp["band_rows"]).repeat_interleave(w)  # (N,)
    piece = (torch.arange(w, device=dev) // cols).repeat(h)  # (N,)
    rb = torch.from_numpy(bp["rb"]).to(dev).long()
    slot = (((torch.arange(b, device=dev)[:, None] * nb + band) * ncp + piece) * ncr
            + labels - rb[band] * gw)
    vals = torch.cat([rows.to(torch.float64),
                      torch.ones((b, h * w, 1), dtype=torch.float64, device=dev)], dim=2)
    sums = torch.zeros((b * nb * ncp * ncr, 6), dtype=torch.float64, device=dev)
    sums.index_add_(0, slot.reshape(-1), vals.reshape(-1, 6))
    return out, sums.reshape(b, nb, ncp, ncr, 6)


def slic_band_update_plain(cent: torch.Tensor, parts: torch.Tensor, bp: dict) -> torch.Tensor:
    """Plain version of K13's update: the partials added per superpixel in
    band order, and within a band in column order (float64), then the
    centroid step."""
    b, nb, ncp, ncr, _ = parts.shape
    gw = bp["gw"]
    g = torch.zeros((b, bp["n_sp"], 6), dtype=torch.float64, device=parts.device)
    for t in range(nb):
        lo = int(bp["rb"][t]) * gw
        for c in range(ncp):
            g[:, lo:lo + ncr] += parts[:, t, c]
    return slic_update(cent, g[..., :5], g[..., 5])


def slic_band_pass(lab: torch.Tensor, cent: torch.Tensor, bp: dict, sw: float,
                   partials: bool = True, cols: int = _BAND_COLS):
    """K13, one banded pass: (B, H, W, 3) float32 Lab and (B, S, 5) float32
    centroids [L, a, b, y, x] -> ((B, H, W) int32 labels, (B, n_bands,
    ceil(W / cols), w_rows * gw, 6) float64 partials or None). ``bp``: the
    uniform-band plan (slic_plan); ``sw``: the spatial weight's square
    root; ``cols``: the column pieces' width."""
    _check_lab(lab)
    b, h, w, _ = lab.shape
    _kernels.check(tuple(cent.shape) == (b, bp["n_sp"], 5) and cent.dtype == torch.float32,
                   f"cent must be ({b}, {bp['n_sp']}, 5) float32")
    if _kernels.use_plain(lab, cent):
        return slic_band_pass_plain(lab, cent, bp, sw, partials, cols)
    lab, cent = lab.contiguous(), cent.contiguous()
    labels = torch.empty((b, h, w), dtype=torch.int32, device=lab.device)
    parts = (torch.empty((b, bp["n_bands"], _n_col_pieces(w, cols), bp["w_rows"] * bp["gw"],
                          6), dtype=torch.float64, device=lab.device) if partials else None)
    _kernels.launch("gcis_slic_band_pass", lab.data_ptr(), cent.data_ptr(),
                    labels.data_ptr(), parts.data_ptr() if partials else None,
                    b, h, w, bp["gh"], bp["gw"], bp["w_rows"], bp["band_rows"], cols,
                    *_scales(h, w, bp, sw), outputs=(parts,) if partials else ())
    slic_band_pass.launches += 1
    return labels, parts


slic_band_pass.launches = 0


def slic_band_update(cent: torch.Tensor, parts: torch.Tensor, bp: dict, h: int) -> torch.Tensor:
    """K13's update (one warp per superpixel, launched after each pass but
    the last; its own launch counter): the new (B, S, 5) centroids. On the
    card ``cent`` is updated in place and returned."""
    b = cent.shape[0]
    _kernels.check(tuple(cent.shape) == (b, bp["n_sp"], 5) and cent.dtype == torch.float32,
                   f"cent must be ({b}, {bp['n_sp']}, 5) float32")
    _kernels.check(parts.dim() == 5 and tuple(parts.shape[:2]) == (b, bp["n_bands"])
                   and tuple(parts.shape[3:]) == (bp["w_rows"] * bp["gw"], 6)
                   and parts.dtype == torch.float64, "parts must be the pass's partials")
    if _kernels.use_plain(cent, parts):
        return slic_band_update_plain(cent, parts, bp)
    _kernels.check(cent.is_contiguous() and parts.is_contiguous(),
                   "cent and parts must be contiguous")
    _kernels.launch("gcis_slic_band_update", parts.data_ptr(), cent.data_ptr(), b, h,
                    bp["gh"], bp["gw"], bp["w_rows"], bp["band_rows"], parts.shape[2],
                    outputs=(cent,))
    slic_band_update.launches += 1
    return cent


slic_band_update.launches = 0


def _banded_loop(lab, n_superpixels, ruler, n_iter, band_pass, band_update):
    b, h, w, _ = lab.shape
    bp = _band_plan(h, w, n_superpixels)
    _, _, sw = slic_geometry(h, w, n_superpixels, ruler)
    cent = slic_init_centroids(lab, bp["gh"], bp["gw"])
    for _ in range(n_iter):
        _, parts = band_pass(lab, cent, bp, sw)
        cent = band_update(cent, parts, bp, h)
    return band_pass(lab, cent, bp, sw, partials=False)[0]


def slic_banded_plain(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
                      n_iter: int = 10) -> torch.Tensor:
    """Plain version of the banded loop (K13's passes) and of K12: n_iter
    passes and updates, then a last assignment; labels as slic_plain's."""
    return _banded_loop(lab, n_superpixels, ruler, n_iter, slic_band_pass_plain,
                        lambda cent, parts, bp, h: slic_band_update_plain(cent, parts, bp))


def slic_banded(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
                n_iter: int = 10) -> torch.Tensor:
    """The reference's launch-per-pass banded loop (slic_pallas.py:704-768)
    on K13: n_iter + 1 pass launches and n_iter updates, no host sync."""
    _check_lab(lab)
    _kernels.check(n_iter >= 0, f"n_iter must be >= 0, got {n_iter}")
    return _banded_loop(lab, n_superpixels, ruler, n_iter, slic_band_pass,
                        slic_band_update)


# ---------------------------------------------------------------------------
# K12: every iteration on uniform bands in one cluster launch
# ---------------------------------------------------------------------------

W5_CLUSTERS = (1, 2, 4, 8, 16)  # K12's cluster sizes (16 needs the non-portable size)
W5_GROUPS = (1, 2, 4)  # K12's groups of 256 threads a CTA, each passing its own pieces
W5_COLS = (_BAND_COLS, _BAND_COLS // 2)  # K12's column-piece widths
# K12's launch shapes: (CTAs an image, groups a CTA, column-piece width)
W5_SHAPES = tuple((c, g, cw) for c in W5_CLUSTERS for g in W5_GROUPS for cw in W5_COLS)
_W5_SMEM_MAX = 227 * 1024 - 1024  # a K12 CTA's dynamic shared memory at most (W5_SMEM_MAX)
# csrc/slic_common.cuh's Cand, Slot and Rec, and the pass block's 8 warps
# (one staged record a lane, 4 words of touched-slot mask each)
_CAND_BYTES, _SLOT_BYTES, _REC_BYTES, _NWARP = 32, 40, 40, 8
_W5_PIECE_PIXELS = 512  # a piece's fixed cost a pass in slic_w5_plan's model, in pixels
_W5_SM_GROUPS = 2  # groups an SM runs at full speed side by side, in that model


def _pass_smem(nmax: int) -> int:
    """csrc/slic_banded.cu's pass_smem(nmax, true)."""
    return ((_CAND_BYTES + _SLOT_BYTES * _NWARP) * nmax + _REC_BYTES * _NWARP * 32
            + 4 * _NWARP * 4)


def _piece_columns(x0: int, x1: int, fx: np.float32, gw: int) -> Tuple[int, int]:
    """The cell columns pixel columns [x0, x1) reach, their cells +- 1
    (csrc/slic_banded.cu's piece_columns, float32 cell arithmetic)."""
    lo, hi = (min(max(int(np.float32(x) * fx), 0), gw - 1) for x in (x0, x1 - 1))
    return max(lo - 1, 0), min(hi + 1, gw - 1)


@functools.lru_cache(maxsize=None)
def w5_layout(h: int, w: int, n_superpixels: int, ctas: int, groups: int,
              cw: int = _BAND_COLS) -> dict:
    """K12's geometry with clusters of ``ctas`` CTAs an image, each of
    ``groups`` groups of 256 threads, mirrored by csrc/slic_banded.cu. The
    image's ``pieces`` (band, column piece) pieces of ``cw`` columns, in
    that order, are split into runs: CTA r owns pieces
    ``first[r]`` .. ``first[r + 1] - 1`` (r * pieces // ctas on), and its
    group g passes the run's pieces g, g + groups, ...
    It keeps the candidates of grid rows ``rows[r]`` = [ty0, ty1), the
    windows of its first to its last band, all gw columns. ``bands[gy]`` =
    (t_lo, t_hi) are the bands whose window holds grid row gy ((n_bands, -1)
    where none does); ``cols[cp]`` the cell columns piece column cp reaches,
    so a piece's partials are its ``w_rows * (hi - lo + 1)`` <= ``nmax``
    local candidates. A CTA's shared memory holds its table (``tmax`` rows
    at most), a band pass's scratch for each group, the plan's ``table``
    and, where they fit
    (``parts_in_smem``), the partials of its pieces (``kmax`` at most) in
    two buffers: ``smem`` bytes. ``work[r]`` is CTA r's costliest group:
    its pieces' pixels and ``_W5_PIECE_PIXELS`` a piece. ``table`` is the
    int32 plan the kernel reads: first, rows, bands, ``rb`` (each band's
    first window row) and cols, flat."""
    bp = _band_plan(h, w, n_superpixels)
    gh, gw, wr, br, nb = (bp[k] for k in ("gh", "gw", "w_rows", "band_rows", "n_bands"))
    ncp = _n_col_pieces(w, cw)
    pieces = nb * ncp
    fx = np.float32(gw / w)
    cols = tuple(_piece_columns(c * cw, min(w, c * cw + cw), fx, gw) for c in range(ncp))
    nmax = wr * max(hi - lo + 1 for lo, hi in cols)
    rb = [max(0, min(t * br * gh // h - 1, gh - wr)) for t in range(nb)]  # the kernel's form
    first = tuple(r * pieces // ctas for r in range(ctas + 1))
    owned = tuple(first[r + 1] - first[r] for r in range(ctas))
    rows = tuple((rb[first[r] // ncp], rb[(first[r + 1] - 1) // ncp] + wr) if owned[r] else (0, 0)
                 for r in range(ctas))
    gy = np.arange(gh)[:, None]
    rba = np.asarray(rb)[None, :]
    holds = (rba <= gy) & (gy < rba + wr)  # (gh, nb)
    bands = tuple((int(np.argmax(m)), int(nb - 1 - np.argmax(m[::-1]))) if m.any() else (nb, -1)
                  for m in holds)
    piece_px = [(min(h, (q // ncp + 1) * br) - q // ncp * br)
                * (min(w, (q % ncp + 1) * cw) - q % ncp * cw) for q in range(pieces)]
    pixels = tuple(sum(piece_px[first[r]:first[r + 1]]) for r in range(ctas))
    work = tuple(max(sum(px + _W5_PIECE_PIXELS for px in piece_px[first[r] + g:first[r + 1]:groups])
                     for g in range(groups)) for r in range(ctas))
    kmax, tmax = max(owned), max(1, max(ty1 - ty0 for ty0, ty1 in rows))
    table = (first + tuple(v for r in rows for v in r) + tuple(v for t in bands for v in t)
             + tuple(rb) + tuple(v for c in cols for v in c))
    base = _CAND_BYTES * tmax * gw + groups * _pass_smem(nmax) + 4 * len(table)
    part_bytes = 8 * 12 * kmax * nmax
    parts_in_smem = base + part_bytes <= _W5_SMEM_MAX
    return dict(h=h, w=w, n_superpixels=n_superpixels, gh=gh, gw=gw, w_rows=wr, band_rows=br,
                n_bands=nb, n_col_pieces=ncp, pieces=pieces, ctas=ctas, groups=groups, cw=cw,
                first=first, owned=owned, rows=rows, bands=bands, cols=cols, rb=tuple(rb),
                nmax=nmax, kmax=kmax, tmax=tmax, pixels=pixels, work=work,
                parts_in_smem=parts_in_smem,
                smem=base + (part_bytes if parts_in_smem else 0), table=table)


def slic_w5_plan(h: int, w: int, n_superpixels: int, b: int, active: dict) -> dict:
    """K12's launch for a batch of ``b`` frames: the ``w5_layout`` of the
    cluster shape chosen, with ``waves`` (clusters run one after another) and
    ``active`` beside it. ``active[(ctas, groups, cw)]`` is how many
    clusters of that shape the card holds at once at its shared memory (a GPC
    holds whole clusters only; 0 or missing: none). Shapes with more CTAs
    than pieces or whose layout passes the shared memory a CTA may take are
    out. A CTA's iteration takes as long as its costliest group (``work``)
    or, when its groups are more than an SM runs at full speed
    (``_W5_SM_GROUPS``), its whole run's cost shared among those: the shape
    with the least waves x the costliest CTA wins, the smaller cluster and
    then the fewer groups and the wider pieces on a tie."""
    best, best_cost = None, None
    for shape in W5_SHAPES:
        n = active.get(shape, 0)
        lay = w5_layout(h, w, n_superpixels, *shape)
        if n < 1 or lay["ctas"] > lay["pieces"] or lay["smem"] > _W5_SMEM_MAX:
            continue
        waves = -(-b // n)
        cost = waves * max(max(wk, (px + _W5_PIECE_PIXELS * k) / _W5_SM_GROUPS)
                           for wk, px, k in zip(lay["work"], lay["pixels"], lay["owned"]))
        if best_cost is None or cost < best_cost:
            best, best_cost = dict(lay, waves=waves, active=n), cost
    _kernels.check(best is not None, f"no K12 cluster shape of {W5_SHAPES} fits the card at "
                   f"{h}x{w} with {n_superpixels} superpixels (active clusters {active})")
    return best


@functools.lru_cache(maxsize=None)
def _w5_active_clusters(ctas: int, groups: int, smem: int, device: int) -> int:
    out = torch.zeros(1, dtype=torch.int32)
    with torch.cuda.device(device):
        _kernels.launch("gcis_slic_w5_active_clusters", ctas, groups, smem, out.data_ptr())
    return int(out[0])


def w5_active(h: int, w: int, n_superpixels: int, device: int) -> dict:
    """The card's co-resident K12 clusters for each of W5_SHAPES at this
    frame's layouts (0 for a layout the plan rules out)."""
    out = {}
    for ctas, groups, cw in W5_SHAPES:
        lay = w5_layout(h, w, n_superpixels, ctas, groups, cw)
        out[(ctas, groups, cw)] = (_w5_active_clusters(ctas, groups, lay["smem"], device)
                                   if ctas <= lay["pieces"] and lay["smem"] <= _W5_SMEM_MAX
                                   else 0)
    return out


@functools.lru_cache(maxsize=None)
def _w5_plan(h: int, w: int, n_superpixels: int, b: int, device: int) -> dict:
    """slic_w5_plan on the card's co-resident clusters (cached: the plan is
    host work a call would otherwise repeat)."""
    return slic_w5_plan(h, w, n_superpixels, b, w5_active(h, w, n_superpixels, device))


@functools.lru_cache(maxsize=None)
def _w5_table(h: int, w: int, n_superpixels: int, shape: tuple, device: str) -> torch.Tensor:
    return torch.tensor(w5_layout(h, w, n_superpixels, *shape)["table"], dtype=torch.int32,
                        device=device)


def w5_launch(lab: torch.Tensor, cent: torch.Tensor, labels: torch.Tensor, plan: dict,
              n_iter: int, sw: float) -> None:
    """One K12 launch on contiguous CUDA tensors: ``labels`` from ``lab``
    and the seed centroids ``cent`` (read only) under ``plan`` (a
    ``slic_w5_plan``)."""
    b, h, w, _ = lab.shape
    parts = (None if plan["parts_in_smem"] else
             torch.empty((b, 2, plan["pieces"], plan["nmax"], 6), dtype=torch.float64,
                         device=lab.device))
    table = _w5_table(h, w, plan["n_superpixels"], (plan["ctas"], plan["groups"], plan["cw"]),
                      str(lab.device))
    _kernels.launch("gcis_slic_w5", lab.data_ptr(), cent.data_ptr(), labels.data_ptr(),
                    parts.data_ptr() if parts is not None else None, table.data_ptr(), b, h, w,
                    plan["gh"], plan["gw"], plan["w_rows"], plan["band_rows"], plan["cw"],
                    n_iter, plan["ctas"], plan["groups"], plan["kmax"], plan["tmax"], plan["nmax"],
                    plan["smem"], *_scales(h, w, plan, sw))


def slic_w5(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
            n_iter: int = 10) -> torch.Tensor:
    """K12: the banded loop in one launch, a thread-block cluster of
    ``slic_w5_plan``'s size an image, each CTA passing its own run of the
    image's pieces and adding the pieces' partials it needs from the other
    CTAs' shared memory, one cluster barrier an iteration. Labels bit-equal
    to slic_banded's."""
    _check_lab(lab)
    _kernels.check(n_iter >= 0, f"n_iter must be >= 0, got {n_iter}")
    if _kernels.use_plain(lab):
        return slic_banded_plain(lab, n_superpixels, ruler, n_iter)
    b, h, w, _ = lab.shape
    plan = _w5_plan(h, w, n_superpixels, b, lab.device.index)
    _, _, sw = slic_geometry(h, w, n_superpixels, ruler)
    lab = lab.contiguous()
    cent = slic_init_centroids(lab, plan["gh"], plan["gw"])
    labels = torch.empty((b, h, w), dtype=torch.int32, device=lab.device)
    w5_launch(lab, cent, labels, plan, n_iter, sw)
    slic_w5.launches += 1
    return labels


slic_w5.launches = 0


def slic_fused(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
               n_iter: int = 10, plan: str = "auto") -> torch.Tensor:
    """The reference's kernel entry point: (B, H, W, 3) float32 Lab -> (B,
    H, W) int32 superpixel labels through the kernel ``slic_route`` picks.
    Its callers must check ``slic_fused_eligible`` first, as the
    reference's: an ineligible frame raises ValueError."""
    _check_lab(lab)
    _, h, w, _ = lab.shape
    if plan not in ("auto", "w3", "w5"):
        raise ValueError(f"unknown SLIC plan {plan!r}")
    if not slic_fused_eligible(h, w, n_superpixels):
        raise ValueError(f"ineligible shape ({h}x{w}, {n_superpixels} superpixels): the "
                         "reference has no SLIC kernel here; use slic_batch(impl='auto')")
    return slic_batch(lab, n_superpixels, ruler, n_iter, "auto", plan)


def slic_batch(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
               n_iter: int = 10, impl: str = "auto", plan: str = "auto") -> torch.Tensor:
    """(B, H, W, 3) float32 Lab -> (B, H, W) int32 superpixel labels in
    [0, gh * gw), through the kernel ``slic_route`` picks; ``plan`` as the
    reference's slic_fused takes it.

    ``impl`` as the reference's: "auto", "xla" or "fused", anything else
    raises ValueError, and "fused" raises where ``slic_fused_eligible`` is
    False. All three run the same exact-float32 SLIC on the kernels (the
    semantics the reference's "xla" asks for, which its bf16x3 kernel did
    not give); "xla" takes no plan, as the reference's exact path has
    none."""
    _check_lab(lab)
    if impl not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown SLIC impl {impl!r}")
    _, h, w, _ = lab.shape
    if impl == "fused" and not slic_fused_eligible(h, w, n_superpixels):
        raise ValueError(f"impl='fused' ineligible at {h}x{w} with {n_superpixels} "
                         "superpixels (slic_fused_eligible is False)")
    route = slic_route(h, w, n_superpixels, "auto" if impl == "xla" else plan)
    if route == "banded":
        return slic_banded(lab, n_superpixels, ruler, n_iter)
    if route == "w5":
        return slic_w5(lab, n_superpixels, ruler, n_iter)
    return slic_w3(lab, n_superpixels, ruler, n_iter)
