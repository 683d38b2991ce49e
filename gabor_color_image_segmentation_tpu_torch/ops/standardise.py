"""The standardisation of the labels-only path on the card
(``csrc/standardise.cu``): the per-row affine (a, b) with the coherence
weights folded in, the 2x2 mean pools and the normalised buffers, on raw
channel-major rows.

Each wrapper runs its ``*_plain`` twin for CPU tensors and launches the
kernels for CUDA tensors, and counts its launches in ``.launches``:

- ``pool2x2(x)``: ``ops/features.py::_pool2x2_cm``, in one launch
  (``std_apply_kernel``, raw).
- ``affine_params(xe, xc4, cluster_cfg, eps, pooled)``: the affine of
  ``models/kmeans_chw.py`` (the twin is its former body). One launch of
  ``std_moments_kernel`` for the whole planes' moments, one for the
  coherence statistics (the 8x8 block means, from the 2x2 twins in
  ``pooled`` or from the full-resolution rows), one more without
  normalisation (the stds over the 8x8-divisible crop), then
  ``std_affine_kernel``. The card sums in float64 and rounds (a, b) to
  float32 once, where the twin sums in float32, so the two differ in the
  last bits of (a, b); two launches give the same bits.
- ``normalised_rows(pe, pc4, a, b, pools)``: the normalised (B, E + 3, m)
  buffers of ``assemble_xp_from_affine`` in the energies' dtype on the rows
  pooled 0 or more times (``pools``: one depth, or 0 and one depth), from
  one read of the rows (``std_apply_kernel``); bit-equal to the twin.
  Pooling rounds the colour rows to the energies' dtype first, as
  ``build_color4(color, dtype)`` does. A depth past ``MAX_POOL`` pools the
  raw rows first (``pool2x2``), then pools the rest in the launch that
  normalises.

No wrapper reads a device value on the host. The launch plans
(``moments_plan``, ``apply_plan``) come from the shapes and the card's SM
count only.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.ops.features import (
    _COH_BLOCK,
    _pool2x2_cm,
    assemble_xp_from_affine,
    fold_coherence_affine,
)

MAX_POOL = 5  # pool depth of std_apply_kernel (32 x 32 blocks in a 2,048-value tile)
_TILE = 2048  # values a tile of std_apply_kernel
_NT = 256  # threads a block
_RUN = 32768  # source values a block of std_moments_kernel, about


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def moments_plan(rows: int, hc: int, wc: int, level: int, n_sm: int) -> int:
    """std_moments_kernel's blocks a row: about one for each 32,768 source
    values the row's pooled crop (hc x wc, pooled ``level`` times) reads,
    at least two waves' worth of blocks over the card (one image at a
    time splits its rows), and no more than one for each 256 pooled
    values."""
    n = hc * wc
    want = max(-(-n * 4**level // _RUN), -(-2 * n_sm // rows))
    return max(1, min(want, -(-n // _NT), 65535))


def apply_plan(h: int, w: int, lv: int, full: bool, rows: int, n_sm: int):
    """std_apply_kernel's tiles: (log2 of the tile width, rows and columns
    the tiles cover, tiles across, tiles in all, blocks a row). A tile holds
    2,048 values: the narrowest power of two >= 2^lv that covers the
    columns, at most 2,048 / 2^lv wide, and as many rows as that leaves.
    With ``full`` the tiles cover the frame, else the rows and columns the
    pooled plane reads. The blocks of a row walk its tiles: about 16 blocks
    an SM over the card, at most one a tile."""
    hl, wl = h >> lv, w >> lv
    rows_lim, cols_lim = (h, w) if full else (hl << lv, wl << lv)
    tw = 1 << lv
    while tw < cols_lim and tw < _TILE >> lv:
        tw <<= 1
    ntx = -(-cols_lim // tw)
    ntiles = ntx * -(-rows_lim // (_TILE // tw))
    x = max(1, min(ntiles, -(-16 * n_sm // rows), 65535))
    return tw.bit_length() - 1, rows_lim, cols_lim, ntx, ntiles, x


def _check_rows(xe: torch.Tensor, xc: torch.Tensor, what: str) -> None:
    _kernels.check(xe.dim() == 4 and xc.dim() == 4,
                   f"{what}: energies and colour must be (B, E, H, W) and (B, C, H, W)")
    b, _, h, w = xe.shape
    _kernels.check(xc.shape[0] == b and xc.shape[1] >= 3 and tuple(xc.shape[2:]) == (h, w),
                   f"{what}: colour must be (B, >= 3, H, W) = ({b}, >= 3, {h}, {w}), "
                   f"got {tuple(xc.shape)}")
    _kernels.storage_code(xe.dtype)
    _kernels.storage_code(xc.dtype)
    _kernels.check(xc.dtype in (xe.dtype, torch.float32),
                   f"{what}: colour must be stored as the energies ({xe.dtype}) or in "
                   f"float32, got {xc.dtype}")


def _launch_apply(counter, xe, xc, a, b_aff, full, pooled, lv: int) -> None:
    """One std_apply_kernel launch, counted in ``counter.launches`` (none
    where the tiles are empty)."""
    bsz, e, h, w = xe.shape
    nc = 0 if xc is None else 3
    out = full if full is not None else pooled
    plan = apply_plan(h, w, lv, full is not None, bsz * (e + nc), _kernels.sm_count(xe.device))
    if plan[4] == 0 or out.numel() == 0:
        return
    te = _kernels.storage_code(xe.dtype)
    _kernels.launch(
        "gcis_std_apply", xe.data_ptr(), _ptr(xc), _ptr(a), _ptr(b_aff), _ptr(full),
        _ptr(pooled), bsz, e, nc, 0 if xc is None else xc.shape[1], h, w, lv, int(a is None),
        *plan, te, te if xc is None else _kernels.storage_code(xc.dtype),
        outputs=tuple(t for t in (full, pooled) if t is not None),
    )
    counter.launches += 1


# ---------------------------------------------------------------------------
# 2x2 pools
# ---------------------------------------------------------------------------


def pool2x2_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of pool2x2: ``_pool2x2_cm``."""
    return _pool2x2_cm(x)


def pool2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) float32 or bf16 -> (B, C, H // 2, W // 2): 2x2 means
    in ``_pool2x2_cm``'s order and rounding, in one pass over x."""
    _kernels.check(x.dim() == 4, f"pool2x2 takes (B, C, H, W), got {tuple(x.shape)}")
    _kernels.storage_code(x.dtype)
    if _kernels.use_plain(x):
        return pool2x2_plain(x)
    x = x.contiguous()
    b, c, h, w = x.shape
    out = torch.empty((b, c, h // 2, w // 2), dtype=x.dtype, device=x.device)
    if x.numel():
        _launch_apply(pool2x2, x, None, None, None, None, out, 1)
    return out


pool2x2.launches = 0


# ---------------------------------------------------------------------------
# the affine
# ---------------------------------------------------------------------------


def affine_params_plain(xe, xc4, cluster_cfg, eps: float, pooled=None):
    """Plain version of affine_params (float32 moments)."""
    b, e = xe.shape[:2]
    dev = xe.device
    cw = cluster_cfg.color_weight * float(math.sqrt(e / 3.0))
    if not cluster_cfg.normalize:
        a = torch.cat([torch.ones((b, e), device=dev),
                       torch.full((b, 3), cw, device=dev)], dim=1)
        return fold_coherence_affine(
            a, torch.zeros((b, e + 3), device=dev), xe, xc4, cluster_cfg, eps,
            pooled=pooled,
        )

    def moments(x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(2, 3))
        sq = xf.square().mean(dim=(2, 3))
        return mean, torch.sqrt(torch.clamp(sq - mean.square(), min=0.0))

    m_e, s_e = moments(xe)
    m_c, s_c = moments(xc4[:, :3])
    a_e = 1.0 / (s_e + eps)
    a_c = cw / (s_c + eps)
    a = torch.cat([a_e, a_c], dim=1)
    bb = torch.cat([-m_e * a_e, -m_c * a_c], dim=1)
    return fold_coherence_affine(a, bb, xe, xc4, cluster_cfg, eps,
                                 pooled=pooled, s_full=torch.cat([s_e, s_c], dim=1))


def _moments(xe, xc, level: int, hc: int, wc: int) -> torch.Tensor:
    """Per-row float64 partials (B, E + 3, blocks, 2) of the rows pooled
    ``level`` times over the crop [0, hc) x [0, wc): one launch."""
    b, e, h, w = xe.shape
    ns = moments_plan(b * (e + 3), hc, wc, level, _kernels.sm_count(xe.device))
    out = torch.empty((b, e + 3, ns, 2), dtype=torch.float64, device=xe.device)
    _kernels.launch("gcis_std_moments", xe.data_ptr(), xc.data_ptr(), out.data_ptr(), b, e, 3,
                    xc.shape[1], h, w, level, hc, wc, ns, _kernels.storage_code(xe.dtype),
                    _kernels.storage_code(xc.dtype))
    affine_params.launches += 1
    return out


def affine_params(xe, xc4, cluster_cfg, eps: float, pooled=None):
    """Per-row standardisation affine over raw CHW rows: x = a*r + b, with
    the sqrt(E/3) colour balance and ``color_weight`` in the colour rows and
    the coherence weights folded in. xe: (B, E, H, W), xc4: (B, >= 3, H, W)
    (rows L, a, b), float32 or bf16, the colour stored as the energies or
    in float32. Returns (a, b), each (B, E + 3)
    float32. ``pooled`` = (energy twin, colour twin), the 2x2 pools of xe
    and xc4, for the coherence statistics."""
    _check_rows(xe, xc4, "affine_params")
    b, e, h, w = xe.shape
    if pooled is not None:
        _check_rows(pooled[0], pooled[1], "affine_params pooled")
        _kernels.check(tuple(pooled[0].shape) == (b, e, h // 2, w // 2),
                       f"pooled twins must be (B, E, H // 2, W // 2) = {(b, e, h // 2, w // 2)}, "
                       f"got {tuple(pooled[0].shape)}")
    if _kernels.use_plain(xe, xc4, *(pooled or ())):
        return affine_params_plain(xe, xc4, cluster_cfg, eps, pooled)
    xe, xc4 = xe.contiguous(), xc4.contiguous()
    n = _COH_BLOCK
    hb, wb = h // n, w // n
    full = _moments(xe, xc4, 0, h, w) if cluster_cfg.normalize else None
    coh = crop = None
    if getattr(cluster_cfg, "cue_weight", "static") == "coherence" and hb >= 2 and wb >= 2:
        if pooled is not None:
            coh = _moments(pooled[0].contiguous(), pooled[1].contiguous(), 2, hb, wb)
        else:
            coh = _moments(xe, xc4, 3, hb, wb)
        if full is None:
            crop = _moments(xe, xc4, 0, n * hb, n * wb)
    a = torch.empty((b, e + 3), dtype=torch.float32, device=xe.device)
    b_aff = torch.empty_like(a)
    _kernels.launch(
        "gcis_std_affine", _ptr(full), _ptr(coh), _ptr(crop), a.data_ptr(), b_aff.data_ptr(),
        b, e, *(0 if t is None else t.shape[2] for t in (full, coh, crop)),
        float(h * w), float(hb * wb), float(n * n * hb * wb),
        cluster_cfg.color_weight * math.sqrt(e / 3.0), float(eps),
        float(getattr(cluster_cfg, "coherence_pow", 1.0)), outputs=(a, b_aff),
    )
    affine_params.launches += 1
    return a, b_aff


affine_params.launches = 0


# ---------------------------------------------------------------------------
# the normalised buffers
# ---------------------------------------------------------------------------


def _check_pools(pools: Sequence[int]) -> Tuple[int, ...]:
    pools = tuple(int(p) for p in pools)
    _kernels.check(
        len(pools) in (1, 2) and all(p >= 0 for p in pools)
        and (len(pools) == 1 or (pools[0] == 0 and pools[1] > 0)),
        f"pools must be one depth >= 0 or (0, depth), got {pools}",
    )
    return pools


def normalised_rows_plain(pe, pc4, a, b_aff, pools=(0,)):
    """Plain version of normalised_rows: ``assemble_xp_from_affine`` on
    the rows pooled by ``_pool2x2_cm``, the colour rounded to the
    energies' dtype first."""
    out = []
    for lv in pools:
        qe, qc = pe, pc4
        if lv:
            qc = pc4[:, :3].to(pe.dtype)
            for _ in range(lv):
                qe, qc = _pool2x2_cm(qe), _pool2x2_cm(qc)
        out.append(assemble_xp_from_affine(qe, qc, a, b_aff, pe.dtype))
    return tuple(out)


def normalised_rows(pe, pc4, a, b_aff, pools=(0,)):
    """Raw channel-major rows + the affine -> normalised buffers (B, E + 3,
    m) in pe's dtype, one for each depth in ``pools`` (m = (H >> p) * (W >>
    p)): energy rows, then the three colour rows, pooled p times
    (``_pool2x2_cm``'s order; the colour rounded to pe's dtype first), then
    (rows * a + b) rounded as ``assemble_xp_from_affine`` rounds. pe: (B,
    E, H, W); pc4: (B, >= 3, H, W), stored as pe or in float32; a, b_aff:
    (B, E + 3) float32. ``pools`` is one depth or (0, depth): the
    full-resolution buffer and a pooled one from one read of the rows (up
    to ``MAX_POOL`` deep; past it the raw rows are pooled first)."""
    _check_rows(pe, pc4, "normalised_rows")
    b, e, h, w = pe.shape
    for name, t in (("a", a), ("b_aff", b_aff)):
        _kernels.check(tuple(t.shape) == (b, e + 3) and t.dtype == torch.float32,
                       f"{name} must be float32 {(b, e + 3)}, got {t.dtype} {tuple(t.shape)}")
    pools = _check_pools(pools)
    if _kernels.use_plain(pe, pc4, a, b_aff):
        return normalised_rows_plain(pe, pc4, a, b_aff, pools)
    if pools[-1] > MAX_POOL:
        # pooling is the same rounding level by level, so the raw rows
        # pooled past MAX_POOL, then MAX_POOL more in the apply, give the
        # same bits
        qe, qc = pe, pc4[:, :3].to(pe.dtype)
        for _ in range(pools[-1] - MAX_POOL):
            qe, qc = pool2x2(qe), pool2x2(qc)
        first = normalised_rows(pe, pc4, a, b_aff, (0,)) if pools[0] == 0 else ()
        return first + normalised_rows(qe, qc, a, b_aff, (MAX_POOL,))
    pe, pc4, a, b_aff = pe.contiguous(), pc4.contiguous(), a.contiguous(), b_aff.contiguous()
    bufs = [torch.empty((b, e + 3, (h >> p) * (w >> p)), dtype=pe.dtype, device=pe.device)
            for p in pools]
    full = bufs[0] if pools[0] == 0 else None
    pooled = bufs[-1] if pools[-1] > 0 else None
    _launch_apply(normalised_rows, pe, pc4, a, b_aff, full, pooled, pools[-1])
    return tuple(bufs)


normalised_rows.launches = 0
