"""Lloyd k-means on the feature kernel's channel-major layout (counterpart of
the JAX package's models/kmeans_chw.py), with kernels K2 and K4.

Per-image standardisation is folded into the centres instead of the pixel
buffer: for x = a*r + b (per-row affine, colour balance and coherence
weights included), argmin_c ||x - c||^2 over raw rows r is scored as
offs_c - 2 * (a*(c - b)) . r with offs_c = ||c - b||^2, and member means
map back through the same affine. Semantics of the reference: maximin
seeds (probe the mean, then farthest points, first index on ties), first-
minimum argmin, an empty cluster keeps its centre, the fixed-point early
exit, and final labels from one assign-only pass under the final centres.

K2 ``lloyd_chw_pass`` (csrc/lloyd_chw.cu) replaces
``models/kmeans_chw.py::_lloyd_chw_kernel``; K4 ``maximin_chw_pass``
(csrc/maximin_chw.cu) replaces ``::_maximin_chw_kernel``. Both source files
say what bounds them on the H100 (HBM bandwidth). K2 runs persistent CTAs
that stage tiles of P pixels x D rows in shared memory and score and sum
them on the tensor cores (``lloyd_plan`` sizes the tiles, the stages and
the CTAs an image; past what shared memory holds it stages a tile's rows in
blocks, so K2 takes any D). Each wrapper runs its
``*_plain`` twin for CPU tensors and launches the kernel for CUDA tensors.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.ops.features import (
    _pool2x2_cm,
    fold_coherence_affine,
)
from gabor_color_image_segmentation_tpu_torch.utils.trace import sync

K_MAX = 8  # centre rows the kernels hold
_TILE = 256  # pixels per block of K4


def _check_rows(xe: torch.Tensor, xc4: torch.Tensor) -> None:
    _kernels.check(xe.dim() == 4 and xc4.dim() == 4,
                   "xe and xc4 must be (B, E, H, W) and (B, 4, H, W)")
    b, _, h, w = xe.shape
    _kernels.check(tuple(xc4.shape) == (b, 4, h, w),
                   f"xc4 must be {(b, 4, h, w)}, got {tuple(xc4.shape)}")
    _kernels.check(xe.dtype == xc4.dtype, "xe and xc4 must share a dtype")
    _kernels.storage_code(xe.dtype)


def _raw_rows(xe: torch.Tensor, xc4: torch.Tensor) -> torch.Tensor:
    """(B, E + 3, N) float32 raw feature rows: energies, then L, a, b."""
    b, e, h, w = xe.shape
    return torch.cat([xe.reshape(b, e, h * w), xc4[:, :3].reshape(b, 3, h * w)],
                     dim=1).to(torch.float32)


# ---------------------------------------------------------------------------
# K2: Lloyd pass
# ---------------------------------------------------------------------------


def lloyd_chw_pass_plain(xe, xc4, wc, offs, assign_only=False):
    """Plain PyTorch version of K2 (same contract as lloyd_chw_pass)."""
    b, _, h, w = xe.shape
    k = wc.shape[1]
    x = _raw_rows(xe, xc4)
    scores = offs[:, :, None] - 2.0 * torch.bmm(wc, x)  # (B, k, N)
    labels = torch.argmin(scores, dim=1)  # first minimum
    if assign_only:
        return labels.to(torch.int32).reshape(b, h, w)
    onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)  # (B, N, k)
    sums = torch.bmm(x, onehot).transpose(1, 2)  # (B, k, D)
    return labels.to(torch.int32).reshape(b, h, w), sums, onehot.sum(dim=1)


# K2's launch (csrc/lloyd_chw.cu): 512 threads a CTA, one CTA an SM, at most
# 227 KB of shared memory a CTA
_SMEM_CTA = 227 * 1024


def _lloyd_smem(d: int, p: int, stages: int, esize: int, rb: int = None) -> int:
    """K2's dynamic shared memory a CTA, as csrc/lloyd_chw.cu's smem_bytes:
    the ring of staged tiles (rows of p values plus 16 bytes for the
    alignment shift, and a row of ones and one of zeros a stage), the
    centre rows as score fragments (three bf16 parts, 768 bytes a 16-row
    chunk), the sums fragments (512 bytes a 16-row tile of the (D + 1)-row
    operand), the rows' source addresses, the ring's mbarriers, the tile's
    labels, the rows' offsets and the score offsets. With ``rb`` < d rows a
    staged block, a stage holds a block, the fragments and the rows'
    offsets (one set a stage) cover a block, and the sums fragments and the
    addresses leave shared memory."""
    nkc, nmt = -(-d // 16), -(-(d + 1) // 16)
    if rb is not None and rb < d:
        return (stages * (rb + 2) * (p * esize + 16) + 768 * -(-rb // 16) + 32
                + 4 * (p + stages * rb + K_MAX))
    return (stages * (d + 2) * (p * esize + 16) + 768 * nkc + 512 * nmt + 8 * d + 32
            + 4 * (p + 16 * nkc + K_MAX))


_BLOCK_TILE = (128, 3)  # K2's tile and stages once a tile's rows are staged in blocks


def lloyd_plan(b: int, n: int, d: int, esize: int, n_sm: int):
    """K2's launch: (pixels a tile, stages, CTAs an image, tiles a CTA, rows
    a staged block).

    A tile is 128 pixels (each of the CTA's 16 warps scores 8 of them) or
    fewer, halving until two stages fit a CTA's shared memory, then the
    most stages (up to 4) that fit; one stage of 16 pixels is the last
    resort (D up to 1,344 float32 or 1,650 bf16 rows). Its rows are staged
    in one go (rows a block = d). Past that a tile of 128 pixels is staged
    in blocks of rows through three stages: the most rows (a multiple of
    16) whose stages fit, then blocks as even as that allows, so any
    d >= 4 has a plan. One CTA an SM: the CTAs of the b images make about
    one wave (n_sm // b an image, each walking consecutive tiles), one CTA
    an image when the batch alone fills the card."""

    def launch(p, stages, rb):
        ntiles = -(-n // p)
        ctas = min(ntiles, max(1, n_sm // b))
        tpc = -(-ntiles // ctas)
        return p, stages, -(-ntiles // tpc), tpc, rb

    for ring in ((4, 3, 2), (1,)):
        p = 128
        while p >= 16:
            fits = [s for s in ring if _lloyd_smem(d, p, s, esize) <= _SMEM_CTA]
            if fits:
                return launch(p, fits[0], d)
            p //= 2
    p, stages = _BLOCK_TILE
    most = 16
    while _lloyd_smem(d, p, stages, esize, most + 16) <= _SMEM_CTA:
        most += 16
    blocks = -(-d // most)
    return launch(p, stages, 16 * -(-(-(-d // blocks)) // 16))


def lloyd_chw_pass(xe, xc4, wc, offs, assign_only=False):
    """One Lloyd pass over raw rows under folded centres.

    xe: (B, E, H, W) and xc4: (B, 4, H, W) (rows L, a, b, unused), float32
    or bfloat16; wc: (B, k, E + 3) float32 folded centre rows a*(c - b);
    offs: (B, k) float32 ||c - b||^2. Returns labels (B, H, W) int32 and,
    unless assign_only, raw member sums (B, k, E + 3) and counts (B, k),
    float32."""
    _check_rows(xe, xc4)
    b, e, h, w = xe.shape
    k = wc.shape[1]
    _kernels.check(1 <= k <= K_MAX, f"k must be in [1, {K_MAX}], got {k}")
    _kernels.check(tuple(wc.shape) == (b, k, e + 3) and wc.dtype == torch.float32,
                   f"wc must be float32 {(b, k, e + 3)}")
    _kernels.check(tuple(offs.shape) == (b, k) and offs.dtype == torch.float32,
                   f"offs must be float32 {(b, k)}")
    if _kernels.use_plain(xe, xc4, wc, offs):
        return lloyd_chw_pass_plain(xe, xc4, wc, offs, assign_only)
    xe, xc4 = xe.contiguous(), xc4.contiguous()
    wc, offs = wc.contiguous(), offs.contiguous()
    n = h * w
    p, stages, ctas, tpc, rb = lloyd_plan(b, n, e + 3, xe.element_size(),
                                          _kernels.sm_count(xe.device))
    labels = torch.empty((b, h, w), dtype=torch.int32, device=xe.device)
    partial = sums = accs = None
    if not assign_only:
        partial = torch.empty((b, ctas, k, e + 4), dtype=torch.float32, device=xe.device)
        sums = torch.empty((b, k, e + 4), dtype=torch.float32, device=xe.device)
        if rb < e + 3:  # the CTAs' sums fragments, past what shared memory holds
            accs = torch.empty((b, ctas, 128 * -(-(e + 4) // 16)), dtype=torch.float32,
                               device=xe.device)
    _kernels.launch(
        "gcis_lloyd_chw", xe.data_ptr(), xc4.data_ptr(), wc.data_ptr(),
        offs.data_ptr(), labels.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (partial, sums, accs)),
        b, e, n, k, _kernels.storage_code(xe.dtype), p, stages, rb, ctas, tpc,
        int(assign_only), outputs=() if assign_only else (sums,),
    )
    lloyd_chw_pass.launches += 1
    if assign_only:
        return labels
    return labels, sums[:, :, : e + 3], sums[:, :, e + 3]


lloyd_chw_pass.launches = 0


# ---------------------------------------------------------------------------
# K4: maximin step
# ---------------------------------------------------------------------------


def maximin_chw_pass_plain(xe, xc4, a2, probe, dmin, reset):
    """Plain PyTorch version of K4 (same contract as maximin_chw_pass)."""
    x = _raw_rows(xe, xc4)
    d2 = (a2[:, :, None] * (x - probe[:, :, None]).square()).sum(dim=1)
    new = d2 if reset else torch.minimum(dmin.reshape(d2.shape), d2)
    dmin.copy_(new.reshape(dmin.shape))
    idx = torch.argmax(new, dim=1)  # first maximum
    return torch.gather(x, 2, idx[:, None, None].expand(-1, x.shape[1], 1))[:, :, 0]


def maximin_chw_pass(xe, xc4, a2, probe, dmin, reset: bool):
    """One weighted farthest-point step: d2 = sum_d a2_d (r_d - probe_d)^2,
    ``dmin`` (B, H, W) float32 becomes d2 (reset) or min(dmin, d2), in
    place. Returns the raw column (B, E + 3) float32 at the first flat index
    of the new dmin's maximum. a2, probe: (B, E + 3) float32."""
    _check_rows(xe, xc4)
    b, e, h, w = xe.shape
    for name, t in (("a2", a2), ("probe", probe)):
        _kernels.check(tuple(t.shape) == (b, e + 3) and t.dtype == torch.float32,
                       f"{name} must be float32 {(b, e + 3)}")
    _kernels.check(tuple(dmin.shape) == (b, h, w) and dmin.dtype == torch.float32
                   and dmin.is_contiguous(), f"dmin must be contiguous float32 {(b, h, w)}")
    if _kernels.use_plain(xe, xc4, a2, probe, dmin):
        return maximin_chw_pass_plain(xe, xc4, a2, probe, dmin, reset)
    xe, xc4 = xe.contiguous(), xc4.contiguous()
    a2, probe = a2.contiguous(), probe.contiguous()
    n = h * w
    nblk = -(-n // _TILE)
    bestv = torch.empty((b, nblk), dtype=torch.float32, device=xe.device)
    besti = torch.empty((b, nblk), dtype=torch.int32, device=xe.device)
    best = torch.empty((b, e + 3), dtype=torch.float32, device=xe.device)
    _kernels.launch(
        "gcis_maximin_chw", xe.data_ptr(), xc4.data_ptr(), a2.data_ptr(),
        probe.data_ptr(), dmin.data_ptr(), bestv.data_ptr(), besti.data_ptr(),
        best.data_ptr(), b, e, n, _kernels.storage_code(xe.dtype), int(reset),
        outputs=(dmin, best),
    )
    maximin_chw_pass.launches += 1
    return best


maximin_chw_pass.launches = 0


def _maximin_init_chw(xe, xc4, a, b_aff, k: int) -> torch.Tensor:
    """Weighted maximin seeding on raw rows -> (B, k, D) NORMALISED centres.

    The probe sequence of models.kmeans.maximin_init on the normalised
    features: the mean, then k - 1 farthest-point steps (the running min
    restarts on steps 0 and 1); distances are the normalised-space ones via
    the a^2 weights."""
    b, e, h, w = xe.shape
    a2 = a * a
    probe = torch.cat([xe.to(torch.float32).mean(dim=(2, 3)),
                       xc4[:, :3].to(torch.float32).mean(dim=(2, 3))], dim=1)
    dmin = torch.zeros((b, h, w), dtype=torch.float32, device=xe.device)
    cols = []
    for step in range(k):
        probe = maximin_chw_pass(xe, xc4, a2, probe, dmin, step < 2)
        cols.append(probe)
    return a[:, None, :] * torch.stack(cols, dim=1) + b_aff[:, None, :]


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------


def _affine_params(xe, xc4, cluster_cfg, eps: float, pooled=None):
    """Per-row standardisation affine over raw CHW rows: x = a*r + b, with
    the sqrt(E/3) colour balance and ``color_weight`` in the colour rows and
    the coherence weights folded in. Returns (a, b), each (B, E + 3)
    float32. ``pooled`` = (energy twin, colour twin) for the coherence
    statistics."""
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


def build_color4(color: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) colour -> (B, 4, H, W) channel-major rows [L, a, b, 1] in
    ``dtype`` (the reference's layout; the kernels read rows 0..2)."""
    b, h, w, _ = color.shape
    cm = color.to(dtype).permute(0, 3, 1, 2)
    return torch.cat([cm, torch.ones((b, 1, h, w), dtype=dtype, device=color.device)],
                     dim=1).contiguous()


def kmeans_fused_chw(
    energies_cm,
    color4: torch.Tensor,
    affine: Tuple[torch.Tensor, torch.Tensor],
    k: int,
    n_iter: int = 25,
    refine_iters: int = 10,
    init_centers: Optional[torch.Tensor] = None,
    with_labels: bool = True,
    coarse_iters: int = 0,
    eps: float = 1e-6,
    pooled: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Lloyd directly on raw (B, E, H, W) energies + color4 under ``affine``.

    ``energies_cm`` is the (B, E, H, W) tensor or, as the reference takes
    it, a tuple of per-group (B, E_g, H, W) buffers (concatenated once).
    Returns (labels (B, H, W) int32 or None, centres (B, k, E + 3) float32
    in normalised feature space). With ``init_centers`` (normalised; the
    pipeline's multigrid warm start) it runs up to ``refine_iters`` passes
    from them. Without, and with ``coarse_iters`` > 0 on a frame of at
    least 2x2, the reference's own multigrid: maximin seeding (K4) and up to
    ``coarse_iters`` passes (K2) on the 2x2 twin (``pooled`` = (energy
    twin, colour twin) when given, else pooled here from the raw rows,
    since pooling commutes with the affine), then up to ``refine_iters``
    full-resolution passes (K2). Otherwise maximin seeding and up to
    ``n_iter`` passes at full resolution. with_labels=False skips the final
    assign-only pass. ``eps`` is the reference's parameter, which its body
    does not read either: the affine already holds it."""
    if k > K_MAX:
        raise ValueError(f"fused chw Lloyd supports k <= {K_MAX}, got {k}")
    if isinstance(energies_cm, (tuple, list)):
        energies_cm = torch.cat(list(energies_cm), dim=1)
    a, b_aff = affine
    mm = energies_cm.dtype

    def folded(c):
        u = c - b_aff[:, None, :]
        # the folded rows are rounded to the storage dtype, as the
        # reference's kernel operands were
        return (a[:, None, :] * u).to(mm).to(torch.float32), u.square().sum(dim=2)

    def solve(xe, xc4, c, max_iter):
        """Up to ``max_iter`` Lloyd passes from ``c`` on one level, stopping
        at the fixed point, where further passes are identities."""
        for _ in range(max_iter):
            _, sums, counts = lloyd_chw_pass(xe, xc4, *folded(c))
            raw_mean = sums / torch.clamp(counts, min=1.0)[:, :, None]
            new = a[:, None, :] * raw_mean + b_aff[:, None, :]
            new = torch.where(counts[:, :, None] > 0, new, c)
            changed = sync("lloyd_fixed_point", bool, (new != c).any())
            c = new
            if not changed:
                break
        return c

    h, w = energies_cm.shape[2:]
    if init_centers is not None:
        c = solve(energies_cm, color4, init_centers, refine_iters)
    elif coarse_iters > 0 and h >= 2 and w >= 2:
        pe, pc = pooled if pooled is not None else (_pool2x2_cm(energies_cm),
                                                    _pool2x2_cm(color4))
        c = solve(pe, pc, _maximin_init_chw(pe, pc, a, b_aff, k), coarse_iters)
        c = solve(energies_cm, color4, c, refine_iters)
    else:
        c = solve(energies_cm, color4, _maximin_init_chw(energies_cm, color4, a, b_aff, k),
                  n_iter)
    if not with_labels:
        return None, c
    return lloyd_chw_pass(energies_cm, color4, *folded(c), True), c
