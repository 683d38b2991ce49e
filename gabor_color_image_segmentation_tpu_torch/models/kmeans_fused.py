"""Lloyd k-means on the normalised (B, D, N) solver buffer (counterpart of
the JAX package's models/kmeans_pallas.py), with kernels K3, K5 and K6,
and on a row-major (B, N, D) buffer with K7.

The buffer holds D normalised feature rows of N pixels in the storage dtype
(float32 or bfloat16). The reference's transposed ``xt`` layout also
carried a ones-row (member counts) and zero padding to TPU tiles; the
kernels here count members themselves and mask the ragged edge, so neither
is built.

- K3 (csrc/coarse_centers.cu) replaces ``_coarse_all_kernel``: maximin
  seeding and ``coarse_iters`` Lloyd passes on the pooled buffer in one
  launch, each image spread over a thread-block cluster of ``coarse_plan``
  CTAs that stream its pixels and trade their partial sums through
  distributed shared memory. The JAX package runs that kernel in
  bf16 only and routes f32 through separate maximin and Lloyd passes (with
  a fixed-point early exit, identical at the fixed point); the port runs K3
  in both dtypes, so the two differ only in reduction order. Past the 400
  rows K3's tiles hold, ``coarse_route`` sends the warm start through K6
  and K5, the reference's blocked route.
- K5 ``lloyd_t_pass`` (csrc/lloyd_t.cu) replaces ``_lloyd_t_kernel``: one
  Lloyd pass in one launch, ``lloyd_t_plan`` CTAs an image over the whole
  card, whose float64 partial sums the last CTA of each image adds in CTA
  order (an int counter an image, left at 0 for the next launch).
- K6 ``maximin_t_pass`` (csrc/maximin_t.cu) replaces ``_maximin_kernel``:
  one farthest-point step in one launch, ``maximin_t_plan`` CTAs an image,
  each reducing its pixels to a (max, first index) pair; the last CTA of
  each image picks among the pairs and reads the winning column (the same
  int counters as K5).
- K7 ``lloyd_pass`` (csrc/lloyd_rows.cu) replaces ``_lloyd_kernel``: one
  Lloyd pass on a row-major (B, N, D) buffer in one launch,
  ``lloyd_rows_plan`` CTAs an image, each staging tiles of consecutive
  pixels (one contiguous span, or past what shared memory holds blocks of
  values) and scoring and summing them on the tensor cores; the last CTAs
  add the partials in a fixed order (the same int counters as K5). The
  member counts are counted (the reference's ones column and 128-lane
  padding of D are not built). It serves ``kmeans_fused``, the reference's
  drop-in for a batched ``kmeans``, which no pipeline path calls.

The solvers: ``kmeans_fused_t_xt`` on the (B, D, N) buffer (K6 seeds, or
the plain strided seeding with ``init_stride`` > 1, then K5 passes; with
a multigrid schedule, seeds and passes on the buffer pooled
``coarse_levels`` times by exact 2x2 means, ``mid_iters`` passes on each
intermediate grid, then the full-resolution passes), ``kmeans_fused_t``
on (B, N, D) features (the with-features path's, through
models/kmeans.py::kmeans_batch; their transpose is the buffer), and
``kmeans_fused`` on K7.

Scores follow the reference: ||c||^2 - 2 c . x with c in float32 for the
norm and rounded to the storage dtype for the cross term, first minimum
wins, an empty cluster keeps its centre. Each source file says what bounds
its kernel on the H100.
"""

from __future__ import annotations

import functools

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.models.kmeans import maximin_init
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import K_MAX
from gabor_color_image_segmentation_tpu_torch.ops.tiled import pool2x2_mean
from gabor_color_image_segmentation_tpu_torch.utils.trace import sync

D_COARSE_MAX = 400  # feature rows K3 stages (two tiles of >= 32 pixels in shared memory)
COARSE_CLUSTERS = (1, 2, 4, 8, 16)  # K3's cluster sizes (16 needs the non-portable size)
_COARSE_CTA_PIXELS = 128  # a CTA's fixed cost a pass, in pixels (about one tile)


def coarse_plan(b: int, m: int, active) -> int:
    """CTAs per image of K3's cluster. ``active[i]`` is how many clusters of
    ``COARSE_CLUSTERS[i]`` CTAs the card holds at once (its shared memory
    decides: a GPC holds whole clusters only). Each pass costs a CTA about
    ceil(m / ctas) + 128 pixels of work, and ceil(b / active) waves of
    clusters run one after another: the size with the least waves x work
    wins, the smaller size on a tie."""
    best, best_cost = 1, None
    for ctas, n in zip(COARSE_CLUSTERS, active):
        if n < 1:
            continue
        cost = -(-b // n) * (-(-m // ctas) + _COARSE_CTA_PIXELS)
        if best_cost is None or cost < best_cost:
            best, best_cost = ctas, cost
    return best


@functools.lru_cache(maxsize=None)
def _active_clusters(d: int, code: int, device: int) -> tuple:
    """The card's co-resident clusters of K3 for each of COARSE_CLUSTERS."""
    out = torch.zeros(len(COARSE_CLUSTERS), dtype=torch.int32)
    with torch.cuda.device(device):
        _kernels.launch("gcis_coarse_active_clusters", d, code, out.data_ptr())
    return tuple(out.tolist())


def kmeans_coarse_centers_xp_plain(xp, k: int, d: int, m: int, coarse_iters: int):
    """Plain PyTorch version of K3 (same contract as kmeans_coarse_centers_xp)."""
    x = xp[:, :d, :m].to(torch.float32)  # (B, d, m)

    def rounded(c):  # the cross term sees centres in the storage dtype
        return c.to(xp.dtype).to(torch.float32)

    probe = rounded(x.sum(dim=2) / m)
    dmin = None
    cols = []
    for step in range(k):
        d2 = (x - probe[:, :, None]).square().sum(dim=1)  # (B, m)
        dmin = d2 if step < 2 else torch.minimum(dmin, d2)
        idx = torch.argmax(dmin, dim=1)  # first maximum
        probe = torch.gather(x, 2, idx[:, None, None].expand(-1, d, 1))[:, :, 0]
        cols.append(probe)
    c = torch.stack(cols, dim=1)  # (B, k, d)
    for _ in range(coarse_iters):
        csq = c.square().sum(dim=2)
        scores = csq[:, :, None] - 2.0 * torch.bmm(rounded(c), x)  # (B, k, m)
        onehot = torch.nn.functional.one_hot(torch.argmin(scores, dim=1), k)
        onehot = onehot.to(torch.float32)  # (B, m, k)
        counts = onehot.sum(dim=1)
        new = torch.bmm(x, onehot).transpose(1, 2) / torch.clamp(counts, min=1.0)[:, :, None]
        c = torch.where(counts[:, :, None] > 0, new, c)
    return c


def coarse_route(d: int) -> str:
    """Which route the coarse warm start takes for d feature rows on the
    card: "k3" (K3, one launch for the seeding and every pass) up to
    ``D_COARSE_MAX`` rows, whose tiles fit K3's shared memory (every
    preset's d is 243 or less), else "blocked": K6's maximin steps then K5's
    Lloyd passes on the same buffer, which take any d.

    The reference (gabor_color_image_segmentation_tpu/models/
    kmeans_pallas.py:704-722, ``kmeans_coarse_centers_xp``) runs its fused
    warm-start kernel in bf16 while the padded pooled buffer fits its 12 MiB
    ``_COARSE_FUSE_BYTES`` (d <= 607 at config1's 80 x 120 grid), and its
    blocked passes (``_maximin_init_t_fused``, then ``_solve_t``) past that
    and always in f32. The port runs K3 in both dtypes up to 400 rows: it
    and the blocked passes differ only in their reduction order."""
    return "k3" if d <= D_COARSE_MAX else "blocked"


def _coarse_centers_blocked(xp, k: int, d: int, m: int, coarse_iters: int):
    """The blocked route: maximin seeds (K6) and ``coarse_iters`` Lloyd
    updates (K5) on rows [0, d) and columns [0, m) of xp, copied into the
    contiguous (B, d, m) buffer the two kernels read."""
    x = xp[:, :d, :m].contiguous()
    return _lloyd_t_updates(x, _maximin_init_t_fused(x, k), coarse_iters)


def kmeans_coarse_centers_xp(xp, k: int, d: int, m: int, coarse_iters: int):
    """Maximin seeding + ``coarse_iters`` Lloyd passes on a pooled buffer.

    xp: (B, rows, cols) float32 or bfloat16 with normalised features in rows
    [0, d) and pixels in columns [0, m) (the port's (B, E + 3, m) buffer, or
    the reference's padded xt layout, whose ones-row and padding are not
    read). Returns (B, k, d) float32 centres in normalised feature space.
    ``coarse_route(d)`` picks K3 or the blocked route (K6, K5); on CPU
    tensors each takes its kernels' plain versions."""
    _kernels.check(xp.dim() == 3, f"xp must be (B, rows, cols), got {tuple(xp.shape)}")
    _kernels.check(d <= xp.shape[1] and 1 <= m <= xp.shape[2],
                   f"d={d}, m={m} do not fit xp {tuple(xp.shape)}")
    _kernels.check(1 <= k <= K_MAX, f"k must be in [1, {K_MAX}], got {k}")
    _kernels.storage_code(xp.dtype)
    if coarse_route(d) == "blocked":
        return _coarse_centers_blocked(xp, k, d, m, coarse_iters)
    if _kernels.use_plain(xp):
        return kmeans_coarse_centers_xp_plain(xp, k, d, m, coarse_iters)
    _kernels.check(d >= 1, f"the CUDA kernel takes d >= 1, got {d}")
    xp = xp.contiguous()
    b, rows, cols = xp.shape
    code = _kernels.storage_code(xp.dtype)
    ctas = coarse_plan(b, m, _active_clusters(d, code, xp.device.index))
    centers = torch.empty((b, k, d), dtype=torch.float32, device=xp.device)
    dmin = torch.empty((b, m), dtype=torch.float32, device=xp.device)
    _kernels.launch(
        "gcis_coarse_centers", xp.data_ptr(), centers.data_ptr(), dmin.data_ptr(),
        b, rows, cols, d, m, k, coarse_iters, code, ctas, outputs=(centers,),
    )
    kmeans_coarse_centers_xp.launches += 1
    return centers


kmeans_coarse_centers_xp.launches = 0


def _rounded(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """float32 values as the cross term sees them: rounded to the storage
    dtype."""
    return c.to(dtype).to(torch.float32)


def _check_buffer(x: torch.Tensor) -> None:
    _kernels.check(x.dim() == 3, f"x must be (B, D, N), got {tuple(x.shape)}")
    _kernels.storage_code(x.dtype)


# ---------------------------------------------------------------------------
# K5: Lloyd pass
# ---------------------------------------------------------------------------


def lloyd_t_pass_plain(x, centers, assign_only: bool = False):
    """Plain PyTorch version of K5 (same contract as lloyd_t_pass)."""
    b, _, n = x.shape
    k = centers.shape[1]
    xf = x.to(torch.float32)
    csq = centers.square().sum(dim=2)
    scores = csq[:, :, None] - 2.0 * torch.bmm(_rounded(centers, x.dtype), xf)
    labels = torch.argmin(scores, dim=1)  # first minimum
    if assign_only:
        return labels.to(torch.int32)
    onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)  # (B, N, k)
    sums = torch.bmm(xf, onehot).transpose(1, 2)  # (B, k, D)
    return labels.to(torch.int32), sums, onehot.sum(dim=1)


_T_MIN_PIXELS = 256  # pixels a CTA of K5 and K6 at the least


def lloyd_t_plan(b: int, n: int, n_sm: int) -> int:
    """CTAs per image of K5: the card's SMs shared among the b images (one
    wave), but no CTA with fewer than 256 of the image's n pixels, and at
    least one."""
    return max(1, min(n_sm // b, -(-n // _T_MIN_PIXELS)))


# The images' int counters of K5 and K6, kept for the last 16 streams that
# launched either: every launch leaves them at 0, so launches on one stream
# share them (a zeroed tensor a call would cost a second launch)
_T_COUNTERS: dict = {}
_T_STREAMS_KEPT = 16


def _counters(device: torch.device, b: int) -> torch.Tensor:
    """At least b zeroed int32 counters on ``device`` for a launch on its
    current stream (call under ``torch.cuda.device(device)``)."""
    key = (device.index, torch.cuda.current_stream().cuda_stream)
    counters = _T_COUNTERS.pop(key, None)
    if counters is None or counters.numel() < b:
        counters = torch.zeros(b, dtype=torch.int32, device=device)
    while len(_T_COUNTERS) >= _T_STREAMS_KEPT:
        _T_COUNTERS.pop(next(iter(_T_COUNTERS)))
    _T_COUNTERS[key] = counters
    return counters


def lloyd_t_pass(x, centers, assign_only: bool = False):
    """One Lloyd pass over the normalised buffer.

    x: (B, D, N) float32 or bfloat16; centers: (B, k, D) float32. Returns
    labels (B, N) int32 and, unless assign_only, member sums (B, k, D) and
    counts (B, k), float32."""
    _check_buffer(x)
    b, d, n = x.shape
    k = centers.shape[1]
    _kernels.check(1 <= k <= K_MAX, f"k must be in [1, {K_MAX}], got {k}")
    _kernels.check(tuple(centers.shape) == (b, k, d) and centers.dtype == torch.float32,
                   f"centers must be float32 {(b, k, d)}")
    if _kernels.use_plain(x, centers):
        return lloyd_t_pass_plain(x, centers, assign_only)
    _kernels.check(d >= 1 and n >= 1, f"the CUDA kernel takes D >= 1 and N >= 1, got {(d, n)}")
    x, centers = x.contiguous(), centers.contiguous()
    cpi = lloyd_t_plan(b, n, _kernels.sm_count(x.device))
    labels = torch.empty((b, n), dtype=torch.int32, device=x.device)
    sums = part = counters = None
    # on x's device, so the counters are keyed by the stream the kernel runs on
    with torch.cuda.device(x.device):
        if not assign_only:
            sums = torch.empty((b, k, d + 1), dtype=torch.float32, device=x.device)
            part = torch.empty((b, cpi, k, d + 1), dtype=torch.float64, device=x.device)
            counters = _counters(x.device, b)
        _kernels.launch(
            "gcis_lloyd_t", x.data_ptr(), centers.data_ptr(), labels.data_ptr(),
            *(None if assign_only else t.data_ptr() for t in (sums, part, counters)),
            b, d, n, k, _kernels.storage_code(x.dtype), int(assign_only), cpi,
            outputs=() if assign_only else (sums,),
        )
    lloyd_t_pass.launches += 1
    if assign_only:
        return labels
    return labels, sums[:, :, :d], sums[:, :, d]


lloyd_t_pass.launches = 0


# ---------------------------------------------------------------------------
# K6: maximin step
# ---------------------------------------------------------------------------


def maximin_t_pass_plain(x, probe, dmin, reset: bool):
    """Plain PyTorch version of K6 (same contract as maximin_t_pass)."""
    xf = x.to(torch.float32)
    cross = torch.bmm(_rounded(probe, x.dtype)[:, None, :], xf)[:, 0]  # (B, N)
    d2 = xf.square().sum(dim=1) - 2.0 * cross + probe.square().sum(dim=1, keepdim=True)
    new = d2 if reset else torch.minimum(dmin, d2)
    dmin.copy_(new)
    idx = torch.argmax(new, dim=1)  # first maximum
    return torch.gather(xf, 2, idx[:, None, None].expand(-1, x.shape[1], 1))[:, :, 0]


def maximin_t_plan(b: int, n: int, n_sm: int) -> int:
    """CTAs per image of K6: K5's plan (the SMs shared among the images, no
    CTA under 256 pixels, at least one). At config2's fit grid its 16 read
    faster than 8 or 32 (experiments/torch_k6_k7.py)."""
    return lloyd_t_plan(b, n, n_sm)


def maximin_t_pass(x, probe, dmin, reset: bool):
    """One farthest-point step: d2 = ||x||^2 - 2 round(p) . x + ||p||^2 in
    float32 (the reference's expanded form; its ones-row adds 1 - 2 + 1 = 0
    and is left out), ``dmin`` (B, N) float32 becomes d2 (reset) or
    min(dmin, d2), in place. Returns the column (B, D) float32 of x at the
    first index of the new dmin's maximum. probe: (B, D) float32."""
    _check_buffer(x)
    b, d, n = x.shape
    _kernels.check(tuple(probe.shape) == (b, d) and probe.dtype == torch.float32,
                   f"probe must be float32 {(b, d)}")
    _kernels.check(tuple(dmin.shape) == (b, n) and dmin.dtype == torch.float32
                   and dmin.is_contiguous(), f"dmin must be contiguous float32 {(b, n)}")
    if _kernels.use_plain(x, probe, dmin):
        return maximin_t_pass_plain(x, probe, dmin, reset)
    x, probe = x.contiguous(), probe.contiguous()
    cpi = maximin_t_plan(b, n, _kernels.sm_count(x.device))
    bestv = torch.empty((b, cpi), dtype=torch.float32, device=x.device)
    besti = torch.empty((b, cpi), dtype=torch.int32, device=x.device)
    best = torch.empty((b, d), dtype=torch.float32, device=x.device)
    # on x's device, so the counters are keyed by the stream the kernel runs on
    with torch.cuda.device(x.device):
        _kernels.launch(
            "gcis_maximin_t", x.data_ptr(), probe.data_ptr(), dmin.data_ptr(),
            bestv.data_ptr(), besti.data_ptr(), best.data_ptr(),
            _counters(x.device, b).data_ptr(), b, d, n, _kernels.storage_code(x.dtype),
            int(reset), cpi, outputs=(dmin, best),
        )
    maximin_t_pass.launches += 1
    return best


maximin_t_pass.launches = 0


# ---------------------------------------------------------------------------
# K7: Lloyd pass on a row-major buffer
# ---------------------------------------------------------------------------

# K7's launch (csrc/lloyd_rows.cu): 512 threads a CTA, one CTA an SM, at most
# 227 KB of shared memory a CTA; the CTAs of its ordered reduction's groups
_ROWS_SMEM = 227 * 1024
_ROWS_GROUP = 8
_ROWS_BLOCK_TILE = (128, 3)  # K7's tile and stages once a tile's values are staged in blocks


def _rows_smem(d: int, p: int, stages: int, esize: int, vb: int = None) -> int:
    """K7's dynamic shared memory a CTA, as csrc/lloyd_rows.cu's smem_bytes:
    the ring (a stage holds p rows of d values as one span plus 16 bytes
    for its alignment shift; staged in blocks of ``vb`` < d values, p
    segments of a block, each in whole 16-byte chunks with its shift), the
    centre fragments of a block (256 bytes a 16-value chunk, three parts in
    float32), the CTA's sums fragments (512 bytes a 16-value M-tile of the
    d + 1 values) unless staged in blocks, the split scores' exchange (8
    KB), the mbarriers, each stage's pixel offsets, the labels and the
    norms."""
    vb = d if vb is None else vb
    blocked = vb < d
    stage = (p * 16 * ((vb * esize + 30) // 16) if blocked
             else 16 * ((p * d * esize + 15) // 16 + 1))
    return (stages * stage + 256 * -(-vb // 16) * (1 if esize == 2 else 3)
            + (0 if blocked else 512 * ((d + 16) // 16)) + 8192 + 32
            + 4 * ((stages + 1) * p + 8))


def lloyd_rows_plan(b: int, n: int, d: int, esize: int, n_sm: int):
    """K7's launch: (CTAs an image, tiles a CTA, pixels a tile, stages,
    values a staged block).

    A tile is 128 pixels (a 16-pixel group for each pair of the CTA's 16
    warps) or fewer, halving until two stages of its rows fit a CTA's shared
    memory, then the most stages (up to 4) that fit; its rows are staged as
    one span (values a block = d). Where not even 16 pixels' rows fit, a
    tile of 128 pixels is staged in blocks of values through three stages:
    the most values (a multiple of 16) whose stages fit, then blocks as
    even as that allows, so any d has a plan. One CTA an SM: the CTAs of the
    b images make about one wave (n_sm // b an image, each walking
    consecutive tiles), one CTA an image when the batch alone fills the
    card."""
    for p in (128, 64, 32, 16):
        fits = [s for s in (4, 3, 2) if _rows_smem(d, p, s, esize) <= _ROWS_SMEM]
        if fits:
            stages, vb = fits[0], d
            break
    else:
        p, stages = _ROWS_BLOCK_TILE
        most = 16
        while most + 16 < d and _rows_smem(d, p, stages, esize, most + 16) <= _ROWS_SMEM:
            most += 16
        blocks = -(-d // most)
        vb = 16 * -(-(-(-d // blocks)) // 16)
    ntiles = -(-n // p)
    ctas = min(ntiles, max(1, n_sm // b))
    tpc = -(-ntiles // ctas)
    return -(-ntiles // tpc), tpc, p, stages, vb


def lloyd_pass_plain(x, centers, k: int):
    """Plain PyTorch version of K7 (same contract as lloyd_pass)."""
    xf = x.to(torch.float32)
    csq = centers.square().sum(dim=2)
    scores = csq[:, None, :] - 2.0 * torch.bmm(xf, _rounded(centers, x.dtype).transpose(1, 2))
    labels = torch.argmin(scores, dim=2)  # first minimum
    onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)  # (B, N, k)
    return labels.to(torch.int32), torch.bmm(onehot.transpose(1, 2), xf), onehot.sum(dim=1)


def lloyd_pass(x, centers, k: int):
    """One Lloyd pass over a row-major buffer.

    x: (B, N, D) float32 or bfloat16; centers: (B, k, D) float32. Returns
    labels (B, N) int32, member sums (B, k, D) and counts (B, k) float32."""
    _kernels.check(x.dim() == 3, f"x must be (B, N, D), got {tuple(x.shape)}")
    _kernels.storage_code(x.dtype)
    b, n, d = x.shape
    _kernels.check(1 <= k <= K_MAX, f"k must be in [1, {K_MAX}], got {k}")
    _kernels.check(tuple(centers.shape) == (b, k, d) and centers.dtype == torch.float32,
                   f"centers must be float32 {(b, k, d)}")
    if _kernels.use_plain(x, centers):
        return lloyd_pass_plain(x, centers, k)
    _kernels.check(d >= 1 and n >= 1, f"the CUDA kernel takes D >= 1 and N >= 1, got {(d, n)}")
    x, centers = x.contiguous(), centers.contiguous()
    ctas, tpc, p, stages, vb = lloyd_rows_plan(b, n, d, x.element_size(),
                                               _kernels.sm_count(x.device))
    w = k * (d + 1)
    w4 = -(-w // 4) * 4
    ngrp = -(-ctas // _ROWS_GROUP)
    # scratch: the CTAs' partials, the groups' sums past one group, the CTAs'
    # sums fragments when staged in blocks (offsets a multiple of 16 bytes)
    sizes = (b * ctas * w4, b * ngrp * w4 if ngrp > 1 else 0,
             b * ctas * 128 * ((d + 16) // 16) if vb < d else 0)
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    ptrs, off = [], 0
    for size in sizes:
        ptrs.append(scratch[off:].data_ptr() if size else None)
        off += size
    labels = torch.empty((b, n), dtype=torch.int32, device=x.device)
    sums = torch.empty((b, w4), dtype=torch.float32, device=x.device)
    # on x's device, so the counters are keyed by the stream the kernel runs on
    with torch.cuda.device(x.device):
        _kernels.launch("gcis_lloyd_rows", x.data_ptr(), centers.data_ptr(), labels.data_ptr(),
                        sums.data_ptr(), *ptrs,
                        _counters(x.device, b * (ngrp + 1)).data_ptr(), b, d, n, k,
                        _kernels.storage_code(x.dtype), ctas, tpc, p, stages, vb,
                        outputs=(sums[:, :w],))
    lloyd_pass.launches += 1
    sums = sums[:, :w].view(b, k, d + 1)
    return labels, sums[:, :, :d], sums[:, :, d]


lloyd_pass.launches = 0


# ---------------------------------------------------------------------------
# solvers
# ---------------------------------------------------------------------------


def _maximin_init_t_fused(x: torch.Tensor, k: int) -> torch.Tensor:
    """Maximin seeds (B, k, D) float32: probe the float32 mean, then k
    farthest-point steps (the running min restarts on steps 0 and 1)."""
    b, _, n = x.shape
    probe = x.to(torch.float32).sum(dim=2) / n
    dmin = torch.zeros((b, n), dtype=torch.float32, device=x.device)
    cols = []
    for step in range(k):
        probe = maximin_t_pass(x, probe, dmin, step < 2)
        cols.append(probe)
    return torch.stack(cols, dim=1)


def _lloyd_t_updates(x: torch.Tensor, c: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` Lloyd updates (K5) of the centres c (B, k, D) on x (B, D, N);
    an empty cluster keeps its centre."""
    for _ in range(n):
        _, sums, counts = lloyd_t_pass(x, c)
        new = sums / torch.clamp(counts, min=1.0)[:, :, None]
        c = torch.where(counts[:, :, None] > 0, new, c)
    return c


def _solve_t(x: torch.Tensor, c0: torch.Tensor, max_iter: int):
    """Lloyd from centres c0 (B, k, D): exactly ``max_iter`` update passes,
    then one labels pass. Returns (labels (B, N) int32, centres).

    The reference loops until the centres stop changing or ``max_iter``
    passes. Its passes reduce in a fixed order, as K5's do, so a pass at the
    fixed point returns the same centres bit for bit: running the full
    count gives the reference's centres and labels, with no host sync to
    test for the fixed point."""
    c = _lloyd_t_updates(x, c0, max_iter)
    return lloyd_t_pass(x, c, assign_only=True), c


def _pool_xt(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, D, N = h*w) -> (B, D, (h//2)*(w//2)): exact 2x2 block means of
    each row, the ordered float32 sum of models.kmeans.pool2x2."""
    b, d, _ = x.shape
    return pool2x2_mean(x.reshape(b, d, h, w), 2).reshape(b, d, (h // 2) * (w // 2))


def kmeans_fused_t_xt(x: torch.Tensor, k: int, n_iter: int = 25, init_stride: int = 1,
                      hw=None, coarse_iters: int = 0, refine_iters: int = 10,
                      coarse_levels: int = 1, mid_iters: int = 0):
    """k-means on the normalised buffer x (B, D, N). Returns (labels (B, N)
    int32, centres (B, k, D) float32).

    Without a multigrid schedule: maximin seeds (K6; with ``init_stride`` >
    1 ``models.kmeans.maximin_init`` on every init_stride-th pixel), then
    ``n_iter`` Lloyd passes (K5). With
    one (``coarse_iters`` > 0 and ``hw`` = (h, w), N = h * w): x pooled
    ``coarse_levels`` times by exact 2x2 means, seeds (K6) and
    ``coarse_iters`` passes (K5) on the coarsest grid, ``mid_iters`` passes
    on each intermediate grid, coarse to fine, then ``refine_iters``
    full-resolution passes."""
    _kernels.check(1 <= k <= K_MAX, f"fused Lloyd supports k <= {K_MAX}, got {k}")
    if coarse_iters > 0 and hw is not None:
        if init_stride != 1:
            raise ValueError("multigrid schedule requires init_stride == 1")
        (h, w), levels, buf = hw, [], x
        for _ in range(coarse_levels):
            buf = _pool_xt(buf, h, w)
            h, w = h // 2, w // 2
            levels.append(buf)
        c = _lloyd_t_updates(buf, _maximin_init_t_fused(buf, k), coarse_iters)
        for lvl in reversed(levels[:-1]):
            c = _lloyd_t_updates(lvl, c, mid_iters)
        return _solve_t(x, c, refine_iters)
    if init_stride == 1:
        return _solve_t(x, _maximin_init_t_fused(x, k), n_iter)
    # the reference's strided seeding is plain XLA: models.kmeans.maximin_init
    # on the pixels' view of the buffer
    return _solve_t(x, maximin_init(x.transpose(1, 2), k, init_stride).to(torch.float32),
                    n_iter)


def kmeans_fused_t(x: torch.Tensor, k: int, n_iter: int = 25,
                   dtype: torch.dtype = torch.float32, init_stride: int = 1, hw=None,
                   coarse_iters: int = 0, refine_iters: int = 10, coarse_levels: int = 1,
                   mid_iters: int = 0):
    """``kmeans_fused_t_xt`` on features x (B, N, D) (or one image (N, D))
    rounded to ``dtype``: the (B, D, N) buffer is x's transpose, which
    costs no copy when x is the view of a channel-major buffer, as the
    pipeline's features are."""
    if x.dim() == 2:
        labels, centers = kmeans_fused_t(x[None], k, n_iter, dtype, init_stride, hw,
                                         coarse_iters, refine_iters, coarse_levels, mid_iters)
        return labels[0], centers[0]
    return kmeans_fused_t_xt(x.to(dtype).transpose(1, 2).contiguous(), k, n_iter, init_stride,
                             hw, coarse_iters, refine_iters, coarse_levels, mid_iters)


def kmeans_fused(x: torch.Tensor, k: int, n_iter: int = 25,
                 dtype: torch.dtype = torch.float32, init_stride: int = 1):
    """Lloyd k-means of each image of x (B, N, D) (or one image (N, D)) with
    K7, the reference's drop-in for a batched ``kmeans``. Returns (labels
    (B, N) int32, centres (B, k, D) float32).

    The features are rounded to ``dtype``; each image seeds with
    ``maximin_init`` on every ``init_stride``-th row. Each pass assigns with
    the current centres and updates them (an empty cluster keeps its
    centre) until a pass leaves every centre of the batch unchanged or
    ``n_iter`` updates have run; the last pass gives the labels. The test
    for the fixed point reads the centres back to the host once a pass."""
    if x.dim() == 2:
        labels, centers = kmeans_fused(x[None], k, n_iter, dtype, init_stride)
        return labels[0], centers[0]
    _kernels.check(1 <= k <= K_MAX, f"fused Lloyd supports k <= {K_MAX}, got {k}")
    x = x.to(dtype)
    centers = torch.stack([maximin_init(xi, k, init_stride) for xi in x]).to(torch.float32)
    t = 0
    while True:
        labels, sums, counts = lloyd_pass(x, centers, k)
        new = centers
        if t < n_iter:
            upd = sums / torch.clamp(counts, min=1.0)[:, :, None]
            new = torch.where(counts[:, :, None] > 0, upd, centers)
        t += 1
        if t > n_iter or sync("lloyd_rows_fixed_point", torch.equal, new, centers):
            return labels, new
        centers = new
