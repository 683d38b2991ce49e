"""SLIC superpixels and connectivity enforcement, plain PyTorch (counterpart
of the JAX package's models/slic.py).

``slic_plain`` is the plain version of kernel K11 (models/slic_fused.py):
the exact-float32 SLIC of the reference's ``slic``. Centroids are
[L, a, b, y, x] seeded at the grid-cell centres; a pixel z = [L, a, b,
sw y, sw x] scores cs.cs - 2 z.cs against the centroids cs = [L, a, b,
sw y, sw x] of its 3x3 neighbour cells only (the pixel's own |z|^2 is the
same for every candidate and is dropped), ties go to the lowest superpixel
id, and a centroid moves to the mean [L, a, b, y, x] of its members or
stays where it was when it has none. The reference writes the candidate
rule as a masked dense (N, S) score matmul; here each pixel gathers its
<= 9 candidates in ascending id, which is the same function without the
(N, S) intermediates (571 MB per image and pass at 321x481, S = 925).

The score is summed term by term in a fixed order (csq = c0 c0 + c1 c1 +
..., dot = z0 c0 + z1 c1 + ...) with no fused multiply-add, and the moments
accumulate in float64 and round to float32 once, so K11 can repeat this
arithmetic exactly.

``enforce_connectivity_plain`` is the plain version of K14
(models/connectivity.py), bit-equal to the reference's
``enforce_connectivity_device``: 4-connected components of equal labels
(id = the component's smallest flat index), components of at least
``min_size`` pixels renumbered in raster order of their roots and capped at
``s_max``, then Jacobi adoption of the absorbed pixels (first kept
neighbour up, left, right, down) for at most h + w steps, leftovers
clamped to 0. Its components come from union-find hooking with path
compression rather than the reference's run-min sweeps: the components and
their ids are the same, so the output is.

``enforce_connectivity_bfs_plain`` is K14's own algorithm (the city-block
distance to the kept pixels, a pointer to the first nearer neighbour,
pointer jumping), bit-equal to ``enforce_connectivity_plain``;
``connectivity_readings`` reports what the pass meets on a label map.

``enforce_connectivity`` is the copy of the reference's host pass
(numpy/scipy; largest-shared-border absorption).

The reference's single-image entry points keep its names and contracts:
``slic`` (one (H, W, 3) image: ``slic_fused.slic_batch`` on a batch of one
on the card, ``slic_plain`` on the CPU), ``slic_assign`` (its dense masked
assignment) and ``enforce_connectivity_device`` (K14 on the card,
``enforce_connectivity_plain`` on the CPU).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

_SCORE_INF = float("inf")


def grid_shape(h: int, w: int, n_superpixels: int) -> Tuple[int, int, float]:
    """Choose the seed grid (gh, gw) and cell size s for a target count."""
    s = math.sqrt(h * w / n_superpixels)
    gh = max(1, round(h / s))
    gw = max(1, round(w / s))
    return gh, gw, s


def slic_geometry(h: int, w: int, n_superpixels: int, ruler: float):
    """(gh, gw, sw): seed grid + the sqrt spatial weight of the z features."""
    gh, gw, s = grid_shape(h, w, n_superpixels)
    spatial_w = (ruler / s) ** 2
    sw = float(np.sqrt(spatial_w)) if spatial_w > 0 else 0.0
    return gh, gw, sw


def _f32(v: float, device) -> torch.Tensor:
    """A Python float rounded to a float32 scalar tensor, as the reference's
    weakly typed constants meet float32 arrays."""
    return torch.tensor(np.float32(v), device=device)


def slic_seed_coords(h: int, w: int, gh: int, gw: int, device="cpu"):
    """Cell-centre seed coordinates: ((gh, gw) cy, cx float32 grids,
    (gh, gw) iy, ix int64 pixel indices of the colour sample)."""
    cy = (torch.arange(gh, dtype=torch.float32, device=device) + 0.5) * _f32(h / gh, device)
    cx = (torch.arange(gw, dtype=torch.float32, device=device) + 0.5) * _f32(w / gw, device)
    cyg, cxg = torch.meshgrid(cy, cx, indexing="ij")
    iy = cyg.to(torch.int32).clamp(0, h - 1).long()
    ix = cxg.to(torch.int32).clamp(0, w - 1).long()
    return cyg, cxg, iy, ix


def slic_init_centroids(lab: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(B, H, W, 3) Lab -> (B, gh * gw, 5) float32 centroids [L, a, b, y, x]
    at the cell centres, coloured by the pixel under each centre."""
    b, h, w, _ = lab.shape
    cyg, cxg, iy, ix = slic_seed_coords(h, w, gh, gw, lab.device)
    color = lab.to(torch.float32)[:, iy.reshape(-1), ix.reshape(-1)]  # (B, S, 3)
    pos = torch.stack([cyg.reshape(-1), cxg.reshape(-1)], dim=1)
    return torch.cat([color, pos.expand(b, -1, -1)], dim=2).contiguous()


def cell_index(n: int, g: int, device) -> torch.Tensor:
    """(n,) int64 grid cell of each pixel row (or column): clip(int(f32(i) *
    f32(g / n)), 0, g - 1), the reference's float32 cell arithmetic."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return (i * _f32(g / n, device)).to(torch.int32).clamp(0, g - 1).long()


def _candidates(h: int, w: int, gh: int, gw: int, device, row0: int = 0,
                rows: Optional[int] = None):
    """(N, 9) int64 candidate superpixel ids of each pixel in ascending id
    (the 3x3 cells around its own, clipped to the grid) and the (N, 9) mask
    of the ones that exist; of the image's rows [row0, row0 + rows) (all
    by default) of an (h, w) image."""
    rows = h - row0 if rows is None else rows
    cy = cell_index(h, gh, device)[row0:row0 + rows]
    cx = cell_index(w, gw, device)
    d = torch.tensor([-1, 0, 1], device=device)
    gy = cy[:, None, None, None] + d[None, None, :, None]  # (rows, 1, 3, 1)
    gx = cx[None, :, None, None] + d[None, None, None, :]  # (1, w, 1, 3)
    ok = (gy >= 0) & (gy < gh) & (gx >= 0) & (gx < gw)
    ids = gy.clamp(0, gh - 1) * gw + gx.clamp(0, gw - 1)
    return ids.reshape(rows * w, 9), ok.expand(rows, w, 3, 3).reshape(rows * w, 9)


def _pixel_rows(lab: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """(B, H, W, 3) -> (B, N, 5) float32 [L, a, b, y, x], y counted from
    the image row ``row0`` (a strip's first row)."""
    b, h, w, _ = lab.shape
    yy, xx = torch.meshgrid(torch.arange(row0, row0 + h, dtype=torch.float32,
                                         device=lab.device),
                            torch.arange(w, dtype=torch.float32, device=lab.device),
                            indexing="ij")
    pos = torch.stack([yy, xx], dim=2).expand(b, h, w, 2)
    return torch.cat([lab.to(torch.float32), pos], dim=3).reshape(b, h * w, 5)


def _weighted(v: torch.Tensor, sw: torch.Tensor) -> list:
    """[L, a, b, sw y, sw x] columns of (..., 5) rows."""
    return [v[..., 0], v[..., 1], v[..., 2], sw * v[..., 3], sw * v[..., 4]]


def _assign(z: list, cent: torch.Tensor, cand, ok, sw) -> torch.Tensor:
    """(B, N) int64 argmin over each pixel's candidates of csq - 2 z.cs."""
    cs = _weighted(cent, sw)  # each (B, S)
    csq = cs[0] * cs[0]
    for c in cs[1:]:
        csq = csq + c * c
    dot = z[0][:, :, None] * cs[0][:, cand]
    for zc, c in zip(z[1:], cs[1:]):
        dot = dot + zc[:, :, None] * c[:, cand]
    score = csq[:, cand] - 2.0 * dot  # (B, N, 9)
    score = torch.where(ok, score, _SCORE_INF)
    return cand[torch.arange(cand.shape[0], device=cand.device), torch.argmin(score, dim=2)]


def slic_pixel_arrays(lab: torch.Tensor, h: int, w: int, gh: int, gw: int, sw: float,
                      row0: int = 0):
    """(B, rows, W, 3) Lab (the whole image, or a strip whose first image
    row is ``row0``) of an (h, w) image -> ((B, N, 5) [L, a, b, y, x] rows
    in image coordinates, their weighted columns z, the (N, 9) candidate
    ids and mask): what ``_assign`` and ``slic_moments`` read."""
    swt = _f32(sw, lab.device)
    rows = _pixel_rows(lab, row0)
    cand, ok = _candidates(h, w, gh, gw, lab.device, row0, lab.shape[1])
    return rows, _weighted(rows, swt), cand, ok


def slic_moments(rows: torch.Tensor, labels: torch.Tensor, n_sp: int):
    """Per-centroid (sums (B, S, 5) float64, counts (B, S) int64) of the
    [L, a, b, y, x] rows of each superpixel's members."""
    b, n, _ = rows.shape
    flat = (labels + torch.arange(b, device=labels.device)[:, None] * n_sp).reshape(-1)
    sums = torch.zeros((b * n_sp, 5), dtype=torch.float64, device=rows.device)
    sums.index_add_(0, flat, rows.reshape(-1, 5).to(torch.float64))
    counts = torch.bincount(flat, minlength=b * n_sp)
    return sums.reshape(b, n_sp, 5), counts.reshape(b, n_sp)


def slic_update(centroids: torch.Tensor, sums: torch.Tensor, cnts: torch.Tensor) -> torch.Tensor:
    """Centroid step with the empty-cluster rule (keep the previous one)."""
    c = cnts.to(torch.float32)[:, :, None]
    new = sums.to(torch.float32) / torch.clamp(c, min=1.0)
    return torch.where(c > 0, new, centroids)


def slic_plain(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
               n_iter: int = 10) -> torch.Tensor:
    """Plain version of K11: (B, H, W, 3) float32 Lab -> (B, H, W) int32
    superpixel labels in [0, gh * gw)."""
    b, h, w, _ = lab.shape
    gh, gw, sw = slic_geometry(h, w, n_superpixels, ruler)
    n_sp = gh * gw
    dev = lab.device
    swt = _f32(sw, dev)
    rows = _pixel_rows(lab)
    z = _weighted(rows, swt)
    cand, ok = _candidates(h, w, gh, gw, dev)
    cent = slic_init_centroids(lab, gh, gw)
    for _ in range(n_iter):
        cent = slic_update(cent, *slic_moments(rows, _assign(z, cent, cand, ok, swt), n_sp))
    return _assign(z, cent, cand, ok, swt).to(torch.int32).reshape(b, h, w)


def slic_assign(z: torch.Tensor, centroids: torch.Tensor, neighbor: torch.Tensor,
                sw: float) -> torch.Tensor:
    """The reference's assignment: (N, 5) z + (S, 5) centroids [L, a, b, y,
    x] + (N, S) bool candidate mask -> (N,) int32 argmin of |c|^2 - 2 z.c
    over the candidates (c the centroids with sw * y, sw * x), the lowest
    id on ties, as one dense (N, S) score matrix.

    The float32 arithmetic is the reference's term for term, so that ties
    within rounding fall the same way: |c|^2 summed in column order, and
    z.c in the order of its five-term float32 dot (a fused multiply-add
    chain over the even terms and one over the odd, their sum, then the
    fifth product; each fused step is taken exactly in float64 and rounded
    once). Not on the pipeline's path, which runs K11-K13."""
    cs = torch.cat([centroids[:, :3], sw * centroids[:, 3:]], dim=1)
    csq = cs[:, 0] * cs[:, 0]
    for j in range(1, 5):
        csq = csq + cs[:, j] * cs[:, j]
    prod = [z[:, j, None].double() * cs[None, :, j].double() for j in range(5)]  # exact
    even = (prod[0].float().double() + prod[2]).float()
    odd = (prod[1].float().double() + prod[3]).float()
    dot = (even + odd) + prod[4].float()
    scores = torch.where(neighbor, csq - 2.0 * dot, _SCORE_INF)
    return torch.argmin(scores, dim=1).to(torch.int32)


def slic(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
         n_iter: int = 10) -> torch.Tensor:
    """(H, W, 3) Lab image -> (H, W) int32 superpixel labels in [0, gh * gw):
    ``slic_fused.slic_batch`` on a batch of one on the card (the kernel
    ``slic_route`` picks), ``slic_plain`` on the CPU."""
    from gabor_color_image_segmentation_tpu_torch import _kernels
    from gabor_color_image_segmentation_tpu_torch.models.slic_fused import slic_batch

    lab = torch.as_tensor(lab).to(torch.float32)[None]
    if _kernels.use_plain(lab):
        return slic_plain(lab, n_superpixels, ruler, n_iter)[0]
    return slic_batch(lab, n_superpixels, ruler, n_iter)[0]


# ---------------------------------------------------------------------------
# Connectivity enforcement (plain version of K14)
# ---------------------------------------------------------------------------


def connectivity_defaults(h: int, w: int, n_sp: int, min_size: Optional[int],
                          s_max: Optional[int]) -> Tuple[int, int]:
    """The reference's defaults: min_size = cell area / 4, s_max = n_sp."""
    if min_size is None:
        min_size = max(1, (h * w) // n_sp // 4)
    return min_size, (n_sp if s_max is None else s_max)


def _components(labels: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """connected_components, and the number of its hook rounds."""
    b, h, w = labels.shape
    n = h * w
    lab = labels.reshape(b, n)
    idx = torch.arange(n, device=labels.device)
    par = idx.expand(b, n).clone()
    pix = idx.reshape(h, w)
    edges = [(pix[:, :-1].reshape(-1), pix[:, 1:].reshape(-1)),
             (pix[:-1].reshape(-1), pix[1:].reshape(-1))]
    edges = [(p, q) for p, q in edges if p.numel()]
    rounds = 0
    while True:
        rounds += 1
        changed = False
        for p, q in edges:
            same = lab[:, p] == lab[:, q]
            rp, rq = par[:, p], par[:, q]
            hook = same & (rp != rq)
            if bool(hook.any()):
                changed = True
                hi = torch.where(hook, torch.maximum(rp, rq), rp)
                lo = torch.where(hook, torch.minimum(rp, rq), rp)
                par.scatter_reduce_(1, hi, lo, "amin")
        while True:  # compress every path to its root
            nxt = torch.gather(par, 1, par)
            if torch.equal(nxt, par):
                break
            par = nxt
        if not changed:
            return par, rounds


def connected_components(labels: torch.Tensor) -> torch.Tensor:
    """(B, H, W) int labels -> (B, N) int64 ids of their 4-connected
    equal-label components, each the smallest flat index it contains.

    Union-find over (B, N): every edge of equal labels hooks the larger of
    its two roots to the smaller (a scatter-min), then path compression,
    until no edge joins two roots."""
    return _components(labels)[0]


def _seeds(labels: torch.Tensor, comp: torch.Tensor, min_size: int,
           s_max: int) -> torch.Tensor:
    """(B, H, W) labels and their components -> (B, H, W) int64 seeds: each
    kept component's new id (raster order of the roots of >= min_size
    pixels, below s_max), -1 on absorbed pixels."""
    b, h, w = labels.shape
    n = h * w
    idx = torch.arange(n, device=labels.device)
    counts = torch.zeros((b, n), dtype=torch.int64, device=labels.device)
    counts.scatter_add_(1, comp, torch.ones_like(comp))
    survives = (comp == idx) & (counts >= min_size)
    newid = torch.cumsum(survives.to(torch.int64), dim=1) - 1  # raster order
    survives = survives & (newid < s_max)
    seed = torch.where(survives, newid, -1)
    return torch.gather(seed, 1, comp).reshape(b, h, w)


def _shifted(x: torch.Tensor, dy: int, dx: int, fill: int) -> torch.Tensor:
    """(B, H, W) -> out[y, x] = x[y + dy, x + dx], ``fill`` outside the
    image."""
    h, w = x.shape[1:]
    out = torch.full_like(x, fill)
    ys, yd = (slice(dy, None), slice(None, h - dy)) if dy >= 0 else \
        (slice(None, h + dy), slice(-dy, None))
    xs, xd = (slice(dx, None), slice(None, w - dx)) if dx >= 0 else \
        (slice(None, w + dx), slice(-dx, None))
    out[:, yd, xd] = x[:, ys, xs]
    return out


# up, left, right, down: the adoption's priority, as (dy, dx)
_PRIORITY = ((-1, 0), (0, -1), (0, 1), (1, 0))


def _jacobi_adoption(lab: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The reference's adoption loop on (B, H, W) seeds: (labels with -1
    left where no kept pixel reached, the steps it ran)."""
    h, w = lab.shape[1:]
    t = 0
    while bool((lab < 0).any()) and t < h + w:
        cand = lab
        for dy, dx in reversed(_PRIORITY):  # so the first of them wins
            nl = _shifted(lab, dy, dx, -1)
            cand = torch.where(nl >= 0, nl, cand)
        lab = torch.where(lab < 0, cand, lab)
        t += 1
    return lab, t


def enforce_connectivity_plain(labels: torch.Tensor, n_sp: int,
                               min_size: Optional[int] = None,
                               s_max: Optional[int] = None) -> torch.Tensor:
    """Plain version of K14: (B, H, W) int32 SLIC labels -> (B, H, W) int32
    4-connected superpixels in [0, s_max)."""
    h, w = labels.shape[1:]
    min_size, s_max = connectivity_defaults(h, w, n_sp, min_size, s_max)
    lab, _ = _jacobi_adoption(_seeds(labels, connected_components(labels), min_size, s_max))
    return torch.clamp(lab, min=0).to(torch.int32)


def enforce_connectivity_device(labels: torch.Tensor, n_sp: int,
                                min_size: Optional[int] = None,
                                s_max: Optional[int] = None) -> torch.Tensor:
    """The reference's name for the connectivity pass: (B, H, W) int32 SLIC
    labels -> (B, H, W) int32 4-connected superpixels in [0, s_max), K14
    (``connectivity.enforce_connectivity_fused``) on the card and
    ``enforce_connectivity_plain`` on the CPU."""
    from gabor_color_image_segmentation_tpu_torch.models.connectivity import (
        enforce_connectivity_fused,
    )

    return enforce_connectivity_fused(labels, n_sp, min_size, s_max)


DIST_INF = 0x3FFFFFFF  # csrc/connectivity.cu's INF: no kept pixel in reach


def city_block_distance(kept: torch.Tensor) -> torch.Tensor:
    """(B, H, W) bool -> (B, H, W) int64: each pixel's distance to the
    nearest kept pixel of its image along the 4-connected grid, DIST_INF
    where the image keeps none. As K14 takes it: the distance along each
    column (a min-plus scan down and one up), then min over x' of that +
    |x - x'| along each row (a prefix min of g - x', then a suffix min of
    f + x' on its result f)."""
    h, w = kept.shape[1:]
    g = torch.where(kept, 0, DIST_INF).to(torch.int64)
    ys = torch.arange(h, device=kept.device).reshape(1, h, 1)
    xs = torch.arange(w, device=kept.device).reshape(1, 1, w)
    fwd = torch.cummin(g - ys, dim=1).values + ys
    g = torch.minimum(fwd, torch.cummin((g + ys).flip(1), dim=1).values.flip(1) - ys)
    g = g.clamp(max=DIST_INF)
    f = (torch.cummin(g - xs, dim=2).values + xs).clamp(max=DIST_INF)
    return (torch.cummin((f + xs).flip(2), dim=2).values.flip(2) - xs).clamp(max=DIST_INF)


def enforce_connectivity_bfs_plain(labels: torch.Tensor, n_sp: int,
                                   min_size: Optional[int] = None,
                                   s_max: Optional[int] = None) -> torch.Tensor:
    """K14's algorithm in PyTorch, bit-equal to enforce_connectivity_plain.

    The Jacobi loop sets an absorbed pixel at step dist(p), its city-block
    distance to the nearest kept pixel (every unset pixel can be set, so
    nothing blocks the spread), to the id of its first neighbour, up, left,
    right, down, with dist one less. So each absorbed pixel points to that
    neighbour, and ceil(log2(h + w)) rounds of pointer jumping reach the
    kept pixel whose id it takes. dist <= h + w - 2 wherever the image keeps
    a pixel; pixels past the loop's h + w steps (DIST_INF: the image keeps
    none) end at 0, as its clamp leaves them."""
    b, h, w = labels.shape
    n = h * w
    min_size, s_max = connectivity_defaults(h, w, n_sp, min_size, s_max)
    lab = _seeds(labels, connected_components(labels), min_size, s_max)
    dist = city_block_distance(lab >= 0)
    idx = torch.arange(n, device=labels.device).reshape(1, h, w).expand(b, h, w)
    ptr = torch.where(lab >= 0, idx, -1)
    reach = (lab < 0) & (dist <= h + w)
    for dy, dx in reversed(_PRIORITY):  # so the first of them wins
        nearer = _shifted(dist, dy, dx, -1) == dist - 1
        ptr = torch.where(reach & nearer, idx + dy * w + dx, ptr)
    ptr = ptr.reshape(b, n)
    span = 1
    while span < h + w:
        ptr = torch.where(ptr >= 0, torch.gather(ptr, 1, ptr.clamp(min=0)), ptr)
        span *= 2
    out = torch.where(ptr >= 0, torch.gather(lab.reshape(b, n), 1, ptr.clamp(min=0)), 0)
    return out.reshape(b, h, w).to(torch.int32)


def connectivity_readings(labels: torch.Tensor, n_sp: int,
                          min_size: Optional[int] = None,
                          s_max: Optional[int] = None) -> dict:
    """What the pass meets on ``labels``: the plain union-find's hook rounds,
    the Jacobi adoption's steps, the largest adoption distance, the share of
    absorbed pixels and the kept components per image (min, max)."""
    h, w = labels.shape[1:]
    min_size, s_max = connectivity_defaults(h, w, n_sp, min_size, s_max)
    comp, rounds = _components(labels)
    lab = _seeds(labels, comp, min_size, s_max)
    _, steps = _jacobi_adoption(lab)
    dist = city_block_distance(lab >= 0)
    finite = dist[dist < DIST_INF]
    kept = (lab.amax(dim=(1, 2)) + 1).tolist()
    return {"union_find_rounds": rounds, "adoption_steps": steps,
            "max_distance": int(finite.max()) if finite.numel() else 0,
            "absorbed_share": float((lab < 0).float().mean()),
            "kept_per_image": (min(kept), max(kept))}


def enforce_connectivity(labels: np.ndarray, min_size: int | None = None) -> np.ndarray:
    """Host post-pass mirroring SuperpixelSLIC::enforceLabelConnectivity:
    split disconnected fragments of a label, absorb fragments smaller than
    min_size (default: cell area / 4) into their largest adjacent component.

    Returns contiguous int32 labels.
    """
    from scipy import ndimage

    h, w = labels.shape
    n_in = int(labels.max()) + 1
    if min_size is None:
        min_size = max(1, (h * w) // n_in // 4)

    # connected components per label value (4-connectivity, SLIC convention)
    comp = np.full((h, w), -1, np.int32)
    n_comp = 0
    structure = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
    for v in range(n_in):
        mask = labels == v
        if not mask.any():
            continue
        cc, n = ndimage.label(mask, structure=structure)
        comp[mask] = cc[mask] + n_comp - 1
        n_comp += n

    # absorb small components into the most-adjacent large neighbour, looping
    # because absorption can chain (tiny fragment rings)
    out = comp.copy()
    for _ in range(4):
        sizes = np.bincount(out.reshape(-1))
        small = np.flatnonzero(sizes < min_size)
        if small.size == 0:
            break
        small_set = np.zeros(sizes.size, bool)
        small_set[small] = True
        # horizontal + vertical neighbour pairs with differing components
        pairs = []
        a, b = out[:, :-1].reshape(-1), out[:, 1:].reshape(-1)
        m = a != b
        pairs.append(np.stack([a[m], b[m]], 1))
        a, b = out[:-1, :].reshape(-1), out[1:, :].reshape(-1)
        m = a != b
        pairs.append(np.stack([a[m], b[m]], 1))
        pr = np.concatenate(pairs)
        pr = np.concatenate([pr, pr[:, ::-1]])  # symmetric
        # for each small comp, count adjacency to each neighbour; pick argmax
        m = small_set[pr[:, 0]]
        pr = pr[m]
        if pr.size == 0:
            break
        key = pr[:, 0].astype(np.int64) * sizes.size + pr[:, 1]
        uk, cnt = np.unique(key, return_counts=True)
        order = np.argsort(-cnt, kind="stable")
        uk, cnt = uk[order], cnt[order]
        src = (uk // sizes.size).astype(np.int32)
        dst = (uk % sizes.size).astype(np.int32)
        # first occurrence per src = neighbour with max shared boundary
        first = np.unique(src, return_index=True)[1]
        mapping = np.arange(sizes.size, dtype=np.int32)
        mapping[src[first]] = dst[first]
        out = mapping[out]

    # relabel contiguous
    _, out = np.unique(out, return_inverse=True)
    return out.reshape(h, w).astype(np.int32)
