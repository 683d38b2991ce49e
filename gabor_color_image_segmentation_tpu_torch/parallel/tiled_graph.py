"""The distributed graph-cut stage over the ``space`` axis (counterpart of
the JAX package's parallel/tiled_graph.py), on one controller's strips
(parallel/mesh.py).

* **SLIC** (``slic_sharded``, models/slic.py's exact-float32 semantics):
  each shard assigns its own pixels against the replicated centroids in
  global row coordinates; the float64 member sums and the counts are
  psum'd, an (S, 6)-sized psum an iteration, and every shard steps the same
  centroids. The seed colours are rebuilt by mask + psum with one non-zero
  addend per entry, so exactly.
* **Connectivity** (``enforce_connectivity_sharded``): run-min sweeps on
  each strip alternate with a one-row seam merge until no id moves; the
  component sizes and the survivor bitmap are (H*W,)-sized integer tables
  psum'd to every shard; the Jacobi adoption runs with one-row halos. Every
  step is integer arithmetic with order-free reductions, so the result is
  bit-equal to the single-chip pass (models/slic.py::
  enforce_connectivity_plain, kernel K14 on the card). Each fixpoint loop
  reads a psum'd flag back to the host once an iteration (``mesh.
  host_syncs``); every image runs its own loops, so no shard waits on
  another image's count.
* **Moments and cut** (``graph_cut_strip``): each shard's superpixel sums
  and counts come from kernel K17 (models/graph.py's call, in the features'
  dtype), psum'd; the affinity and the spectral n-cut run once an image on
  the psum'd (S, D) statistics (every shard's inputs are the same bits, so
  one computation is every shard's), and the (S,) region table is copied
  to each shard, whose pixels read it through kernel K15.

SLIC and connectivity are plain torch, as the reference leaves them to XLA.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from gabor_color_image_segmentation_tpu_torch.models.graph import (
    affinity_matrix,
    resolve_eig_method,
    spectral_labels,
)
from gabor_color_image_segmentation_tpu_torch.models.graph_fused import (
    superpixel_moments_fused_t,
)
from gabor_color_image_segmentation_tpu_torch.models.slic import (
    _assign,
    _f32,
    _shifted,
    connectivity_defaults,
    grid_shape,
    slic_geometry,
    slic_moments,
    slic_pixel_arrays,
    slic_seed_coords,
    slic_update,
)
from gabor_color_image_segmentation_tpu_torch.ops.lookup import table_lookup
from gabor_color_image_segmentation_tpu_torch.parallel.mesh import Mesh

Shards = List[torch.Tensor]
_RUN_BIG = 2 ** 30


def _neighbor_rows(xs: Shards, mesh: Mesh, axis: str, fill) -> Tuple[Shards, Shards]:
    """(rows, W) strips -> (top halo, bottom halo), each (1, W): the
    previous shard's last row (``fill`` on shard 0) and the next shard's
    first row (``fill`` on the last shard)."""
    n = mesh.shape[axis]
    from_prev = mesh.ppermute([x[-1:] for x in xs], axis, [(i, (i + 1) % n) for i in range(n)])
    from_next = mesh.ppermute([x[:1] for x in xs], axis, [(i, (i - 1) % n) for i in range(n)])
    top = [torch.full_like(t, fill) if i == 0 else t for i, t in enumerate(from_prev)]
    bot = [torch.full_like(b, fill) if i == n - 1 else b for i, b in enumerate(from_next)]
    return top, bot


# ---------------------------------------------------------------------------
# SLIC
# ---------------------------------------------------------------------------


def slic_sharded(labs: Shards, h: int, w: int, n_superpixels: int, ruler: float,
                 n_iter: int, mesh: Mesh, axis: str) -> Shards:
    """(rows, W, 3) Lab strips of an (h, w) image -> (rows, W) int32
    superpixel labels in [0, gh * gw), the same centroids on every shard."""
    gh, gw, sw = slic_geometry(h, w, n_superpixels, ruler)
    n_sp = gh * gw
    rows = labs[0].shape[0]
    arrays = [slic_pixel_arrays(lab[None], h, w, gh, gw, sw, i * rows)
              for i, lab in enumerate(labs)]
    seeds, parts = [], []
    for i, lab in enumerate(labs):
        row0 = i * rows
        cyg, cxg, iy, ix = slic_seed_coords(h, w, gh, gw, lab.device)
        iy, ix = iy.reshape(-1), ix.reshape(-1)
        own = (iy >= row0) & (iy < row0 + rows)
        iy_loc = torch.clamp(iy - row0, 0, rows - 1)
        parts.append(torch.where(own[:, None], lab[iy_loc, ix].to(torch.float32), 0.0))
        seeds.append(torch.stack([cyg.reshape(-1), cxg.reshape(-1)], dim=1))
    colors = mesh.psum(parts, axis)  # (S, 3), one non-zero addend each
    cents = [torch.cat([c, yx], dim=1)[None] for c, yx in zip(colors, seeds)]
    swts = [_f32(sw, lab.device) for lab in labs]
    for _ in range(n_iter):
        mom = [slic_moments(px, _assign(z, c, cand, ok, s), n_sp)
               for (px, z, cand, ok), c, s in zip(arrays, cents, swts)]
        sums = mesh.psum([m[0] for m in mom], axis)
        counts = mesh.psum([m[1] for m in mom], axis)
        cents = [slic_update(c, s, n) for c, s, n in zip(cents, sums, counts)]
    return [_assign(z, c, cand, ok, s).to(torch.int32).reshape(rows, w)
            for (_, z, cand, ok), c, s in zip(arrays, cents, swts)]


# ---------------------------------------------------------------------------
# connectivity
# ---------------------------------------------------------------------------


def _shift1d(x: torch.Tensor, k: int, dim: int, fill) -> torch.Tensor:
    """out[i] = x[i - k] along ``dim`` (k may be negative), ``fill`` outside."""
    n = x.shape[dim]
    out = torch.full_like(x, fill)
    if abs(k) < n:
        if k >= 0:
            out.narrow(dim, k, n - k).copy_(x.narrow(dim, 0, n - k))
        else:
            out.narrow(dim, 0, n + k).copy_(x.narrow(dim, -k, n + k))
    return out


def _run_min(vals: torch.Tensor, keys: torch.Tensor, dim: int) -> torch.Tensor:
    """Min of ``vals`` over each position's maximal equal-``keys`` run along
    ``dim``: prefix doubling both ways (the reference's _run_extreme)."""
    n = vals.shape[dim]
    out = vals
    for direction in (1, -1):
        ok = _shift1d(keys, direction, dim, -1) == keys
        v, k = vals, 1
        while k < n:
            v = torch.where(ok, torch.minimum(v, _shift1d(v, direction * k, dim, _RUN_BIG)), v)
            ok = ok & _shift1d(ok, direction * k, dim, False)
            k *= 2
        out = torch.minimum(out, v)
    return out


def _pass_min(vals: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """One row-then-column run-min sweep over (rows, W) arrays."""
    return _run_min(_run_min(vals, keys, 1), keys, 0)


def _cc_sharded(labels: Shards, w: int, mesh: Mesh, axis: str) -> Shards:
    """(rows, W) strip labels -> (rows, W) int32 component ids, each the
    least global flat index of its 4-connected equal-label component: local
    sweeps alternating with a one-row seam merge to the fixed point."""
    rows = labels[0].shape[0]
    top_lab, bot_lab = _neighbor_rows(labels, mesh, axis, -1)
    comps = [_pass_min(i * rows * w + torch.arange(rows * w, dtype=torch.int32,
                                                   device=lab.device).reshape(rows, w), lab)
             for i, lab in enumerate(labels)]
    while True:
        top_c, bot_c = _neighbor_rows(comps, mesh, axis, _RUN_BIG)
        new = []
        for lab, comp, tl, bl, tc, bc in zip(labels, comps, top_lab, bot_lab, top_c, bot_c):
            first = torch.where(lab[:1] == tl, torch.minimum(comp[:1], tc), comp[:1])
            last = torch.where(lab[-1:] == bl, torch.minimum(comp[-1:], bc), comp[-1:])
            if rows == 1:
                seam = torch.minimum(first, last)
            else:
                seam = torch.cat([first, comp[1:-1], last], dim=0)
            new.append(_pass_min(seam, lab))
        moved = mesh.any_true([torch.any(a != b) for a, b in zip(new, comps)], axis)
        comps = new
        if not moved:
            return comps


def enforce_connectivity_sharded(labels: Shards, n_sp: int, h: int, mesh: Mesh, axis: str,
                                 min_size: Optional[int] = None,
                                 s_max: Optional[int] = None) -> Shards:
    """(rows, W) int32 SLIC label strips of an (h, W) image -> (rows, W)
    int32 4-connected superpixels in [0, s_max), bit-equal to the
    single-chip pass on the gathered image."""
    rows, w = labels[0].shape
    n = h * w
    min_size, s_max = connectivity_defaults(h, w, n_sp, min_size, s_max)
    comps = _cc_sharded(labels, w, mesh, axis)
    flat = [c.reshape(-1).long() for c in comps]
    counts = mesh.psum([torch.bincount(f, minlength=n) for f in flat], axis)
    parts = []
    for i, (f, cnt) in enumerate(zip(flat, counts)):
        gidx = torch.arange(i * rows * w, (i + 1) * rows * w, device=f.device)
        keep = (f == gidx) & (cnt[f] >= min_size)
        part = torch.zeros(n, dtype=torch.int64, device=f.device)
        part[i * rows * w:(i + 1) * rows * w] = keep.to(torch.int64)
        parts.append(part)
    bitmap = mesh.psum(parts, axis)
    labs = []
    for f, bm in zip(flat, bitmap):
        newid = torch.cumsum(bm, dim=0) - 1  # raster order of the roots
        table = torch.where((bm > 0) & (newid < s_max), newid, -1)
        labs.append(table[f].reshape(rows, w))
    kept = [lab >= 0 for lab in labs]
    t = 0
    while mesh.any_true([~torch.all(k) for k in kept], axis) and t < h + w:
        top_l, bot_l = _neighbor_rows(labs, mesh, axis, 0)
        top_k, bot_k = _neighbor_rows([k.to(torch.int32) for k in kept], mesh, axis, 0)
        new_l, new_k = [], []
        for lab, kp, tl, bl, tk, bk in zip(labs, kept, top_l, bot_l, top_k, bot_k):
            labp = torch.cat([tl, lab, bl], dim=0)
            keptp = torch.cat([tk, kp.to(torch.int32), bk], dim=0)
            cand, have = lab, torch.zeros_like(kp)
            # reverse priority (down, right, left, up), so the first listed wins
            for dy, dx in ((1, 0), (0, 1), (0, -1), (-1, 0)):
                if dx:
                    nl = _shifted(lab[None], 0, dx, 0)[0]
                    nk = _shifted(kp[None], 0, dx, False)[0]
                else:
                    nl = labp[1 + dy:1 + dy + rows]
                    nk = keptp[1 + dy:1 + dy + rows] > 0
                cand = torch.where(nk, nl, cand)
                have = have | nk
            adopt = ~kp & have
            new_l.append(torch.where(adopt, cand, lab))
            new_k.append(kp | adopt)
        labs, kept = new_l, new_k
        t += 1
    return [torch.clamp(lab, min=0).to(torch.int32) for lab in labs]


# ---------------------------------------------------------------------------
# moments and the cut
# ---------------------------------------------------------------------------


def superpixel_means_sharded(feats: Shards, sp: Shards, n_sp: int, mesh: Mesh, axis: str
                             ) -> Tuple[Shards, Shards]:
    """(D, N_local) features + (N_local,) int32 superpixel ids per shard ->
    replicated ((S, D) means, (S,) counts): each shard's sums and counts by
    K17, called as models/graph.py::superpixel_means calls it (in the
    features' dtype), psum'd."""
    mom = [superpixel_moments_fused_t(s.reshape(1, -1), f[None], n_sp, dtype=f.dtype)
           for f, s in zip(feats, sp)]
    mom = [(m[0][0], m[1][0]) for m in mom]
    sums = mesh.psum([m[0] for m in mom], axis)
    counts = mesh.psum([m[1] for m in mom], axis)
    return [s / torch.clamp(c, min=1.0)[:, None] for s, c in zip(sums, counts)], counts


def graph_cut_strip(feats: Shards, labs: Shards, cfg, h: int, mesh: Mesh, axis: str) -> Shards:
    """The cut chain on a row-sharded (pooled) image: (D, rows, W) features
    and (rows, W, 3) Lab strips, ``h`` the image's (pooled) height ->
    (rows, W) int32 region label strips."""
    g = cfg.graph
    d, rows, w = feats[0].shape
    sp = slic_sharded(labs, h, w, g.n_superpixels, g.slic_compactness, g.slic_iters, mesh,
                      axis)
    gh, gw, _ = grid_shape(h, w, g.n_superpixels)
    sp = enforce_connectivity_sharded(sp, gh * gw, h, mesh, axis)
    means, counts = superpixel_means_sharded([f.reshape(d, rows * w) for f in feats], sp,
                                             gh * gw, mesh, axis)
    # every shard holds the same statistics: the cut runs once, on shard 0's
    # device, and its (S,) table is every shard's
    dev0 = means[0].device
    aff = affinity_matrix(means[0][None], g.affinity_sigma, counts[0][None],
                          g.affinity_sigma_scale)
    regions = spectral_labels(aff, g.n_regions,
                              eig_method=resolve_eig_method(g, cfg.dtype, dev0))
    return [table_lookup(s.reshape(1, -1), regions.to(s.device)).reshape(rows, w)
            for s in sp]


def graph_strip_fn(strips: Shards, cfg, bank, h: int, w: int, mesh: Mesh, axis: str) -> Shards:
    """One frame's (rows, W, 3) sRGB strips -> (rows, W) int32 labels of the
    filter -> cut chain: pooled strip features, the distributed graph stage
    on the pooled grid, each label repeated 2^pool times along both axes."""
    from gabor_color_image_segmentation_tpu_torch.parallel.tiling import _strip_graph_inputs

    p = cfg.graph.pool
    feats, labs = _strip_graph_inputs(strips, cfg, bank, mesh, axis)
    labels = graph_cut_strip(feats, labs, cfg, h >> p, mesh, axis)
    f = 1 << p
    return [lab.repeat_interleave(f, dim=0).repeat_interleave(f, dim=1) if p else lab
            for lab in labels]
