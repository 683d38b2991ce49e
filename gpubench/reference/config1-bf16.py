"""Plain reference of config1-bf16: the 80-kernel bank's energies and
their 2x2 twin, the standardisation with the coherence fold, then the
multigrid k-means: maximin seeds and ``coarse_iters`` Lloyd passes on the
grid pooled ``coarse_levels`` times, up to ``mid_iters`` passes on each
finer pooled grid, up to ``refine_iters`` at full resolution, one
assignment pass for the labels.

Scores are ||c - b||^2 - 2 (a (c - b)) . raw over the raw rows, the folded
centre rows stored as the energies are; first minimum wins; an empty
cluster keeps its centre; a level's passes stop at the fixed point.
"""

from __future__ import annotations

import torch

from gpubench.reference import common


def _coarse_centers(xp, k: int, iters: int, store):
    """Maximin seeds (the stored mean, then farthest points, the running
    minimum restarting on steps 0 and 1, first index on ties) and ``iters``
    Lloyd passes on the normalised buffer xp (B, d, m)."""
    d, m = xp.shape[1], xp.shape[2]
    probe = store(xp.sum(dim=2) / m)
    dmin, cols = None, []
    for step in range(k):
        d2 = (xp - probe[:, :, None]).square().sum(dim=1)
        dmin = d2 if step < 2 else torch.minimum(dmin, d2)
        idx = torch.argmax(dmin, dim=1)
        probe = torch.gather(xp, 2, idx[:, None, None].expand(-1, d, 1))[:, :, 0]
        cols.append(probe)
    c = torch.stack(cols, dim=1)
    for _ in range(iters):
        scores = c.square().sum(dim=2)[:, :, None] - 2.0 * torch.bmm(store(c), xp)
        onehot = torch.nn.functional.one_hot(torch.argmin(scores, dim=1), k).to(torch.float32)
        counts = onehot.sum(dim=1)
        new = torch.bmm(xp, onehot).transpose(1, 2) / torch.clamp(counts, min=1.0)[:, :, None]
        c = torch.where(counts[:, :, None] > 0, new, c)
    return c


def _scores(x, c, a, b, store):
    u = c - b[:, None, :]
    wc = store(a[:, None, :] * u)
    return u.square().sum(dim=2)[:, :, None] - 2.0 * torch.bmm(wc, x)


def _solve(xe, col, a, b, c, max_iter: int, store):
    """Up to ``max_iter`` Lloyd passes on raw rows from normalised centres
    c (B, k, D), stopping once a pass leaves every centre unchanged."""
    x = common.raw_rows(xe, col)
    k = c.shape[1]
    for _ in range(max_iter):
        labels = torch.argmin(_scores(x, c, a, b, store), dim=1)
        onehot = torch.nn.functional.one_hot(labels, k).to(torch.float32)
        counts = onehot.sum(dim=1)
        raw_mean = torch.bmm(x, onehot).transpose(1, 2) / torch.clamp(counts, min=1.0)[:, :, None]
        new = torch.where(counts[:, :, None] > 0, a[:, None, :] * raw_mean + b[:, None, :], c)
        changed = bool((new != c).any())
        c = new
        if not changed:
            break
    return c


def segment(rgb: torch.Tensor, cfg: dict, store) -> torch.Tensor:
    """(B, H, W, 3) uint8 on the device -> (B, H, W) int64 labels."""
    bsz, h, w, _ = rgb.shape
    cl = cfg["cluster"]
    if cl["method"] != "kmeans" or cl["coarse_iters"] <= 0 or cl["init_stride"] != 1:
        raise ValueError("this reference runs the multigrid k-means with stride 1")
    lab = common.rgb_to_lab(rgb)
    groups = common.bank_groups(cfg["bank"], rgb.device)
    energies, twin = common.gabor_energies(lab, groups, store, twin=True)
    col = common.color4(lab, store)
    pc0 = common.pool2x2(col, store)
    a, b = common.affine(energies, col, cl, store, twins=(twin, pc0))
    levels = [(twin, pc0)]
    for _ in range(cl["coarse_levels"] - 1):
        pe, pc = levels[-1]
        levels.append((common.pool2x2(pe, store), common.pool2x2(pc, store)))
    xp = common.normalised(*levels[-1], a, b, store)
    c = _coarse_centers(xp, cl["k"], cl["coarse_iters"], store)
    del xp
    if cl["mid_iters"] > 0:
        for pe, pc in reversed(levels[:-1]):
            c = _solve(pe, pc, a, b, c, cl["mid_iters"], store)
    c = _solve(energies, col, a, b, c, cl["refine_iters"], store)
    x = common.raw_rows(energies, col)
    return torch.argmin(_scores(x, c, a, b, store), dim=1).reshape(bsz, h, w)
