"""Boundary F-measure, BSDS500 protocol (the port's counterpart of the JAX
package's metrics/boundary.py).

Boundary extraction: a pixel is boundary iff its label differs from its
right or down neighbour (thin, deterministic, the same on host and device).

Matching (tolerance = 0.0075 * image diagonal, the BSDS default):

  * ``fboundary_np`` — host, exact one-to-one matching. The BSDS bench's
    CSA assignment maximises the number of matches within tolerance, and
    precision and recall depend only on that count, so maximum-cardinality
    bipartite matching (scipy's Hopcroft-Karp over the tolerance graph)
    reports the exact protocol number. This is the reported matcher.
  * ``_match_one_greedy`` — greedy by increasing distance, the C++ matcher
    (utils/native.py); approximate, up to ~13 % fewer matches than optimal
    on wavy boundary pairs (the JAX package's tests measure the gap). Its
    Python version ``_match_one_greedy_plain`` gives the same masks.
  * ``fboundary_torch`` — on the inputs' device, the "loose" dilated
    matching used for fast iteration: a boundary pixel matches if any
    counterpart lies within tolerance (no uniqueness). An exact truncated
    Euclidean distance transform, two separable 1-D min-plus passes over
    shifted tensors. ``fboundary_dilated_np`` is the same number on the
    host from scipy's exact distance transform.

With several human ground truths (BSDS convention): precision counts a
predicted pixel as correct if it matches any human's boundary; recall
accumulates matched GT pixels over all humans.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.utils.native import greedy_match_native

# ---------------------------------------------------------------------------
# boundary extraction
# ---------------------------------------------------------------------------


def boundaries_np(labels: np.ndarray) -> np.ndarray:
    b = np.zeros(labels.shape, bool)
    b[:, :-1] |= labels[:, :-1] != labels[:, 1:]
    b[:-1, :] |= labels[:-1, :] != labels[1:, :]
    return b


def boundaries_torch(labels: torch.Tensor) -> torch.Tensor:
    """(..., H, W) labels -> (..., H, W) bool boundary map."""
    b = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    b[..., :, :-1] |= labels[..., :, :-1] != labels[..., :, 1:]
    b[..., :-1, :] |= labels[..., :-1, :] != labels[..., 1:, :]
    return b


def default_tolerance(h: int, w: int, frac: float = 0.0075) -> float:
    return frac * math.hypot(h, w)


# ---------------------------------------------------------------------------
# host: one-to-one matching (the optimal matcher gives the reported number)
# ---------------------------------------------------------------------------


def _candidate_pairs(pp: np.ndarray, gg: np.ndarray, tol: float):
    """cKDTree candidate lists: for each pred pixel, gt indices within tol."""
    from scipy.spatial import cKDTree

    tree = cKDTree(gg)
    return tree.query_ball_point(pp, r=tol)


def _match_one_greedy_plain(pred_b: np.ndarray, gt_b: np.ndarray, tol: float):
    """One-to-one greedy matching by increasing distance, in Python, tie
    break (d, i, j): the plain version of the C++ matcher. Returns
    (pred_matched, gt_matched) masks over the boundary-pixel lists."""
    pp = np.argwhere(pred_b)
    gg = np.argwhere(gt_b)
    pm = np.zeros(len(pp), bool)
    gm = np.zeros(len(gg), bool)
    if len(pp) == 0 or len(gg) == 0:
        return pm, gm
    pairs = _candidate_pairs(pp, gg, tol)
    cand = [
        (float(np.hypot(*(pp[i] - gg[j]))), i, j)
        for i, js in enumerate(pairs)
        for j in js
    ]
    cand.sort()
    for _, i, j in cand:
        if not pm[i] and not gm[j]:
            pm[i] = True
            gm[j] = True
    return pm, gm


def _match_one_greedy(pred_b: np.ndarray, gt_b: np.ndarray, tol: float):
    """One-to-one greedy matching by increasing distance, by the C++
    matcher (utils/native.py; a failed build raises). Approximate."""
    pp = np.argwhere(pred_b)
    gg = np.argwhere(gt_b)
    if len(pp) == 0 or len(gg) == 0:
        return np.zeros(len(pp), bool), np.zeros(len(gg), bool)
    return greedy_match_native(pp, gg, tol)


def _match_one(pred_b: np.ndarray, gt_b: np.ndarray, tol: float):
    """One-to-one optimal matching (maximum-cardinality bipartite matching
    on the within-tolerance graph, Hopcroft-Karp). Precision/recall depend
    only on the match count, so this reports the exact BSDS CSA number."""
    pp = np.argwhere(pred_b)
    gg = np.argwhere(gt_b)
    pm = np.zeros(len(pp), bool)
    gm = np.zeros(len(gg), bool)
    if len(pp) == 0 or len(gg) == 0:
        return pm, gm

    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import maximum_bipartite_matching

    pairs = _candidate_pairs(pp, gg, tol)
    lens = np.fromiter((len(js) for js in pairs), np.int64, len(pairs))
    indptr = np.concatenate([[0], np.cumsum(lens)])
    if indptr[-1] == 0:
        return pm, gm
    indices = np.concatenate([np.asarray(js, np.int64) for js in pairs if len(js)])
    graph = csr_matrix(
        (np.ones(indptr[-1], np.int8), indices, indptr),
        shape=(len(pp), len(gg)),
    )
    match = maximum_bipartite_matching(graph, perm_type="column")
    pm = match != -1
    gm[match[pm]] = True
    return pm, gm


def fboundary_np(
    pred_labels: np.ndarray,
    gts: Sequence[np.ndarray],
    tol_frac: float = 0.0075,
    matcher: str = "optimal",
) -> Tuple[float, float, float]:
    """BSDS boundary benchmark for one image -> (precision, recall, F).

    matcher="optimal" (reported): exact maximum-cardinality matching.
    matcher="greedy": the approximate distance-greedy variant."""
    h, w = pred_labels.shape
    tol = default_tolerance(h, w, tol_frac)
    match = _match_one if matcher == "optimal" else _match_one_greedy
    pred_b = boundaries_np(pred_labels)
    pp_n = int(pred_b.sum())
    pred_matched = np.zeros(pp_n, bool)
    sum_r = 0
    cnt_r = 0
    for gt in gts:
        gt_b = boundaries_np(gt)
        pm, gm = match(pred_b, gt_b, tol)
        pred_matched |= pm
        sum_r += int(gm.sum())
        cnt_r += int(gt_b.sum())
    precision = pred_matched.sum() / max(pp_n, 1)
    recall = sum_r / max(cnt_r, 1)
    f = 2 * precision * recall / max(precision + recall, 1e-12)
    return float(precision), float(recall), float(f)


# ---------------------------------------------------------------------------
# dilated matching via a truncated Euclidean distance transform
# ---------------------------------------------------------------------------


def _truncated_sq_dt(mask: torch.Tensor, radius: int) -> torch.Tensor:
    """Exact squared Euclidean distance transform of a (H, W) bool mask,
    truncated at ``radius`` (values > radius^2 clamped to radius^2 + 1), in
    float32 (every value an exact integer): a column pass then a row pass
    of min-plus over shifts 1 .. radius, O(radius) elementwise ops."""
    big = float(radius * radius + 1)
    d = torch.where(mask, 0.0, big).to(torch.float32)

    def pass_axis(d: torch.Tensor, axis: int) -> torch.Tensor:
        out = d
        n = d.shape[axis]
        for s in range(1, min(radius, n - 1) + 1):
            fwd = torch.full_like(d, big)
            bwd = torch.full_like(d, big)
            fwd.narrow(axis, s, n - s).copy_(d.narrow(axis, 0, n - s) + s * s)
            bwd.narrow(axis, 0, n - s).copy_(d.narrow(axis, s, n - s) + s * s)
            out = torch.minimum(out, torch.minimum(fwd, bwd))
        return out

    d = pass_axis(d, 0)
    d = pass_axis(d, 1)
    return torch.clamp(d, max=big)


def fboundary_torch(pred_labels: torch.Tensor, gt_labels: torch.Tensor,
                    tol: float) -> torch.Tensor:
    """Dilated-matching (P, R, F) of one (pred, gt) pair of (H, W) label
    maps on their device, a float64 (3,) tensor: the match counts are exact
    integers, the ratios float64.

    Slightly optimistic against the one-to-one matcher (no uniqueness):
    for fast sweeps; the reported number is fboundary_np's."""
    r = int(math.ceil(tol))
    pred_b = boundaries_torch(pred_labels)
    gt_b = boundaries_torch(gt_labels)
    t2 = tol * tol
    matched_p = (pred_b & (_truncated_sq_dt(gt_b, r) <= t2)).sum()
    matched_g = (gt_b & (_truncated_sq_dt(pred_b, r) <= t2)).sum()
    counts = torch.stack([matched_p, pred_b.sum(), matched_g, gt_b.sum()]).to(torch.float64)
    n_p, n_g = counts[1].clamp(min=1.0), counts[3].clamp(min=1.0)
    p, rr = counts[0] / n_p, counts[2] / n_g
    f = 2 * p * rr / torch.clamp(p + rr, min=1e-12)
    return torch.stack([p, rr, f])


def fboundary_dilated_np(pred_labels: np.ndarray, gt_labels: np.ndarray,
                         tol: float) -> Tuple[float, float, float]:
    """fboundary_torch's (P, R, F) on the host, from scipy's exact Euclidean
    distance transform: a boundary pixel matches if a counterpart lies
    within ``tol``."""
    from scipy.ndimage import distance_transform_edt

    pred_b = boundaries_np(pred_labels)
    gt_b = boundaries_np(gt_labels)

    def near(mask):  # within tol of a pixel of mask (squared distances exact)
        if not mask.any():
            return np.zeros(mask.shape, bool)
        return np.rint(distance_transform_edt(~mask) ** 2) <= tol * tol

    p = (pred_b & near(gt_b)).sum() / max(int(pred_b.sum()), 1)
    r = (gt_b & near(pred_b)).sum() / max(int(gt_b.sum()), 1)
    return float(p), float(r), float(2 * p * r / max(p + r, 1e-12))
