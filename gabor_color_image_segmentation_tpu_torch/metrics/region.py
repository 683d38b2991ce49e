"""Region-based segmentation metrics: Variation of Information and
Segmentation Covering (the port's counterpart of the JAX package's
metrics/region.py; the BSDS500 region-metric family beside PRI).

Both are functions of the label contingency table only:

  VoI(S, G)      = H(S) + H(G) - 2 I(S, G)          (natural log, nats;
                   0 = identical partitions, lower is better)
  Covering(S->G) = (1/N) sum_{R in G} |R| max_{R' in S} |R ∩ R'| / |R ∪ R'|
                   (how well the machine segmentation S covers the
                   ground-truth regions; 1 = perfect, higher is better)

Several ground truths: the mean over the set, as ``pri_np``.

The host versions are copies. ``voi_torch`` and ``covering_torch`` take
static label-count bounds, as the reference's device versions do, on the
exact int64 contingency of ``metrics.pri.contingency_torch``, in float64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.metrics.pri import contingency_torch


def _contingency_np(pred: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(kp, kg) float64 contingency table of two integer label maps."""
    p = pred.reshape(-1)
    g = gt.reshape(-1)
    _, pi = np.unique(p, return_inverse=True)
    _, gi = np.unique(g, return_inverse=True)
    kp, kg = pi.max() + 1, gi.max() + 1
    return np.bincount(pi * kg + gi, minlength=kp * kg).reshape(kp, kg).astype(np.float64)


def voi_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """Variation of Information (nats) between two label maps."""
    cont = _contingency_np(pred, gt)
    n = cont.sum()
    pij = cont / n
    pi = pij.sum(axis=1)
    pj = pij.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        h_p = -np.sum(pi * np.log(np.where(pi > 0, pi, 1.0)))
        h_g = -np.sum(pj * np.log(np.where(pj > 0, pj, 1.0)))
        mi = np.sum(
            np.where(
                pij > 0,
                pij * (np.log(np.where(pij > 0, pij, 1.0))
                       - np.log(np.outer(np.where(pi > 0, pi, 1.0),
                                         np.where(pj > 0, pj, 1.0)))),
                0.0,
            )
        )
    return float(h_p + h_g - 2.0 * mi)


def mean_voi_np(pred: np.ndarray, gts: Sequence[np.ndarray]) -> float:
    """Mean VoI vs a set of ground truths (lower is better)."""
    if len(gts) == 0:
        raise ValueError("need at least one ground truth")
    return float(np.mean([voi_np(pred, g) for g in gts]))


def covering_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """Covering of the ground-truth regions by the predicted segments."""
    cont = _contingency_np(pred, gt)  # (kp, kg); rows = pred segments
    n = cont.sum()
    a = cont.sum(axis=0)  # |R| per GT region
    b = cont.sum(axis=1)  # |R'| per pred segment
    union = b[:, None] + a[None, :] - cont
    overlap = np.where(union > 0, cont / union, 0.0)
    best = overlap.max(axis=0)  # per GT region: best-matching pred segment
    return float(np.sum(a * best) / n)


def mean_covering_np(pred: np.ndarray, gts: Sequence[np.ndarray]) -> float:
    """Mean covering vs a set of ground truths (higher is better)."""
    if len(gts) == 0:
        raise ValueError("need at least one ground truth")
    return float(np.mean([covering_np(pred, g) for g in gts]))


def voi_torch(pred: torch.Tensor, gt: torch.Tensor, n_pred: int, n_gt: int) -> torch.Tensor:
    """VoI (nats), a float64 scalar on the inputs' device; label values
    must lie in [0, n_pred) / [0, n_gt)."""
    cont = contingency_torch(pred, gt, n_pred, n_gt).to(torch.float64)
    pij = cont / cont.sum()
    pi = pij.sum(dim=1)
    pj = pij.sum(dim=0)

    def safe(x):
        return torch.where(x > 0, x, torch.ones_like(x))

    h_p = -(pi * torch.log(safe(pi))).sum()
    h_g = -(pj * torch.log(safe(pj))).sum()
    mi = torch.where(pij > 0, pij * (torch.log(safe(pij)) - torch.log(safe(pi))[:, None]
                                     - torch.log(safe(pj))[None, :]),
                     torch.zeros_like(pij)).sum()
    return h_p + h_g - 2.0 * mi


def covering_torch(pred: torch.Tensor, gt: torch.Tensor, n_pred: int,
                   n_gt: int) -> torch.Tensor:
    """Covering of the GT regions by the pred segments, a float64 scalar on
    the inputs' device (the same label bounds)."""
    cont = contingency_torch(pred, gt, n_pred, n_gt).to(torch.float64)
    a = cont.sum(dim=0)
    b = cont.sum(dim=1)
    union = b[:, None] + a[None, :] - cont
    overlap = torch.where(union > 0, cont / torch.where(union > 0, union, 1.0),
                          torch.zeros_like(cont))
    return (a * overlap.max(dim=0).values).sum() / cont.sum()
