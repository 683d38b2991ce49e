"""Probabilistic Rand Index (the port's counterpart of the JAX package's
metrics/pri.py).

PRI(S, {G_t}) = mean_t RI(S, G_t), where RI is the Rand index computed from
the pair-confusion counts of the contingency table (the form sklearn's
rand_score uses).

The host versions (numpy, any label values) are copies. The tensor versions
(``rand_index_torch``, ``pri_torch``) run where their inputs lie and take
static label-count bounds, as the reference's device versions do; their
contingency table is exact, one ``torch.bincount`` in int64 (the
reference's one-hot matmul answers the TPU's matrix unit), and the sums
after it are in float64.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def rand_index_np(pred: np.ndarray, gt: np.ndarray) -> float:
    """Rand index between two integer label maps (any shape, elementwise pairs)."""
    pred = pred.reshape(-1)
    gt = gt.reshape(-1)
    n = pred.size
    # contingency via flat bincount
    _, pi = np.unique(pred, return_inverse=True)
    _, gi = np.unique(gt, return_inverse=True)
    kp, kg = pi.max() + 1, gi.max() + 1
    cont = np.bincount(pi * kg + gi, minlength=kp * kg).reshape(kp, kg).astype(np.float64)
    sum_ij = (cont * (cont - 1)).sum() / 2.0
    a = cont.sum(axis=1)
    b = cont.sum(axis=0)
    sum_a = (a * (a - 1)).sum() / 2.0
    sum_b = (b * (b - 1)).sum() / 2.0
    total = n * (n - 1) / 2.0
    # agreements = pairs together in both + pairs apart in both
    return float((total + 2.0 * sum_ij - sum_a - sum_b) / total)


def pri_np(pred: np.ndarray, gts: Sequence[np.ndarray]) -> float:
    """Probabilistic Rand Index vs a set of ground-truth segmentations."""
    if len(gts) == 0:
        raise ValueError("need at least one ground truth")
    return float(np.mean([rand_index_np(pred, g) for g in gts]))


def contingency_torch(pred: torch.Tensor, gt: torch.Tensor, n_pred: int,
                      n_gt: int) -> torch.Tensor:
    """(..., n_pred, n_gt) int64 contingency table of the label map ``pred``
    and each map of ``gt`` (``pred``'s shape, or a stack of such maps): one
    bincount over all of them.
    Label values must lie in [0, n_pred) and [0, n_gt); others raise."""
    p = pred.reshape(-1).to(torch.int64)
    g = gt.reshape(-1, p.numel()).to(torch.int64)
    if bool(((p < 0) | (p >= n_pred)).any()) or bool(((g < 0) | (g >= n_gt)).any()):
        raise ValueError(f"labels must lie in [0, {n_pred}) and [0, {n_gt})")
    t = torch.arange(g.shape[0], device=g.device)[:, None] * (n_pred * n_gt)
    cont = torch.bincount((t + p * n_gt + g).reshape(-1), minlength=g.shape[0] * n_pred * n_gt)
    return cont.reshape(gt.shape[:gt.dim() - pred.dim()] + (n_pred, n_gt))


def _rand_index_of(cont: torch.Tensor) -> torch.Tensor:
    """Rand index of each (..., kp, kg) contingency table, float64."""
    c = cont.to(torch.float64)
    n = c.sum(dim=(-2, -1))
    sum_ij = (c * (c - 1)).sum(dim=(-2, -1)) / 2.0
    a = c.sum(dim=-1)
    b = c.sum(dim=-2)
    sum_a = (a * (a - 1)).sum(dim=-1) / 2.0
    sum_b = (b * (b - 1)).sum(dim=-1) / 2.0
    total = n * (n - 1) / 2.0
    return (total + 2.0 * sum_ij - sum_a - sum_b) / total


def rand_index_torch(pred: torch.Tensor, gt: torch.Tensor, n_pred: int,
                     n_gt: int) -> torch.Tensor:
    """Rand index of two label maps, a float64 scalar on their device;
    label values must lie in [0, n_pred) / [0, n_gt)."""
    return _rand_index_of(contingency_torch(pred, gt, n_pred, n_gt))


def pri_torch(pred: torch.Tensor, gts: torch.Tensor, n_pred: int, n_gt: int) -> torch.Tensor:
    """pred: (H, W), gts: (T, H, W) -> PRI, a float64 scalar on their device."""
    return _rand_index_of(contingency_torch(pred, gts, n_pred, n_gt)).mean()
