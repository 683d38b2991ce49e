"""Label-map utilities (the port's numpy/scipy copy of the JAX package's
utils/labels.py): contiguous relabelling, optimal permutation alignment
for parity checks, agreement rates."""

from __future__ import annotations

import numpy as np


def relabel_contiguous(labels: np.ndarray) -> np.ndarray:
    """Map label values to 0..K-1 in order of first appearance."""
    flat = labels.reshape(-1)
    _, first_idx, inv = np.unique(flat, return_index=True, return_inverse=True)
    # np.unique sorts values; re-rank them by first appearance for determinism
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    return rank[inv].reshape(labels.shape).astype(np.int32)


def align_labels(pred: np.ndarray, ref: np.ndarray, k: int | None = None) -> np.ndarray:
    """Permute pred's label ids to maximise agreement with ref (Hungarian)."""
    from scipy.optimize import linear_sum_assignment

    p = pred.reshape(-1)
    r = ref.reshape(-1)
    kk = max(int(p.max()) + 1, int(r.max()) + 1) if k is None else k
    cont = np.zeros((kk, kk), dtype=np.int64)
    np.add.at(cont, (p, r), 1)
    row, col = linear_sum_assignment(-cont)
    mapping = np.arange(kk)
    mapping[row] = col
    return mapping[pred].astype(np.int32)


def agreement_rate(a: np.ndarray, b: np.ndarray) -> float:
    """Fraction of pixels with equal labels (after your own alignment)."""
    return float((a.reshape(-1) == b.reshape(-1)).mean())
