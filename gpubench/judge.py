"""The comparison that decides ``correct``: the program's label maps of
the checked frames against the reference's, each image's ids matched to
the reference's one to one (Hungarian, on the contingency table) before
pixels are counted, since a partition does not fix its ids.

Numbers a configuration file may hold a limit for (those it holds are
compared): ``worst_image_mismatch``, the largest share of an image's
pixels that disagree; ``median_image_mismatch``, the median of the
checked images' shares; ``mean_mismatch``, the share of all checked
pixels that disagree; ``labels_outside_k``, labels outside [0, k)
(limit 0).
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment

NUMBERS = ("worst_image_mismatch", "median_image_mismatch", "mean_mismatch", "labels_outside_k")


def mismatch(pred: np.ndarray, ref: np.ndarray) -> float:
    """Share of pixels where ``pred``, its ids matched to ``ref``'s best,
    differs from ``ref``."""
    p = pred.reshape(-1).astype(np.int64)
    r = ref.reshape(-1).astype(np.int64)
    p = p - p.min()
    r = r - r.min()
    k = int(max(p.max(), r.max())) + 1
    cont = np.bincount(p * k + r, minlength=k * k).reshape(k, k)
    row, col = linear_sum_assignment(-cont)
    return 1.0 - float(cont[row, col].sum()) / p.size


def compare(pred: np.ndarray, ref: np.ndarray, k: int) -> dict:
    """Images (B, H, W) of the program (``pred``) against the reference's
    (``ref``): each image's mismatch and the labels outside [0, k)."""
    if pred.shape != ref.shape:
        raise ValueError(f"labels {pred.shape} against the reference's {ref.shape}")
    return {"per_image": [mismatch(p, r) for p, r in zip(pred, ref)],
            "labels_outside_k": int(np.count_nonzero((pred < 0) | (pred >= k)))}


def absent(ref: np.ndarray) -> dict:
    """``compare``'s result for ``ref``'s images where no labels came back:
    every pixel counted wrong."""
    return {"per_image": [1.0] * ref.shape[0], "labels_outside_k": ref.size}


def numbers(parts: list) -> dict:
    """The numbers over the images of several ``compare`` results."""
    per = [v for p in parts for v in p["per_image"]]
    return {"worst_image_mismatch": max(per), "median_image_mismatch": float(np.median(per)),
            "mean_mismatch": float(np.mean(per)),
            "labels_outside_k": sum(p["labels_outside_k"] for p in parts)}


def verdict(numbers: dict, limits: dict) -> tuple:
    """(every number that ``limits`` names within its limit, {name:
    {"value", "limit"}})."""
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in NUMBERS if k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
