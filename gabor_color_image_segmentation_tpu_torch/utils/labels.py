"""Label-map alignment (the port's numpy/scipy copy of the JAX package's
utils/labels.py::align_labels)."""

from __future__ import annotations

import numpy as np


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
