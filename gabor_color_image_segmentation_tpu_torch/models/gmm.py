"""Per-image GMM helpers (counterpart of the JAX package's models/gmm.py).

Only the pooled-fit schedule is ported here; the fused solver the pipeline
runs is ``models/gmm_fused.py``. The NHWC solver ``gmm_fit`` /
``gmm_predict`` (the reference's path behind ``subsample > 1`` and
``with_features=True``) waits for ROADMAP queue 1 item 14.
"""

from __future__ import annotations

from typing import Tuple

_LOG2PI = 1.8378770664093453


def gmm_fit_levels(h: int, w: int, fit_pool: int) -> Tuple[int, int, int]:
    """(pooled h, pooled w, levels): the number of 2x2 poolings the fit
    grid takes, at most ``fit_pool``; each level needs a grid of at least
    4x4 and at least 4096 pooled pixels."""
    lv = 0
    while lv < fit_pool and h >= 4 and w >= 4 and (h // 2) * (w // 2) >= 4096:
        h, w = h // 2, w // 2
        lv += 1
    return h, w, lv
