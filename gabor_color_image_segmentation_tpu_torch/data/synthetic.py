"""Seeded texture mosaics with exact ground truth (the port's numpy copy of
the JAX package's data/synthetic.py::synthetic_mosaic, bit-identical
output; the tests hold it to that).

Each Voronoi region gets a distinct base colour plus an oriented sinusoidal
texture, the signal family a Gabor + colour pipeline separates.
"""

from __future__ import annotations

import numpy as np


def _voronoi_labels(h: int, w: int, n_regions: int, rng: np.random.Generator):
    """Voronoi partition from random sites -> (h, w) int32 labels in [0, n)."""
    sites = np.stack([rng.uniform(0, h, n_regions), rng.uniform(0, w, n_regions)], axis=1)
    yy, xx = np.mgrid[0:h, 0:w]
    d = (yy[..., None] - sites[:, 0]) ** 2 + (xx[..., None] - sites[:, 1]) ** 2
    return np.argmin(d, axis=-1).astype(np.int32)


def _hsv_to_rgb(h: float, s: float, v: float) -> tuple[float, float, float]:
    i = int(h * 6.0) % 6
    f = h * 6.0 - int(h * 6.0)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    return [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)][i]


def synthetic_mosaic(
    h: int = 321,
    w: int = 481,
    n_regions: int = 5,
    seed: int = 0,
    texture_strength: float = 0.25,
    noise: float = 0.02,
    texture_only: bool = False,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (rgb uint8 (h, w, 3), ground-truth labels int32 (h, w)).

    ``texture_only=True`` gives every region the same base colour, so the
    regions differ only in texture orientation and frequency."""
    rng = np.random.default_rng(seed)
    gt = _voronoi_labels(h, w, n_regions, rng)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3), dtype=np.float64)
    hues = np.linspace(0.0, 1.0, n_regions, endpoint=False)
    rng.shuffle(hues)
    for r in range(n_regions):
        base = _hsv_to_rgb(hues[r], 0.55, 0.75)
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(0.06, 0.22)
        phase = rng.uniform(0, 2 * np.pi)
        if texture_only:  # the draws above still happen: same stream
            base = (0.55, 0.55, 0.55)
            theta = np.pi * r / n_regions
            freq = 0.07 + 0.13 * r / max(1, n_regions - 1)
        tex = np.sin(2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)) + phase)
        m = gt == r
        for c in range(3):
            img[:, :, c][m] = base[c] + texture_strength * tex[m]
    img += rng.normal(0.0, noise, img.shape)
    img = np.clip(img, 0.0, 1.0)
    return (img * 255.0 + 0.5).astype(np.uint8), gt
