"""Seeded texture mosaics with exact ground truth (the port's numpy copy of
the JAX package's data/synthetic.py: ``synthetic_mosaic``,
``synthetic_mosaic_multigt`` and ``synthetic_dataset``, bit-identical
output; the tests hold them to that).

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


def synthetic_mosaic_multigt(
    h: int = 321,
    w: int = 481,
    n_regions: int = 5,
    seed: int = 0,
    n_gts: int = 3,
    texture_strength: float = 0.25,
    noise: float = 0.02,
) -> tuple[np.ndarray, list[np.ndarray]]:
    """Mosaic with ground truths that disagree in granularity, as BSDS's
    human segmentations do.

    A fine Voronoi partition of 2 * n_regions cells, each cell given one of
    n_regions appearance classes (colour + texture). The ground truths:
    gt[0] the appearance classes (the exact truth), gt[1] the fine cells
    (an over-segmenting human), gt[2] the classes merged in pairs (a coarse
    human), and further ones alternative cell -> class merges.

    Returns (rgb uint8, [gts] of length n_gts)."""
    rng = np.random.default_rng(seed)
    m = 2 * n_regions
    cells = _voronoi_labels(h, w, m, rng)
    # every class present; remaining cells assigned pseudo-randomly
    cls_of_cell = np.concatenate(
        [np.arange(n_regions), rng.integers(0, n_regions, m - n_regions)]
    ).astype(np.int32)
    rng.shuffle(cls_of_cell)
    gt_exact = cls_of_cell[cells]

    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.zeros((h, w, 3), dtype=np.float64)
    hues = np.linspace(0.0, 1.0, n_regions, endpoint=False)
    rng.shuffle(hues)
    for r in range(n_regions):
        base = _hsv_to_rgb(hues[r], 0.55, 0.75)
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(0.06, 0.22)
        phase = rng.uniform(0, 2 * np.pi)
        tex = np.sin(2 * np.pi * freq * (xx * np.cos(theta) + yy * np.sin(theta)) + phase)
        msk = gt_exact == r
        for c in range(3):
            img[:, :, c][msk] = base[c] + texture_strength * tex[msk]
    img += rng.normal(0.0, noise, img.shape)
    img = np.clip(img, 0.0, 1.0)
    rgb = (img * 255.0 + 0.5).astype(np.uint8)

    gts = [gt_exact]
    if n_gts > 1:
        gts.append(cells.astype(np.int32))
    if n_gts > 2:
        gts.append((gt_exact // 2).astype(np.int32))
    for g in range(3, n_gts):
        merge = (cls_of_cell + g) % max(2, n_regions - 1)
        gts.append(merge[cells].astype(np.int32))
    return rgb, gts[:n_gts]


def synthetic_dataset(
    n_images: int,
    h: int = 321,
    w: int = 481,
    n_regions: int = 5,
    seed: int = 0,
    n_gts: int = 3,
):
    """Yield (image_id, rgb, [gt variants]) for seeds seed .. seed +
    n_images - 1 (``synthetic_mosaic_multigt``)."""
    for i in range(n_images):
        rgb, gts = synthetic_mosaic_multigt(h, w, n_regions, seed=seed + i, n_gts=n_gts)
        yield f"synth{i:04d}", rgb, gts


def spiral_path(h: int, w: int) -> np.ndarray:
    """(h, w) bool: a 1-pixel corridor that spirals in from the top-left
    corner with 1-pixel walls between its turns (an h x w maze whose path
    is about h * w / 2 pixels long)."""
    path = np.zeros((h, w), bool)
    top, left, bottom, right = 0, 0, h - 1, w - 1
    while top <= bottom and left <= right:
        path[top, left:right + 1] = True
        path[top:bottom + 1, right] = True
        if bottom > top + 1:
            path[bottom, left:right + 1] = True
        if bottom > top + 3 and right > left + 1:
            path[top + 2:bottom + 1, left] = True
            path[top + 2, left + 1] = True  # the step into the next turn
        top, left, bottom, right = top + 2, left + 2, bottom - 2, right - 2
    return path


def connectivity_maze(h: int, w: int, kept: str) -> np.ndarray:
    """(h, w) int32 label maps that stress the connectivity pass: every
    pixel a one-pixel component (checkerboard labels, 0-1 on the walls, 2-3
    on the spiral corridor of ``spiral_path``) but for the kept part:
    ``kept="centre"`` a 3 x 3 block of label 9 at the image's centre,
    ``kept="corner"`` the same at the bottom-right corner (the longest
    adoption distances), ``kept="walls"`` the walls as one component of
    label 9, ``kept="none"`` nothing (every component absorbed for min_size
    >= 2)."""
    yy, xx = np.mgrid[0:h, 0:w]
    path = spiral_path(h, w)
    lab = ((yy + xx) % 2 + 2 * path).astype(np.int32)
    if kept == "centre":
        cy, cx = h // 2, w // 2
        lab[max(0, cy - 1):cy + 2, max(0, cx - 1):cx + 2] = 9
    elif kept == "corner":
        lab[-3:, -3:] = 9
    elif kept == "walls":
        lab[~path] = 9
    elif kept != "none":
        raise ValueError(f"kept must be 'centre', 'corner', 'walls' or 'none', got {kept!r}")
    return lab
