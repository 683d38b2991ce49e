"""Peaks of the card and the operations and bytes of the stages that
roofline metrics judge, computed from a cell's shapes and the algorithm:
each input byte read once, each output written once, whatever a kernel
reads again.

The counts are the ones ``chip_smoke.py`` bounds its kernels by (its
``compare_features`` tap-loop count for the energies, its ``check_em``
count for an EM pass), frozen here.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM, NVIDIA's data sheet, dense rates, at its 700 W
# power limit.
PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "bf16_tensor_flop_per_s": 989e12,
    "fp32_flop_per_s": 67e12,
}

ESIZE = {"bfloat16": 2, "float32": 4}


def least_seconds(flops: float, nbytes: float, peak_flops: float):
    """(the least time the card could take, what bounds it)."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAKS["hbm_bytes_per_s"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bank_radii(bank: dict) -> list:
    """(kernels, conv radius p, smoothing radius r) of each scale group."""
    n_f = 1 if bank["frequencies"] is None else len(bank["frequencies"])
    out = []
    for sigma in bank["scales"]:
        ksize = min(2 * int(math.ceil(bank["truncate"] * float(sigma))) + 1,
                    bank["max_ksize"]) | 1
        r = int(math.ceil(bank["smooth_truncate"] * bank["smoothing"] * float(sigma)))
        out.append((bank["orientations"] * n_f, ksize // 2, r))
    return out


def energies_counts(b: int, h: int, w: int, c: int, bank: dict, twin: bool, dtype: str):
    """(operations, bytes) of the Gabor energies of b frames of h x w x c:
    per plane the separable modulated blur (rows over the conv halo's
    width, then columns; real and imaginary parts), the separable
    smoothing and, with the twin, its pooled smoothing (2r + 2 taps down
    the rows over the halo's width, then across), two operations an FMA;
    bytes the float32 colour in, the energies and the twin out."""
    flops = 0
    e = 0
    for n, p, r in bank_radii(bank):
        flops += 2 * b * n * c * (2 * (2 * p + 1) * (h * (w + 2 * p) + h * w)
                                  + 2 * (2 * r + 1) * h * w
                                  + (2 * (r + 1) * (h // 2) * (w + 2 * r + w // 2)
                                     if twin else 0))
        e += n * c
    es = ESIZE[dtype]
    nbytes = b * h * w * c * 4 + b * e * h * w * es + (b * e * (h // 2) * (w // 2) * es
                                                        if twin else 0)
    return flops, nbytes


def em_pass_flops(b: int, n: int, k: int, d: int, moments: bool) -> int:
    """One EM pass over b images of n pixels: P^T x - P^T mu on the lower
    triangle, and with moments the extended scatter's lower triangle."""
    return b * n * (k * d * (d + 1) + (k * (d + 1) * (d + 2) if moments else 0))


def fit_grid(h: int, w: int, fit_pool: int) -> int:
    """Pixels of the EM's fit grid: pooled up to ``fit_pool`` times while
    each level keeps 4x4 and 4,096 pixels."""
    lv = 0
    while lv < fit_pool and h >= 4 and w >= 4 and (h // 2) * (w // 2) >= 4096:
        h, w = h // 2, w // 2
        lv += 1
    return h * w


def em_counts(b: int, h: int, w: int, cluster: dict, d: int, dtype: str):
    """(operations, bytes) of the GMM's EM: ``n_iter`` passes with moments
    on the fit grid, ``gmm_refine_iters`` at full resolution and one
    labels-only pass; bytes the buffers read once (the fit grid's apart
    where it is pooled) and the labels written once."""
    k, n = cluster["k"], h * w
    m = fit_grid(h, w, cluster["gmm_fit_pool"])
    flops = (cluster["n_iter"] * em_pass_flops(b, m, k, d, True)
             + cluster["gmm_refine_iters"] * em_pass_flops(b, n, k, d, True)
             + em_pass_flops(b, n, k, d, False))
    es = ESIZE[dtype]
    nbytes = b * d * (n + (m if m < n else 0)) * es + b * n * 4
    return flops, nbytes
