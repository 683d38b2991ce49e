#!/usr/bin/env python3
"""Feature rows K2, K4 and the coarse warm start take on the card against
the reference's range at W = 481 (arithmetic only: runs anywhere, no card,
no JAX).

    python3 experiments/torch_range_check.py

The port: the largest D = E + 3 for which ``kmeans_chw.lloyd_plan`` stages
a whole tile in shared memory (past it the plan stages a tile's rows in
blocks, so K2 takes any D), and K4's entry check (the probe and a^2 in
40 KB of shared memory: 2 (E + 3) 4 bytes). The reference: the TPU's VMEM
a grid step of ``_lloyd_chw_pass`` / ``_maximin_chw_pass`` needs at
t_sub = 1, from their BlockSpecs (every block double-buffered; a block's
last two dims padded to the (8, 128) f32 / (16, 128) bf16 tile; W = 481
lanes take 512), under their 100 MB ``vmem_limit_bytes``: once with the
blocks alone (an upper bound of what compiles) and once with the copies
their kernels keep live beside them (K2: the row-masked copy of the rows,
read again by the sums' dots; K4: that copy and the squares). What Mosaic
really allocates shows only in a TPU compile.

The coarse warm start at config1's 4x4 grid (80 x 120 = 9,600 pixels):
the reference's ``kmeans_coarse_centers_xp`` runs its fused kernel in bf16
while the padded buffer (``xt_geometry``: d + 1 rows padded to 16, the
pixels to ``_block_for_t``'s block) holds at most ``_COARSE_FUSE_BYTES`` =
12 MiB, and its blocked passes (maximin, then Lloyd) past that and in f32
at any d; the port (``kmeans_fused.coarse_route``) runs K3 up to 400 rows
and the blocked passes (K6, K5) past them, in both dtypes, at any d.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused  # noqa: E402

W, HB, K = 481, 16, 5  # the frame's width, the reference's sub-tile rows, the presets' k
VMEM = 100 * 1024 * 1024


def pad(n: int, to: int) -> int:
    return -(-n // to) * to


def block(rows: int, lanes: int, s: int) -> int:
    """VMEM bytes of a (rows, lanes) block of s-byte values."""
    return pad(rows, 8 * 4 // s) * pad(lanes, 128) * s


def k2_step(e: int, s: int, live: bool) -> int:
    """_lloyd_chw_pass at t_sub = 1: the rows (E + 4 of them, HB x W), the
    expanded weights (k HB x (E + 4) HB), offsets, labels and partials."""
    blocks = (block((e + 4) * HB, W, s) + block(K * HB, (e + 4) * HB, s) + block(8, 128, 4)
              + block(HB, W, 4) + block(8, (e + 4) * HB, 4))
    return 2 * blocks + (block((e + 4) * HB, W, s) if live else 0)


def k4_step(e: int, s: int, live: bool) -> int:
    """_maximin_chw_pass at t_sub = 1: xe, xc4, the four expanded weights,
    csq, dmin in and out and the per-block picks."""
    blocks = (block(e * HB, W, s) + block(4 * HB, W, s) + 2 * block(HB, e * HB, s)
              + 2 * block(HB, 4 * HB, s) + block(8, 128, 4) + 2 * block(HB, W, 4)
              + block(8, e * HB, 4) + block(8, 4 * HB, 4) + block(8, 128, 4))
    return 2 * blocks + (2 * block(e * HB, W, s) if live else 0)


def largest(fits) -> int:
    """The largest E >= 1 with fits(E), by bisection (fits is monotone)."""
    lo, hi = 0, 1 << 16
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


def coarse_fused(d: int, m: int, s: int) -> bool:
    """Whether the reference's warm start takes its fused kernel: bf16 and
    the padded pooled buffer within 12 MiB (kmeans_pallas.py's
    xt_geometry and _block_for_t, copied)."""
    if s != 2:
        return False
    dp = pad(d + 1, 16)
    target = max(128, (2 * 1024 * 1024) // (dp * s))
    blk = min(1 << (target.bit_length() - 1), 32768)
    while blk > 128 and blk // 2 >= m:
        blk //= 2
    return dp * pad(m, blk) * s <= 12 * 2**20


def main() -> None:
    for name, s in (("f32", 4), ("bf16", 2)):
        whole = largest(lambda e: kmeans_chw.lloyd_plan(1, 321 * W, e + 3, s, 132)[4] == e + 3)
        k2 = [largest(lambda e, lv=lv: k2_step(e, s, lv) <= VMEM) for lv in (False, True)]
        print(f"K2 {name}: the port takes any E (a whole tile staged up to E = {whole}, "
              f"D = {whole + 3}; rows staged in blocks past it); the reference at W = {W}: "
              f"E <= {k2[0]} with its blocks alone, E <= {k2[1]} with its live copies -> the "
              "port takes more")
        k4 = [largest(lambda e: 2 * (e + 3) * 4 <= 40 * 1024)] + [
            largest(lambda e, lv=lv: k4_step(e, s, lv) <= VMEM) for lv in (False, True)]
        port, ref, ref_live = k4
        print(f"K4 {name}: the port takes E <= {port} (D = E + 3 <= {port + 3}); the "
              f"reference at W = {W}: E <= {ref} with its blocks alone, E <= {ref_live} "
              f"with its live copies -> "
              f"{'the port takes more' if port >= ref else 'the port takes less'}")
        m = 80 * 120
        fused = largest(lambda e: coarse_fused(e + 3, m, s))
        k3 = largest(lambda e: kmeans_fused.coarse_route(e + 3) == "k3")
        ref_txt = (f"its fused kernel up to d = {fused + 3}, its blocked passes past it"
                   if fused else "its blocked passes at every d")
        print(f"coarse warm start {name} at config1's {m}-pixel grid: the reference runs "
              f"{ref_txt}; the port runs K3 up to d = {k3 + 3} and K6 + K5 past it, at any d "
              f"-> the port takes every d the reference does")


if __name__ == "__main__":
    main()
