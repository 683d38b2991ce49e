#!/usr/bin/env python3
"""Feature rows K2 and K4 take on the card against the reference's range at
W = 481 (arithmetic only: runs anywhere, no card, no JAX).

    python3 experiments/torch_range_check.py

The port: K2's largest D = E + 3 for which ``kmeans_chw.lloyd_plan`` finds
a tile that fits shared memory, and K4's entry check (the probe and a^2 in
40 KB of shared memory: 2 (E + 3) 4 bytes). The reference: the TPU's VMEM
a grid step of ``_lloyd_chw_pass`` / ``_maximin_chw_pass`` needs at
t_sub = 1, from their BlockSpecs (every block double-buffered; a block's
last two dims padded to the (8, 128) f32 / (16, 128) bf16 tile; W = 481
lanes take 512), under their 100 MB ``vmem_limit_bytes``: once with the
blocks alone (an upper bound of what compiles) and once with the copies
their kernels keep live beside them (K2: the row-masked copy of the rows,
read again by the sums' dots; K4: that copy and the squares). What Mosaic
really allocates shows only in a TPU compile.
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw  # noqa: E402

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


def main() -> None:
    for name, s in (("f32", 4), ("bf16", 2)):
        def k2_port(e):
            try:
                kmeans_chw.lloyd_plan(1, 321 * W, e + 3, s, 132)
                return True
            except ValueError:
                return False

        k2 = [largest(k2_port)] + [largest(lambda e, lv=lv: k2_step(e, s, lv) <= VMEM)
                                   for lv in (False, True)]
        k4 = [largest(lambda e: 2 * (e + 3) * 4 <= 40 * 1024)] + [
            largest(lambda e, lv=lv: k4_step(e, s, lv) <= VMEM) for lv in (False, True)]
        for kern, (port, ref, ref_live) in (("K2", k2), ("K4", k4)):
            print(f"{kern} {name}: the port takes E <= {port} (D = E + 3 <= {port + 3}); the "
                  f"reference at W = {W}: E <= {ref} with its blocks alone, E <= {ref_live} "
                  f"with its live copies -> "
                  f"{'the port takes more' if port >= ref else 'the port takes less'}")


if __name__ == "__main__":
    main()
