"""Time the superpixel-moments kernel (K16-K18, csrc/superpixel_moments.cu)
and the lookup kernel (K15, csrc/lookup.cu) on one NVIDIA card, at
config3's and config4's graph-stage shapes, by chunk size.

    python3 experiments/torch_moments_chunks.py [--chunks 1024 2048 4096 8192]

Inputs: the graph stage's own standardised features and connected
superpixels (``pipeline._graph_front``) of the bench mosaics (seeds 100..)
at config3 (8 x 321 x 481, S = 925) and config4's pooled grid (8 x 540 x
960 of 2160 x 3840 frames, S = 405), bf16. For each chunk size of
``graph_fused.chunk_plan`` (set through ``graph_fused.CHUNK``): K17's time
(CUDA events, the median of 5 means over 50 back-to-back calls queued
behind a sleep kernel), its
blocks, and whether its sums and counts equal the plain version's; beside
it one float32 ``index_add_`` and the plain version. Then K15 on config3's
superpixels against ``torch.gather``. Prints the card's name and power
limit first. Needs a card; it builds the kernels at first use."""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import graph_fused as gm
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl
from gabor_color_image_segmentation_tpu_torch.ops import lookup
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy


def cuda_ms(fn, reps=5, inner=50):
    """Median over ``reps`` pairs of CUDA events of the mean of ``inner``
    back-to-back calls; a sleep kernel queued first holds the card while the
    host queues them (chip_smoke.py's timing)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold_cycles = int(inner * (time.perf_counter() - t0) * 2.0e9)
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(hold_cycles)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", type=int, nargs="+", default=[1024, 2048, 4096, 8192])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    print(card, flush=True)
    set_policy()
    dev = torch.device("cuda")
    for name in ("config3", "config4"):
        cfg = preset(name).replace(dtype="bfloat16")
        h, w = (321, 481) if name == "config3" else cfg.image_hw
        rgb = np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0]
                        for i in range(8)])
        feats, sp, n_sp = pl._graph_front(torch.from_numpy(rgb).to(dev), cfg,
                                          make_bank(cfg.bank))
        del rgb
        b, d, n = feats.shape
        rs, rc = gm.superpixel_moments_plain(sp, feats, n_sp, True)
        flat = (sp.long() + n_sp * torch.arange(b, device=dev)[:, None]).reshape(-1)
        rows = feats.transpose(1, 2).float().reshape(-1, d)
        lib = cuda_ms(lambda: torch.zeros((b * n_sp, d), device=dev).index_add_(0, flat, rows))
        plain = cuda_ms(lambda: gm.superpixel_moments_plain(sp, feats, n_sp, True), inner=5)
        print(f"{name} bf16 features {tuple(feats.shape)}, S={n_sp}: index_add_ {lib:.4f} "
              f"ms, plain {plain:.4f} ms ({card})", flush=True)
        saved = gm.CHUNK
        for chunk in args.chunks:
            gm.CHUNK = chunk
            got = gm.superpixel_moments_fused_t(sp, feats, n_sp)
            same = torch.equal(got[0], rs) and torch.equal(got[1], rc)
            ms = cuda_ms(lambda: gm.superpixel_moments_fused_t(sp, feats, n_sp))
            size, n_chunks = gm.chunk_plan(b, n, n_sp, d)
            print(f"  chunk {size}: {n_chunks} an image, {b * n_chunks} blocks, K17 {ms:.4f} "
                  f"ms, equal to the plain version: {same}", flush=True)
        gm.CHUNK = saved
        table = torch.randint(0, 8, (b, n_sp), dtype=torch.int32, device=dev)
        sp64 = sp.long()
        same = torch.equal(lookup.table_lookup(sp, table), lookup.table_lookup_plain(sp, table))
        print(f"{name} K15 idx {tuple(sp.shape)} table {tuple(table.shape)}: kernel "
              f"{cuda_ms(lambda: lookup.table_lookup(sp, table)):.4f} ms, torch.gather "
              f"{cuda_ms(lambda: torch.gather(table, 1, sp64)):.4f} ms, bit-equal {same} "
              f"({card})", flush=True)
        del feats, sp, flat, rows, rs, rc


if __name__ == "__main__":
    main()
