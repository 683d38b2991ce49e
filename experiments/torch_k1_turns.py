#!/usr/bin/env python3
"""K1 and the labels-only path end to end, a parent checkout against this
one in turns (parent, change, change, parent), on one NVIDIA card.

    git archive <parent> | tar -x -C _checkout/parent
    python3 experiments/torch_k1_turns.py --parent _checkout/parent

Each turn is a fresh process that imports the port from its own checkout
(both builds land in their own ``_build/``) and reads, on the bench's
mosaics (seeds 100...): K1 at config1's shape (16 x 321 x 481 bf16 with
its twin; median of 5 calls, CUDA events) and ``segment_batch(...,
with_features=False)`` host uint8 to host int32 at config1 batch 16 bf16,
config2 batch 8 bf16 and config0 batch 1 f32 (median of 5 after one).
Prints one line a turn and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = r'''
import json, statistics, sys, time
sys.path.insert(0, sys.argv[1])
import numpy as np
import torch
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl
from gabor_color_image_segmentation_tpu_torch.ops import fused
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank

rgb = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=100 + i)[0]
                for i in range(16)])
out = {}
color = pl._color_transform(torch.from_numpy(rgb).cuda(), "lab")
groups = bank_tensors(make_bank(preset("config1").bank), "cuda")
fused.gabor_energies_fused(color, groups, torch.bfloat16)
times = []
for _ in range(5):
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fused.gabor_energies_fused(color, groups, torch.bfloat16)
    b.record()
    b.synchronize()
    times.append(a.elapsed_time(b))
out["k1_config1_ms"] = statistics.median(times)
for name, bsz, dtype in (("config1", 16, "bfloat16"), ("config2", 8, "bfloat16"),
                         ("config0", 1, "float32")):
    cfg = preset(name).replace(batch_size=bsz, dtype=dtype)
    pl.segment_batch(rgb[:bsz], cfg, with_features=False)[0].cpu()
    times = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl.segment_batch(rgb[:bsz], cfg, with_features=False)[0].cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    out[f"{name}_ms"] = statistics.median(times)
print(json.dumps(out))
'''


def turn(root: Path) -> dict:
    res = subprocess.run([sys.executable, "-c", TURN, str(root)], capture_output=True,
                         text=True)
    if res.returncode:
        sys.exit(f"turn in {root} failed:\n{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
    return json.loads(res.stdout.strip().splitlines()[-1])


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", required=True, help="a checkout of the parent commit")
    args = parser.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    parent = Path(args.parent).resolve()
    for label, root in (("parent", parent), ("change", ROOT), ("change", ROOT),
                        ("parent", parent)):
        res = turn(root)
        print(f"{label}: " + ", ".join(f"{k} {v:.2f}" for k, v in res.items())
              + f" ({card})", flush=True)


if __name__ == "__main__":
    main()
