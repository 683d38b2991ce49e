#!/usr/bin/env python3
"""Where the evaluation loop's host time goes: each host metric of
``eval.evaluate``'s rows, timed per image and, for the optimal boundary
matcher, per ground truth, on the labels the port's pipeline gives for
``load_split("test", limit=N)`` (no JAX; the pipeline on the card, or on the
CPU with ``--device cpu``).

    python3 experiments/torch_eval_matcher.py [--preset config0] [--dtype float32]
        [--limit 8] [--device cuda|cpu]

Prints one line per image: its boundary pixels, the seconds of
``pri_np``, ``mean_voi_np``, ``mean_covering_np`` and ``fboundary_np``, and
for each ground truth its boundary pixels, the candidate pairs within the
tolerance, the seconds of the cKDTree query and of scipy's
``maximum_bipartite_matching``, and the matches.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="config0")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--limit", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from gabor_color_image_segmentation_tpu_torch.config import preset
    from gabor_color_image_segmentation_tpu_torch.eval import load_split
    from gabor_color_image_segmentation_tpu_torch.metrics import boundary as mb
    from gabor_color_image_segmentation_tpu_torch.metrics.pri import pri_np
    from gabor_color_image_segmentation_tpu_torch.metrics.region import (
        mean_covering_np,
        mean_voi_np,
    )
    from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images

    cfg = preset(args.preset).replace(batch_size=1, dtype=args.dtype)
    for image_id, rgb, gts in load_split("test", limit=args.limit):
        labels = segment_images(rgb[None], cfg, device=args.device).cpu().numpy()[0]
        times = {}
        for name, fn in (("pri", pri_np), ("voi", mean_voi_np), ("covering", mean_covering_np),
                         ("f_boundary", mb.fboundary_np)):
            t0 = time.perf_counter()
            fn(labels, gts)
            times[name] = round(time.perf_counter() - t0, 3)
        pred_b = mb.boundaries_np(labels)
        tol = mb.default_tolerance(*labels.shape)
        per_gt = []
        for g in gts:
            gt_b = mb.boundaries_np(g)
            t0 = time.perf_counter()
            pairs = mb._candidate_pairs(np.argwhere(pred_b), np.argwhere(gt_b), tol)
            t_query = time.perf_counter() - t0
            t0 = time.perf_counter()
            pm, _ = mb._match_one(pred_b, gt_b, tol)
            t_match = time.perf_counter() - t0 - t_query  # _match_one queries again
            per_gt.append(f"gt px {int(gt_b.sum())} pairs {sum(len(p) for p in pairs)} query "
                          f"{t_query:.3f} s matching {max(t_match, 0.0):.3f} s matches "
                          f"{int(pm.sum())}")
        print(f"{image_id} [{args.preset} {args.dtype}, {args.device}] boundary px "
              f"{int(pred_b.sum())}, seconds {times}; " + "; ".join(per_gt), flush=True)


if __name__ == "__main__":
    main()
