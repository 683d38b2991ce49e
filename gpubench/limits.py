"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process:

  python3 gpubench/limits.py --workload <cell> --seeds 1,2,... --control-seeds 7,8,9

For each seed, the program's labels of the batches a run with that seed
checks, against the configuration's reference; for each control seed, the
control (the reference with its stored tensors in float8 e4m3,
gpubench/reference/common.py) against the reference on the same frames.
Both go through the comparison a run makes (``harness.reference_numbers``).
Prints one JSON line a seed. The program runs as in a run: warmed up,
labels to host memory.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from gpubench import harness, spec, traffic  # noqa: E402


def main(argv=None, device="cuda") -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    cell = spec.load_cell(ROOT, args.workload)
    dev = torch.device(device)
    from gabor_color_image_segmentation_tpu_torch.models import pipeline
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

    cfg = harness.pipeline_config(cell.config)
    bank = make_bank(cfg.bank)
    tr = cell.traffic
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in sorted(set(seeds) | set(controls), key=lambda s: (s not in seeds, s)):
        t0 = time.perf_counter()
        batches = traffic.batches(traffic.make_pool(seed, tr, dev), tr["batch"])
        ids = harness.checked_ids(seed, len(batches), tr["check_batches"])
        frames = {d: batches[d] for d in ids}
        sides, answers = [], []
        if seed in seeds:
            pipeline.segment_images(batches[0], cfg, bank, device=dev).cpu()
            sides.append("program")
            answers.append({d: pipeline.segment_images(f, cfg, bank, device=dev).cpu().numpy()
                            for d, f in frames.items()})
        if seed in controls:
            sides.append("control")
            answers.append({d: harness.reference_labels(cell, f, dev, "fp8")
                            for d, f in frames.items()})
        numbers = harness.reference_numbers(cell, frames, answers, dev)
        reading = {"workload": args.workload, "seed": seed, "checked": ids,
                   **dict(zip(sides, numbers)), "seconds": time.perf_counter() - t0}
        print(json.dumps(reading), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
