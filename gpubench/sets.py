"""Runs of one cell, each a process of its own, and the spreads that the
bounds are set from:

  python3 gpubench/sets.py --workload <cell> --seeds 1,2,3 --seconds 20 --trace 0
      --out runs/set1.jsonl
  python3 gpubench/sets.py --summarize runs/set1.jsonl runs/set2.jsonl

A run's record: its seed, exit code, wall seconds, the result line and the
end of its standard error. A summary gives, for each file and metric, the
median and the spread (the distance between the first and third quartile,
``statistics.quantiles(values, n=4)``, over the median).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def run_set(workload: str, seeds: list, seconds: int, trace: int, out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in seeds:
        cmd = [sys.executable, "gpubench/run.py", "--workload", workload, "--seed", str(seed),
               "--seconds", str(seconds), "--trace", str(trace)]
        t0 = time.perf_counter()
        p = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=1300)
        lines = p.stdout.strip().splitlines()
        try:
            result = json.loads(lines[-1]) if lines else None
        except json.JSONDecodeError:
            result = None
        rec = {"workload": workload, "seed": seed, "trace": trace, "rc": p.returncode,
               "wall_s": time.perf_counter() - t0, "result": result,
               "stderr_tail": p.stderr[-3000:]}
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        m = (result or {}).get("metrics", {})
        print(json.dumps({"seed": seed, "rc": p.returncode, "wall_s": round(rec["wall_s"], 1),
                          "correct": (result or {}).get("correct"),
                          **{k: v["value"] for k, v in m.items()},
                          "checks": {k: v["value"] for k, v in
                                     (result or {}).get("checks", {}).items()}}), flush=True)


def spread(values: list) -> tuple:
    """(median, (q3 - q1) / median) by statistics.quantiles(n=4)."""
    med = statistics.median(values)
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med


def summarize(paths: list) -> None:
    for path in paths:
        recs = [json.loads(line) for line in open(path) if line.strip()]
        ok = [r for r in recs if r["result"]]
        names = sorted({k for r in ok for k in r["result"]["metrics"]})
        for name in names:
            vals = [r["result"]["metrics"][name]["value"] for r in ok
                    if name in r["result"]["metrics"]]
            if len(vals) >= 2:
                med, sp = spread(vals)
                print(f"{path}: {name} n={len(vals)} median {med:.6g} spread {sp:.6f} "
                      f"values {[round(v, 4) for v in vals]}")
        print(f"{path}: correct {[r['result']['correct'] for r in ok]}, "
              f"rc {[r['rc'] for r in recs]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=int, default=20)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", type=Path)
    ap.add_argument("--summarize", nargs="*")
    args = ap.parse_args(argv)
    if args.summarize:
        summarize(args.summarize)
        return 0
    run_set(args.workload, [int(s) for s in args.seeds.split(",") if s], args.seconds,
            args.trace, args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
