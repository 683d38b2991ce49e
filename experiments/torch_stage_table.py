"""Where a benchmark cell's batch time goes, stage by stage: the program's
``gcis.*`` spans in a profiler trace of the cell's traffic.

  python3 experiments/torch_stage_table.py --workload config1.bsds-b16
      [--seed N] [--batches 20] [--root DIR] [--loop N] [--slowest K]

Builds the cell's frames as gpubench does (``--seed``), warms up, then
traces ``--batches`` batches of the closed loop (host frames in, labels
copied into page-locked host memory). For each span, ms a batch: its own
host time (less the spans inside it), the kernel launches made inside it
and not inside a span within it, the device time of what those launches
ran, and the device's idle time in gaps whose middle falls inside it (the
innermost span there; "outside" between calls). ``--root`` runs the
program of another checkout (its package and its gpubench). ``--loop N``
first times N untraced batches host to host, as the harness's window
does, and prints their quantiles and the largest; ``--slowest K`` prints,
for the K slowest traced batches, each span's own host time against the
median batch's (where a slow batch's extra time lands). Prints the table
and writes it as a JSON line to chiprun_out/torch_stage_table.json. Needs
the card.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
from pathlib import Path

import torch


def innermost(spans, starts, t):
    """Index of the innermost span open at t, or None."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if spans[i][1] >= t:
            return i
        i = spans[i][3]  # the span this one sits in
    return None


def table(tr, batches):
    from gpubench import trace

    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                   for e in tr.host if e.get("cat") == "user_annotation"
                   and e["name"].startswith("gcis."))
    # parent links: the nearest earlier span that still covers the start
    linked, stack = [], []
    for s, e, name in spans:
        while stack and linked[stack[-1]][1] < s:
            stack.pop()
        linked.append((s, e, name, stack[-1] if stack else -1))
        stack.append(len(linked) - 1)
    starts = [s[0] for s in linked]
    rows = {}

    def row(i):
        name = "outside" if i is None else linked[i][2]
        return rows.setdefault(name, {"host": 0.0, "launches": 0, "device": 0.0, "idle": 0.0})

    for i, (s, e, _, parent) in enumerate(linked):
        row(i)["host"] += e - s
        if parent >= 0:
            row(parent)["host"] -= e - s
    where = {}
    for ev in tr.runtime:
        i = innermost(linked, starts, float(ev["ts"]))
        corr = ev.get("args", {}).get("correlation")
        if corr is not None:
            where[corr] = i
        if trace._LAUNCH.match(ev.get("name", "")):
            row(i)["launches"] += 1
    for ev in tr.device:
        corr = ev.get("args", {}).get("correlation")
        row(where.get(corr))["device"] += float(ev["dur"])
    busy = trace.merge(tr._clipped(tr.device))
    edges = [tr.t0] + [x for iv in busy for x in iv] + [tr.t1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            row(innermost(linked, starts, 0.5 * (s + e)))["idle"] += e - s
    out = {}
    for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["device"]):
        out[name] = {"host_ms": round(r["host"] / 1e3 / batches, 3),
                     "launches": round(r["launches"] / batches, 2),
                     "device_ms": round(r["device"] / 1e3 / batches, 3),
                     "idle_ms": round(r["idle"] / 1e3 / batches, 3)}
    return out


def slow_batches(events, slowest):
    """(the traced batches' ms, sorted; for each of the ``slowest`` slowest:
    its ms and the spans whose own host ms differ from the median batch's
    by 0.5 ms or more, as span: (its ms, the median's))."""
    from gpubench import trace

    ann = [e for e in events if e.get("cat") == "user_annotation" and "dur" in e]
    batches = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in ann
                     if e["name"] == trace.BATCH)
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]) for e in ann
                   if e["name"].startswith("gcis."))
    own = [[s, e, name, e - s] for s, e, name in spans]
    stack = []
    for i, (s, e, _, _) in enumerate(own):
        while stack and own[stack[-1]][1] < s:
            stack.pop()
        if stack:
            own[stack[-1]][3] -= e - s
        stack.append(i)
    per = []
    for bs, be in batches:
        row = {}
        for s, _, name, t in own:
            if bs <= s < be:
                row[name] = row.get(name, 0.0) + t / 1e3
        per.append(((be - bs) / 1e3, row))
    names = sorted({n for _, r in per for n in r})
    med = {n: sorted(r.get(n, 0.0) for _, r in per)[len(per) // 2] for n in names}
    out = []
    for ms, row in sorted(per, key=lambda x: -x[0])[:slowest]:
        out.append((round(ms, 3), {n: (round(row.get(n, 0.0), 3), round(med[n], 3))
                                   for n in names if abs(row.get(n, 0.0) - med[n]) >= 0.5}))
    return sorted(round(ms, 3) for ms, _ in per), out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2147483647)
    ap.add_argument("--batches", type=int, default=20)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--loop", type=int, default=0)
    ap.add_argument("--slowest", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from torch.profiler import ProfilerActivity, profile, record_function

    from gabor_color_image_segmentation_tpu_torch.models import pipeline
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank
    from gpubench import spec, trace, traffic
    from gpubench.harness import card, pipeline_config

    dev = torch.device("cuda", 0)
    cell = spec.load_cell(root, args.workload)
    cfg = pipeline_config(cell.config)
    bank = make_bank(cfg.bank)
    pool = traffic.make_pool(args.seed, cell.traffic, dev)
    batches = traffic.batches(pool, cell.traffic["batch"])
    host = torch.zeros(batches[0].shape[:3], dtype=torch.int32, pin_memory=True)
    for i in range(3):
        host.copy_(pipeline.segment_images(batches[i % len(batches)], cfg, bank, device=dev))
    torch.cuda.synchronize(dev)
    loop = None
    if args.loop:
        import statistics
        import time

        times = []
        for i in range(args.loop):
            t0 = time.perf_counter()
            host.copy_(pipeline.segment_images(batches[i % len(batches)], cfg, bank, device=dev))
            times.append((time.perf_counter() - t0) * 1e3)
        q = statistics.quantiles(times, n=100)
        loop = {"batches": args.loop, "p50": round(q[49], 3), "p90": round(q[89], 3),
                "p95": round(q[94], 3), "p99": round(q[98], 3),
                "largest": [round(t, 3) for t in sorted(times)[-10:]],
                "over_1.1x_median": sum(t > 1.1 * q[49] for t in times)}
        print(f"untraced loop: {json.dumps(loop)}", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(trace.WINDOW):
            for i in range(args.batches):
                with record_function(trace.BATCH):
                    host.copy_(pipeline.segment_images(batches[i % len(batches)], cfg, bank,
                                                       device=dev))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        tr = trace.Trace.from_file(path)
        slow = None
        if args.slowest:
            with open(path) as f:
                data = json.load(f)
            traced, worst = slow_batches(
                data["traceEvents"] if isinstance(data, dict) else data, args.slowest)
            slow = {"traced_ms": traced, "slowest": worst}
            print(f"traced batches, ms: median {traced[len(traced) // 2]}, largest "
                  f"{traced[-args.slowest:]}", flush=True)
            for ms, spans in worst:
                print(f"  {ms} ms: spans (own host ms, the median batch's) {spans}", flush=True)
    res = {"workload": args.workload, "root": str(root), "seed": args.seed,
           "card": card(dev)["name"], "batches": tr.batches,
           "busy_ms": round(tr.busy_s() * 1e3 / tr.batches, 3),
           "window_ms": round(tr.window_s * 1e3 / tr.batches, 3),
           "launches": round(tr.launches() / tr.batches, 2),
           "stages": table(tr, tr.batches), "loop": loop, "slow": slow}
    for name, r in res["stages"].items():
        print(f"{name:36s} host {r['host_ms']:8.3f}  launches {r['launches']:7.2f}  "
              f"device {r['device_ms']:8.3f}  idle {r['idle_ms']:7.3f}", flush=True)
    print(json.dumps({k: v for k, v in res.items() if k not in ("stages", "slow")}),
          flush=True)
    out = Path(__file__).resolve().parents[1] / "chiprun_out" / "torch_stage_table.json"
    out.parent.mkdir(exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps(res) + "\n")


if __name__ == "__main__":
    main()
