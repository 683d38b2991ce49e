"""One run of one cell:

  python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's frames from the seed and warms the program on
them; then, with ``--trace 0``, a closed loop of one client sends the host
batches back to back for ``--seconds`` (the end-to-end metrics); with
``--trace 1`` the device-resident loop runs, then ``trace_batches`` batches
of the same loop run under torch.profiler (the per-layer metrics). After
the window, the checked batches' labels are compared with the
configuration's plain reference, and the last line of standard output is
the result.

The program under test is gabor_color_image_segmentation_tpu_torch,
called through ``models.pipeline.segment_images``; nothing here imports the
JAX package or JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gpubench import judge, resident, spec, trace, traffic, window

FORBIDDEN = ("jax", "jaxlib", "flax", "gabor_color_image_segmentation_tpu")
PACKAGE = "gabor_color_image_segmentation_tpu_torch"


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's (compared whole: the program's name begins with the JAX
    package's)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def pipeline_config(c: dict):
    """The program's PipelineConfig from a configuration file."""
    from gabor_color_image_segmentation_tpu_torch.config import (
        BankConfig,
        ClusterConfig,
        GraphConfig,
        PipelineConfig,
    )

    bank = dict(c["bank"])
    bank["scales"] = tuple(bank["scales"])
    if bank["frequencies"] is not None:
        bank["frequencies"] = tuple(bank["frequencies"])
    tile = c["tile_hw"]
    return PipelineConfig(
        name=c["name"], bank=BankConfig(**bank), cluster=ClusterConfig(**c["cluster"]),
        graph=GraphConfig(**c["graph"]), color_space=c["color_space"],
        image_hw=tuple(c["image_hw"]), batch_size=c["batch_size"], dtype=c["dtype"],
        feature_impl=c["feature_impl"], mesh_shape=tuple(c["mesh_shape"]),
        tile_hw=None if tile is None else tuple(tile))


def card(device: torch.device) -> dict:
    """The card's name, power limit and the software, for the log; read
    after the window with the card's clock, temperature and draw then and
    the host's load."""
    info = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type != "cuda":
        return dict(info, name="cpu", power_limit="none", state="")
    info["name"] = torch.cuda.get_device_name(device)
    info["power_limit"] = info["state"] = "not read"
    smi = shutil.which("nvidia-smi")
    if smi:
        out = subprocess.run([smi, "--query-gpu=power.limit,clocks.sm,clocks.max.sm,"
                              "temperature.gpu,power.draw", "--format=csv,noheader",
                              f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=60)
        fields = out.stdout.strip().splitlines()[0].split(", ") if out.returncode == 0 else []
        if len(fields) == 5:
            info["power_limit"] = fields[0]
            info["state"] = (f"SM clock {fields[1]} of {fields[2]}, {fields[3]} C, "
                             f"drawing {fields[4]}")
    try:
        with open("/proc/loadavg") as f:
            info["state"] += f"; host load {' '.join(f.read().split()[:3])}"
    except OSError:
        pass
    return info


def checked_ids(seed: int, n_distinct: int, n_checked: int) -> list:
    """The distinct batches a run with ``seed`` checks."""
    rng = np.random.default_rng([traffic.seed64(seed), 1])
    return sorted(int(i) for i in rng.choice(n_distinct, n_checked, replace=False))


class Checked:
    """The batches checked against the reference: ``check_batches`` of the
    pool's distinct batches, drawn from the seed, and for each one of its
    sends, drawn uniformly as the run goes (a reservoir of one). A kept
    send's labels are downloaded into a buffer of their own, made in
    set-up, so keeping them copies nothing inside the window."""

    def __init__(self, seed: int, n_distinct: int, n_checked: int, shape, pinned: bool):
        self.ids = checked_ids(seed, n_distinct, n_checked)
        self.n_distinct = n_distinct
        self.rng = np.random.default_rng([traffic.seed64(seed), 2])
        self.seen = dict.fromkeys(self.ids, 0)
        self.buffers = {d: torch.zeros(shape, dtype=torch.int32, pin_memory=pinned)
                        for d in self.ids}
        self.kept = set()

    def target(self, i: int):
        """The checked batch id whose buffer send i downloads into, or
        None."""
        d = i % self.n_distinct
        if d not in self.seen:
            return None
        self.seen[d] += 1
        return d if self.rng.random() * self.seen[d] < 1.0 else None

    def labels(self, d: int):
        return self.buffers[d].numpy() if d in self.kept else None


class Context:
    """What the metric readers read."""

    def __init__(self, cell, device_info, setup_s, win, tr, resident_mp_s):
        self.cell = cell
        self.config = cell.config
        self.traffic = cell.traffic
        self.card = device_info
        self.setup_s = setup_s
        self.window = win
        self.trace = tr
        self.resident_mp_s = resident_mp_s
        import gabor_color_image_segmentation_tpu_torch as pkg

        self.csrc = Path(pkg.__file__).resolve().parent / "csrc"

    def log(self, *args) -> None:
        log(*args)

    def pattern(self, sources=None):
        """A regex for the kernels defined in the program's ``sources``
        (all of csrc/ with None), or None where they define none."""
        files = ([self.csrc / s for s in sources] if sources is not None
                 else sorted(self.csrc.glob("*.cu")) + sorted(self.csrc.glob("*.cuh")))
        files = [f for f in files if f.is_file()]
        return trace.name_pattern(trace.kernel_names(files))

    def kernel_ms(self, sources) -> float | None:
        """Device ms a batch of the kernels defined in ``sources``, or None
        where the trace holds none of them."""
        pat = self.pattern(sources)
        if self.trace is None or pat is None or not self.trace.batches:
            return None
        seconds, n = self.trace.kernel_seconds(pat)
        return 1e3 * seconds / self.trace.batches if n else None


def reference_labels(cell, frames: np.ndarray, device, storage: str | None = None):
    """The reference's labels (B, H, W) of host frames (B, H, W, 3), worked
    out in blocks of ``reference_block`` frames, each tensor stored in the
    configuration's dtype or in ``storage`` ("fp8": the control)."""
    return np.concatenate([want for _, want in _reference_blocks(cell, frames, device, storage)])


def _reference_blocks(cell, frames, device, storage=None):
    from gpubench.reference import common

    common.set_policy()
    ref = spec.reference(cell.root, cell.config_name)
    store = common.Storage(storage or cell.config["dtype"])
    blk = int(cell.config["reference_block"])
    for s in range(0, frames.shape[0], blk):
        rgb = torch.from_numpy(frames[s:s + blk]).to(device)
        with torch.no_grad():
            want = ref.segment(rgb, cell.config, store).cpu().numpy()
        del rgb
        yield s, want


def reference_numbers(cell, frames: dict, answers: list, device) -> list:
    """The judge's numbers of each set of answers in ``answers`` ({batch id:
    labels (B, H, W), or None where none came back}) against the
    reference's labels of the same batches' frames (``frames``: {batch id:
    host frames}), which it works out once a block. One dict a set."""
    k = int(cell.config["cluster"]["k"])
    parts = [[] for _ in answers]
    for d, batch in frames.items():
        for s, want in _reference_blocks(cell, batch, device):
            for part, got in zip(parts, answers):
                pred = got.get(d)
                if pred is None or pred.shape != batch.shape[:3]:
                    part.append(judge.absent(want))
                else:
                    part.append(judge.compare(pred[s:s + want.shape[0]], want, k))
    return [judge.numbers(p) for p in parts]


def main(argv=None, t_start: float | None = None, device: str = "cuda",
         root: Path | None = None) -> int:
    """Run one cell; returns the exit code. ``device`` other than "cuda"
    skips the look for a card (the harness's own tests on the CPU)."""
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    root = Path(root) if root is not None else spec.HERE.parent
    cell = spec.load_cell(root, args.workload)
    traffic.check(cell.traffic)
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"gpubench: {args.workload} needs {cell.chips} CUDA card(s); "
                f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
                f"device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        dev = torch.device("cuda", 0)
    from gabor_color_image_segmentation_tpu_torch.models import pipeline
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

    cfg = pipeline_config(cell.config)
    bank = make_bank(cfg.bank)
    tr_cfg = cell.traffic
    t_frames = time.perf_counter()
    pool = traffic.make_pool(args.seed, tr_cfg, dev)
    pool_batches = traffic.batches(pool, tr_cfg["batch"])
    del pool
    shape = pool_batches[0].shape[:3]
    # the labels' host buffers: page-locked on a card, so the download is one
    # DMA and no host memcpy; made here, reused by every send
    pinned = dev.type == "cuda"
    host = torch.zeros(shape, dtype=torch.int32, pin_memory=pinned)
    checked = Checked(args.seed, len(pool_batches), tr_cfg["check_batches"], shape, pinned)

    def send(i):
        """The i-th batch of the closed loop: host frames in, labels in host
        memory out (a checked send's into its own buffer)."""
        d = checked.target(i)
        out = host if d is None else checked.buffers[d]
        labels = pipeline.segment_images(pool_batches[i % len(pool_batches)], cfg, bank,
                                         device=dev)
        out.copy_(labels)
        if d is not None:
            checked.kept.add(d)
        return out

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_warm = time.perf_counter()
    for i in range(tr_cfg["warmup_batches"]):
        host.copy_(pipeline.segment_images(pool_batches[i % len(pool_batches)], cfg, bank,
                                           device=dev))
    setup_s = time.perf_counter() - t_start
    log(f"gpubench: {args.workload} seed {args.seed}: set-up {setup_s:.3f} s (to the "
        f"frames {t_frames - t_start:.3f}, frames {t_warm - t_frames:.3f}, warm-up "
        f"{time.perf_counter() - t_warm:.3f})")

    win = tr = res = None
    if args.trace == 0:
        win = window.run(send, args.seconds)
        attempted, failed = win.attempted, win.failed
        log(f"gpubench: window {win.seconds:.3f} s, {attempted} batches, "
            f"{win.mp_s():.4f} MP/s, p50 {win.batch_ms(0.5):.3f} ms, "
            f"p95 {win.batch_ms(0.95):.3f} ms, failed {failed}")
        slow = sorted(range(attempted), key=lambda i: -win.times[i])[:5]
        log(f"gpubench: first batches {[round(1e3 * t, 3) for t in win.times[:5]]} ms; "
            f"slowest {[(i, round(1e3 * win.times[i], 3)) for i in slow]} (batch, ms)")
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        res = resident.resident_mp_s(pipeline.segment_batch, cfg, bank, pool_batches[0],
                                     tr_cfg["resident_iters"], dev)
        log(f"gpubench: device-resident {res:.4f} MP/s over {tr_cfg['resident_iters']} calls")
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        failed = 0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                for i in range(tr_cfg["trace_batches"]):
                    with record_function(trace.BATCH):
                        try:
                            send(i)
                        except Exception as exc:  # a failed batch counts against the run
                            failed += 1
                            log(f"batch {i} failed: {exc!r}")
        attempted = tr_cfg["trace_batches"]
        tmp = tempfile.mkdtemp(prefix="gpubench_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            tr = trace.Trace.from_file(path)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del prof

    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0
    info = card(dev)
    log(f"gpubench: card {info['name']}, power limit {info['power_limit']}, torch "
        f"{info['torch']}, CUDA {info['cuda']}; peak device memory {peak} bytes; after the "
        f"window: {info['state']}")

    ctx = Context(cell, info, setup_s, win, tr, res)
    wanted = cell.end_to_end if args.trace == 0 else cell.per_layer
    metrics = {}
    for m in wanted:
        value = spec.metric_reader(cell.root, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_out = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": info["name"], "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": False, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_out}
    if tr is not None:
        device_out["busy_s"] = tr.busy_s()
        device_out["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}

    # the program's state is done with; the reference runs after it
    del send, host
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    numbers, = reference_numbers(cell, {d: pool_batches[d] for d in checked.ids},
                                 [{d: checked.labels(d) for d in checked.ids}], dev)
    ok, checks = judge.verdict(numbers, cell.config["limits"])
    result["correct"] = bool(ok and failed == 0 and len(checked.kept) == len(checked.ids))
    result["checks"] = checks

    found = forbidden_modules()
    if found:
        log(f"gpubench: modules loaded that the run may not hold: {found}")
        return 3
    print(json.dumps(result), flush=True)
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return 0
