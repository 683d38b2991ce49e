"""End-to-end throughput benchmark core (counterpart of the JAX package's
benchmark.py), behind ``cli.py bench``.

Measures device-resident end-to-end MP/s: the uint8 batch is uploaded to
the card once, and the timed region runs ``iters`` labels-only
``segment_batch`` calls on it, each adding its int32 labels' sum to an
accumulator on the device, fenced once at the end by reading that
checksum back. No upload and no label download sits inside the timer;
the host's orchestration of each call does (see ``bench_device``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

# CPU golden-path throughput for the same workloads (MP/s): the JAX
# package's table (its benchmark.py), measured there on a 1-core x86 with
# its measure_cpu_golden on 2026-08-16 (see BASELINE.md). Method-correct:
# config2's golden runs the f64 GMM EM, config3's runs SLIC + spectral
# n-cut, config4's runs the full filter->cluster->cut chain (pooled graph
# stage, re-measured 2026-08-20 after the preset flip; the pooled golden
# graph is faster than the old full-resolution 4K golden k-means, 0.1276
# vs 0.0428). Copied, not re-measured: the port imports no golden/ module.
CPU_BASELINE_MP_S = {
    "config0": 0.1632,
    "config1": 0.0113,
    "config2": 0.00087,
    "config3": 0.02925,
    "config4": 0.1276,
}


def build_batch(cfg, n_images: int) -> np.ndarray:
    """(n_images, H, W, 3) uint8 bench mosaics at ``cfg.image_hw``: 5
    regions, seeds 100, 101, ... (the JAX package's build_batch, bit for
    bit)."""
    from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic

    h, w = cfg.image_hw
    return np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0]
                     for i in range(n_images)])


def _timed_loop(cfg, batch_dev: torch.Tensor, bank, iters: int, device):
    """``iters`` calls of ``segment_batch(batch_dev + i, cfg, bank, False,
    device)``, each adding its labels' sum to an int64 accumulator on the
    device, and one fence at the end. uint8 input wraps mod 256, as the
    reference's ``b + i.astype(b.dtype)``. Returns (seconds from the
    synchronised start to the fence, the checksum)."""
    from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch

    wrap = batch_dev.dtype == torch.uint8
    acc = torch.zeros((), dtype=torch.int64, device=batch_dev.device)
    if batch_dev.device.type == "cuda":
        torch.cuda.synchronize(batch_dev.device)
    t0 = time.perf_counter()
    for i in range(iters):
        labels, _ = segment_batch(batch_dev + (i % 256 if wrap else i), cfg, bank, False,
                                  device)
        acc += labels.sum()
    checksum = int(acc.item())
    return time.perf_counter() - t0, checksum


def bench_device(cfg, batch: np.ndarray, iters: int, device=None) -> float:
    """MP/s of the labels-only pipeline on ``device`` (the card unless
    ``device="cpu"``; with no card None raises, naming ``device="cpu"``).

    The batch is uploaded once; one untimed loop of ``iters`` calls builds
    the kernels and warms the caches (the reference's first ``run``, which
    compiles); then the same loop is timed (``_timed_loop``). Nothing in it
    synchronises beyond what ``segment_batch`` does itself: the k-means's
    fixed-point test after each Lloyd pass with sums (config0: up to
    ``n_iter`` a call; config1: up to four, three mid-level passes and one
    refine pass) and the graph stage's host reads (configs 3 and 4);
    config2's EM loop freezes converged images on the card and reads
    nothing back. A traced call shows each sync as a ``gcis.sync.*`` range
    (utils/trace.py). The figure differs from the
    reference's, which times one jitted ``fori_loop``: both exclude the
    upload and the labels' download, but here the host orchestrates each
    call, and its launches and syncs count."""
    from gabor_color_image_segmentation_tpu_torch.models.pipeline import _resolve_device
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

    dev = _resolve_device(device)
    bank = make_bank(cfg.bank)
    batch_dev = torch.from_numpy(np.ascontiguousarray(batch)).to(dev)
    _timed_loop(cfg, batch_dev, bank, iters, dev)  # builds the kernels
    seconds, _ = _timed_loop(cfg, batch_dev, bank, iters, dev)
    mp = batch.shape[0] * batch.shape[1] * batch.shape[2] / 1e6
    return mp / (seconds / iters)


def run_benchmark(
    preset_name: str = "config1",
    batch_size: int | None = None,
    iters: int = 50,
    dtype: str = "bfloat16",
    subsample: int = 1,
    cfg=None,
    device=None,
) -> dict:
    """The one-JSON-line result dict: ``metric``, ``value``, ``unit``,
    ``vs_baseline``.

    Pass ``cfg`` (a PipelineConfig) to benchmark any configuration (the
    CLI's preset-override flags build one). ``vs_baseline`` divides by the
    stored CPU golden figure for an unmodified preset; where the reference
    would measure its golden path instead (a ``cfg`` given, a preset
    missing from the table) it is None, since the port imports no golden/
    module. ``device`` None means the card; the unit names the device the
    figure was taken on."""
    from gabor_color_image_segmentation_tpu_torch.config import preset
    from gabor_color_image_segmentation_tpu_torch.models.pipeline import _resolve_device

    dev = _resolve_device(device)
    stock = cfg is None
    if cfg is None:
        cfg = preset(preset_name).replace(dtype=dtype)
    if subsample != 1:
        cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, subsample=subsample))
    if batch_size:
        cfg = cfg.replace(batch_size=batch_size)
    batch = build_batch(cfg, cfg.batch_size)

    mp_s = bench_device(cfg, batch, iters, dev)

    cpu_mp_s = CPU_BASELINE_MP_S.get(preset_name) if stock else None
    vs = mp_s / cpu_mp_s if cpu_mp_s else None
    unit = "MP/s/GPU" if dev.type == "cuda" else "MP/s/CPU"
    return {
        "metric": f"end-to-end {unit} ({cfg.name}: {cfg.bank.n_kernels}-kernel bank, "
                  f"batch {cfg.batch_size}, {cfg.cluster.method} k={cfg.cluster.k})",
        "value": round(mp_s, 3),
        "unit": unit,
        "vs_baseline": round(vs, 1) if vs else None,
    }
