"""Device-resident MP/s: the measure of the program's
``benchmark.py::bench_device`` and ``_timed_loop``, copied. The batch is
uploaded once; each call runs the labels-only ``segment_batch`` on the
batch plus i (mod 256, uint8 wraps) and adds its labels' sum to an int64
accumulator on the device; one fence at the end reads the checksum. No
upload and no label download sits inside the timer; the host's
orchestration of each call does."""

from __future__ import annotations

import time

import numpy as np
import torch


def _timed_loop(segment_batch, cfg, batch_dev: torch.Tensor, bank, iters: int, device):
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


def resident_mp_s(segment_batch, cfg, bank, batch: np.ndarray, iters: int, device) -> float:
    """MP/s of ``iters`` device-resident calls on ``batch``, after two
    untimed ones."""
    batch_dev = torch.from_numpy(np.ascontiguousarray(batch)).to(device)
    _timed_loop(segment_batch, cfg, batch_dev, bank, 2, device)
    seconds, _ = _timed_loop(segment_batch, cfg, batch_dev, bank, iters, device)
    return batch.shape[0] * batch.shape[1] * batch.shape[2] / 1e6 / (seconds / iters)
