"""The measured window: a closed loop of one client sending host batches
back to back, each timed from its call to its labels in host memory."""

from __future__ import annotations

import math
import sys
import time

import numpy as np


class Window:
    """What a window recorded: each batch's host-to-host time, the pixels
    labelled, failures, and the window's start and end (the last batch's
    return)."""

    def __init__(self):
        self.times = []
        self.pixels = 0
        self.failed = 0
        self.t_begin = self.t_end = None

    @property
    def attempted(self) -> int:
        return len(self.times)

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_begin

    def mp_s(self) -> float:
        """Megapixels whose labels reached the host, over the window."""
        return self.pixels / 1e6 / self.seconds

    def batch_ms(self, q: float) -> float:
        """The q-quantile of every batch's host-to-host time, nearest rank
        (the ceil(q n)-th smallest), in ms."""
        t = sorted(self.times)
        return 1e3 * t[max(0, math.ceil(q * len(t)) - 1)]


def run(send, seconds: float) -> Window:
    """Call ``send(i)`` for i = 0, 1, ... back to back until ``seconds``
    have passed since the first call; each returns the i-th batch's host
    labels, or raises (a failed batch)."""
    w = Window()
    w.t_begin = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if t0 - w.t_begin >= seconds:
            break
        try:
            labels = send(i)
        except Exception as exc:  # a failed batch counts against the run
            labels = None
            w.failed += 1
            print(f"batch {i} failed: {exc!r}", file=sys.stderr, flush=True)
        t1 = time.perf_counter()
        w.times.append(t1 - t0)
        w.t_end = t1
        if labels is not None:
            w.pixels += int(np.prod(labels.shape))
        i += 1
    return w
