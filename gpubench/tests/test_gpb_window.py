"""The window's arithmetic: the rate over the whole window and the p95 over
every batch, both moved by a stall."""

from __future__ import annotations

import numpy as np
import pytest

from gpubench import window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _run(monkeypatch, costs, seconds):
    """window.run over a fake clock: the i-th send takes costs[i] s (the
    last cost repeats)."""
    clock = FakeClock()
    monkeypatch.setattr(window.time, "perf_counter", clock)

    def send(i):
        clock.t += costs[min(i, len(costs) - 1)]
        return np.zeros((2, 3, 4), np.int32)

    return window.run(send, seconds)


def test_rate_and_p95_over_every_batch(monkeypatch):
    w = _run(monkeypatch, [0.125], 1.0)
    assert w.attempted == 8 and w.failed == 0
    assert w.seconds == pytest.approx(1.0)
    assert w.mp_s() == pytest.approx(8 * 24 / 1e6 / 1.0)
    assert w.batch_ms(0.95) == pytest.approx(125.0)


def test_a_stall_moves_both(monkeypatch):
    steady = _run(monkeypatch, [0.125], 2.0)
    stalled = _run(monkeypatch, [0.125] * 5 + [0.625] + [0.125], 2.0)
    assert stalled.mp_s() < steady.mp_s()
    assert stalled.batch_ms(0.95) == pytest.approx(625.0)
    assert steady.batch_ms(0.95) == pytest.approx(125.0)
    # the rate is all the work over all the time: 12 batches in 2.0 s
    assert stalled.attempted == 12
    assert stalled.mp_s() == pytest.approx(12 * 24 / 1e6 / 2.0)


def test_p95_is_the_nearest_rank_over_all_batches():
    w = window.Window()
    w.times = [i / 1000 for i in range(1, 101)]  # 1 .. 100 ms
    assert w.batch_ms(0.95) == pytest.approx(95.0)
    assert w.batch_ms(0.5) == pytest.approx(50.0)
    w.times = [0.010] * 19 + [0.500]
    assert w.batch_ms(0.95) == pytest.approx(10.0)
    w.times = [0.010] * 18 + [0.500] * 2
    assert w.batch_ms(0.95) == pytest.approx(500.0)


def test_a_failed_batch_is_counted_and_timed(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(window.time, "perf_counter", clock)

    def send(i):
        clock.t += 0.25
        if i == 1:
            raise RuntimeError("planted")
        return np.zeros((1, 2, 2), np.int32)

    w = window.run(send, 1.0)
    assert (w.attempted, w.failed) == (4, 1)
    assert w.pixels == 3 * 4
