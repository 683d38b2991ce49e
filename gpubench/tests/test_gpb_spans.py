"""The readers of the program's spans (gpubench/spans.py and the six
metric files that use it) on a synthetic chrome trace: device time
charged to the span that launched it, gaps that begin inside a sync span,
host time outside the syncs, the syncs counted, and nothing read from a
trace without spans or without device events."""

from __future__ import annotations

import types

import pytest

from gpubench import spans, spec, trace
from gpubench.tests.conftest import REPO

_corr = iter(range(1, 1000))


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _span(name, ts, dur):
    return _ev("user_annotation", "gcis." + name, ts, dur)


def _launch(api, ts, cat, name, start, dur):
    """A runtime call at ``ts`` and the device event it enqueued."""
    c = next(_corr)
    return [_ev("cuda_runtime", api, ts, 2.0, c), _ev(cat, name, start, dur, c)]


def _kernel(ts, start, dur):
    return _launch("cudaLaunchKernel", ts, "kernel", "k(float*)", start, dur)


def _copy(ts, kind, start, dur):
    return _launch("cudaMemcpyAsync", ts, "gpu_memcpy", f"Memcpy {kind}", start, dur)


def _events():
    """Two batches in a window of 1000 us; device busy and idle as the
    comments say (times in us)."""
    ev = [_ev("user_annotation", trace.WINDOW, 1000.0, 1000.0),
          _ev("user_annotation", trace.BATCH, 1000.0, 500.0),
          _ev("user_annotation", trace.BATCH, 1500.0, 500.0),
          # batch A
          _span("segment", 1000.0, 480.0),
          _span("features", 1000.0, 100.0), _span("color", 1000.0, 20.0),
          _span("assemble", 1100.0, 40.0), _span("assemble_xp", 1140.0, 10.0),
          _span("coarse", 1150.0, 50.0),
          _span("mid", 1200.0, 100.0), _span("sync.lloyd_fixed_point", 1260.0, 40.0),
          _span("cluster", 1300.0, 180.0), _span("sync.lloyd_fixed_point", 1400.0, 20.0),
          _ev("cuda_runtime", "cudaStreamSynchronize", 1266.0, 33.0),
          # batch B
          _span("segment", 1500.0, 400.0), _span("sync.upload", 1500.0, 60.0),
          _span("features", 1560.0, 140.0), _span("cluster", 1700.0, 200.0)]
    # launched inside gcis.color, run after it ends: still the colour's
    ev += _kernel(1005.0, 1030.0, 30.0)
    ev += _kernel(1050.0, 1060.0, 90.0)  # features, outside color
    ev += _kernel(1110.0, 1150.0, 20.0)  # assemble
    ev += _kernel(1145.0, 1170.0, 10.0)  # assemble_xp
    ev += _kernel(1160.0, 1180.0, 60.0)  # coarse
    ev += _kernel(1210.0, 1240.0, 15.0)  # mid
    # the fixed-point read: the gap 1265-1310 begins inside the sync span
    ev += _copy(1262.0, "DtoH (Device -> Pageable)", 1262.0, 3.0)
    ev += _kernel(1305.0, 1310.0, 85.0)  # cluster; the gap 1395-1401 begins before the sync
    ev += _copy(1401.0, "DtoH (Device -> Pageable)", 1401.0, 2.0)  # gap 1403-1425: in the sync
    ev += _kernel(1421.0, 1425.0, 45.0)  # cluster; the gap 1470-1505 begins outside a sync
    ev += _copy(1505.0, "HtoD (Pageable -> Device)", 1505.0, 45.0)  # upload; gap 1550-1600
    ev += _kernel(1580.0, 1600.0, 90.0)  # features
    ev += _kernel(1710.0, 1720.0, 80.0)  # cluster
    return ev


def _read(name, events):
    ctx = types.SimpleNamespace(trace=trace.Trace(events))
    return spec.metric_reader(REPO, name).read(ctx)


def test_device_time_is_charged_to_the_span_that_launched_it():
    ev = _events()
    assert _read("color_ms", ev) == pytest.approx(30e-3 / 2)
    assert _read("assemble_ms", ev) == pytest.approx((20 + 10) * 1e-3 / 2)
    # coarse 60; mid 15 + the read's 3; cluster 85 + 2 + 45 and 80
    assert _read("cluster_ms", ev) == pytest.approx((60 + 18 + 132 + 80) * 1e-3 / 2)
    assert spans.launched_ms(trace.Trace(ev), ("superpixels",)) is None


def test_idle_gaps_that_begin_inside_a_sync_span():
    # 1265-1310, 1403-1425 and 1550-1600; not 1395-1401, 1470-1505 nor the
    # window's edges
    assert _read("sync_idle_ms", _events()) == pytest.approx((45 + 22 + 50) * 1e-3 / 2)


def test_host_enqueue_leaves_out_the_nested_sync_spans():
    assert _read("host_enqueue_ms", _events()) == pytest.approx(
        ((480 + 400) - (40 + 20 + 60)) * 1e-3 / 2)


def test_syncs_counted_a_batch():
    assert _read("host_syncs_per_batch", _events()) == pytest.approx(1.5)


@pytest.mark.parametrize("name", ["host_syncs_per_batch", "sync_idle_ms", "host_enqueue_ms",
                                  "color_ms", "assemble_ms", "cluster_ms"])
def test_nothing_read_without_spans_or_without_device_events(name):
    ev = _events()
    without_spans = [e for e in ev if not e["name"].startswith(spans.PREFIX)]
    assert _read(name, without_spans) is None
    without_device = [e for e in ev if e["cat"] not in trace.DEVICE_CATS]
    assert _read(name, without_device) is None
    assert spec.metric_reader(REPO, name).read(types.SimpleNamespace(trace=None)) is None
