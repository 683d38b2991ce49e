"""The readers of the EM loop's spans (``gmm_init_ms``, ``em_fit_ms``,
``em_refine_ms``, ``em_launches_per_batch``) on a synthetic chrome trace:
device time charged to the EM span that launched it, launches counted by
where their runtime call starts, and nothing read from a trace without EM
spans, without spans at all or without device events."""

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


def _launch(api, ts, start, dur):
    """A runtime call at ``ts`` and the kernel it enqueued."""
    c = next(_corr)
    return [_ev("cuda_runtime", api, ts, 2.0, c), _ev("kernel", "k(float*)", start, dur, c)]


def _events():
    """Two batches in a window of 1000 us; each runs its cluster stage as
    the three EM spans, times in us."""
    ev = [_ev("user_annotation", trace.WINDOW, 1000.0, 1000.0),
          _ev("user_annotation", trace.BATCH, 1000.0, 500.0),
          _ev("user_annotation", trace.BATCH, 1500.0, 500.0)]
    for t0 in (1000.0, 1500.0):
        ev += [_span("segment", t0, 480.0), _span("features", t0, 100.0),
               _span("cluster", t0 + 100.0, 380.0), _span("gmm_init", t0 + 100.0, 50.0),
               _span("em_fit", t0 + 150.0, 200.0), _span("em_refine", t0 + 350.0, 130.0)]
        ev += _launch("cudaLaunchKernel", t0 + 10.0, t0 + 20.0, 70.0)  # features
        # launched in gmm_init, run after it ends: still the init's
        ev += _launch("cudaLaunchKernel", t0 + 140.0, t0 + 160.0, 30.0)
        ev += _launch("cudaLaunchKernelExC", t0 + 160.0, t0 + 200.0, 40.0)  # em_fit
        ev += _launch("cuLaunchKernel", t0 + 170.0, t0 + 250.0, 50.0)  # em_fit
        ev += _launch("cudaLaunchKernel", t0 + 360.0, t0 + 370.0, 90.0)  # em_refine
        # a runtime call that launches nothing, inside em_fit
        ev.append(_ev("cuda_runtime", "cudaMemsetAsync", t0 + 300.0, 1.0))
    return ev


def _read(name, events):
    tr = None if events is None else trace.Trace(events)
    return spec.metric_reader(REPO, name).read(types.SimpleNamespace(trace=tr))


def test_em_stages_are_charged_what_they_launched():
    ev = _events()
    assert _read("gmm_init_ms", ev) == pytest.approx(30e-3)
    assert _read("em_fit_ms", ev) == pytest.approx((40 + 50) * 1e-3)
    assert _read("em_refine_ms", ev) == pytest.approx(90e-3)


def test_em_launches_counted_a_batch_where_the_call_starts():
    # four launch calls a batch start inside the EM spans; the features'
    # launch and the memset do not count
    assert _read("em_launches_per_batch", _events()) == pytest.approx(4.0)


def test_em_launches_leave_out_a_call_that_starts_before_the_spans():
    ev = _events()
    ev += _launch("cudaLaunchKernel", 1095.0, 1110.0, 5.0)  # in cluster, before gmm_init
    assert _read("em_launches_per_batch", ev) == pytest.approx(4.0)
    ev += _launch("cudaLaunchKernel", 1145.0, 1150.0, 5.0)  # inside gmm_init
    assert _read("em_launches_per_batch", ev) == pytest.approx(4.5)


@pytest.mark.parametrize("name", ["gmm_init_ms", "em_fit_ms", "em_refine_ms",
                                  "em_launches_per_batch"])
def test_nothing_read_without_em_spans(name):
    ev = _events()
    em = {spans.PREFIX + n for n in ("gmm_init", "em_fit", "em_refine")}
    # a program whose cluster stage has no EM spans (an older one, or k-means)
    assert _read(name, [e for e in ev if e["name"] not in em]) is None
    assert _read(name, [e for e in ev if not e["name"].startswith(spans.PREFIX)]) is None
    assert _read(name, [e for e in ev if e["cat"] not in trace.DEVICE_CATS]) is None
    assert _read(name, None) is None
