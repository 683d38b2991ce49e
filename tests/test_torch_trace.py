"""The port's spans and host syncs (utils/trace.py) on the CPU: with no
profiler recording nothing enters ``record_function``; under
``torch.profiler`` each route of ``segment_batch`` shows its stages as
``gcis.*`` ranges in the exported chrome trace, nested by time under one
``gcis.segment``, with every host read of a device value in a
``gcis.sync.*`` range, and the labels equal the untraced run's bit for
bit."""

import dataclasses
import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch, segment_images
from gabor_color_image_segmentation_tpu_torch.parallel.mesh import Mesh
from gabor_color_image_segmentation_tpu_torch.utils import trace

torch.set_num_threads(2)


def _config3(graph):
    cfg = preset("config3")
    return cfg.replace(batch_size=2, graph=dataclasses.replace(cfg.graph, **graph))


_NCUT = {"n_superpixels": 64, "n_regions": 4, "slic_compactness": 10.0,
         "affinity_sigma_scale": 1.0}
_MINCUT = {"n_superpixels": 64, "cut": "mincut", "mincut_k": 15.0, "mincut_min_size": 2}

# route: (configuration, frame (h, w), entry point, with_features, the direct
# children of gcis.segment in order, each child's own children in order)
ROUTES = {
    "kmeans_chw": (preset("config1").replace(batch_size=2), (64, 96), "batch", False,
                   ["features", "assemble", "assemble_xp", "coarse", "mid", "cluster"],
                   {"features": ["color"], "mid": ["sync.lloyd_fixed_point"] * 3,
                    "cluster": ["sync.lloyd_fixed_point"]}),
    "gmm": (preset("config2").replace(batch_size=2), (128, 128), "batch", False,
            ["features", "assemble", "assemble_xp", "cluster"],
            {"features": ["color"], "cluster": ["gmm_init", "em_fit", "em_refine"]}),
    "nhwc": (preset("config1").replace(batch_size=2), (64, 96), "batch", True,
             ["features", "assemble", "cluster"], {"features": ["color"]}),
    "ncut": (_config3(_NCUT), (96, 128), "batch", False,
             ["features", "assemble", "superpixels", "graph_cut"], {"features": ["color"]}),
    "mincut": (_config3(_MINCUT), (96, 128), "images", False,
               ["features", "assemble", "superpixels", "sync.mincut_download",
                "sync.mincut_download", "graph_cut", "sync.mincut_upload"],
               {"features": ["color"]}),
}


def _frames(hw):
    return np.stack([synthetic_mosaic(h=hw[0], w=hw[1], n_regions=5, seed=100 + i)[0]
                     for i in range(2)])


def _run(route):
    cfg, hw, entry, with_features, _, _ = ROUTES[route]
    x = _frames(hw)
    if entry == "images":
        return segment_images(x, cfg, device="cpu")
    return segment_batch(x, cfg, with_features=with_features, device="cpu")[0]


def _traced(fn, tmp_path):
    """(fn's result, the gcis.* ranges of the exported chrome trace sorted
    by start: [name without the prefix, start, end] in microseconds)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [[e["name"][len(trace.PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"])]
             for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(trace.PREFIX)]
    return out, sorted(spans, key=lambda s: (s[1], -s[2]))


def _children(spans):
    """{index of a span (-1: none): [indices of its direct children]}, by
    time containment."""
    kids, stack = {-1: []}, []
    for i, (_, s, e) in enumerate(spans):
        while stack and spans[stack[-1]][2] < e - 1e-3:
            stack.pop()
        kids.setdefault(stack[-1] if stack else -1, []).append(i)
        kids[i] = []
        stack.append(i)
    return kids


@pytest.mark.parametrize("route", list(ROUTES))
def test_no_profiler_enters_no_record_function(route, monkeypatch):
    entered = []
    real = profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(profiler.record_function, "__enter__", counting)
    assert not profiler._is_profiler_enabled
    _run(route)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _run(route)
    assert entered[0] == "gcis.segment"


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_spans_nest_in_order_and_leave_labels_bit_equal(route, tmp_path):
    *_, top, inner = ROUTES[route]
    plain = _run(route)
    traced, spans = _traced(lambda: _run(route), tmp_path)
    assert torch.equal(plain, traced)
    kids = _children(spans)
    assert [spans[i][0] for i in kids[-1]] == ["segment"]
    seg = kids[-1][0]
    assert [spans[i][0] for i in kids[seg]] == top
    for i in kids[seg]:
        name = spans[i][0]
        if route == "kmeans_chw" and name in ("mid", "cluster"):
            # the fixed point can stop a level early: at most its passes' tests
            got = [spans[j][0] for j in kids[i]]
            assert 1 <= len(got) <= len(inner[name]) and set(got) == {"sync.lloyd_fixed_point"}
        else:
            assert [spans[j][0] for j in kids[i]] == inner.get(name, []), name


def test_one_sync_span_per_fixed_point_test(monkeypatch, tmp_path):
    passes = []
    real = kmeans_chw.lloyd_chw_pass_plain

    def counting(xe, xc4, wc, offs, assign_only=False):
        passes.append(assign_only)
        return real(xe, xc4, wc, offs, assign_only)

    monkeypatch.setattr(kmeans_chw, "lloyd_chw_pass_plain", counting)
    _, spans = _traced(lambda: _run("kmeans_chw"), tmp_path)
    tests = passes.count(False)  # every pass with sums is followed by one test
    assert passes.count(True) == 1 and 2 <= tests <= 4
    assert [s[0] for s in spans].count("sync.lloyd_fixed_point") == tests
    assert [s[0] for s in spans].count("segment") == 1


def test_mesh_any_true_is_a_counted_sync_span(tmp_path):
    mesh = Mesh(["cpu"] * 2, ("space",))
    flags = [torch.tensor(False), torch.tensor(True)]
    assert mesh.any_true(flags, "space") is True
    got, spans = _traced(lambda: mesh.any_true(flags[:1] * 2, "space"), tmp_path)
    assert got is False and mesh.host_syncs == 2
    assert [s[0] for s in spans] == ["sync.mesh_any_true"]


@pytest.mark.parametrize("recording", [False, True])
def test_sync_makes_the_same_read_either_way(recording, tmp_path):
    t = torch.tensor([1.5, 2.5])
    if recording:
        got, spans = _traced(lambda: trace.sync("site", torch.Tensor.tolist, t), tmp_path)
        assert [s[0] for s in spans] == ["sync.site"]
    else:
        got = trace.sync("site", torch.Tensor.tolist, t)
    assert got == [1.5, 2.5]
