"""The GMM solver's stage spans on the CPU: under ``torch.profiler`` a small
config2 call opens ``gcis.gmm_init``, ``gcis.em_fit`` and ``gcis.em_refine``
once each, in that order, inside ``gcis.cluster``, and with ``_FUSED_PREP``
on as off; with no profiler recording nothing enters ``record_function``
and the labels are the traced call's bit for bit."""

import json

import numpy as np
import pytest
import torch
from torch.autograd import profiler
from torch.profiler import ProfilerActivity, profile

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import gmm_fused
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images
from gabor_color_image_segmentation_tpu_torch.utils import trace

torch.set_num_threads(2)

EM = ["gmm_init", "em_fit", "em_refine"]


def _frames(hw=(72, 96)):
    return np.stack([synthetic_mosaic(h=hw[0], w=hw[1], n_regions=5, seed=300 + i)[0]
                     for i in range(2)])


def _segment(hw=(72, 96)):
    return segment_images(_frames(hw), preset("config2").replace(batch_size=2), device="cpu")


def _spans(fn, tmp_path):
    """(fn's result, [name without the prefix, start, end] of every gcis.*
    range of the exported chrome trace, by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    got = [[e["name"][len(trace.PREFIX):], float(e["ts"]), float(e["ts"]) + float(e["dur"])]
           for e in events
           if e.get("cat") == "user_annotation" and e["name"].startswith(trace.PREFIX)]
    return out, sorted(got, key=lambda s: (s[1], -s[2]))


@pytest.mark.parametrize("fused_prep", [False, True])
@pytest.mark.parametrize("hw", [(72, 96), (128, 160)])  # fit on x, and on the pooled grid
def test_em_spans_open_once_each_in_order_inside_cluster(fused_prep, hw, monkeypatch,
                                                         tmp_path):
    monkeypatch.setattr(gmm_fused, "_FUSED_PREP", fused_prep)
    plain = _segment(hw)
    traced, spans = _spans(lambda: _segment(hw), tmp_path)
    assert torch.equal(plain, traced)
    em = [s for s in spans if s[0] in EM]
    assert [s[0] for s in em] == EM
    (cluster,) = [s for s in spans if s[0] == "cluster"]
    for _, s, e in em:
        assert cluster[1] <= s and e <= cluster[2]
    for (_, _, e0), (_, s1, _) in zip(em, em[1:]):
        assert e0 <= s1  # one after the other, none inside another
    # no host sync inside the solver: the GMM route's only sync is the upload,
    # which the CPU route does not make
    assert not [s for s in spans if s[0].startswith("sync.")]


def test_no_profiler_records_no_em_range(monkeypatch):
    entered = []
    real = profiler.record_function.__enter__

    def counting(self):
        entered.append(self.name)
        return real(self)

    monkeypatch.setattr(profiler.record_function, "__enter__", counting)
    assert not profiler._is_profiler_enabled
    labels = _segment()
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        traced = _segment()
    assert [n for n in entered if n[len(trace.PREFIX):] in EM] == ["gcis." + n for n in EM]
    assert torch.equal(labels, traced)
