"""The plain references against the port's CPU path (its plain versions)
on small frames, and the control (stored tensors in float8) apart from
them."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gpubench import harness, judge, spec, traffic
from gpubench.reference import common
from gpubench.tests.conftest import REPO, TINY

CONFIGS = sorted(p.stem for p in (REPO / "gpubench/configs").glob("*.json"))


def _frames(seed, hw=(72, 96), n=2):
    mix = dict(json.loads((REPO / "gpubench/workloads/bsds-b16.json").read_text()), **TINY)
    mix.update(frame_hw=list(hw), pool=n, batch=n)
    return traffic.make_pool(seed, mix, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed,hw", [(3, (72, 96)), (2 ** 31 + 9, (96, 128))])
def test_reference_equals_the_port_cpu_path(name, seed, hw):
    from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

    cfg_json = json.loads((REPO / f"gpubench/configs/{name}.json").read_text())
    cfg = harness.pipeline_config(cfg_json)
    rgb = _frames(seed, hw)
    got = segment_images(rgb, cfg, make_bank(cfg.bank), device="cpu").numpy()
    ref = spec.reference(REPO, name)
    want = ref.segment(torch.from_numpy(rgb), cfg_json, common.Storage("bfloat16")).numpy()
    numbers = judge.numbers([judge.compare(got, want, cfg.cluster.k)])
    assert numbers == {"worst_image_mismatch": 0.0, "median_image_mismatch": 0.0,
                       "mean_mismatch": 0.0, "labels_outside_k": 0}
    assert np.array_equal(got, want)


def test_storage_rounding():
    x = torch.tensor([[1.0 + 2 ** -10, 300.0, -1e-3]])
    assert torch.equal(common.Storage("bfloat16")(x), x.to(torch.bfloat16).float())
    fp8 = common.Storage("fp8")(x)
    # one scale for the row: 300 is the largest, 448 its code
    assert fp8[0, 1].item() == pytest.approx(300.0)
    assert fp8[0, 0].item() != x[0, 0].item()
    assert abs(fp8[0, 0].item() - 1.0) < 0.07
    with pytest.raises(ValueError):
        common.Storage("int4")


def test_judge_matches_ids_before_counting():
    a = np.array([[[0, 0, 1, 1], [2, 2, 1, 1]]])
    b = np.array([[[3, 3, 0, 0], [1, 1, 0, 0]]])  # the same partition, other ids
    assert judge.compare(a, b, 5)["per_image"] == [0.0]
    c = b.copy()
    c[0, 0, 0] = 0
    assert judge.compare(a, c, 5)["per_image"] == [pytest.approx(1 / 8)]
    assert judge.compare(a + 4, b, 5)["labels_outside_k"] == 6  # ids 5 and 6
    got = judge.numbers([judge.compare(a, c, 5), judge.compare(a, b, 5),
                         judge.absent(np.zeros((1, 2, 4)))])
    assert got == {"worst_image_mismatch": 1.0, "median_image_mismatch": pytest.approx(1 / 8),
                   "mean_mismatch": pytest.approx((1 / 8 + 1) / 3), "labels_outside_k": 8}
    ok, checks = judge.verdict({"worst_image_mismatch": 0.1, "mean_mismatch": 0.0,
                                "labels_outside_k": 0},
                               {"worst_image_mismatch": 0.05, "mean_mismatch": 0.01,
                                "labels_outside_k": 0})
    assert not ok and checks["worst_image_mismatch"] == {"value": 0.1, "limit": 0.05}
