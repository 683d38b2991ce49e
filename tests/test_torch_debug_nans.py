"""PyTorch port, ``evaluate(debug_nans=True)`` (utils/debug.py): the
counterpart of the JAX package's ``jax_debug_nans``.

With the mode on, evaluate at config0 and config1 on two synthetic 64x96
items writes the same rows as with it off; a stage patched to make a NaN
raises FloatingPointError naming the aten operation (and a kernel's
outputs, checked through the helper every launch calls, name the kernel);
uninitialised allocations (``torch.empty`` and kin), their views and the
writes into them do not trip it; outside the mode nothing is checked."""

import json

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data.synthetic import synthetic_dataset
from gabor_color_image_segmentation_tpu_torch.eval import evaluate
from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gabor_color_image_segmentation_tpu_torch.utils.debug import (
    NanCheckMode,
    active_mode,
    check_kernel_outputs,
    debug_nans,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def items():
    return list(synthetic_dataset(2, h=64, w=96, seed=5))


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", ["config0", "config1"])
def test_rows_equal_with_the_mode_on(items, name, tmp_path):
    cfg = preset(name).replace(batch_size=2)
    off, on = tmp_path / "off.jsonl", tmp_path / "on.jsonl"
    s_off = evaluate(items, cfg, out_path=str(off), device="cpu")
    s_on = evaluate(items, cfg, out_path=str(on), debug_nans=True, device="cpu")
    assert s_on["n_failed"] == s_off["n_failed"] == 0
    assert _rows(on) == _rows(off)
    assert active_mode() is None  # the mode ends with the call


def test_a_nan_raises_naming_the_op(items, monkeypatch):
    cfg = preset("config0").replace(batch_size=2)

    def nan_lab(rgb):  # a colour stage that takes the square root of -1
        return torch.sqrt(-torch.ones_like(rgb))

    monkeypatch.setattr(pipeline, "rgb_to_lab", nan_lab)
    with pytest.raises(FloatingPointError, match=r"nan\) encountered in aten\.sqrt"):
        evaluate(items, cfg, debug_nans=True, device="cpu")


def test_kernel_outputs_are_checked_under_the_mode():
    bad = torch.tensor([1.0, float("nan")])
    check_kernel_outputs("gcis_table_lookup", [bad])  # outside the mode: nothing
    with debug_nans():
        check_kernel_outputs("gcis_table_lookup", [torch.ones(3), torch.zeros(2, dtype=torch.int32)])
        with pytest.raises(FloatingPointError, match="kernel gcis_em_pass"):
            check_kernel_outputs("gcis_em_pass", [bad])


def test_uninitialised_memory_does_not_trip_the_mode():
    with debug_nans():
        assert isinstance(active_mode(), NanCheckMode)
        buf = torch.empty(4096).fill_(float("nan"))  # what empty may hold
        view = buf.view(64, 64)
        like = torch.empty_like(view)
        strided = torch.empty_strided((8, 8), (1, 8))
        fresh = buf.new_empty(16)
        buf[:8] = torch.arange(8.0)  # a write into uninitialised memory
        total = torch.ones(3).sum() + like.shape[0] + strided.shape[0] + fresh.shape[0]
        assert float(total) == 3 + 64 + 8 + 16
        with pytest.raises(FloatingPointError, match="aten.mul"):
            view * 2.0  # a value made from it is checked
        # a kernel's outputs, once written and checked, leave the
        # uninitialised set: later writes into them are checked again
        out = torch.empty(4)
        check_kernel_outputs("gcis_lloyd_t", [out.zero_()])
        with pytest.raises(FloatingPointError, match="aten.div_"):
            out.div_(0.0)
    with debug_nans(False):
        assert active_mode() is None
        assert bool(torch.isnan(torch.zeros(1) / 0.0).all())
    assert np.isnan(float(torch.tensor(0.0) / 0.0))
