"""PyTorch port, the evaluation harness (``eval.py``) and the CLI on the CPU.

``evaluate`` (``device="cpu"``, config0 f32 on two 96x128 synthetic images)
writes one row per image whose metrics equal the JAX package's host metrics
applied to the port's labels; ``resume`` skips the ids already written;
``profile_dir`` writes a torch.profiler trace; ``debug_nans`` runs and
finds no NaN. The
CLI's ``info`` JSON equals the JAX package's for every preset; ``run``
writes its overlay PNG; ``run`` and ``eval`` default to the card
(``bench`` in tests/test_torch_benchmark.py). (The JAX
package's ``evaluate`` itself runs in tests/test_torch_eval_reference.py.)"""

import json
import os

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.cli import main as jax_cli_main
from gabor_color_image_segmentation_tpu.config import PRESETS as JAX_PRESETS
from gabor_color_image_segmentation_tpu.metrics.boundary import fboundary_np as jax_fb
from gabor_color_image_segmentation_tpu.metrics.pri import pri_np as jax_pri
from gabor_color_image_segmentation_tpu.metrics.region import (
    mean_covering_np as jax_cov,
    mean_voi_np as jax_voi,
)
from gabor_color_image_segmentation_tpu_torch.cli import main as cli_main
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.eval import (
    _batches,
    _done_ids,
    evaluate,
    load_split,
)
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images
from gabor_color_image_segmentation_tpu_torch.utils.visualize import plot_metrics

torch.set_num_threads(2)

CFG = preset("config0").replace(batch_size=2)


@pytest.fixture(scope="module")
def split():
    data = load_split("val", limit=3, image_hw=(96, 128))
    assert [d[0] for d in data] == ["synth0000", "synth0001", "synth0002"]
    return data


def test_evaluate_rows_are_the_reference_metrics(split, tmp_path):
    out = str(tmp_path / "rows.jsonl")
    summary = evaluate(split[:2], CFG, out_path=out, device="cpu")
    assert summary["n_images"] == 2 and summary["n_failed"] == 0
    rows = [json.loads(line) for line in open(out)]
    labels = segment_images(np.stack([d[1] for d in split[:2]]), CFG, device="cpu").numpy()
    for row, (image_id, _, gts), lab in zip(rows, split, labels):
        p, r, f = jax_fb(lab, gts)
        assert row == {"id": image_id, "pri": jax_pri(lab, gts), "precision": p, "recall": r,
                       "f_boundary": f, "voi": jax_voi(lab, gts),
                       "covering": jax_cov(lab, gts), "n_regions": int(len(np.unique(lab)))}
    for key, metric in (("mean_pri", "pri"), ("mean_f_boundary", "f_boundary"),
                        ("mean_voi", "voi"), ("mean_covering", "covering")):
        assert summary[key] == float(np.mean([row[metric] for row in rows]))
    assert summary["config"] == "config0" and summary["mp_per_s"] > 0


def test_evaluate_resume_skips_done_ids(split, tmp_path):
    out = str(tmp_path / "r.jsonl")
    assert evaluate(split[:1], CFG, out_path=out, resume=True, device="cpu")["n_images"] == 1
    assert _done_ids(out) == {"synth0000"}
    s2 = evaluate(split[:2], CFG, out_path=out, resume=True, device="cpu")
    assert s2["n_images"] == 1
    assert [json.loads(line)["id"] for line in open(out)] == ["synth0000", "synth0001"]
    assert evaluate(split[:2], CFG, out_path=out, resume=True, device="cpu")["n_images"] == 0
    assert [len(b) for b in _batches(list(range(5)), 2)] == [2, 2, 1]


def test_evaluate_isolates_a_failed_image(split):
    """An image whose ground truth cannot be scored yields a row with its
    error; the rest of the batch is scored."""
    bad = [(split[0][0], split[0][1], [np.zeros((3, 3), np.int32)]), split[1]]
    summary = evaluate(bad, CFG, device="cpu")
    assert summary["n_images"] == 2 and summary["n_failed"] == 1
    assert summary["mean_pri"] is not None


def test_evaluate_profile_and_debug_nans(split, tmp_path, capsys):
    prof = tmp_path / "prof"
    plain = evaluate(split[:1], CFG, profile_dir=str(prof), device="cpu")
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    # debug_nans checks every operation for NaN (tests/test_torch_debug_nans.py)
    # and finds none: the same metrics
    checked = evaluate(split[:1], CFG, debug_nans=True, device="cpu")
    for key in ("n_images", "n_failed", "mean_pri", "mean_f_boundary", "mean_voi",
                "mean_covering"):
        assert checked[key] == plain[key], key
    capsys.readouterr()
    cli_main(["eval", "--device", "cpu", "--limit", "1", "--debug-nans"])
    assert json.loads(capsys.readouterr().out)["n_failed"] == 0


def test_evaluate_and_cli_default_to_the_card(split):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        evaluate(split[:1], CFG)
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        cli_main(["run", "--preset", "config0"])


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_cli_info_equals_reference(name, capsys):
    cli_main(["info", "--preset", name])
    got = json.loads(capsys.readouterr().out)
    jax_cli_main(["info", "--preset", name])
    assert got == json.loads(capsys.readouterr().out)


def test_cli_run_writes_png(capsys, tmp_path):
    out_png = str(tmp_path / "seg.png")
    cli_main(["run", "--preset", "config0", "--device", "cpu", "--out", out_png])
    out = json.loads(capsys.readouterr().out)
    assert out == {"shape": [321, 481], "n_regions": 5, "preset": "config0"}
    assert os.path.getsize(out_png) > 1000


def test_plot_metrics(tmp_path):
    p = tmp_path / "rows.jsonl"
    with open(p, "w") as f:
        for i in range(10):
            f.write(json.dumps({"pri": 0.7 + 0.01 * i, "f_boundary": 0.5}) + "\n")
    out = tmp_path / "hist.png"
    plot_metrics(str(p), str(out))
    assert os.path.getsize(out) > 1000
