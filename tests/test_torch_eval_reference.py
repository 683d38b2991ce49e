"""PyTorch port, ``evaluate`` and ``evaluate_sweep`` against the JAX
package's on the same split (config0 f32, two 96x128 synthetic images).

The two packages' labels agree on every pixel after alignment there (the
check comes first), and every metric is invariant to a permutation of the
label ids, so the summaries' means agree to 1e-9 and the sweep's ODS/OIS
are equal."""

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.eval import evaluate as jax_evaluate
from gabor_color_image_segmentation_tpu.eval import evaluate_sweep as jax_evaluate_sweep
from gabor_color_image_segmentation_tpu.eval import load_split as jax_load_split
from gabor_color_image_segmentation_tpu.models.pipeline import (
    segment_images as jax_segment_images,
)
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.eval import evaluate, evaluate_sweep, load_split
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images
from gabor_color_image_segmentation_tpu_torch.utils.labels import agreement_rate, align_labels

torch.set_num_threads(2)

MEANS = ("mean_pri", "mean_voi", "mean_covering", "mean_f_boundary")


@pytest.fixture(scope="module")
def split():
    data = load_split("test", limit=2, image_hw=(96, 128))
    ref = jax_load_split("test", limit=2, image_hw=(96, 128))
    for (i, rgb, gts), (ri, rrgb, rgts) in zip(data, ref):
        assert i == ri
        np.testing.assert_array_equal(rgb, rrgb)
        for g, r in zip(gts, rgts):
            np.testing.assert_array_equal(g, r)
    return data


def test_evaluate_summary_equals_reference(split):
    cfg = preset("config0").replace(batch_size=2)
    rgbs = np.stack([d[1] for d in split])
    ours = segment_images(rgbs, cfg, device="cpu").numpy()
    theirs = np.asarray(jax_segment_images(rgbs, jax_preset("config0").replace(batch_size=2)))
    for a, b in zip(ours, theirs):
        assert agreement_rate(align_labels(a, b), b) == 1.0
    got = evaluate(split, cfg, device="cpu")
    ref = jax_evaluate(split, jax_preset("config0").replace(batch_size=2))
    assert got["n_images"] == ref["n_images"] == 2
    assert got["n_failed"] == ref["n_failed"] == 0
    for key in MEANS:
        assert abs(got[key] - ref[key]) <= 1e-9, key


def test_evaluate_sweep_equals_reference(split, tmp_path):
    cfg = preset("config0").replace(batch_size=2)
    got = evaluate_sweep(split, cfg, [3, 4], out_path=str(tmp_path / "ours"), device="cpu")
    ref = jax_evaluate_sweep(split, jax_preset("config0").replace(batch_size=2), [3, 4],
                             out_path=str(tmp_path / "theirs"))
    assert got["ks"] == ref["ks"] == [3, 4] and got["n_images"] == ref["n_images"]
    for metric in ("pri", "f_boundary", "voi", "covering"):
        g, r = got[metric], ref[metric]
        assert g["ods_k"] == r["ods_k"], metric
        assert abs(g["ods"] - r["ods"]) <= 1e-9 and abs(g["ois"] - r["ois"]) <= 1e-9, metric
        assert g["per_k"].keys() == r["per_k"].keys()
        for k in g["per_k"]:
            assert abs(g["per_k"][k] - r["per_k"][k]) <= 1e-9, (metric, k)
