"""PyTorch port, the with-features path (the reference's default):
``segment_batch(with_features=True)`` at config0 and config2 against the
JAX package's ``segment_batch``, and ``segment_image``.

Batch 2 of 64x96 mosaics (seeds 100+, N = 6,144): the port takes the
card's route on the CPU (config0: ``kmeans_batch`` through the transposed
solver, K6 and K5's plain versions; config2: ``gmm_fused_t``, K6, K5, K9,
K8's plain versions); the JAX package off its TPU takes its XLA solvers,
its energies pinned to K1 (``feature_impl="pallas"``, interpret mode).
Bounds: labels after Hungarian alignment >= 0.999 (float32) / >= 0.99
(bfloat16, on images whose JAX bf16 and f32 labels agree >= 0.99 first);
features of the reference's shape and dtype within 1e-4 (float32) /
2e-2 (bfloat16) of its largest |feature| (K1's bounds: the two K1s'
energies differ in their last bits)."""

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models.pipeline import (
    segment_batch as jax_segment_batch,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused, pipeline
from gabor_color_image_segmentation_tpu_torch.models.pipeline import (
    segment_batch,
    segment_image,
)

torch.set_num_threads(2)

FLOOR = {"float32": 0.999, "bfloat16": 0.99}
FEATURE_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# the fused solver each preset's path must reach on the port
SOLVER = {"config0": (kmeans_fused, "kmeans_fused_t"), "config2": (pipeline, "gmm_fused_t")}


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


@pytest.fixture(scope="module")
def batch():
    return np.stack([synthetic_mosaic(h=64, w=96, n_regions=5, seed=100 + i)[0]
                     for i in range(2)])


@pytest.fixture(scope="module")
def reference(batch):
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            cfg = jax_preset(name).replace(batch_size=2, dtype=dtype, feature_impl="pallas")
            labels, feats = jax_segment_batch(batch, cfg, jax_make_bank(cfg.bank))
            cache[name, dtype] = np.asarray(labels), np.asarray(feats)
        return cache[name, dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["config0", "config2"])
def test_with_features_matches_jax(batch, reference, monkeypatch, name, dtype):
    ref_l, ref_f = reference(name, dtype)
    if dtype == "bfloat16":
        stable = _agreement(ref_l, reference(name, "float32")[0])
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    calls = []
    mod, attr = SOLVER[name]
    real = getattr(mod, attr)
    monkeypatch.setattr(mod, attr, lambda *a, **kw: calls.append(attr) or real(*a, **kw))
    cfg = preset(name).replace(batch_size=2, dtype=dtype)
    labels, feats = segment_batch(batch, cfg, device="cpu")
    assert calls == [attr]
    assert labels.dtype == torch.int32 and tuple(labels.shape) == batch.shape[:3]
    assert feats.dtype == TORCH_DTYPE[dtype] and tuple(feats.shape) == ref_f.shape
    err = np.abs(feats.to(torch.float32).numpy() - ref_f.astype(np.float32)).max()
    assert err <= FEATURE_BOUND[dtype] * np.abs(ref_f.astype(np.float32)).max(), err
    agree = _agreement(labels.numpy(), ref_l)
    assert min(agree) >= FLOOR[dtype], agree


def test_segment_image_is_row_0_of_segment_batch(batch):
    cfg = preset("config0").replace(batch_size=2)
    labels, feats = segment_batch(batch, cfg, device="cpu")
    one = preset("config0")
    l0, f0 = segment_image(batch[0], one, device="cpu")
    assert torch.equal(l0, segment_batch(batch[:1], one, device="cpu")[0][0])
    assert tuple(l0.shape) == (64, 96) and tuple(f0.shape) == (64, 96, 39)
    assert torch.equal(f0, feats[0])
    # the features are standardised per image, so row 0 of the batch of two
    # is row 0 alone; the k-means of one image does not read the other
    assert torch.equal(l0, labels[0])


def test_labels_only_and_with_features_share_the_nhwc_route(batch):
    """Off the transposed path (here a tiled frame), with_features only adds
    the features: the labels are the same bits."""
    cfg = preset("config0").replace(batch_size=2, tile_hw=(32, 48))
    assert not pipeline._can_segment_transposed(cfg, 64, 96)
    with_f, feats = segment_batch(batch, cfg, device="cpu")
    without, none = segment_batch(batch, cfg, with_features=False, device="cpu")
    assert none is None and torch.equal(with_f, without)
    assert tuple(feats.shape) == (2, 64, 96, 39)
