"""PyTorch port, the with-features path at config1 (the 80-kernel bank,
D = 243, and the multigrid schedule: ``kmeans_batch`` through the
transposed solver's pooled branch, seeds and 15 passes on the 4x4-pooled
buffer, 3 on the 2x2-pooled one, one at full resolution):
``segment_batch(with_features=True)`` against the JAX package's, its
energies pinned to K1 (interpret mode) and its XLA ``kmeans_multigrid``.
Same bounds as test_torch_with_features.py; a file of its own because the
JAX reference takes ~10 s per dtype on the CPU."""

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
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch

torch.set_num_threads(2)

FLOOR = {"float32": 0.999, "bfloat16": 0.99}
FEATURE_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


@pytest.fixture(scope="module")
def batch():
    return np.stack([synthetic_mosaic(h=64, w=96, n_regions=5, seed=100 + i)[0]
                     for i in range(2)])


@pytest.fixture(scope="module")
def reference(batch):
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cfg = jax_preset("config1").replace(batch_size=2, dtype=dtype,
                                                feature_impl="pallas")
            labels, feats = jax_segment_batch(batch, cfg, jax_make_bank(cfg.bank))
            cache[dtype] = np.asarray(labels), np.asarray(feats)
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_with_features_matches_jax(batch, reference, monkeypatch, dtype):
    ref_l, ref_f = reference(dtype)
    if dtype == "bfloat16":
        stable = _agreement(ref_l, reference("float32")[0])
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    passes = []
    real = kmeans_fused._pool_xt
    monkeypatch.setattr(kmeans_fused, "_pool_xt",
                        lambda *a: passes.append(a[0].shape[2]) or real(*a))
    labels, feats = segment_batch(batch, preset("config1").replace(batch_size=2, dtype=dtype),
                                  device="cpu")
    assert passes == [64 * 96, 32 * 48]  # the multigrid branch pooled twice
    assert feats.dtype == TORCH_DTYPE[dtype] and tuple(feats.shape) == ref_f.shape
    assert tuple(feats.shape) == (2, 64, 96, 243)
    err = np.abs(feats.to(torch.float32).numpy() - ref_f.astype(np.float32)).max()
    assert err <= FEATURE_BOUND[dtype] * np.abs(ref_f.astype(np.float32)).max(), err
    agree = _agreement(labels.numpy(), ref_l)
    assert min(agree) >= FLOOR[dtype], agree
