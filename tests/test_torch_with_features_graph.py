"""PyTorch port, the with-features path through the graph stage (config3;
config4 tiled and pooled): ``segment_batch(with_features=True)`` returns
the region labels and the pooled grid's (B, H >> pool, W >> pool, D)
features, against the JAX package's ``segment_batch``.

Batch 2 of 64x96 mosaics (seeds 100+) with small-frame pins (48
superpixels, 4 regions, compactness 10, sigma scale 1; config4 with
``tile_hw`` (32, 48), so it runs four windows, and 24 superpixels on its
16x24 pooled grid). Both sides pin the modulated route
(``feature_impl="modulated"``, float32 energies and features, the
reference's graph route at batch 1 or in float32), which the JAX package
runs off its TPU; the port's own bf16 route (K1, bf16 features, the
reference's dtype on its accelerator) is held to the same references.
Bounds: labels after Hungarian alignment >= 0.999 (float32) / >= 0.99
(bfloat16, on images whose JAX bf16 and f32 labels agree >= 0.99 first);
features within 1e-4 (float32) / 2e-2 (bfloat16: the modulated route's
passes round their operands to bf16, K1 its energies; the bound of both)
of the reference's largest |feature|."""

import dataclasses

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
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch

torch.set_num_threads(2)

FLOOR = {"float32": 0.999, "bfloat16": 0.99}
PINS = {"config3": (dict(n_superpixels=48, n_regions=4, slic_compactness=10.0,
                         affinity_sigma_scale=1.0), None),
        "config4": (dict(n_superpixels=24, n_regions=4), (32, 48))}


def _pinned(cfg, name, dtype, impl):
    graph, tile = PINS[name]
    return cfg.replace(batch_size=2, dtype=dtype, feature_impl=impl, tile_hw=tile,
                       graph=dataclasses.replace(cfg.graph, **graph))


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


@pytest.fixture(scope="module")
def batch():
    return np.stack([synthetic_mosaic(h=64, w=96, n_regions=4, seed=100 + i)[0]
                     for i in range(2)])


@pytest.fixture(scope="module")
def reference(batch):
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            cfg = _pinned(jax_preset(name), name, dtype, "modulated")
            labels, feats = jax_segment_batch(batch, cfg, jax_make_bank(cfg.bank))
            cache[name, dtype] = np.asarray(labels), np.asarray(feats)
        return cache[name, dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["config3", "config4"])
def test_with_features_matches_jax(batch, reference, name, dtype):
    ref_l, ref_f = reference(name, dtype)
    if dtype == "bfloat16":
        stable = _agreement(ref_l, reference(name, "float32")[0])
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    pool = preset(name).graph.pool
    peak = np.abs(ref_f).max()
    bound = 1e-4 if dtype == "float32" else 2e-2
    routes = [("modulated", torch.float32)]
    if dtype == "bfloat16":
        routes.append(("auto", torch.bfloat16))  # K1, the port's bf16 graph route
    for impl, fdt in routes:
        cfg = _pinned(preset(name), name, dtype, impl)
        labels, feats = segment_batch(batch, cfg, device="cpu")
        assert labels.dtype == torch.int32 and tuple(labels.shape) == batch.shape[:3]
        assert tuple(feats.shape) == ref_f.shape == (2, 64 >> pool, 96 >> pool, 39)
        assert feats.dtype == fdt, impl
        err = np.abs(feats.to(torch.float32).numpy() - ref_f).max()
        assert err <= bound * peak, (impl, err / peak)
        agree = _agreement(labels.numpy(), ref_l)
        assert min(agree) >= FLOOR[dtype], (impl, agree)
