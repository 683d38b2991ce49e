"""PyTorch port, whole slice at config3 (SLIC superpixels, connectivity,
spectral n-cut; labels only): ``segment_batch(with_features=False)`` against
the JAX package's ``segment_batch``, and the min-cut route of
``segment_images`` against the JAX package's, on the CPU.

Batch 2 of 96x128 mosaics (tests/test_pipeline_configs.py's fixture) with
that test's pins for this toy geometry: 64 superpixels, compactness 10,
4 regions, sigma scale 1 (the production preset is tuned for 321x481).
Bounds after Hungarian alignment: >= 0.999 in float32 and >= 0.99 in
bfloat16, on images whose JAX bf16 and f32 labels themselves agree >= 0.99.
The JAX reference takes ~5-10 s per call on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models.pipeline import (
    segment_batch as jax_segment_batch,
)
from gabor_color_image_segmentation_tpu.models.pipeline import (
    segment_images as jax_segment_images,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import GraphConfig, preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import (
    connectivity,
    pipeline,
    slic_fused,
)
from gabor_color_image_segmentation_tpu_torch.models.pipeline import (
    segment_batch,
    segment_images,
)
from gabor_color_image_segmentation_tpu_torch.ops import lookup

torch.set_num_threads(2)

FLOOR = {"float32": 0.999, "bfloat16": 0.99}
MINCUT = GraphConfig(enabled=True, n_superpixels=64, cut="mincut", mincut_k=15.0,
                     mincut_min_size=2)


def _pinned(cfg, dtype):
    return cfg.replace(batch_size=2, dtype=dtype, graph=dataclasses.replace(
        cfg.graph, n_superpixels=64, n_regions=4, slic_compactness=10.0,
        affinity_sigma_scale=1.0))


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


@pytest.fixture(scope="module")
def batch():
    return np.stack([synthetic_mosaic(h=96, w=128, n_regions=4, seed=20 + i)[0]
                     for i in range(2)])


@pytest.fixture(scope="module")
def reference(batch):
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cfg = _pinned(jax_preset("config3"), dtype)
            labels, _ = jax_segment_batch(batch, cfg, jax_make_bank(cfg.bank), False)
            cache[dtype] = np.asarray(labels)
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_matches_jax(batch, reference, dtype):
    cfg = _pinned(preset("config3"), dtype)
    ref = reference(dtype)
    if dtype == "bfloat16":
        stable = _agreement(ref, reference("float32"))
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    labels, feats = segment_batch(batch, cfg, with_features=False, device="cpu")
    assert feats is None and labels.device.type == "cpu"
    assert labels.dtype == torch.int32 and tuple(labels.shape) == batch.shape[:3]
    got = labels.numpy()
    assert got.min() >= 0 and got.max() < cfg.graph.n_regions
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR[dtype], agree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mincut_route_matches_jax(batch, dtype):
    ref = np.asarray(jax_segment_images(
        batch, jax_preset("config3").replace(batch_size=2, dtype=dtype, graph=MINCUT)))
    cfg = preset("config3").replace(batch_size=2, dtype=dtype, graph=MINCUT)
    got = segment_images(batch, cfg, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == batch.shape[:3]
    agree = _agreement(got.numpy(), ref)
    assert min(agree) >= FLOOR[dtype], agree


def test_graph_path_runs_every_stage(batch, monkeypatch):
    """The n-cut path runs K1, SLIC, connectivity and the lookup once per
    batch (their plain versions on the CPU), and the min-cut route SLIC and
    connectivity; segment_batch refuses the host-side min-cut."""
    calls = []
    for mod, name in ((pipeline, "gabor_energies_fused"), (slic_fused, "slic_plain"),
                      (connectivity, "enforce_connectivity_plain"),
                      (lookup, "table_lookup_plain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    segment_batch(batch, _pinned(preset("config3"), "bfloat16"), with_features=False, device="cpu")
    assert calls == ["gabor_energies_fused", "slic_plain", "enforce_connectivity_plain",
                     "table_lookup_plain"]
    calls.clear()
    cfg = preset("config3").replace(batch_size=2, graph=MINCUT)
    segment_images(batch, cfg, device="cpu")
    assert calls == ["gabor_energies_fused", "slic_plain", "enforce_connectivity_plain"]
    with pytest.raises(ValueError, match="segment_images"):
        segment_batch(batch, cfg, with_features=False, device="cpu")


def test_production_preset_matches_jax():
    """The config3 preset itself (900 superpixels, compactness 5, 8
    regions, sigma scale 0.1: S > 512, so the affinity's median takes the
    strided subsample) on a 64x96 batch, in float32."""
    rgb = np.stack([synthetic_mosaic(h=64, w=96, n_regions=5, seed=100 + i)[0]
                    for i in range(2)])
    jcfg = jax_preset("config3").replace(batch_size=2)
    ref = np.asarray(jax_segment_batch(rgb, jcfg, jax_make_bank(jcfg.bank), False)[0])
    cfg = preset("config3").replace(batch_size=2)
    got = segment_batch(rgb, cfg, with_features=False, device="cpu")[0].numpy()
    assert got.min() >= 0 and got.max() < cfg.graph.n_regions
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR["float32"], agree
