"""PyTorch port, whole slice at config4 (tiled features pooled per window,
SLIC, connectivity and n-cut on the pooled grid; labels only):
``segment_batch(with_features=False)`` against the JAX package's
``segment_batch``, and the pooled min-cut route of ``segment_images``
against the JAX package's, on the CPU.

The config4 preset pinned to a toy geometry: batch 2 of 96x128 mosaics
(tests/test_pipeline_configs.py's fixture), tile_hw (48, 64) (2 x 2
windows), pool 2 (the graph runs on 24x32), 24 superpixels and 4 regions
(the preset's 400 and 5 are sized for the pooled 4K grid). Bounds after
Hungarian alignment: >= 0.999 in float32 and >= 0.99 in bfloat16, on
images whose JAX bf16 and f32 labels themselves agree >= 0.99."""

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
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import connectivity, pipeline, slic_fused
from gabor_color_image_segmentation_tpu_torch.models.pipeline import (
    segment_batch,
    segment_images,
)
from gabor_color_image_segmentation_tpu_torch.ops import lookup

torch.set_num_threads(2)

FLOOR = {"float32": 0.999, "bfloat16": 0.99}


def _pinned(cfg, dtype, **graph):
    g = dict(n_superpixels=24, n_regions=4, **graph)
    return cfg.replace(batch_size=2, dtype=dtype, tile_hw=(48, 64),
                       graph=dataclasses.replace(cfg.graph, **g))


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
            cfg = _pinned(jax_preset("config4"), dtype)
            labels, _ = jax_segment_batch(batch, cfg, jax_make_bank(cfg.bank), False)
            cache[dtype] = np.asarray(labels)
        return cache[dtype]

    return get


def test_preset_pins():
    """What the toy geometry cuts: the published preset runs batch 8 of 4K
    frames in 432x768 tiles, 400 superpixels and 5 regions on the pooled
    540x960 grid."""
    cfg = preset("config4")
    assert (cfg.batch_size, cfg.image_hw, cfg.tile_hw) == (8, (2160, 3840), (432, 768))
    g = cfg.graph
    assert (g.pool, g.n_superpixels, g.n_regions, g.cut) == (2, 400, 5, "ncut")
    assert slic_fused.slic_route(540, 960, g.n_superpixels) == "banded"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_matches_jax(batch, reference, dtype):
    cfg = _pinned(preset("config4"), dtype)
    ref = reference(dtype)
    if dtype == "bfloat16":
        stable = _agreement(ref, reference("float32"))
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    labels, feats = segment_batch(batch, cfg, with_features=False, device="cpu")
    assert feats is None and labels.device.type == "cpu"
    assert labels.dtype == torch.int32 and tuple(labels.shape) == batch.shape[:3]
    got = labels.numpy()
    assert got.min() >= 0 and got.max() < cfg.graph.n_regions
    # constant on each 4x4 block of the pooled grid
    assert np.array_equal(got, np.repeat(np.repeat(got[:, ::4, ::4], 4, 1), 4, 2))
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR[dtype], agree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mincut_route_matches_jax(batch, dtype):
    mincut = dict(cut="mincut", mincut_k=15.0, mincut_min_size=2)
    ref = np.asarray(jax_segment_images(batch, _pinned(jax_preset("config4"), dtype,
                                                       **mincut)))
    got = segment_images(batch, _pinned(preset("config4"), dtype, **mincut), device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == batch.shape[:3]
    agree = _agreement(got.numpy(), ref)
    assert min(agree) >= FLOOR[dtype], agree


def test_pooled_path_runs_every_stage(batch, monkeypatch):
    """K1 once per window (2 x 2 windows; bf16 at batch 2 keeps the
    reference's K1 route, and the pipeline hands the tiling its energies
    function), the banded SLIC pass (forced:
    the port's whole-image gate at 0 sends the 24x32 grid to K13's loop, 5
    passes of 4 iterations and the last assignment), connectivity and the
    lookup once."""
    calls = []
    for mod, name in ((pipeline, "gabor_energies_fused"),
                      (slic_fused, "slic_band_pass_plain"),
                      (slic_fused, "slic_plain"),
                      (connectivity, "enforce_connectivity_plain"),
                      (lookup, "table_lookup_plain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    monkeypatch.setattr(slic_fused, "_SLIC_FUSE_BYTES", 0)
    cfg = _pinned(preset("config4"), "bfloat16", slic_iters=4)
    assert slic_fused.slic_route(24, 32, 24) == "banded"
    segment_batch(batch, cfg, with_features=False, device="cpu")
    assert calls == (["gabor_energies_fused"] * 4 + ["slic_band_pass_plain"] * 5
                     + ["enforce_connectivity_plain", "table_lookup_plain"])


def test_pool_needs_divisible_frame(batch):
    cfg = _pinned(preset("config4"), "float32")
    jcfg = _pinned(jax_preset("config4"), "float32")
    odd = batch[:, :94]
    with pytest.raises(ValueError, match="divisible by 4"):
        jax_segment_batch(odd, jcfg, jax_make_bank(jcfg.bank), False)
    with pytest.raises(ValueError, match="divisible by 4"):
        segment_batch(odd, cfg, with_features=False, device="cpu")
