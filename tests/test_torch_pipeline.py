"""PyTorch port, whole slice: ``segment_batch(with_features=False)`` against
the JAX package's ``_segment_batch_transposed`` for config0 (its Pallas
kernels in interpret mode on the CPU), plus the entry points' contract: the
card by default, ``device="cpu"`` for the CPU.

Bounds after Hungarian alignment: >= 0.999 in float32 and >= 0.99 in
bfloat16 (tests/test_pipeline_configs.py's floor for this path). The bf16
bound presumes an image whose reference labels are themselves stable under
bf16: the test first checks that the JAX package's own bf16 and f32 labels
agree >= 0.99 on it. (On borderline mosaics they do not, e.g. 0.92, and
no bf16 implementation can be held closer than that.) config1 is in
test_torch_pipeline_config1.py and config2 in test_torch_pipeline_config2.py,
so the slow cases spread over workers."""

import dataclasses

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import GraphConfig, preset
from gabor_color_image_segmentation_tpu.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu.models.pipeline import (
    _segment_batch_transposed as jax_segment,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.models.pipeline import (
    segment_batch,
    segment_images,
)
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

torch.set_num_threads(2)

PRESET = "config0"
FLOOR = {"float32": 0.999, "bfloat16": 0.99}


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


@pytest.fixture(scope="module")
def batch():
    """64x96 mosaics from the bench's generator (5 regions, seeds 100+)."""
    return np.stack([synthetic_mosaic(h=64, w=96, n_regions=5, seed=100 + i)[0]
                     for i in range(2)])


@pytest.fixture(scope="module")
def reference(batch):
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cfg = preset(PRESET).replace(batch_size=2, dtype=dtype)
            cache[dtype] = np.asarray(jax_segment(batch, cfg, jax_make_bank(cfg.bank)))
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_matches_jax(batch, reference, dtype):
    cfg = preset(PRESET).replace(batch_size=2, dtype=dtype)
    ref = reference(dtype)
    if dtype == "bfloat16":
        stable = _agreement(ref, reference("float32"))
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    labels, feats = segment_batch(torch.from_numpy(batch), cfg, with_features=False,
                                  device="cpu")
    assert feats is None
    assert labels.dtype == torch.int32 and tuple(labels.shape) == batch.shape[:3]
    got = labels.numpy()
    assert got.min() >= 0 and got.max() < cfg.cluster.k
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR[dtype], agree


def test_bank_forms_and_entry_points_agree(batch):
    """The port's own bank, the JAX bank and segment_images give the same
    labels; float input in [0, 1] equals uint8 input; a tile_hw the frame
    fits in changes nothing (the reference's transposed path ignores it)."""
    cfg = preset(PRESET).replace(batch_size=2)
    x = torch.from_numpy(batch)
    labels_only = {"with_features": False, "device": "cpu"}
    own, _ = segment_batch(x, cfg, **labels_only)
    jb, _ = segment_batch(x, cfg, jax_make_bank(cfg.bank), **labels_only)
    assert torch.equal(own, jb)
    assert torch.equal(segment_images(x, cfg, make_bank(cfg.bank), device="cpu"), own)
    as_float, _ = segment_batch(x.to(torch.float32) / 255.0, cfg, **labels_only)
    assert torch.equal(as_float, own)
    from_numpy, _ = segment_batch(batch, cfg, **labels_only)
    assert torch.equal(from_numpy, own)
    fits, _ = segment_batch(x, cfg.replace(tile_hw=(64, 96)), **labels_only)
    assert torch.equal(fits, own)


def test_entry_points_default_to_the_card(batch):
    """device=None means the card: with none present both entry points
    raise and name device="cpu"; nothing moves to the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = preset(PRESET).replace(batch_size=2)
    for call in (lambda: segment_batch(batch, cfg), lambda: segment_images(batch, cfg)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_constant_image_gives_valid_labels():
    # 64x64: a frame inside the reference's pixel range of the clustering
    cfg = preset(PRESET).replace(batch_size=1)
    labels, _ = segment_batch(torch.full((1, 64, 64, 3), 128, dtype=torch.uint8), cfg,
                              with_features=False, device="cpu")
    assert labels.min() >= 0 and labels.max() < cfg.cluster.k


UNSUPPORTED = {
    "with_features": (preset(PRESET), True),
    # the graph stage with the coherence cue weights (the NHWC path);
    # config3's and config4's static weights are ported
    "graph": (preset("config3").replace(cluster=dataclasses.replace(
        preset("config3").cluster, cue_weight="coherence")), False),
    # gmm's subsample > 1 is the reference's NHWC gmm_predict
    "gmm": (preset("config2").replace(cluster=dataclasses.replace(
        preset("config2").cluster, subsample=2)), False),
    # a tiled frame takes the reference's NHWC clustering path; config4's
    # tiled graph path is ported
    "tiling": (preset(PRESET).replace(tile_hw=(8, 8)), False),
    "feature_set": (preset(PRESET).replace(cluster=dataclasses.replace(
        preset(PRESET).cluster, feature_set="color")), False),
    "subsample": (preset(PRESET).replace(cluster=dataclasses.replace(
        preset(PRESET).cluster, subsample=2)), False),
    "init_stride": (preset(PRESET).replace(cluster=dataclasses.replace(
        preset(PRESET).cluster, init_stride=2)), False),
    "gamma": (preset(PRESET).replace(bank=dataclasses.replace(
        preset(PRESET).bank, gamma=0.5)), False),
    "mincut": (preset(PRESET).replace(graph=GraphConfig(enabled=True, cut="mincut")),
               False),
}


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unported_configs_raise(case):
    cfg, with_features = UNSUPPORTED[case]
    x = torch.zeros((1, 16, 16, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        segment_batch(x, cfg, with_features=with_features, device="cpu")
