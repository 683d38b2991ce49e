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


# Configurations the pipeline once refused, each now run on the CPU against
# the JAX package: (config, with_features, frame (H, W)). The JAX side pins
# feature_impl="pallas" (its Pallas K1 in interpret mode, as the port's
# "auto" runs K1), but for the gamma != 1 bank (the direct convolutions on
# both sides) and the graph stage (its batch-1 modulated route on both).
UNSUPPORTED = {
    "with_features": (preset(PRESET), True, (32, 48)),
    # the graph stage with the coherence cue weights
    "graph": (preset("config3").replace(cluster=dataclasses.replace(
        preset("config3").cluster, cue_weight="coherence"), graph=dataclasses.replace(
        preset("config3").graph, n_superpixels=24, n_regions=4, slic_compactness=10.0,
        affinity_sigma_scale=1.0)), False, (32, 48)),
    # gmm's subsample > 1: the reference's NHWC gmm_predict
    "gmm": (preset("config2").replace(cluster=dataclasses.replace(
        preset("config2").cluster, subsample=2)), False, (32, 48)),
    # a frame larger than tile_hw: the NHWC clustering on the tiled energies
    "tiling": (preset(PRESET).replace(tile_hw=(16, 24)), False, (32, 48)),
    "feature_set": (preset(PRESET).replace(cluster=dataclasses.replace(
        preset(PRESET).cluster, feature_set="color")), False, (32, 48)),
    "subsample": (preset(PRESET).replace(cluster=dataclasses.replace(
        preset(PRESET).cluster, subsample=2)), False, (32, 48)),
    # 4,096 pixels: the port's transposed path with the strided seeding
    # (the JAX package off its TPU takes its NHWC path)
    "init_stride": (preset(PRESET).replace(cluster=dataclasses.replace(
        preset(PRESET).cluster, init_stride=2)), False, (64, 64)),
    "gamma": (preset(PRESET).replace(bank=dataclasses.replace(
        preset(PRESET).bank, gamma=0.5)), False, (32, 48)),
    # segment_batch refuses the host-side cut with ValueError, as the
    # reference does; segment_images runs it
    "mincut": (preset(PRESET).replace(graph=GraphConfig(enabled=True, n_superpixels=24,
                                                        cut="mincut", mincut_k=15.0,
                                                        mincut_min_size=2)), False, (32, 48)),
}


def _jax_twin(cfg):
    """The JAX package's config equal to the port's ``cfg``, its energies
    pinned as the UNSUPPORTED comment says."""
    from gabor_color_image_segmentation_tpu import config as jc

    impl = "pallas" if cfg.bank.gamma == 1.0 and not cfg.graph.enabled else cfg.feature_impl
    return jc.PipelineConfig(
        name=cfg.name, bank=jc.BankConfig(**dataclasses.asdict(cfg.bank)),
        cluster=jc.ClusterConfig(**dataclasses.asdict(cfg.cluster)),
        graph=jc.GraphConfig(**dataclasses.asdict(cfg.graph)), color_space=cfg.color_space,
        batch_size=cfg.batch_size, dtype=cfg.dtype, feature_impl=impl, tile_hw=cfg.tile_hw)


@pytest.mark.parametrize("case", sorted(UNSUPPORTED))
def test_unported_configs_raise(case):
    """Each configuration once raised NotImplementedError here (the test
    keeps its name); each now runs, labels agreeing with the JAX package's
    >= 0.999 after alignment (features, where asked, within 1e-4 of the
    reference's largest)."""
    from gabor_color_image_segmentation_tpu.models.pipeline import (
        segment_batch as jax_segment_batch,
    )
    from gabor_color_image_segmentation_tpu.models.pipeline import (
        segment_images as jax_segment_images,
    )

    cfg, with_features, (h, w) = UNSUPPORTED[case]
    rgb = synthetic_mosaic(h=h, w=w, n_regions=4, seed=115)[0][None]
    jcfg = _jax_twin(cfg)
    if case == "mincut":
        for call in (lambda: segment_batch(rgb, cfg, with_features=False, device="cpu"),
                     lambda: jax_segment_batch(rgb, jcfg, jax_make_bank(jcfg.bank), False)):
            with pytest.raises(ValueError, match="host-side"):
                call()
        got = segment_images(rgb, cfg, device="cpu").numpy()
        ref = np.asarray(jax_segment_images(rgb, jcfg, jax_make_bank(jcfg.bank)))
    else:
        labels, feats = segment_batch(rgb, cfg, with_features=with_features, device="cpu")
        ref, ref_f = jax_segment_batch(rgb, jcfg, jax_make_bank(jcfg.bank), with_features)
        got, ref = labels.numpy(), np.asarray(ref)
        assert (feats is None) == (not with_features)
        if with_features:
            ref_f = np.asarray(ref_f)
            assert tuple(feats.shape) == ref_f.shape
            assert np.abs(feats.numpy() - ref_f).max() <= 1e-4 * np.abs(ref_f).max()
    assert got.dtype == np.int32 and got.shape == (1, h, w)
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR["float32"], agree
