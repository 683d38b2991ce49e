"""PyTorch port, whole slice at config2 (per-image GMM, labels only):
``segment_batch(with_features=False)`` against the JAX package's
``_segment_batch_transposed`` with its Pallas kernels in interpret mode.

Batch 2 of 160x224 mosaics: large enough for ``gmm_fit_levels`` to take one
pooling level (80x112 = 8960 fit pixels), so the pooled fit buffer, the EM
loop with its tol freeze, the full-resolution refine pass and the
labels-only pass all run at the preset's own n_iter (30). Bounds after
Hungarian alignment: >= 0.999 in float32 and >= 0.99 in bfloat16, on an
image whose JAX bf16 and f32 labels themselves agree >= 0.99 (see
test_torch_pipeline.py). A file of its own because the JAX reference takes
~10-20 s per dtype on the CPU.

Also config2 with a 16-kernel bank (4 scales x 4 orientations, D = 51
feature rows, past the 40 the card's first EM kernel holds in registers)
on 96x128 mosaics, at the same bounds."""

import dataclasses

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models.pipeline import (
    _segment_batch_transposed as jax_segment,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import gmm_fused, kmeans_fused
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch

torch.set_num_threads(2)

FLOOR = {"float32": 0.999, "bfloat16": 0.99}


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


@pytest.fixture(scope="module")
def batch():
    """160x224 mosaics from the bench's generator (5 regions, seeds 100+)."""
    return np.stack([synthetic_mosaic(h=160, w=224, n_regions=5, seed=100 + i)[0]
                     for i in range(2)])


@pytest.fixture(scope="module")
def reference(batch):
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cfg = jax_preset("config2").replace(batch_size=2, dtype=dtype)
            cache[dtype] = np.asarray(jax_segment(batch, cfg, jax_make_bank(cfg.bank)))
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slice_matches_jax(batch, reference, dtype):
    cfg = preset("config2").replace(batch_size=2, dtype=dtype)
    ref = reference(dtype)
    if dtype == "bfloat16":
        stable = _agreement(ref, reference("float32"))
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    labels, feats = segment_batch(batch, cfg, with_features=False, device="cpu")
    assert feats is None and labels.device.type == "cpu"
    assert labels.dtype == torch.int32 and tuple(labels.shape) == batch.shape[:3]
    got = labels.numpy()
    assert got.min() >= 0 and got.max() < cfg.cluster.k
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR[dtype], agree


def test_gmm_path_runs_every_stage(batch, monkeypatch):
    """The gmm branch runs the k-means init on the pooled fit grid (5
    maximin steps, 10 + 1 Lloyd passes), 30 EM passes on it, the refine
    pass and the labels-only pass at full resolution."""
    calls = []
    for mod, name in ((kmeans_fused, "maximin_t_pass_plain"),
                      (kmeans_fused, "lloyd_t_pass_plain"),
                      (gmm_fused, "em_pass_plain")):
        real = getattr(mod, name)

        def spy(x, *args, _real=real, _name=name):
            # em_pass hands em_pass_plain (x, pt, bias, const, moments)
            calls.append((_name, x.shape[2], args[3] if len(args) == 4 else True))
            return _real(x, *args)

        monkeypatch.setattr(mod, name, spy)
    segment_batch(batch, preset("config2").replace(batch_size=2), with_features=False,
                  device="cpu")
    m, n = 80 * 112, 160 * 224
    assert calls.count(("maximin_t_pass_plain", m, True)) == 5
    assert calls.count(("lloyd_t_pass_plain", m, True)) == 11
    assert calls.count(("em_pass_plain", m, True)) == 30
    assert calls.count(("em_pass_plain", n, True)) == 1
    assert calls.count(("em_pass_plain", n, False)) == 1
    assert len(calls) == 48


SIXTEEN = (2.0, 3.0, 4.0, 8.0)  # scales of a 16-kernel bank (4 orientations)


def _sixteen(cfg):
    return cfg.replace(bank=dataclasses.replace(cfg.bank, scales=SIXTEEN))


@pytest.fixture(scope="module")
def batch16():
    return np.stack([synthetic_mosaic(h=96, w=128, n_regions=5, seed=100 + i)[0]
                     for i in range(2)])


@pytest.fixture(scope="module")
def reference16(batch16):
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cfg = _sixteen(jax_preset("config2").replace(batch_size=2, dtype=dtype))
            cache[dtype] = np.asarray(jax_segment(batch16, cfg, jax_make_bank(cfg.bank)))
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sixteen_kernel_bank_matches_jax(batch16, reference16, dtype):
    cfg = _sixteen(preset("config2").replace(batch_size=2, dtype=dtype))
    assert cfg.bank.n_kernels == 16
    ref = reference16(dtype)
    if dtype == "bfloat16":
        stable = _agreement(ref, reference16("float32"))
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    labels, _ = segment_batch(batch16, cfg, with_features=False, device="cpu")
    got = labels.numpy()
    assert got.min() >= 0 and got.max() < cfg.cluster.k
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR[dtype], agree
