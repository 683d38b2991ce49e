"""PyTorch port, whole slice at config1 (the multigrid schedule: coarse
warm start K3 on the 4x4 grid, mid passes K2 on the 2x2 twin, one
full-resolution pass): ``segment_batch(with_features=False)`` against the
JAX package's ``_segment_batch_transposed`` with its Pallas kernels in
interpret mode. Same bounds and bf16 precondition as
test_torch_pipeline.py; a file of its own because the JAX reference takes
~20 s per case on the CPU."""

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset
from gabor_color_image_segmentation_tpu.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu.models.pipeline import (
    _segment_batch_transposed as jax_segment,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw, kmeans_fused
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch

torch.set_num_threads(2)

PRESET = "config1"
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
    labels, _ = segment_batch(torch.from_numpy(batch), cfg, with_features=False, device="cpu")
    assert labels.dtype == torch.int32 and tuple(labels.shape) == batch.shape[:3]
    agree = _agreement(labels.numpy(), ref)
    assert min(agree) >= FLOOR[dtype], agree


def test_multigrid_path_runs_coarse_and_mid_stages(batch, monkeypatch):
    """config1 reaches the coarse warm start and the centre-only mid passes;
    config0 seeds with the full-resolution maximin instead."""
    calls = []
    for mod, name in ((kmeans_fused, "kmeans_coarse_centers_xp_plain"),
                      (kmeans_chw, "maximin_chw_pass_plain"),
                      (kmeans_chw, "lloyd_chw_pass_plain")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    x = torch.from_numpy(batch)
    segment_batch(x, preset(PRESET).replace(batch_size=2), with_features=False, device="cpu")
    assert calls.count("kmeans_coarse_centers_xp_plain") == 1
    assert "maximin_chw_pass_plain" not in calls
    c = preset(PRESET).cluster
    # mid passes (<= mid_iters) + at most refine_iters + the assign-only pass
    assert 2 <= calls.count("lloyd_chw_pass_plain") <= c.mid_iters + c.refine_iters + 1
    calls.clear()
    segment_batch(x, preset("config0").replace(batch_size=2), with_features=False, device="cpu")
    assert calls.count("maximin_chw_pass_plain") == preset("config0").cluster.k
    assert "kmeans_coarse_centers_xp_plain" not in calls
