"""PyTorch port at config1's published frame, in bfloat16: batch 2 of
321x481 mosaics (the bench's generator, 5 regions, seeds 100 and 102), the
preset as published (the 80-kernel bank, the coarse warm start on the 4x4
grid, mid passes on K1's 2x2 twin, one full-resolution pass), labels only:
``segment_batch(with_features=False)`` against the JAX package's
transposed path, ``_segment_batch_transposed``, with its Pallas kernels in
interpret mode. The reference's NHWC with-features path parts from its
own transposed path on seed 102 (0.818699), so the port is held to the
path it runs.

Bound after Hungarian alignment, the minimum over the batch: >= 0.99, on
images whose JAX bf16 and f32 labels themselves agree >= 0.99. A file per
dtype (test_torch_published_config1_f32.py is the other): the JAX
reference takes ~30-40 s per dtype on the CPU, and this one runs it in
both."""

import numpy as np
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models.pipeline import (
    _segment_batch_transposed as jax_segment,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch

torch.set_num_threads(2)

PRESET = "config1"
SEEDS = (100, 102)
FLOOR = 0.99


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


def _reference(batch, dtype):
    cfg = jax_preset(PRESET).replace(batch_size=len(SEEDS), dtype=dtype)
    return np.asarray(jax_segment(batch, cfg, jax_make_bank(cfg.bank)))


def test_published_frame():
    cfg = preset(PRESET)
    assert cfg.image_hw == (321, 481) and cfg.bank.n_kernels == 80
    assert cfg.cluster.coarse_iters > 0 and cfg.cluster.coarse_levels == 2


def test_published_frame_matches_jax():
    batch = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=s)[0] for s in SEEDS])
    ref = _reference(batch, "bfloat16")
    stable = _agreement(ref, _reference(batch, "float32"))
    assert min(stable) >= FLOOR, f"borderline test image: {stable}"
    cfg = preset(PRESET).replace(batch_size=len(SEEDS), dtype="bfloat16")
    labels, _ = segment_batch(batch, cfg, with_features=False, device="cpu")
    got = labels.numpy()
    assert got.shape == batch.shape[:3] and got.min() >= 0 and got.max() < cfg.cluster.k
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR, agree
