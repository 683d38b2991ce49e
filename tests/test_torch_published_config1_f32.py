"""PyTorch port at config1's published frame, in float32: batch 2 of
321x481 mosaics (the bench's generator, 5 regions, seeds 100 and 102), the
preset as published (the 80-kernel bank, the coarse warm start on the 4x4
grid, mid passes on K1's 2x2 twin, one full-resolution pass), labels only:
``segment_batch(with_features=False)`` against the JAX package's
transposed path, ``_segment_batch_transposed``, with its Pallas kernels in
interpret mode.

Bound after Hungarian alignment, the minimum over the batch: >= 0.999. A
file per dtype (test_torch_published_config1_bf16.py is the other): the
JAX reference takes ~30-40 s per dtype on the CPU."""

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
FLOOR = 0.999


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


def test_published_frame_matches_jax():
    batch = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=s)[0] for s in SEEDS])
    jcfg = jax_preset(PRESET).replace(batch_size=len(SEEDS), dtype="float32")
    ref = np.asarray(jax_segment(batch, jcfg, jax_make_bank(jcfg.bank)))
    cfg = preset(PRESET).replace(batch_size=len(SEEDS), dtype="float32")
    labels, _ = segment_batch(batch, cfg, with_features=False, device="cpu")
    got = labels.numpy()
    assert got.shape == batch.shape[:3] and got.min() >= 0 and got.max() < cfg.cluster.k
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR, agree
