"""PyTorch port at config0's published frame: 321x481 mosaics (the bench's
generator, 5 regions, seeds 100 and 102) as a batch of 2, the preset as
published (float32, full-resolution maximin seeding and Lloyd passes, the
coherence^4 cue weights read from K1's twin), labels only:
``segment_batch(with_features=False)`` against the JAX package's
``_segment_batch_transposed`` with its Pallas kernels in interpret mode.

Bound after Hungarian alignment, the minimum over the batch: >= 0.999 (the
preset is float32). A file of its own: the JAX reference takes ~35 s on
the CPU."""

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

PRESET = "config0"
SEEDS = (100, 102)
FLOOR = 0.999


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


def test_published_frame():
    cfg = preset(PRESET)
    assert cfg.image_hw == (321, 481) and cfg.dtype == "float32"


def test_published_frame_matches_jax():
    batch = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=s)[0] for s in SEEDS])
    jcfg = jax_preset(PRESET).replace(batch_size=len(SEEDS))
    ref = np.asarray(jax_segment(batch, jcfg, jax_make_bank(jcfg.bank)))
    cfg = preset(PRESET).replace(batch_size=len(SEEDS))
    labels, _ = segment_batch(batch, cfg, with_features=False, device="cpu")
    got = labels.numpy()
    assert got.shape == batch.shape[:3] and got.min() >= 0 and got.max() < cfg.cluster.k
    agree = _agreement(got, ref)
    assert min(agree) >= FLOOR, agree
