"""PyTorch port at config3's published frame with the min-cut graph stage
(``graph.cut="mincut"``): batch 2 of 321x481 mosaics, seeds 100 and 101,
both dtypes, through ``segment_images`` (the entry point that runs the
host-side greedy merge; port ``models/pipeline.py::segment_images``, the
reference's ``segment_images``) against the JAX package's, its energies
pinned to K1 (interpret mode), the port's route for the min-cut. Bounds:
labels after Hungarian alignment >= 0.999 (float32) / >= 0.99 (bfloat16,
on images whose reference bf16 and f32 labels agree >= 0.99). A file of
its own: the reference takes ~25 s a dtype on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models.pipeline import (
    segment_images as jax_segment_images,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images
from published_with_features import check_labels, jax_config, mosaics

torch.set_num_threads(2)

PRESET, SEEDS = "config3", (100, 101)


def _mincut(cfg):
    return cfg.replace(graph=dataclasses.replace(cfg.graph, cut="mincut"))


@pytest.fixture(scope="module")
def batch():
    return mosaics(SEEDS)


@pytest.fixture(scope="module")
def ref(batch):
    """dtype -> the reference's min-cut labels."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            cfg = _mincut(jax_config(PRESET, batch, dtype))
            cache[dtype] = np.asarray(jax_segment_images(batch, cfg, jax_make_bank(cfg.bank)))
        return cache[dtype]

    return get


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_published_mincut_matches_jax(batch, ref, dtype):
    cfg = _mincut(preset(PRESET)).replace(batch_size=len(SEEDS), dtype=dtype)
    labels = segment_images(batch, cfg, device="cpu")
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (2, 321, 481)
    check_labels(labels, ref(dtype), dtype,
                 ref_f32=ref("float32") if dtype == "bfloat16" else None)
