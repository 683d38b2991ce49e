"""PyTorch port at config0's published frame with features, the default
path (tests/published_with_features.py): batch 2 of 321x481 mosaics,
seeds 100 and 101, float32 as published, ``segment_batch`` against the JAX
package's (K1 pinned, interpret mode; its XLA k-means off the TPU; the
port's transposed solver, K6 and K5's plain versions, through
``kmeans_batch``); and ``segment_image`` on seed 100 against the
reference's ``segment_image``. Bounds: labels >= 0.999, features within
1e-4 of the reference's peak. A file of its own: the reference takes
~15 s on the CPU."""

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models.pipeline import (
    segment_image as jax_segment_image,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_image
from published_with_features import (
    check_features,
    check_labels,
    jax_config,
    mosaics,
    port,
    reference,
)

torch.set_num_threads(2)

PRESET, DTYPE, SEEDS = "config0", "float32", (100, 101)


@pytest.fixture(scope="module")
def batch():
    return mosaics(SEEDS)


@pytest.fixture(scope="module")
def ref(batch):
    return reference(PRESET, batch, DTYPE)


@pytest.fixture(scope="module")
def got(batch):
    """The port's (labels, features, solver calls): the with-features path
    must reach the transposed solver once."""
    calls = []
    real = kmeans_fused.kmeans_fused_t
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kmeans_fused, "kmeans_fused_t",
                   lambda *a, **kw: calls.append(1) or real(*a, **kw))
        labels, feats = port(PRESET, batch, DTYPE)
    return labels, feats, len(calls)


def test_published_frame():
    cfg = preset(PRESET)
    assert cfg.image_hw == (321, 481) and cfg.dtype == DTYPE and cfg.feature_impl == "auto"


def test_with_features_route(got):
    labels, feats, calls = got
    assert calls == 1
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (2, 321, 481)
    assert tuple(feats.shape) == (2, 321, 481, 39)


def test_published_features_match_jax(got, ref):
    check_features(got[1], ref[1], DTYPE)


def test_published_labels_match_jax(got, ref):
    check_labels(got[0], ref[0], DTYPE, k=preset(PRESET).cluster.k)


def test_segment_image_matches_jax(batch):
    jcfg = jax_config(PRESET, batch[:1], DTYPE)
    ref_l, ref_f = jax_segment_image(batch[0], jcfg, jax_make_bank(jcfg.bank))
    labels, feats = segment_image(batch[0], preset(PRESET), device="cpu")
    assert tuple(labels.shape) == (321, 481) and tuple(feats.shape) == (321, 481, 39)
    check_features(feats[None], np.asarray(ref_f, np.float32)[None], DTYPE)
    check_labels(labels[None], np.asarray(ref_l)[None], DTYPE)
