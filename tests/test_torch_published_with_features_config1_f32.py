"""PyTorch port at config1's published frame with features, float32, the
default path (tests/published_with_features.py): batch 2 of 321x481
mosaics, seeds 100 and 102 (seed 102 is where the reference's own
labels-only transposed path and its with-features NHWC path part,
0.818699; this path is the NHWC one, which the port's with-features path
follows), ``segment_batch`` against the JAX package's (K1 pinned,
interpret mode; the port's transposed multigrid solver through
``kmeans_batch``). Bounds: labels >= 0.999, features within 1e-4 of the
reference's peak. A file per dtype: the reference takes ~20 s a dtype on
the CPU."""

import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused
from published_with_features import check_features, check_labels, mosaics, port, reference

torch.set_num_threads(2)

PRESET, DTYPE, SEEDS = "config1", "float32", (100, 102)


@pytest.fixture(scope="module")
def batch():
    return mosaics(SEEDS)


@pytest.fixture(scope="module")
def ref(batch):
    return reference(PRESET, batch, DTYPE)


@pytest.fixture(scope="module")
def got(batch):
    """The port's (labels, features, solver calls)."""
    calls = []
    real = kmeans_fused.kmeans_fused_t
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kmeans_fused, "kmeans_fused_t",
                   lambda *a, **kw: calls.append(1) or real(*a, **kw))
        labels, feats = port(PRESET, batch, DTYPE)
    return labels, feats, len(calls)


def test_with_features_route(got):
    labels, feats, calls = got
    assert calls == 1 and preset(PRESET).cluster.coarse_iters > 0
    assert labels.dtype == torch.int32 and tuple(feats.shape) == (2, 321, 481, 243)


def test_published_features_match_jax(got, ref):
    check_features(got[1], ref[1], DTYPE)


def test_published_labels_match_jax(got, ref):
    check_labels(got[0], ref[0], DTYPE, k=preset(PRESET).cluster.k)
