"""PyTorch port at config4's published geometry, the graph stage on seed
101's 2160x3840 frame: test_torch_published_config4_graph.py's checks
(the pooled Lab, SLIC, connectivity, the features, the degenerate
affinity and spectrum of both packages, the n-cut as a reading, the
lookup and the unpooling), a file of its own so --dist loadfile runs the
two frames on two workers (~55 s alone)."""

import pytest
from test_torch_published_config4_graph import (
    DTYPES,
    check_affinity,
    check_features,
    check_lab_and_superpixels,
    check_ncut,
)

SEED = 101


def test_pooled_lab_and_superpixels_match_jax_seed_101():
    check_lab_and_superpixels(SEED)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_features_match_jax_seed_101(dtype):
    check_features(SEED, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_affinity_is_degenerate_in_both_packages_seed_101(dtype):
    check_affinity(SEED, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ncut_lookup_and_unpooling_seed_101(dtype):
    check_ncut(SEED, dtype)
