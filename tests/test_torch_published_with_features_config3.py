"""PyTorch port at config3's published frame with features, the default
path (tests/published_with_features.py): batch 2 of 321x481 mosaics,
seeds 100 and 101, in both dtypes. The graph stage's features against the
JAX package's ``segment_batch`` on the route each side takes (float32:
the modulated route, ``feature_impl="auto"`` on both sides; bfloat16: K1,
the reference's pinned to its Pallas kernel in interpret mode), and the
port's with-features labels bit-equal to its own labels-only labels. The
labels against the reference stay with test_torch_published_config3.py,
which hands the graph stage the reference's energies: the n-cut's labels
turn on tiny eigengaps (ROADMAP "Not faults").

The float32 bound is 3e-4 of the reference's largest |feature|, not K1's
1e-4. experiments/torch_modulated_f64.py evaluates the modulated route's
arithmetic in float64 on these frames: the port's float32 features lie
1.418e-4 of the peak from it, the reference's 1.427e-4 (1.433e-4 with
the same float32 Lab; seeds 100 and 101), and the reference under jit
parts from itself run op by op by 1.526e-4, as much as from the port
(1.532e-4). The float32 energies of both sit ~2.1e-3 of a channel's
standard deviation from float64, which the standardisation carries into
the features; the float64 energies rounded to float32 give features
within 1.6e-6. Two float32 evaluations each within 1.5e-4 of the exact
value part by at most 3e-4. On seeds 102 and 103 the port lies 1.640e-4
from float64 and the reference 2.148e-4 (the port the nearer). bfloat16
keeps 2e-2. A file of its own: the
reference's graph path takes ~15 s a dtype on the CPU."""

import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.ops import modulated
from published_with_features import check_features, mosaics, port, reference

torch.set_num_threads(2)

PRESET, SEEDS = "config3", (100, 101)
# the reference's route in each dtype, and the float32 bound derived above
REF_IMPL = {"float32": "auto", "bfloat16": "pallas"}
FEATURE_BOUND = {"float32": 3e-4, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def batch():
    return mosaics(SEEDS)


@pytest.fixture(scope="module")
def runs(batch):
    """dtype -> (the reference's features, the port's labels and features
    with features, its labels only, the modulated route's calls)."""
    cache = {}

    def get(dtype):
        if dtype not in cache:
            _, ref_f = reference(PRESET, batch, dtype, REF_IMPL[dtype])
            modulated.gabor_energies_mod.calls = 0
            labels, feats = port(PRESET, batch, dtype)
            calls = modulated.gabor_energies_mod.calls
            only, _ = port(PRESET, batch, dtype, with_features=False)
            cache[dtype] = ref_f, labels, feats, only, calls
        return cache[dtype]

    return get


def test_published_frame():
    cfg = preset(PRESET)
    assert cfg.image_hw == (321, 481) and cfg.graph.enabled and cfg.graph.pool == 0
    assert cfg.feature_impl == "auto" and cfg.dtype == "float32"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_published_features_match_jax(runs, dtype):
    ref_f, _, feats, _, calls = runs(dtype)
    # float32 takes the modulated route, bf16 batches K1
    assert calls == (1 if dtype == "float32" else 0)
    assert tuple(feats.shape) == (2, 321, 481, 39)
    check_features(feats, ref_f, dtype, FEATURE_BOUND[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_with_features_labels_are_the_labels_only_labels(runs, dtype):
    _, labels, _, only, _ = runs(dtype)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (2, 321, 481)
    assert torch.equal(labels, only)
    assert labels.min() >= 0 and labels.max() < preset(PRESET).graph.n_regions
