"""PyTorch port: the NHWC feature assembly (``ops/features.py::
assemble_features``, ``coherence_weights``, ``gabor_features``) against
the JAX package's, on the same energies (the direct energies of a
synthetic mosaic's Lab, seed 102), over every ``feature_set`` and both
``cue_weight`` rules.

Tolerances: float32 max abs error <= 1e-4; bfloat16 |d| <= 2^-7 *
max(1, |ref|) elementwise (one bf16 rounding of the output: the moments
and the standardisation are float32 on both sides, the energies the same
bf16 values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import ClusterConfig as JaxClusterConfig
from gabor_color_image_segmentation_tpu.ops import features as jfeat
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu_torch.config import ClusterConfig, preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.ops import features as tfeat
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
FEATURE_SETS = ("full", "color", "texture")
CUES = ("static", "coherence")


@pytest.fixture(scope="module")
def inputs():
    """(energies (2, 48, 72, 36) float32 NHWC, Lab (2, 48, 72, 3))."""
    rgb = np.stack([synthetic_mosaic(h=48, w=72, n_regions=4, seed=102 + i)[0]
                    for i in range(2)])
    lab = rgb_to_lab(torch.from_numpy(rgb).to(torch.float32) / 255.0)
    energies = tfeat.gabor_energies(lab, make_bank(preset("config0").bank))
    return energies.numpy().copy(), lab.numpy()


def _within(got, ref, dtype):
    err = np.abs(got - ref)
    if dtype == "float32":
        return err.max() <= 1e-4, err.max()
    rel = (err / np.maximum(1.0, np.abs(ref))).max()
    return rel <= 2.0**-7, rel


@pytest.mark.parametrize("cue", CUES)
@pytest.mark.parametrize("feature_set", FEATURE_SETS)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_assemble_features_matches_jax(inputs, dtype, feature_set, cue):
    jdt, tdt = DTYPES[dtype]
    energies, lab = inputs
    fields = dict(feature_set=feature_set, cue_weight=cue, coherence_pow=4.0, color_weight=1.5)
    ej = jnp.asarray(energies, jdt)
    ref = np.asarray(jfeat.assemble_features(ej, jnp.asarray(lab), JaxClusterConfig(**fields)))
    et = torch.from_numpy(np.array(ej.astype(jnp.float32))).to(tdt).permute(0, 3, 1, 2)
    got = tfeat.assemble_features(et, torch.from_numpy(lab), ClusterConfig(**fields))
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    # the (B, H, W, D) view of a channel-major buffer: no NHWC copy
    assert got.permute(0, 3, 1, 2).is_contiguous()
    ok, err = _within(got.to(torch.float32).numpy(), ref.astype(np.float32), dtype)
    assert ok, err


def test_assemble_features_without_normalisation(inputs):
    energies, lab = inputs
    cc = dict(normalize=False, color_weight=2.0)
    ref = np.asarray(jfeat.assemble_features(jnp.asarray(energies), jnp.asarray(lab),
                                             JaxClusterConfig(**cc)))
    got = tfeat.assemble_features(torch.from_numpy(energies).permute(0, 3, 1, 2),
                                  torch.from_numpy(lab), ClusterConfig(**cc))
    assert np.abs(got.numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_coherence_weights_match_jax(inputs, dtype):
    jdt, tdt = DTYPES[dtype]
    feats = np.asarray(jfeat.assemble_features(jnp.asarray(inputs[0]), jnp.asarray(inputs[1]),
                                               JaxClusterConfig()))
    fj = jnp.asarray(feats, jdt)
    ref = np.asarray(jfeat.coherence_weights(fj))
    got = tfeat.coherence_weights(torch.from_numpy(np.array(fj.astype(jnp.float32))).to(tdt))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 1, 1, 39)
    assert np.abs(got.numpy() - ref).max() <= 1e-4


def test_coherence_weights_are_ones_below_two_blocks():
    """A frame of fewer than two 8x8 blocks a side: ones, as the reference's."""
    feats = np.random.default_rng(103).normal(size=(1, 15, 40, 5)).astype(np.float32)
    assert torch.equal(tfeat.coherence_weights(torch.from_numpy(feats)), torch.ones((1, 1, 1, 5)))
    ref = np.asarray(jfeat.coherence_weights(jnp.asarray(feats)))
    assert np.array_equal(ref, np.ones((1, 1, 1, 5), np.float32))


def test_gabor_features_match_jax(inputs):
    _, lab = inputs
    cfg = preset("config0")
    ref = np.asarray(jfeat.gabor_features(jnp.asarray(lab), jax_make_bank(cfg.bank)))
    got = tfeat.gabor_features(torch.from_numpy(lab), make_bank(cfg.bank))
    assert tuple(got.shape) == ref.shape == (2, 48, 72, 39)
    assert np.abs(got.numpy() - ref).max() <= 1e-4
