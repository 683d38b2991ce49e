"""PyTorch port: the direct Gabor energies (``ops/features.py::
gabor_energies``, the route of a bank with gamma != 1) and ``energy_index``
against the JAX package's.

Tolerances: energies within 1e-4 (float32) / 2e-2 (bfloat16) of the
reference's peak, K1's bounds (the bf16 products are exact in float32 on
both sides; the sums differ in order); ``energy_index`` exactly equal."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.ops import features as jfeat
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gabor_color_image_segmentation_tpu_torch.ops import features as tfeat
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab

torch.set_num_threads(2)

BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (H, W): a frame, and one smaller than the sigma-8 kernel's radius 15
# (the REFLECT_101 pad folds more than once)
FRAMES = {"40x56": (40, 56), "12x20": (12, 20)}


def _lab(h, w, seed=100):
    rgb = synthetic_mosaic(h=h, w=w, n_regions=4, seed=seed)[0]
    return rgb_to_lab(torch.from_numpy(rgb[None]).to(torch.float32) / 255.0).numpy()


def _bank(gamma):
    return dataclasses.replace(preset("config0").bank, gamma=gamma)


@pytest.mark.parametrize("frame", sorted(FRAMES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gabor_energies_match_jax(dtype, frame):
    jdt, tdt = DTYPES[dtype]
    lab = _lab(*FRAMES[frame])
    cfg = _bank(0.5)
    ref = np.asarray(jfeat.gabor_energies(jnp.asarray(lab), jax_make_bank(cfg), jdt))
    got = tfeat.gabor_energies(torch.from_numpy(lab), make_bank(cfg), tdt)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
    assert err <= BOUND[dtype], err


@pytest.mark.parametrize("name", ["config0", "config1"])
def test_energy_index_matches_jax(name):
    cfg = preset(name).bank
    bank, jbank = make_bank(cfg), jax_make_bank(jax_preset(name).bank)
    got = [tfeat.energy_index(bank, 3, i, c) for i in range(cfg.n_kernels) for c in range(3)]
    want = [jfeat.energy_index(jbank, 3, i, c) for i in range(cfg.n_kernels) for c in range(3)]
    assert got == want and sorted(got) == list(range(3 * cfg.n_kernels))
    with pytest.raises(IndexError):
        tfeat.energy_index(bank, 3, cfg.n_kernels, 0)


def test_auto_takes_the_direct_route_for_gamma_not_one(monkeypatch):
    """compute_energies: "auto" resolves to the direct convolutions for a
    gamma != 1 bank (K1 and the modulated route refuse it, as the
    reference's do), and "direct" pinned gives the same energies."""
    calls = []
    real = pipeline.gabor_energies

    def spy(*args, **kw):
        calls.append("direct")
        return real(*args, **kw)

    monkeypatch.setattr(pipeline, "gabor_energies", spy)
    cfg = preset("config0").replace(bank=_bank(0.5))
    rgb = torch.from_numpy(synthetic_mosaic(h=32, w=40, n_regions=3, seed=101)[0][None])
    auto, _ = pipeline.compute_energies(rgb, cfg, make_bank(cfg.bank))
    pinned, _ = pipeline.compute_energies(rgb, cfg.replace(feature_impl="direct"),
                                          make_bank(cfg.bank))
    assert calls == ["direct", "direct"] and torch.equal(auto, pinned)
    assert tuple(auto.shape) == (1, 36, 32, 40) and auto.dtype == torch.float32
    for impl in ("pallas", "modulated"):
        with pytest.raises(ValueError, match="gamma"):
            pipeline.compute_energies(rgb, cfg.replace(feature_impl=impl), make_bank(cfg.bank))
    with pytest.raises(ValueError, match="unknown feature_impl"):
        pipeline.compute_energies(rgb, cfg.replace(feature_impl="xla"), make_bank(cfg.bank))
