"""PyTorch port, the modulated route's tiling hooks (ops/modulated.py:
``h_halo`` and ``y0`` of ``modulated_group_magnitudes``, ``h_halo`` of
``smooth_group_magnitudes``), which parallel/tiling.py's strips use.

A strip of rows [r0, r1) of a 64x96 image, handed its real neighbour rows
as halos and its global first row as ``y0``, against the JAX package's
functions on the same strip (within 1e-6 of the peak: the same rounding
points, only cos, sin and the summation order may differ in their last
bits) and against the port's whole-image rows. A halo below the conv or
smoothing radius raises, as in the reference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import BankConfig as JaxBankConfig
from gabor_color_image_segmentation_tpu.ops import modulated as jax_mod
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu_torch.config import BankConfig
from gabor_color_image_segmentation_tpu_torch.ops import modulated
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

torch.set_num_threads(2)

BANK = dict(scales=(2.0, 3.0), orientations=3, frequencies=None)
TOL = 1e-6


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(11)
    return rng.uniform(0.0, 100.0, (1, 64, 96, 3)).astype(np.float32)


def _strip(img, r0, r1, halo):
    return img[:, r0 - halo:r1 + halo]


@pytest.mark.parametrize("rows", [(16, 40), (24, 48)])
@pytest.mark.parametrize("extra", [0, 3])
def test_magnitudes_strip_match_jax(image, rows, extra):
    """h_halo >= p real rows and y0 = the strip's first row: the port's
    strip against the JAX package's and against the port's whole-image
    rows."""
    bank, jbank = make_bank(BankConfig(**BANK)), jax_make_bank(JaxBankConfig(**BANK))
    r0, r1 = rows
    for g, jg in zip(bank.groups, jbank.groups):
        halo = g.ksize // 2 + extra
        strip = _strip(image, r0, r1, halo)
        got = modulated.modulated_group_magnitudes(torch.from_numpy(strip), g, bank,
                                                   h_halo=halo, y0=r0)
        # eager, as the port runs: jit's fusion moves the last bits
        ref = np.asarray(jax_mod.modulated_group_magnitudes(jnp.asarray(strip), jg, jbank,
                                                            jnp.float32, h_halo=halo, y0=r0))
        whole = modulated.modulated_group_magnitudes(torch.from_numpy(image), g, bank)
        peak = np.abs(ref).max()
        assert got.shape == (1, r1 - r0, 96, ref.shape[-1])
        assert np.abs(got.numpy() - ref).max() <= TOL * peak
        assert (got - whole[:, r0:r1]).abs().max().item() <= TOL * peak


def test_smooth_strip_match_jax(image):
    """The smoothing with h_halo >= r real magnitude rows equals the
    whole-image smoothing's rows and the JAX package's."""
    bank, jbank = make_bank(BankConfig(**BANK)), jax_make_bank(JaxBankConfig(**BANK))
    for g, jg in zip(bank.groups, jbank.groups):
        mag = modulated.modulated_group_magnitudes(torch.from_numpy(image), g, bank)
        r = g.smooth_radius
        halo = r + 2
        got = modulated.smooth_group_magnitudes(mag[:, 20 - halo:44 + halo], g, h_halo=halo)
        whole = modulated.smooth_group_magnitudes(mag, g)
        ref = np.asarray(jax_mod.smooth_group_magnitudes(
            jnp.asarray(mag[:, 20 - halo:44 + halo].numpy()), jg, jnp.float32, h_halo=halo))
        peak = np.abs(ref).max()
        assert np.abs(got.numpy() - ref).max() <= TOL * peak
        assert (got - whole[:, 20:44]).abs().max().item() <= TOL * peak


def test_default_hooks_unchanged(image):
    """h_halo = 0 and y0 = 0 are the untiled route, bit for bit."""
    bank = make_bank(BankConfig(**BANK))
    g = bank.groups[0]
    x = torch.from_numpy(image)
    a = modulated.modulated_group_magnitudes(x, g, bank)
    b = modulated.modulated_group_magnitudes(x, g, bank, h_halo=0, y0=0)
    assert torch.equal(a, b)
    assert torch.equal(modulated.smooth_group_magnitudes(a, g),
                       modulated.smooth_group_magnitudes(a, g, h_halo=0))


def test_short_halo_raises(image):
    """h_halo < p (conv) or < r (smoothing) raises, as in the reference."""
    bank, jbank = make_bank(BankConfig(**BANK)), jax_make_bank(JaxBankConfig(**BANK))
    g, jg = bank.groups[-1], jbank.groups[-1]
    p, r = g.ksize // 2, g.smooth_radius
    strip = _strip(image, 20, 40, p - 1)
    with pytest.raises(ValueError, match="conv radius"):
        modulated.modulated_group_magnitudes(torch.from_numpy(strip), g, bank, h_halo=p - 1)
    with pytest.raises(ValueError, match="conv radius"):
        jax_mod.modulated_group_magnitudes(jnp.asarray(strip), jg, jbank, h_halo=p - 1)
    mag = torch.zeros((1, 30, 96, 6))
    with pytest.raises(ValueError, match="smooth radius"):
        modulated.smooth_group_magnitudes(mag, g, h_halo=r - 1)
    with pytest.raises(ValueError, match="smooth radius"):
        jax_mod.smooth_group_magnitudes(jnp.asarray(mag.numpy()), jg, h_halo=r - 1)
