"""PyTorch port, spatial tiling and pooling of the feature stage (config4):
the pipeline's exact 2x2 pooling against the JAX package's
``_pool2x2_nhwc``, and ``gabor_energies_tiled`` (K1's plain version once
per window) against the JAX package's ``gabor_energies_tiled`` running its
Pallas K1 in interpret mode, the function the port's K1 tests hold K1
against.

Batch 2 of 96x128 mosaics, tile (48, 64), the config4 bank (halo 39).
Bounds: pooling bit-equal in both dtypes; energies within K1's bounds,
1e-4 of the peak in float32 and 2e-2 in bfloat16. A tiled result is not
bit-equal to the untiled one: K1 centres each window on its own mean, as
the reference's tiling does (tests/test_tiling.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models.pipeline import _pool2x2_nhwc
from gabor_color_image_segmentation_tpu.ops.bank import make_bank
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu.ops.fused_pallas import gabor_energies_fused as jax_k1
from gabor_color_image_segmentation_tpu.ops.tiled import gabor_energies_tiled as jax_tiled
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.ops.bank import from_jax_bank
from gabor_color_image_segmentation_tpu_torch.ops.fused import gabor_energies_fused
from gabor_color_image_segmentation_tpu_torch.ops.tiled import (
    gabor_energies_tiled,
    pool2x2_mean,
    tile_offsets,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TILE = (48, 64)


@pytest.fixture(scope="module")
def bank():
    return make_bank(jax_preset("config4").bank)


@pytest.fixture(scope="module")
def lab():
    rgb = np.stack([synthetic_mosaic(h=96, w=128, n_regions=4, seed=20 + i)[0]
                    for i in range(2)])
    return np.asarray(rgb_to_lab(jnp.asarray(rgb)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", [(2, 13, 18, 5), (1, 96, 128, 36), (2, 7, 9, 3)])
def test_pool_bit_equal_to_jax(shape, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    x = np.random.default_rng(shape[1]).normal(scale=50.0, size=shape).astype(np.float32)
    ref = np.asarray(_pool2x2_nhwc(jnp.asarray(x, jdt)), np.float32)
    xt = torch.from_numpy(x).to(tdt)
    nhwc = pool2x2_mean(xt, 1)
    cm = pool2x2_mean(xt.permute(0, 3, 1, 2), 2)
    assert nhwc.dtype == tdt and cm.dtype == tdt
    np.testing.assert_array_equal(nhwc.float().numpy(), ref)
    np.testing.assert_array_equal(cm.permute(0, 2, 3, 1).float().numpy(), ref)


@pytest.mark.parametrize("pool", [0, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_matches_jax(bank, lab, dtype, pool):
    jdt, tdt, tol = DTYPES[dtype]
    ref = np.asarray(jax_tiled(jnp.asarray(lab), bank, jdt, TILE, jax_k1, pool),
                     np.float32).transpose(0, 3, 1, 2)
    got = gabor_energies_tiled(torch.from_numpy(lab.copy()), from_jax_bank(bank, "cpu"),
                               tdt, TILE, bank.config.max_halo, pool)
    assert got.dtype == tdt and tuple(got.shape) == ref.shape
    peak = float(np.abs(ref).max())
    np.testing.assert_allclose(got.float().numpy(), ref, atol=tol * peak, rtol=0)


@pytest.mark.parametrize("pool", [0, 2])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_matches_untiled(bank, lab, dtype, pool):
    """Tiled K1 against K1 on the whole frame, then pooled."""
    _, tdt, tol = DTYPES[dtype]
    groups = from_jax_bank(bank, "cpu")
    x = torch.from_numpy(lab.copy())
    whole, _ = gabor_energies_fused(x, groups, tdt, pooled=False)
    for _ in range(pool):
        whole = pool2x2_mean(whole, 2)
    got = gabor_energies_tiled(x, groups, tdt, TILE, bank.config.max_halo, pool)
    peak = whole.float().abs().max().item()
    assert (got.float() - whole.float()).abs().max().item() <= tol * peak


def test_tile_offsets_shift_ragged_edges_inward():
    assert tile_offsets(96, 128, TILE) == (48, 64, [0, 48], [0, 64])
    assert tile_offsets(100, 130, TILE) == (48, 64, [0, 48, 52], [0, 64, 66])
    assert tile_offsets(30, 40, TILE) == (30, 40, [0], [0])
    # config4: 5 x 5 windows over a 4K frame
    th, tw, ys, xs = tile_offsets(2160, 3840, (432, 768))
    assert (len(ys), len(xs)) == (5, 5)


def test_misaligned_tile_raises(bank, lab):
    """A tile (or offset) that is not a multiple of 2^pool raises, as in
    the JAX package."""
    with pytest.raises(ValueError, match="divisible by 4"):
        jax_tiled(jnp.asarray(lab), bank, jnp.float32, (42, 64), jax_k1, 2)
    with pytest.raises(ValueError, match="divisible by 4"):
        gabor_energies_tiled(torch.from_numpy(lab.copy()), from_jax_bank(bank, "cpu"),
                             torch.float32, (42, 64), bank.config.max_halo, 2)
    # a ragged frame whose last window shifts to an odd offset
    with pytest.raises(ValueError, match="divisible by 4"):
        gabor_energies_tiled(torch.from_numpy(lab[:, :90].copy()),
                             from_jax_bank(bank, "cpu"), torch.float32, TILE,
                             bank.config.max_halo, 2)
