"""PyTorch port: K1's rounding points and its folded smoothing taps.

In bf16 mode the JAX package's K1 rounds each matmul operand to bfloat16
(the image before its box sums, the modulated planes, the vertical passes,
the magnitude, the taps) and its smoothing matrices fold REFLECT_101 into
each border row. The port's plain version follows those points, so it
gives the reference kernel's bits on all but a few values (sums in another
order round the other way now and then): >= 0.99 of the energies and of
the twin equal, on frames with odd and even sides; a port that rounds only
the stored values matches ~0.4 of them. ``smooth_table`` lays the folded
matrices' rows on the padded axis the CUDA kernel reads."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import BankConfig, preset
from gabor_color_image_segmentation_tpu.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu.ops.bank import make_bank
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu.ops.fused_pallas import gabor_energies_fused as jax_fused
from gabor_color_image_segmentation_tpu_torch.ops import fused
from gabor_color_image_segmentation_tpu_torch.ops.bank import from_jax_bank

torch.set_num_threads(2)

BANKS = {
    "diagonal": BankConfig(scales=(2.0, 3.0), orientations=3, frequencies=(0.12,)),
    "config0": preset("config0").bank,
}
BITS_FLOOR = 0.99


@pytest.mark.parametrize("hw", [(48, 64), (37, 53)])
@pytest.mark.parametrize("bank_name", sorted(BANKS))
def test_bf16_energies_take_the_references_bits(bank_name, hw):
    rgb = np.stack([synthetic_mosaic(h=hw[0], w=hw[1], n_regions=3, seed=3 + i)[0]
                    for i in range(2)])
    lab = np.asarray(rgb_to_lab(jnp.asarray(rgb)))
    bank = make_bank(BANKS[bank_name])
    ref_e, ref_t = jax_fused(jnp.asarray(lab), bank, jnp.bfloat16, channel_major=True,
                             pooled=True)
    out_e, out_t = fused.gabor_energies_fused(torch.from_numpy(lab.copy()),
                                              from_jax_bank(bank, "cpu"), torch.bfloat16)
    for got, ref in ((out_e, ref_e), (out_t, ref_t)):
        ref = np.asarray(ref.astype(jnp.float32))
        assert tuple(got.shape) == ref.shape
        assert (got.float().numpy() == ref).mean() >= BITS_FLOOR


@pytest.mark.parametrize("n", [1, 2, 5, 9, 48, 53])
@pytest.mark.parametrize("pooled", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
def test_smooth_table_is_the_folded_matrix(n, pooled, bf16):
    """Reading the REFLECT_101-padded axis through the table gives the
    folded matrix's product; rows clear of the borders hold the plain taps
    (their means for the twin), the taps the kernel's loops read."""
    g = from_jax_bank(make_bank(preset("config0").bank), "cpu")[1]  # r = 12
    r = g.r
    table = fused.smooth_table(g, n, pooled, bf16).double().numpy()
    m = fused._smooth_matrix(g, n, pooled, bf16).double().numpy()
    stride, ntap = (2, 2 * r + 2) if pooled else (1, 2 * r + 1)
    assert table.shape == (m.shape[0], ntap)
    x = np.random.default_rng(n).normal(size=n)
    padded = x[fused._reflect_np(np.arange(-r, n + r), n)]
    got = np.array([table[i] @ padded[stride * i:stride * i + ntap]
                    for i in range(m.shape[0])])
    np.testing.assert_allclose(got, m @ x, rtol=1e-12, atol=1e-12)
    taps = g.smooth.double().numpy()
    if pooled:
        taps = 0.5 * (np.append(taps, 0.0) + np.insert(taps, 0, 0.0))
    plain = fused._round_storage(torch.from_numpy(taps.astype(np.float32)), bf16)
    assert torch.equal(fused.smooth_taps(g, pooled, bf16), plain)
    for i in range(m.shape[0]):
        if stride * i - r >= 0 and stride * i - r + ntap - 1 <= n - 1:
            np.testing.assert_array_equal(table[i], plain.double().numpy())
