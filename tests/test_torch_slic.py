"""PyTorch port, superpixel stage: the copies of the JAX package's SLIC
geometry, the plain versions of K11 (SLIC), K14 (connectivity) and K15
(table lookup) against the JAX package on the same numpy inputs.

Bounds: ``slic_plain`` agrees with the JAX package's exact-f32 ``slic`` on
>= 0.999 of each image's pixels (the same function; the two sum the 5-term
scores and the moments in different orders, so a pixel equidistant from two
centroids may flip), and with its bf16x3 w3 kernel on >= 0.98, the JAX
package's own bar for that kernel (tests/test_slic.py). Connectivity and
lookup are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models import slic as jslic
from gabor_color_image_segmentation_tpu.models import slic_pallas
from gabor_color_image_segmentation_tpu.models.connectivity_pallas import (
    enforce_connectivity_fused as jax_enforce_fused,
)
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from gabor_color_image_segmentation_tpu.ops.lookup import _lookup_tpu
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import slic as tslic
from gabor_color_image_segmentation_tpu_torch.models.connectivity import (
    enforce_connectivity_fused,
)
from gabor_color_image_segmentation_tpu_torch.models.slic_fused import slic_batch
from gabor_color_image_segmentation_tpu_torch.ops.lookup import (
    table_lookup,
    table_lookup_plain,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def lab():
    """(2, 96, 128, 3) float32 Lab of two seeded mosaics."""
    rgb = np.stack([synthetic_mosaic(h=96, w=128, n_regions=4, seed=7 + i)[0]
                    for i in range(2)])
    return np.array(jax_rgb_to_lab(jnp.asarray(rgb)))


@pytest.mark.parametrize("hw_n", [(96, 128, 64), (321, 481, 900), (64, 96, 800),
                                  (37, 53, 10), (5, 7, 100)])
def test_geometry_copies_equal(hw_n):
    h, w, n = hw_n
    assert tslic.grid_shape(h, w, n) == jslic.grid_shape(h, w, n)
    for ruler in (5.0, 10.0, 0.0):
        assert tslic.slic_geometry(h, w, n, ruler) == jslic.slic_geometry(h, w, n, ruler)
    gh, gw, _ = tslic.grid_shape(h, w, n)
    got = tslic.slic_seed_coords(h, w, gh, gw)
    ref = jslic.slic_seed_coords(h, w, gh, gw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    # the pixels' cells: the same float32 arithmetic as slic_pixel_arrays
    yy = (np.arange(h, dtype=np.float32) * np.float32(gh / h)).astype(np.int32)
    np.testing.assert_array_equal(tslic.cell_index(h, gh, "cpu").numpy(),
                                  np.clip(yy, 0, gh - 1))


def test_slic_plain_matches_jax_slic(lab):
    got = tslic.slic_plain(torch.from_numpy(lab), 64, 10.0, 5)
    assert got.dtype == torch.int32 and tuple(got.shape) == lab.shape[:3]
    for i in range(2):
        ref = np.asarray(jslic.slic(lab[i], 64, 10.0, 5))
        agree = (got[i].numpy() == ref).mean()
        assert agree >= 0.999, f"image {i}: {agree}"


def test_slic_plain_matches_jax_w3_kernel(lab):
    """At the w3-only geometry (800 superpixels: 5 and 4 grid rows exceed
    the TPU kernel's 128-lane window, as config3's do), against the JAX
    package's production SLIC kernel in interpret mode."""
    assert slic_pallas._plan(96, 128, 800)["w_rows"] == 0
    got = slic_batch(torch.from_numpy(lab), 800, 5.0, 5).numpy()
    ref = np.asarray(slic_pallas.slic_fused(jnp.asarray(lab), 800, 5.0, 5, "w3"))
    for i in range(2):
        agree = (got[i] == ref[i]).mean()
        assert agree >= 0.98, f"image {i}: {agree}"


def _fragmented(rng, h, w, n_sp):
    base = rng.integers(0, n_sp, ((h + 7) // 8, (w + 7) // 8))
    lab = np.kron(base, np.ones((8, 8), int))[:h, :w]
    noise = rng.integers(0, n_sp, (h, w))
    lab = np.where(rng.random((h, w)) < 0.25, noise, lab)
    return np.stack([lab, lab[:, ::-1]]).astype(np.int32)


@pytest.mark.parametrize("case", [(48, 64, 12, 16, None), (40, 56, 9, 10, None),
                                  (33, 47, 20, 4, 7), (1, 50, 5, 2, None),
                                  (29, 1, 5, 2, None)])
def test_connectivity_bit_equal_random(case):
    """Heavily fragmented random maps (tests/test_slic.py's generator), a
    survivor cap below the survivor count, and one-row / one-column
    images."""
    h, w, n_sp, min_size, s_max = case
    lab = _fragmented(np.random.default_rng(h * w), h, w, n_sp)
    ref = np.asarray(jslic.enforce_connectivity_device(jnp.asarray(lab), n_sp, min_size,
                                                       s_max))
    got = enforce_connectivity_fused(torch.from_numpy(lab), n_sp, min_size, s_max)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_connectivity_bit_equal_on_slic_output(lab):
    gh, gw, _ = tslic.grid_shape(96, 128, 64)
    sp = tslic.slic_plain(torch.from_numpy(lab), 64, 10.0, 5)
    ref = np.asarray(jslic.enforce_connectivity_device(jnp.asarray(sp.numpy()), gh * gw))
    got = tslic.enforce_connectivity_plain(sp, gh * gw)
    np.testing.assert_array_equal(got.numpy(), ref)
    # and the JAX package's Pallas kernel (interpret mode) on one case
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_enforce_fused(jnp.asarray(sp.numpy()), gh * gw)))


def test_connected_components_ids_are_min_index():
    lab = _fragmented(np.random.default_rng(3), 24, 31, 6)
    ids = tslic.connected_components(torch.from_numpy(lab)).numpy()
    ref = np.asarray(jslic.connected_components(jnp.asarray(lab))).reshape(2, -1)
    np.testing.assert_array_equal(ids, ref)


def test_host_connectivity_copy_equal(lab):
    sp = np.asarray(jslic.slic(lab[0], 64, 10.0, 5))
    for min_size in (None, 40):
        np.testing.assert_array_equal(tslic.enforce_connectivity(sp, min_size),
                                      jslic.enforce_connectivity(sp, min_size))


@pytest.mark.parametrize("shape", [(2, 5000, 37), (3, 1001, 925), (1, 7, 1)])
def test_table_lookup_bit_equal_to_jax_kernel(shape):
    b, n, s = shape
    rng = np.random.default_rng(n)
    idx = rng.integers(0, s, size=(b, n)).astype(np.int32)
    table = rng.integers(0, 8, size=(b, s)).astype(np.int32)
    ref = np.asarray(_lookup_tpu(jnp.asarray(idx), jnp.asarray(table)))
    got = table_lookup(torch.from_numpy(idx), torch.from_numpy(table))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        table_lookup_plain(torch.from_numpy(idx), torch.from_numpy(table)).numpy(), ref)


def test_graph_wrappers_raise_off_cpu():
    """Tensors that are not on the CPU never take the plain versions."""
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        slic_batch(torch.zeros((1, 8, 8, 3), device="meta"), 4)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        enforce_connectivity_fused(torch.zeros((1, 8, 8), dtype=torch.int32,
                                               device="meta"), 4)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        table_lookup(torch.zeros((1, 8), dtype=torch.int32),
                     torch.zeros((1, 4), dtype=torch.int32, device="meta"))
