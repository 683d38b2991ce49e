"""PyTorch port, SLIC on uniform bands (kernels K13 and K12): the copy of the
JAX package's band plan, the kernel each frame is routed to, and the plain
versions against the plain exact SLIC and the JAX package's kernels.

Bounds: the plan copy is equal key for key; the banded loop and the w5
loop are bit-equal to ``slic_plain`` (the same exact-float32 SLIC; on the
Lab of uint8 images the float64 moments are exact, so the band order of
the sums changes no bit); against the JAX package's bf16x3 kernels in
interpret mode >= 0.98 of each image's pixels, the JAX package's own bar
for them (tests/test_slic.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models import slic_pallas
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import slic as tslic
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf

torch.set_num_threads(2)

SHAPES = [(540, 960, 400), (321, 481, 400), (321, 481, 900), (96, 128, 64),
          (64, 96, 800), (37, 53, 10)]
# the kernel of each shape: plan "auto", then plan "w5" (None: raises)
ROUTES = {(540, 960, 400): ("banded", None), (321, 481, 400): ("w3", "w5"),
          (321, 481, 900): ("w3", None), (96, 128, 64): ("w3", "w5"),
          (64, 96, 800): ("w3", None), (37, 53, 10): ("w3", "w5")}


@pytest.fixture(scope="module")
def lab():
    """(2, 96, 128, 3) float32 Lab of two seeded mosaics."""
    rgb = np.stack([synthetic_mosaic(h=96, w=128, n_regions=4, seed=7 + i)[0]
                    for i in range(2)])
    return np.array(jax_rgb_to_lab(jnp.asarray(rgb)))


@pytest.mark.parametrize("shape", SHAPES)
def test_plan_copy_equal(shape):
    ref, got = slic_pallas._plan(*shape), sf.slic_plan(*shape)
    assert got.keys() == ref.keys()
    for key, val in ref.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(val), err_msg=key)
    assert sf.slic_fused_eligible(*shape) == slic_pallas.slic_fused_eligible(*shape)
    if got["w_rows"]:
        # the kernels' integer form of the band's first candidate row
        h, gh, br = shape[0], got["gh"], got["band_rows"]
        rb = [max(0, min(t * br * gh // h - 1, gh - got["w_rows"]))
              for t in range(got["n_bands"])]
        assert rb == got["rb"].tolist()


@pytest.mark.parametrize("shape", SHAPES)
def test_route(shape):
    auto, w5 = ROUTES[shape]
    assert sf.slic_route(*shape) == auto
    if w5 is None:
        with pytest.raises(ValueError, match="plan"):
            sf.slic_route(*shape, plan="w5")
    else:
        assert sf.slic_route(*shape, plan="w5") == w5
    if auto == "w3":
        assert sf.slic_route(*shape, plan="w3") == "w3"


def test_band_windows_cover_every_pixel():
    """The reference's rb comes from float64 arithmetic, the pixels' cells
    from float32: over a sweep of shapes every band's candidate rows still
    fit its window (_band_plan raises otherwise)."""
    n_plans = 0
    for h in range(8, 600, 7):
        for w in (h, 2 * h - 1, int(1.5 * h) + 3):
            for n_sp in (10, 50, 100, 200, 400, 600):
                bp = sf.slic_plan(h, w, n_sp)
                if bp is not None and bp["w_rows"] > 0:
                    sf._band_plan(h, w, n_sp)
                    n_plans += 1
    assert n_plans > 1000
    for plan in ("w3", "w5"):
        with pytest.raises(ValueError, match="plan-free"):
            sf.slic_route(540, 960, 400, plan)
        with pytest.raises(ValueError, match="plan-free"):
            sf.slic_batch(torch.zeros((1, 540, 960, 3)), 400, plan=plan)
    with pytest.raises(ValueError, match="unknown SLIC plan"):
        sf.slic_route(96, 128, 64, "w7")


@pytest.mark.parametrize("n_sp", [64, 30, 10])
def test_banded_and_w5_loops_bit_equal_to_slic_plain(lab, n_sp):
    x = torch.from_numpy(lab)
    ref = tslic.slic_plain(x, n_sp, 10.0, 10)
    assert torch.equal(sf.slic_banded_plain(x, n_sp, 10.0, 10), ref)
    assert torch.equal(sf.slic_banded(x, n_sp, 10.0, 10), ref)
    assert torch.equal(sf.slic_w5(x, n_sp, 10.0, 10), ref)
    assert torch.equal(sf.slic_batch(x, n_sp, 10.0, 10, plan="w5"), ref)


@pytest.mark.parametrize("cols", [sf._BAND_COLS, 48])
def test_band_partials_are_the_band_moments(lab, cols):
    """The pass's partials, added over the bands and their column pieces
    (the last one narrower at 48 columns), are slic_plain's moments of the
    same assignment, bit for bit."""
    x = torch.from_numpy(lab)
    h, w = lab.shape[1:3]
    bp = sf.slic_plan(h, w, 64)
    _, _, sw = tslic.slic_geometry(h, w, 64, 10.0)
    cent = tslic.slic_init_centroids(x, bp["gh"], bp["gw"])
    labels, parts = sf.slic_band_pass_plain(x, cent, bp, sw, cols=cols)
    ncp = -(-w // cols)
    assert parts.shape == (2, bp["n_bands"], ncp, bp["w_rows"] * bp["gw"], 6)
    assert torch.equal(labels, sf.slic_band_pass_plain(x, cent, bp, sw, partials=False)[0])
    sums, counts = tslic.slic_moments(tslic._pixel_rows(x), labels.reshape(2, -1).long(),
                                      bp["n_sp"])
    total = torch.zeros((2, bp["n_sp"], 6), dtype=torch.float64)
    ncr = parts.shape[3]
    for t, rb in enumerate(bp["rb"]):
        for c in range(ncp):
            total[:, rb * bp["gw"]:rb * bp["gw"] + ncr] += parts[:, t, c]
    assert torch.equal(total[..., :5], sums)
    assert torch.equal(total[..., 5], counts.double())
    assert torch.equal(sf.slic_band_update_plain(cent, parts, bp),
                       tslic.slic_update(cent, sums, counts))


@pytest.fixture
def banded_reference(monkeypatch):
    """The JAX package's slic_fused with its gate at 0, so it takes the
    launch-per-pass banded loop (the gate is read at trace time)."""
    monkeypatch.setattr(slic_pallas, "_SLIC_FUSE_BYTES", 0)
    slic_pallas.slic_fused.clear_cache()
    yield slic_pallas.slic_fused
    slic_pallas.slic_fused.clear_cache()


def test_banded_loop_matches_jax_banded_kernel(lab, banded_reference):
    ref = np.asarray(banded_reference(jnp.asarray(lab), 64, 10.0, 5))
    got = sf.slic_banded(torch.from_numpy(lab), 64, 10.0, 5).numpy()
    for i in range(2):
        agree = (got[i] == ref[i]).mean()
        assert agree >= 0.98, f"image {i}: {agree}"


def test_w5_matches_jax_w5_kernel(lab):
    assert sf.slic_route(96, 128, 64, "w5") == "w5"
    ref = np.asarray(slic_pallas.slic_fused(jnp.asarray(lab), 64, 10.0, 5, "w5"))
    got = sf.slic_batch(torch.from_numpy(lab), 64, 10.0, 5, plan="w5").numpy()
    for i in range(2):
        agree = (got[i] == ref[i]).mean()
        assert agree >= 0.98, f"image {i}: {agree}"


def test_banded_wrappers_raise_off_cpu():
    """Tensors that are not on the CPU never take the plain versions."""
    meta = torch.zeros((1, 96, 128, 3), device="meta")
    bp = sf.slic_plan(96, 128, 64)
    cent = torch.zeros((1, bp["n_sp"], 5), device="meta")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        sf.slic_band_pass(meta, cent, bp, 1.0)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        sf.slic_w5(meta, 64)
