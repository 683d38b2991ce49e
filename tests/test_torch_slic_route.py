"""PyTorch port, SLIC routing where the band plan misses candidate rows.

The reference's band plan (``_plan``) puts a band's first window row at
``int(y0 * gh / h) - 1`` in float64, and a pixel's cell row comes from a
float32 product: where y0 * gh / h is an exact integer the cell can fall a
row short of the window. The reference runs these frames (its kernel with
the row penalised, or its XLA ``slic``); the port routes them to K11, which
has no window and the exact ``slic`` semantics. Frames the tests and
chip_smoke.py pin to K13 ("banded") or K12 ("w5") keep their route.

Bounds: ``slic_batch`` equals ``slic_plain`` on every pixel (K11's plain
version is ``slic_plain``), and agrees with the JAX package's ``slic`` on
>= 0.999 of the pixels, as tests/test_torch_slic.py holds it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models import slic as jslic
from gabor_color_image_segmentation_tpu.models import slic_pallas
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import slic as tslic
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf

torch.set_num_threads(2)

# (h, w, S): config3's S = 900 on the frame, config4's S = 400 on the
# pooled grid, and the smallest frame on the auto route
MISSED_AUTO = [(1056, 640, 900), (1288, 480, 900), (1288, 481, 900), (1394, 270, 900),
               (1104, 960, 400), (1392, 270, 400), (1480, 16, 10)]
MISSED_W5 = [(448, 16, 12000), (760, 16, 925), (532, 77, 925)]
# the frames the banded and w5 tests and chip_smoke.py pin, with their plan
# and route
PINNED = [((540, 960, 400), "auto", "banded"), ((321, 481, 400), "w5", "w5"),
          ((1052, 16, 12000), "w5", "w5"), ((1422, 16, 12000), "w5", "w5"),
          ((1422, 127, 10), "w5", "w5")]


@pytest.mark.parametrize("frame", MISSED_AUTO + MISSED_W5)
def test_missed_band_frames_take_k11(frame):
    """The reference has a kernel plan there; the port's band plan fails
    its check, and both plans route to K11."""
    assert slic_pallas.slic_fused_eligible(*frame)
    assert sf.slic_fused_eligible(*frame)
    assert not sf.band_plan_ok(*frame)
    assert sf.slic_route(*frame) == "w3"
    if frame in MISSED_W5 or sf._fits_gate(sf.slic_plan(*frame)):
        assert sf.slic_route(*frame, plan="w5") == "w3"


@pytest.mark.parametrize("frame,plan,route", PINNED)
def test_pinned_frames_keep_their_route(frame, plan, route):
    assert sf.band_plan_ok(*frame)
    assert sf.slic_route(*frame, plan=plan) == route
    sf._band_plan(*frame)  # the direct call's check passes


@pytest.mark.parametrize("fn", ["slic_banded", "slic_w5"])
def test_direct_banded_call_still_raises(fn):
    lab = torch.zeros((1, 1480, 16, 3))
    with pytest.raises(ValueError, match="band 37 of the SLIC plan misses candidate rows"):
        getattr(sf, fn)(lab, 10, 10.0, 1)


def test_slic_batch_runs_the_missed_frame():
    """(1, 1480, 16, 3) at S = 10: the frame the auto route once refused.
    Labels equal slic_plain's and agree with the JAX package's slic (what
    the reference's slic_batch runs off the TPU)."""
    rgb = synthetic_mosaic(h=1480, w=16, n_regions=4, seed=5)[0][None]
    lab = np.array(jax_rgb_to_lab(jnp.asarray(rgb)))
    x = torch.from_numpy(lab)
    got = sf.slic_batch(x, 10, 10.0, 10)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, 1480, 16)
    assert torch.equal(got, tslic.slic_plain(x, 10, 10.0, 10))
    ref = np.asarray(slic_pallas.slic_batch(jnp.asarray(lab), 10, 10.0, 10))
    np.testing.assert_array_equal(ref[0], np.asarray(jslic.slic(lab[0], 10, 10.0, 10)))
    agree = (got[0].numpy() == ref[0]).mean()
    assert agree >= 0.999, agree


def test_band_plan_ok_agrees_with_the_check():
    """band_plan_ok is False exactly where _band_plan raises on a frame with
    a uniform-band plan, over a scan of tall frames."""
    n_missed = n_ok = 0
    for h in range(1400, 1520, 2):
        for w, n_sp in ((16, 10), (16, 925), (77, 925), (270, 400)):
            bp = sf.slic_plan(h, w, n_sp)
            if bp is None or bp["w_rows"] == 0:
                assert not sf.band_plan_ok(h, w, n_sp)
                continue
            if sf.band_plan_ok(h, w, n_sp):
                sf._band_plan(h, w, n_sp)
                n_ok += 1
            else:
                with pytest.raises(ValueError, match="misses candidate rows"):
                    sf._band_plan(h, w, n_sp)
                n_missed += 1
    assert n_missed >= 1 and n_ok > 100
