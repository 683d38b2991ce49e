"""PyTorch port, the SLIC entry points the reference exposes (models/slic.py:
slic, slic_assign, enforce_connectivity_device; models/slic_fused.py:
slic_fused, slic_batch's ``impl``) against the JAX package's.

``slic`` on 64x96 mosaics equals the JAX ``slic`` on >= 0.999 of the pixels
(both are exact float32; the port's is bit-equal to the plain version of
K11), ``slic_assign`` gives the same labels on every pixel,
``enforce_connectivity_device`` the same bits. ``slic_fused`` and
``slic_batch(impl="fused")`` refuse exactly the frames the reference's
``slic_fused_eligible`` refuses: a grid too wide for any candidate window,
and a frame with only the 3-row plan above the whole-image gate; the gate
is lowered in both packages so that frames on both of its sides stay
small."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models import slic as jslic
from gabor_color_image_segmentation_tpu.models import slic_pallas as jsp
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import slic as tslic
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab

torch.set_num_threads(2)

H, W, N_SP = 64, 96, 64


@pytest.fixture(scope="module")
def labs():
    return np.stack([rgb_to_lab(torch.from_numpy(
        synthetic_mosaic(h=H, w=W, n_regions=4, seed=60 + i)[0])).numpy() for i in range(2)])


def test_slic_matches_jax(labs):
    for lab in labs:
        ref = np.asarray(jslic.slic(jnp.asarray(lab), N_SP, 10.0, 5))
        got = tslic.slic(torch.from_numpy(lab), N_SP, 10.0, 5)
        assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
        assert (got.numpy() == ref).mean() >= 0.999
        # on the CPU: the plain version of K11 on the batch of one
        assert torch.equal(got, tslic.slic_plain(torch.from_numpy(lab)[None], N_SP, 10.0, 5)[0])


def test_slic_assign_matches_jax(labs):
    rng = np.random.default_rng(3)
    gh, gw, sw = jslic.slic_geometry(H, W, N_SP, 10.0)
    for lab in labs:
        flat, z, neighbor = (np.array(a) for a in
                             jslic.slic_pixel_arrays(jnp.asarray(lab), H, W, gh, gw, sw))
        # centroids: the members' means of a random superpixel map, jittered
        sp = rng.integers(0, gh * gw, H * W)
        cent = np.stack([flat[sp == s].mean(0) if (sp == s).any() else flat[s]
                         for s in range(gh * gw)]).astype(np.float32)
        cent += rng.normal(scale=0.5, size=cent.shape).astype(np.float32)
        ref = np.asarray(jslic.slic_assign(jnp.asarray(z), jnp.asarray(cent),
                                           jnp.asarray(neighbor), sw))
        got = tslic.slic_assign(torch.from_numpy(z), torch.from_numpy(cent),
                                torch.from_numpy(neighbor), sw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


def test_enforce_connectivity_device_matches_jax(labs):
    gh, gw, _ = jslic.grid_shape(H, W, N_SP)
    rng = np.random.default_rng(8)
    maps = [np.asarray(jslic.slic(jnp.asarray(lab), N_SP, 10.0, 5)) for lab in labs]
    # fragmented: 4x4 blocks of random labels
    maps.append(rng.integers(0, gh * gw, (H // 4, W // 4)).repeat(4, 0).repeat(4, 1))
    labels = np.stack(maps).astype(np.int32)
    for min_size, s_max in ((None, None), (30, 40)):
        ref = np.asarray(jslic.enforce_connectivity_device(jnp.asarray(labels), gh * gw,
                                                           min_size, s_max))
        got = tslic.enforce_connectivity_device(torch.from_numpy(labels), gh * gw,
                                                min_size, s_max)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)


# (h, w, S) and whether the gate is lowered to GATE bytes: a uniform-band
# plan under the gate, the same above it (the banded loop), a frame with
# only the 3-row plan under and above it, and a grid too wide for any
# window (ineligible at any gate)
GATE = 400_000
FRAMES = [(48, 64, 48, True), (64, 96, 64, True), (40, 340, 136, False),
          (40, 340, 136, True), (30, 440, 132, False)]


@pytest.mark.parametrize("frame", FRAMES, ids=lambda f: "x".join(map(str, f[:3]))
                         + ("-gate" if f[3] else ""))
def test_slic_fused_refuses_what_the_reference_refuses(monkeypatch, frame):
    h, w, n_sp, low_gate = frame
    if low_gate:
        monkeypatch.setattr(sf, "_SLIC_FUSE_BYTES", GATE)
        monkeypatch.setattr(jsp, "_SLIC_FUSE_BYTES", GATE)
    eligible = jsp.slic_fused_eligible(h, w, n_sp)
    assert sf.slic_fused_eligible(h, w, n_sp) == eligible
    lab = torch.from_numpy(np.random.default_rng(h).uniform(0, 100, (1, h, w, 3))
                           .astype(np.float32))
    if eligible:
        want = sf.slic_banded_plain(lab, n_sp, 10.0, 1) if sf.slic_route(h, w, n_sp) == "banded" \
            else tslic.slic_plain(lab, n_sp, 10.0, 1)
        assert torch.equal(sf.slic_fused(lab, n_sp, 10.0, 1), want)
        for impl in ("auto", "xla", "fused"):
            assert torch.equal(sf.slic_batch(lab, n_sp, 10.0, 1, impl), want)
        return
    with pytest.raises(ValueError, match="eligible"):
        jsp.slic_fused(jnp.asarray(lab.numpy()), n_sp, 10.0, 1)
    with pytest.raises(ValueError, match="eligible"):
        jsp.slic_batch(jnp.asarray(lab.numpy()), n_sp, 10.0, 1, impl="fused")
    with pytest.raises(ValueError, match="eligible"):
        sf.slic_fused(lab, n_sp, 10.0, 1)
    with pytest.raises(ValueError, match="eligible"):
        sf.slic_batch(lab, n_sp, 10.0, 1, impl="fused")
    # "auto" and "xla" run the exact SLIC there, as the reference's XLA slic
    ref = np.asarray(jsp.slic_batch(jnp.asarray(lab.numpy()), n_sp, 10.0, 1, impl="xla"))
    for impl in ("auto", "xla"):
        got = sf.slic_batch(lab, n_sp, 10.0, 1, impl)
        assert (got.numpy() == ref).mean() >= 0.999


def test_slic_batch_impl_and_plan(monkeypatch, labs):
    lab = torch.from_numpy(labs)
    with pytest.raises(ValueError, match="unknown SLIC impl"):
        sf.slic_batch(lab, N_SP, 10.0, 1, impl="pallas")
    with pytest.raises(ValueError, match="unknown SLIC plan"):
        sf.slic_fused(lab, N_SP, 10.0, 1, plan="w4")
    # above the gate an explicit plan raises, as the reference's kernel path
    # does; "xla", the reference's exact path, takes no plan and runs
    monkeypatch.setattr(sf, "_SLIC_FUSE_BYTES", GATE)
    assert sf.slic_route(H, W, N_SP) == "banded"
    with pytest.raises(ValueError, match="plan-free"):
        sf.slic_batch(lab, N_SP, 10.0, 1, plan="w5")
    got = sf.slic_batch(lab, N_SP, 10.0, 1, "xla", "w5")
    assert torch.equal(got, sf.slic_batch(lab, N_SP, 10.0, 1))
