"""PyTorch port: Gabor bank, colour transform and the kernel build contract.

The port's numpy bank builder must give bitwise the JAX package's arrays
(the system's only parameters); rgb_to_lab agrees to 1e-4 absolute. The
port imports without JAX, and a kernel wrapper handed anything but CPU
tensors launches its kernel or raises: it never falls back to the plain
version."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import BankConfig, preset
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from gabor_color_image_segmentation_tpu.ops.modulated import (
    _dc_mu,
    _envelope_taps,
    group_frequencies,
)
from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import lloyd_chw_pass
from gabor_color_image_segmentation_tpu_torch.ops import bank as tbank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab

torch.set_num_threads(2)

# 3 orientations: diagonal thetas (the reflected-border case), as in
# tests/test_fused_pallas.py
DIAGONAL = BankConfig(scales=(2.0, 3.0), orientations=3, frequencies=(0.12,))
BANKS = {
    "config0": preset("config0").bank,
    "config1": preset("config1").bank,
    "diagonal": DIAGONAL,
}


@pytest.mark.parametrize("name", sorted(BANKS))
def test_make_bank_bitwise(name):
    cfg = BANKS[name]
    ref, port = jax_make_bank(cfg), tbank.make_bank(cfg)
    assert port.n_kernels == ref.n_kernels
    assert len(port.groups) == len(ref.groups)
    for gr, gp in zip(ref.groups, port.groups):
        assert (gp.sigma, gp.ksize, gp.smooth_sigma, gp.smooth_radius) == (
            gr.sigma, gr.ksize, gr.smooth_sigma, gr.smooth_radius)
        assert gp.kernel_indices == gr.kernel_indices
        np.testing.assert_array_equal(gp.filters_hwio, gr.filters_hwio)
        np.testing.assert_array_equal(gp.smooth_taps, gr.smooth_taps)
        assert gp.filters_hwio.dtype == gr.filters_hwio.dtype
        p = gr.ksize // 2
        np.testing.assert_array_equal(tbank._envelope_taps(gr.sigma, p),
                                      _envelope_taps(gr.sigma, p))
        np.testing.assert_array_equal(tbank.group_frequencies(gp, port),
                                      group_frequencies(gr, ref))
        np.testing.assert_array_equal(tbank._dc_mu(gp, port), _dc_mu(gr, ref))


@pytest.mark.parametrize("name", sorted(BANKS))
def test_from_jax_bank_matches_port_bank(name):
    """The JAX bank read duck-typed gives the port bank's tensors, which
    are the fused kernel's float32 parameters."""
    cfg = BANKS[name]
    ref = tbank.from_jax_bank(jax_make_bank(cfg), "cpu")
    port = tbank.bank_tensors(tbank.make_bank(cfg), "cpu")
    jb = jax_make_bank(cfg)
    for gt, gp, g in zip(ref, port, jb.groups):
        assert (gt.n, gt.p, gt.r) == (gp.n, gp.p, gp.r)
        assert (gt.n, gt.p, gt.r) == (len(g.kernel_indices), g.ksize // 2,
                                      g.smooth_radius)
        for f in ("env", "freqs", "mus", "smooth"):
            a, b = getattr(gt, f), getattr(gp, f)
            assert a.dtype == torch.float32 and torch.equal(a, b), f
        np.testing.assert_array_equal(
            gt.freqs.numpy(), group_frequencies(g, jb).astype(np.float32))
        np.testing.assert_array_equal(gt.smooth.numpy(), g.smooth_taps)


def test_rgb_to_lab_matches_jax(small_mosaic):
    rgb, _ = small_mosaic
    rng = np.random.default_rng(0)
    cases = [rgb, rng.integers(0, 256, size=(2, 17, 23, 3), dtype=np.uint8),
             rng.uniform(0.0, 1.0, size=(5, 7, 3)).astype(np.float32)]
    for x in cases:
        ref = np.asarray(jax_rgb_to_lab(jnp.asarray(x)))
        out = rgb_to_lab(torch.from_numpy(x.copy()))
        assert out.dtype == torch.float32 and out.shape == ref.shape
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-4, rtol=0)


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import gabor_color_image_segmentation_tpu_torch.models.pipeline\n"
        "import gabor_color_image_segmentation_tpu_torch.models.kmeans\n"
        "assert 'jax' not in sys.modules, 'the port imported jax'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def _lloyd_inputs(device):
    xe = torch.zeros((1, 2, 4, 4), device=device)
    xc4 = torch.zeros((1, 4, 4, 4), device=device)
    return xe, xc4, torch.zeros((1, 2, 5), device=device), torch.zeros((1, 2), device=device)


def test_wrapper_raises_off_cpu_instead_of_falling_back():
    """A tensor that is not on the CPU never takes the plain version."""
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        lloyd_chw_pass(*_lloyd_inputs("meta"))
    xe, xc4, wc, offs = _lloyd_inputs("cpu")
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        lloyd_chw_pass(xe, xc4, wc.to("meta"), offs)


def test_wrapper_raises_without_nvcc(monkeypatch, tmp_path):
    """With the CUDA route chosen and no nvcc, the wrapper raises a clear
    error; it does not catch it and run the plain version."""
    monkeypatch.setattr(_kernels, "_find_nvcc", lambda: None)
    monkeypatch.setattr(_kernels, "library_path", lambda: tmp_path / "none.so")
    monkeypatch.setattr(_kernels, "use_plain", lambda *t: False)
    _kernels.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="need nvcc"):
            lloyd_chw_pass(*_lloyd_inputs("cpu"))
    finally:
        _kernels.library.cache_clear()
