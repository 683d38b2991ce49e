"""PyTorch port: Gabor bank, colour transform, the copies of the JAX
package's JAX-free modules, and the kernel build contract.

The port's numpy bank builder must give bitwise the JAX package's arrays
(the system's only parameters); rgb_to_lab agrees to 1e-4 absolute; the
port's config, synthetic data and label alignment equal the JAX package's.
The port imports neither JAX nor any module of the JAX package (checked in
a fresh interpreter and by scanning every import statement), and a kernel
wrapper handed anything but CPU tensors launches its kernel or raises: it
never falls back to the plain version."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu import config as jax_config
from gabor_color_image_segmentation_tpu.config import BankConfig, preset
from gabor_color_image_segmentation_tpu.data.synthetic import (
    synthetic_mosaic as jax_synthetic_mosaic,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from gabor_color_image_segmentation_tpu.ops.modulated import (
    _dc_mu,
    _envelope_taps,
    group_frequencies,
)
from gabor_color_image_segmentation_tpu.utils.labels import align_labels as jax_align_labels
from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch import config as tconfig
from gabor_color_image_segmentation_tpu_torch import data as tdata
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import lloyd_chw_pass
from gabor_color_image_segmentation_tpu_torch.ops import bank as tbank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu_torch.utils.labels import align_labels as talign

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


PORT = Path(__import__("gabor_color_image_segmentation_tpu_torch").__file__).parent
JAX_PKG = "gabor_color_image_segmentation_tpu"


def _port_modules():
    return sorted(
        ".".join(("gabor_color_image_segmentation_tpu_torch",)
                 + p.relative_to(PORT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py"))


def test_port_imports_without_jax():
    """Every module of the port imports, in a fresh interpreter, without
    loading jax, any module of the JAX package or of golden/ (the numpy
    oracle behind both)."""
    code = (
        "import importlib, sys\n"
        f"for name in {_port_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'golden')\n"
        f"             or m == {JAX_PKG!r} or m.startswith({JAX_PKG + '.'!r}))\n"
        "assert not bad, f'the port imported {bad}'\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


EVALUATION_SURFACE = ("metrics", "metrics.boundary", "metrics.pri", "metrics.region",
                      "data.bsds", "eval", "cli", "utils.native", "utils.visualize")


def test_import_checks_cover_the_evaluation_surface():
    """The fresh-interpreter check and the AST scan reach the metrics, the
    BSDS loader, eval, the CLI, the native matcher's loader and the
    visualisation, and the scan reaches chip_smoke.py."""
    modules = _port_modules()
    scanned = {str(p.relative_to(PORT.parent)) for p in PORT.rglob("*.py")}
    for name in EVALUATION_SURFACE:
        assert f"gabor_color_image_segmentation_tpu_torch.{name}" in modules, name
        path = "gabor_color_image_segmentation_tpu_torch/" + name.replace(".", "/")
        assert f"{path}.py" in scanned or f"{path}/__init__.py" in scanned, name
    assert (PORT.parent / "chip_smoke.py").exists()


@pytest.mark.parametrize("path", sorted(str(p.relative_to(PORT.parent))
                                        for p in [*PORT.rglob("*.py"),
                                                  PORT.parent / "chip_smoke.py"]))
def test_port_sources_import_no_jax(path):
    """No import statement of the port or of chip_smoke.py names jax, the
    JAX package or golden/, at any depth (function-local imports
    included)."""
    tree = ast.parse((PORT.parent / path).read_text())
    names = [a.name for node in ast.walk(tree) if isinstance(node, ast.Import)
             for a in node.names]
    names += [node.module or "" for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom)]
    bad = [m for m in names if m.split(".")[0] in ("jax", "jaxlib", "golden")
           or m == JAX_PKG or m.startswith(JAX_PKG + ".")]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_config_copies_match_jax(name):
    """The port's own config module equals the JAX package's, field for
    field: the five presets and every dataclass default."""
    assert sorted(tconfig.PRESETS) == sorted(jax_config.PRESETS)
    assert (dataclasses.asdict(tconfig.preset(name))
            == dataclasses.asdict(jax_config.preset(name)))
    for cls in ("BankConfig", "ClusterConfig", "GraphConfig", "PipelineConfig"):
        assert (dataclasses.asdict(getattr(tconfig, cls)())
                == dataclasses.asdict(getattr(jax_config, cls)()))
    bank = tconfig.preset(name).bank
    assert bank.kernel_params() == jax_config.preset(name).bank.kernel_params()
    assert bank.max_halo == jax_config.preset(name).bank.max_halo


def test_data_and_label_copies_match_jax():
    """synthetic_mosaic gives bitwise the JAX package's images and ground
    truth; align_labels the same permutation."""
    for kw in ({"h": 37, "w": 53, "n_regions": 4, "seed": 3},
               {"h": 40, "w": 30, "seed": 9, "texture_only": True}):
        for got, ref in zip(tdata.synthetic_mosaic(**kw), jax_synthetic_mosaic(**kw)):
            np.testing.assert_array_equal(got, ref)
    rng = np.random.default_rng(0)
    a, b = rng.integers(0, 5, size=(2, 40, 50))
    np.testing.assert_array_equal(talign(a, b), jax_align_labels(a, b))


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
