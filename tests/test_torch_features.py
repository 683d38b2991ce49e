"""PyTorch port: fused Gabor energies (kernel K1's plain version) and the
feature-assembly helpers, against the JAX package.

The JAX side runs its Pallas kernel in interpret mode on the CPU (as the
JAX package's own tests do). Tolerances: energies and twin within 1e-4 of
the peak in float32 and 2e-2 of the peak in bfloat16 (the repo's bf16
bound, tests/test_fused_pallas.py); in bf16 the port rounds where the TPU
kernel rounds its matmul operands, and test_torch_k1_rounding.py holds
those bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import BankConfig, ClusterConfig, preset
from gabor_color_image_segmentation_tpu.models import kmeans_chw as jchw
from gabor_color_image_segmentation_tpu.ops import features as jfeat
from gabor_color_image_segmentation_tpu.ops.bank import make_bank
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu.ops.fused_pallas import gabor_energies_fused as jax_fused
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as tchw
from gabor_color_image_segmentation_tpu_torch.ops import features as tfeat
from gabor_color_image_segmentation_tpu_torch.ops.bank import from_jax_bank
from gabor_color_image_segmentation_tpu_torch.ops.fused import gabor_energies_fused

torch.set_num_threads(2)

BANKS = {
    "diagonal": BankConfig(scales=(2.0, 3.0), orientations=3, frequencies=(0.12,)),
    "config0": preset("config0").bank,
}
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


@pytest.fixture(scope="module")
def lab2():
    from gabor_color_image_segmentation_tpu.data import synthetic_mosaic

    rgb = np.stack([synthetic_mosaic(h=48, w=64, n_regions=3, seed=3 + i)[0]
                    for i in range(2)])
    return np.asarray(rgb_to_lab(jnp.asarray(rgb)))


def _jax_energies(lab, bank, jdt):
    e, p = jax_fused(jnp.asarray(lab), bank, jdt, channel_major=True,
                     pooled=True, grouped=True)
    cat = lambda parts: np.concatenate([np.asarray(x, np.float32) for x in parts], 1)
    return cat(e), cat(p)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bank_name", sorted(BANKS))
def test_gabor_energies_match_pallas_kernel(lab2, bank_name, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    bank = make_bank(BANKS[bank_name])
    ref_e, ref_p = _jax_energies(lab2, bank, jdt)
    out_e, out_p = gabor_energies_fused(torch.from_numpy(lab2.copy()),
                                        from_jax_bank(bank, "cpu"), tdt)
    assert out_e.dtype == tdt and out_p.dtype == tdt
    assert tuple(out_e.shape) == ref_e.shape and tuple(out_p.shape) == ref_p.shape
    peak = float(np.abs(ref_e).max())
    np.testing.assert_allclose(out_e.float().numpy(), ref_e, atol=tol * peak, rtol=0)
    np.testing.assert_allclose(out_p.float().numpy(), ref_p, atol=tol * peak, rtol=0)


def test_gabor_energies_without_twin(lab2):
    bank = make_bank(BANKS["diagonal"])
    groups = from_jax_bank(bank, "cpu")
    x = torch.from_numpy(lab2.copy())
    full, twin = gabor_energies_fused(x, groups, torch.float32)
    alone, none = gabor_energies_fused(x, groups, torch.float32, pooled=False)
    assert none is None
    assert torch.equal(full, alone)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pool2x2_cm_matches(dtype):
    jdt, tdt, _ = DTYPES[dtype]
    x = np.random.default_rng(1).normal(size=(2, 5, 13, 18)).astype(np.float32)
    ref = np.asarray(jfeat._pool2x2_cm(jnp.asarray(x, jdt)), np.float32)
    out = tfeat._pool2x2_cm(torch.from_numpy(x).to(tdt))
    assert out.dtype == tdt
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def energies_f32(lab2):
    bank = make_bank(BANKS["config0"])
    return _jax_energies(lab2, bank, jnp.float32)


@pytest.mark.parametrize("cue", ["coherence", "static"])
@pytest.mark.parametrize("twin", [True, False])
def test_affine_params_with_coherence_fold(lab2, energies_f32, cue, twin):
    """Same raw buffers in: the standardisation affine with the coherence^4
    fold, from the kernel's twin or from full-resolution pooling."""
    e, p = energies_f32
    cfg = ClusterConfig(k=5, cue_weight=cue, coherence_pow=4.0)
    jc4 = jchw.build_color4(jnp.asarray(lab2), jnp.float32)
    pooled = (((jnp.asarray(p),), jfeat._pool2x2_cm(jc4)) if twin else None)
    ref_a, ref_b = jchw._affine_params((jnp.asarray(e),), jc4, cfg, 1e-6, pooled=pooled)
    tc4 = tchw.build_color4(torch.from_numpy(lab2.copy()), torch.float32)
    np.testing.assert_array_equal(tc4.numpy(), np.asarray(jc4))
    tpooled = (torch.from_numpy(p), tfeat._pool2x2_cm(tc4)) if twin else None
    a, b = tchw._affine_params(torch.from_numpy(e), tc4, cfg, 1e-6, pooled=tpooled)
    np.testing.assert_allclose(a.numpy(), np.asarray(ref_a), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(ref_b), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_assemble_xp_from_affine(lab2, energies_f32, dtype):
    """The port's coarse buffer equals the reference's xt-layout rows."""
    from gabor_color_image_segmentation_tpu.models.kmeans_pallas import xt_geometry

    jdt, tdt, _ = DTYPES[dtype]
    _, p = energies_f32
    rng = np.random.default_rng(2)
    e = p.shape[1]
    a = rng.uniform(0.5, 2.0, size=(2, e + 3)).astype(np.float32)
    b = rng.normal(size=(2, e + 3)).astype(np.float32)
    pc4 = jfeat._pool2x2_cm(jchw.build_color4(jnp.asarray(lab2), jnp.float32))
    m = p.shape[2] * p.shape[3]
    dp, m_pad, _ = xt_geometry(m, e + 3, jdt)
    ref = np.asarray(jfeat.assemble_xp_from_affine(
        jnp.asarray(p, jdt), pc4.astype(jdt), jnp.asarray(a), jnp.asarray(b),
        dp, m_pad, jdt), np.float32)
    out = tfeat.assemble_xp_from_affine(
        torch.from_numpy(p).to(tdt), torch.from_numpy(np.array(pc4)).to(tdt),
        torch.from_numpy(a), torch.from_numpy(b), tdt)
    assert out.dtype == tdt and tuple(out.shape) == (2, e + 3, m)
    np.testing.assert_array_equal(out.float().numpy(), ref[:, : e + 3, :m])
