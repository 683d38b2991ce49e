"""PyTorch port, config2's kernels and solvers against the JAX package on the
CPU (its Pallas kernels in interpret mode): K5 (Lloyd pass), K6 (maximin
step and seeding), K8 (E+M pass), K9 (precision Cholesky), K10 (moments ->
parameters -> factorisation), and the solvers kmeans_fused_t_xt and
gmm_fused_t_xt, the latter also with the ``_FUSED_PREP`` switch on.

The same numpy inputs go to both: the JAX side in its padded transposed
layout (ones-row, TPU padding), the port in its (B, D, N) layout.
Tolerances: K5 labels equal on >= 99.99 % of pixels, sums within rtol 1e-4
(f32) / 1e-3 (bf16); K6 picks the same pixels, running minima within rtol
1e-5; K8 labels on >= 99.99 %, the log-likelihood within rtol 1e-5, sums,
counts and scatter within rtol 1e-4; K9 within 5e-4 relative
(tests/test_chol_pallas.py's bound), and K10's bias within 2e-4 and its
const within 1e-5 relative (that test's bounds); the solvers' labels agree
on >= 99.9 % after alignment. K8's host-side plan (its moments tile map,
the unpacking of its tile layout and its blocks) is checked exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models import gmm_pallas as jgmm
from gabor_color_image_segmentation_tpu.models import kmeans_pallas as jkp
from gabor_color_image_segmentation_tpu.models.chol_pallas import (
    precision_chol_pallas,
    precision_chol_params_pallas,
)
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.models import chol
from gabor_color_image_segmentation_tpu_torch.models import gmm_fused as gf
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _blobs(b=2, n=3000, d=12, k=4, seed=0):
    """(B, N, D) float32 features: k Gaussian blobs per image."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=2.5, size=(b, k, d))
    lab = rng.integers(0, k, size=(b, n))
    x = np.take_along_axis(means, lab[:, :, None], 1)
    return (x + rng.normal(size=(b, n, d)) * rng.uniform(0.5, 1.5, size=(b, 1, d))
            ).astype(np.float32)


def _both(x, dtype):
    """(B, N, D) numpy -> (JAX padded xt, the port's (B, D, N) tensor) with
    identical values in the storage dtype."""
    jdt, tdt = DTYPES[dtype]
    xt = jkp.build_xt(jnp.asarray(x), jdt)
    return xt, torch.from_numpy(np.swapaxes(np.asarray(jnp.asarray(x, jdt), np.float32),
                                            1, 2).copy()).to(tdt)


def _np(t):
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lloyd_t_pass_matches_kernel(dtype):
    x = _blobs(seed=1)
    b, n, d = x.shape
    xt, xb = _both(x, dtype)
    dp, _, block = jkp.xt_geometry(n, d, DTYPES[dtype][0])
    centers = x[:, :5] + 0.05  # (B, 5, D)
    cpad = jnp.zeros((b, 8, dp), jnp.float32).at[:, :5, :d].set(centers)
    ref_l, ref_s = jkp._lloyd_t_pass(xt, cpad, 5, block, n, True)
    labels, sums, counts = kf.lloyd_t_pass(xb, torch.from_numpy(centers))
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (b, n)
    assert (labels.numpy() == np.asarray(ref_l)[:, :n]).mean() >= 0.9999
    rtol = 1e-4 if dtype == "float32" else 1e-3
    ref_sums = _np(ref_s)[:, :5, :d]
    np.testing.assert_allclose(sums.numpy(), ref_sums, rtol=rtol,
                               atol=rtol * np.abs(ref_sums).max())
    np.testing.assert_array_equal(counts.numpy(), _np(ref_s)[:, :5, d])
    only = kf.lloyd_t_pass(xb, torch.from_numpy(centers), assign_only=True)
    assert torch.equal(only, labels)


# (dtype, (B, N, D), running minima's atol: absolute, share of the largest
# distance): config2-like rows, and rows past the 10,240 the card's K6 once
# took, at a size interpret mode affords. Wide rows are held as chip_smoke.py
# holds the card's K6: the expanded form cancels near the probe by ~eps
# ||x||^2 (2e-3 at D = 700), so the bound is a share of the largest distance.
MAXIMIN_T_CASES = [("bfloat16", (2, 3000, 12), (1e-4, 0.0)),
                   ("float32", (2, 3000, 12), (1e-4, 0.0)),
                   ("bfloat16", (1, 300, 700), (0.0, 1e-5)),
                   ("float32", (1, 300, 700), (0.0, 1e-5))]


@pytest.mark.parametrize("dtype, shape, atol", MAXIMIN_T_CASES,
                         ids=["bfloat16", "float32", "bfloat16-d700", "float32-d700"])
def test_maximin_t_pass_matches_kernel(dtype, shape, atol):
    x = _blobs(*shape, seed=2)
    b, n, d = x.shape
    xt, xb = _both(x, dtype)
    dp, n_pad, block = jkp.xt_geometry(n, d, DTYPES[dtype][0])
    probe_j = jnp.sum(xt, axis=2, dtype=jnp.float32) / n  # extended mean
    probe_t = torch.from_numpy(_np(probe_j)[:, :d].copy())
    dmin_j = jnp.zeros((b, n_pad), jnp.float32)
    dmin_t = torch.zeros((b, n))
    for step in range(5):
        c8 = jnp.zeros((b, 8, dp), jnp.float32).at[:, 0].set(probe_j)
        dmin_j, probe_j = jkp._maximin_pass(xt, c8, dmin_j, step < 2, block, n, True)
        probe_t = kf.maximin_t_pass(xb, probe_t, dmin_t, step < 2)
        np.testing.assert_array_equal(probe_t.numpy(), _np(probe_j)[:, :d])
        ref = _np(dmin_j)[:, :n]
        np.testing.assert_allclose(dmin_t.numpy(), ref, rtol=1e-5,
                                   atol=atol[0] + atol[1] * np.abs(ref).max())
    ref = jkp._maximin_init_t_fused(xt, 5, n, block, True)
    np.testing.assert_array_equal(kf._maximin_init_t_fused(xb, 5).numpy(),
                                  _np(ref)[:, :, :d])


def _gmm_params(xb, k=4, seed=3):
    """float32 (weights, means, covs) from a hard random split of xb."""
    b, _, n = xb.shape
    labels = torch.from_numpy(np.random.default_rng(seed).integers(0, k, size=(b, n)))
    return gf._moments_to_params(*gf._init_moments(xb, labels, k), n, 1e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_em_pass_matches_kernel(dtype):
    _check_em_pass(dtype, _blobs(seed=4))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_em_pass_matches_kernel_wide(dtype):
    """A 16-kernel bank's 51 feature rows, which the card's wide K8 kernel
    takes."""
    _check_em_pass(dtype, _blobs(n=1500, d=51, seed=51))


def _check_em_pass(dtype, x):
    b, n, d = x.shape
    k = 4
    xt, xb = _both(x, dtype)
    dp, _, block = jkp.xt_geometry(n, d, DTYPES[dtype][0])
    pt, bias, const = gf._params_to_kernel_inputs(*_gmm_params(xb, k))
    a = jnp.zeros((b, k, dp, dp), jnp.float32).at[:, :, :d, :d].set(pt.numpy())
    bias_j = jnp.zeros((b, k, dp), jnp.float32).at[:, :, :d].set(bias.numpy())
    const_j = jnp.zeros((b, 8, 1), jnp.float32).at[:, :k, 0].set(const.numpy())
    ref_l, ref_ll, ref_ms, ref_cov = jgmm._em_pass(
        xt, a.reshape(b, k * dp, dp), bias_j.reshape(b, k * dp, 1), const_j, k, block,
        n, True, d)
    labels, ll, counts, sums, scatter = gf.em_pass(xb, pt, bias, const)
    assert (labels.numpy() == np.asarray(ref_l)[:, :n]).mean() >= 0.9999
    np.testing.assert_allclose(ll.numpy(), _np(ref_ll), rtol=1e-5)
    for got, ref in ((counts, _np(ref_ms)[:, :k, d]), (sums, _np(ref_ms)[:, :k, :d]),
                     (scatter, _np(ref_cov)[:, :, :d, :d])):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref).max())
    only = gf.em_pass(xb, pt, bias, const, moments=False)
    ref_only, *_ = jgmm._em_pass(xt, a.reshape(b, k * dp, dp), bias_j.reshape(b, k * dp, 1),
                                 const_j, k, block, n, True, d, False)
    assert torch.equal(only, labels)
    assert (only.numpy() == np.asarray(ref_only)[:, :n]).mean() >= 0.9999


def test_precision_chol_matches_kernel():
    """K9's plain version against the Pallas kernel at config2's order,
    d = 39, M = 10 matrices (tests/test_chol_pallas.py's matrices)."""
    rng = np.random.default_rng(7)
    d = 39
    a = rng.standard_normal((10, d, d + 8))
    cov = (a @ a.transpose(0, 2, 1) / (d + 8) + 1e-2 * np.eye(d)).astype(np.float32)
    ref_pt, ref_diag = precision_chol_pallas(jnp.asarray(cov), d=d)
    pt, diag = chol.precision_chol(torch.from_numpy(cov))
    rel = np.abs(pt.numpy() - _np(ref_pt)) / (np.abs(_np(ref_pt)) + 1e-3)
    assert rel.max() < 5e-4, rel.max()
    np.testing.assert_allclose(diag.numpy(), _np(ref_diag), rtol=1e-5)
    assert np.abs(np.triu(pt.numpy(), 1)).max() == 0.0


def test_precision_chol_matches_kernel_wide():
    """K9's plain version against the Pallas kernel at a 16-kernel bank's
    d = 51, past the 40 rows of the card's first EM kernel (2d samples keep
    cond near 34, so float32 rounding stays far below the bound; the
    reference's interpret mode takes ~80 s at d = 128, which the card tests
    cover)."""
    rng = np.random.default_rng(51)
    d = 51
    a = rng.standard_normal((4, d, 2 * d))
    cov = (a @ a.transpose(0, 2, 1) / (2 * d) + 1e-3 * np.eye(d)).astype(np.float32)
    ref_pt, ref_diag = precision_chol_pallas(jnp.asarray(cov), d=d)
    pt, diag = chol.precision_chol(torch.from_numpy(cov))
    rel = np.abs(pt.numpy() - _np(ref_pt)[:, :d, :d]) / (np.abs(_np(ref_pt)[:, :d, :d]) + 1e-3)
    assert rel.max() < 5e-4, rel.max()
    np.testing.assert_allclose(diag.numpy(), _np(ref_diag)[:, :d], rtol=1e-5)
    assert np.abs(np.triu(pt.numpy(), 1)).max() == 0.0


def test_precision_chol_params_matches_kernel_wide():
    """K10's plain version against the Pallas kernel at a 16-kernel bank's
    d = 51 (dp = 56), B = 1, k = 3, 2,000 pixels."""
    rng = np.random.default_rng(51)
    b, k, d, dp, m_rows = 1, 3, 51, 56, 2000
    xe = np.zeros((b, m_rows, dp))
    xe[:, :, :d] = rng.normal(size=(b, m_rows, d))
    xe[:, :, d] = 1.0
    resp = rng.random((b, k, m_rows)) + 0.05
    covs_m = np.einsum("bkn,bni,bnj->bkij", resp, xe, xe).astype(np.float32)
    ref_pt, _, ref_bias, ref_const = precision_chol_params_pallas(
        jnp.asarray(covs_m), d, m_rows, 1e-4)
    counts, sums, scatter = (torch.from_numpy(a.copy()) for a in (
        covs_m[:, :, d, d], covs_m[:, :, d, :d], covs_m[:, :, :d, :d]))
    pt, bias, const = chol.precision_chol_params(counts, sums, scatter, m_rows, 1e-4)
    want = _np(ref_pt).reshape(b, k, dp, 128)[:, :, :d, :d]
    rel = np.abs(pt.numpy() - want) / (np.abs(want) + 1e-3)
    assert rel.max() < 5e-4, rel.max()
    np.testing.assert_allclose(bias.numpy(), _np(ref_bias).reshape(b, k, dp)[:, :, :d],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(const.numpy(), _np(ref_const)[:, 0].reshape(b, k),
                               rtol=1e-5, atol=1e-4)


def _aligned(got, ref):
    return min(float((align_labels(got[i], ref[i]) == ref[i]).mean())
               for i in range(len(ref)))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kmeans_fused_t_xt_matches_jax(dtype):
    x = _blobs(seed=5)
    b, n, d = x.shape
    xt, xb = _both(x, dtype)
    ref_l, ref_c = jkp.kmeans_fused_t_xt(xt, 5, d, n, 10)
    labels, centers = kf.kmeans_fused_t_xt(xb, 5, 10)
    assert (labels.numpy() == np.asarray(ref_l)).mean() >= 0.9999
    np.testing.assert_allclose(centers.numpy(), _np(ref_c), rtol=1e-4, atol=1e-4)


def _pool(x, h, w):
    """(B, h*w, D) -> (B, (h/2)*(w/2), D) exact 2x2 block means."""
    b, _, d = x.shape
    g = x.reshape(b, h // 2, 2, w // 2, 2, d)
    return ((g[:, :, 0, :, 0] + g[:, :, 0, :, 1]) + (g[:, :, 1, :, 0] + g[:, :, 1, :, 1])
            ).reshape(b, -1, d) * np.float32(0.25)


@pytest.mark.parametrize("pooled", [False, True])
def test_gmm_fused_t_xt_matches_jax(pooled):
    """The whole solver with the tol freeze, fitted on the buffer itself or
    on its 2x2-pooled grid with one full-resolution refine pass."""
    h, w, d, k = 128, 128, 8, 4
    x = _blobs(n=h * w, d=d, k=k, seed=6)
    b, n, _ = x.shape
    xt, xb = _both(x, "float32")
    if pooled:
        fit = _pool(x, h, w)
        fit_xp, fit_t = _both(fit, "float32")
        ref = jgmm.gmm_fused_t_xt(xt, k, d, n, 15, 1e-4, 10, 1e-3, (h, w), 1, fit_xp, 1)
        labels = gf.gmm_fused_t_xt(xb, k, 15, 1e-4, 10, 1e-3, fit_t, 1)
    else:
        ref = jgmm.gmm_fused_t_xt(xt, k, d, n, 15, 1e-4, 10, 1e-3)
        labels = gf.gmm_fused_t_xt(xb, k, 15, 1e-4, 10, 1e-3)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (b, n)
    assert _aligned(labels.numpy(), np.asarray(ref)) >= 0.999


def test_precision_chol_params_matches_kernel():
    """K10's plain version against the Pallas kernel on
    tests/test_chol_pallas.py's moments at config2's order: B = 2, k = 5,
    d = 39, 9801 pixels, the ones-extended scatter split into EM's
    (counts, sums, scatter)."""
    rng = np.random.default_rng(3)
    b, k, d, dp, m_rows = 2, 5, 39, 48, 9801
    xe = np.zeros((b, m_rows, dp))
    xe[:, :, :d] = rng.normal(size=(b, m_rows, d))
    xe[:, :, d] = 1.0
    resp = rng.random((b, k, m_rows)) + 0.05
    covs_m = np.einsum("bkn,bni,bnj->bkij", resp, xe, xe).astype(np.float32)
    ref_pt, _, ref_bias, ref_const = precision_chol_params_pallas(
        jnp.asarray(covs_m), d, m_rows, 1e-4)
    counts, sums, scatter = (torch.from_numpy(a.copy()) for a in (
        covs_m[:, :, d, d], covs_m[:, :, d, :d], covs_m[:, :, :d, :d]))
    pt, bias, const = chol.precision_chol_params(counts, sums, scatter, m_rows, 1e-4)
    assert pt.shape == (b, k, d, d) and bias.shape == (b, k, d) and const.shape == (b, k)
    want = _np(ref_pt).reshape(b, k, dp, 128)[:, :, :d, :d]
    rel = np.abs(pt.numpy() - want) / (np.abs(want) + 1e-3)
    assert rel.max() < 5e-4, rel.max()
    np.testing.assert_allclose(bias.numpy(), _np(ref_bias).reshape(b, k, dp)[:, :, :d],
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(const.numpy(), _np(ref_const)[:, 0].reshape(b, k),
                               rtol=1e-5, atol=1e-4)
    # the plain version is the solver's own chain, bit for bit
    chain = gf._params_to_kernel_inputs(*gf._moments_to_params(counts, sums, scatter,
                                                                m_rows, 1e-4))
    assert all(torch.equal(a, r) for a, r in zip((pt, bias, const), chain))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gmm_fused_prep_matches_standard_loop(dtype, monkeypatch):
    """The port's solver with ``_FUSED_PREP`` on (the moments carried, K8's
    inputs from K10) against the switch off, with the tol freeze, fitted on
    the 2x2-pooled grid with one refine pass."""
    h, w, d, k = 96, 96, 8, 4
    x = _blobs(n=h * w, d=d, k=k, seed=8)
    _, xb = _both(x, dtype)
    _, fit = _both(_pool(x, h, w), dtype)
    off = gf.gmm_fused_t_xt(xb, k, 12, 1e-4, 10, 1e-3, fit, 1)
    monkeypatch.setattr(gf, "_FUSED_PREP", True)
    on = gf.gmm_fused_t_xt(xb, k, 12, 1e-4, 10, 1e-3, fit, 1)
    assert _aligned(on.numpy(), off.numpy()) >= 0.999


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gmm_fused_prep_matches_jax(dtype, monkeypatch):
    """Both packages with the switch on (the JAX package's forced as
    tests/test_gmm.py::test_fused_prep_matches_standard_loop forces it, its
    K10 in interpret mode): tests/test_gmm.py's three blobs, 8 EM
    iterations, tol 1e-3."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(size=(500, 6)) + np.array([3, 0, 0, 0, 0, 0.0]),
                        rng.normal(size=(500, 6)) + np.array([0, 3, 0, 0, 0, 0.0]),
                        rng.normal(size=(500, 6)) - 2.0]).astype(np.float32)
    xs = np.stack([x, x[::-1]])
    b, n, d = xs.shape
    xt, xb = _both(xs, dtype)
    monkeypatch.setattr(jgmm, "_use_fused_prep", lambda: True)
    jgmm.gmm_fused_t_xt.clear_cache()
    try:
        ref = jgmm.gmm_fused_t_xt(xt, 3, d, n, 8, 1e-4, 10, 1e-3)
    finally:
        jgmm.gmm_fused_t_xt.clear_cache()
    monkeypatch.setattr(gf, "_FUSED_PREP", True)
    labels = gf.gmm_fused_t_xt(xb, 3, 8, 1e-4, 10, 1e-3)
    assert _aligned(labels.numpy(), np.asarray(ref)) >= 0.999


@pytest.mark.parametrize("d", [3, 39, 40])
def test_em_tile_map_covers_the_triangle(d):
    """Every lower entry (a >= c) of the extended (d + 1) x (d + 1) scatter
    lies in the lower part of exactly one of K8's tiles; the tiles start on
    float4 boundaries inside the kernel's 52-float columns, and k <= 8
    components need at most the kernel's 320 threads."""
    e = d + 1
    ta, tc = gf._EM_TILE
    cover = np.zeros((e, e), int)
    for a0, c0 in gf.tile_map(d):
        assert a0 % ta == 0 and c0 % tc == 0 and ta % 4 == 0 and tc % 4 == 0
        assert a0 + ta <= 52 and c0 + tc <= 52
        for a in range(a0, min(a0 + ta, e)):
            for c in range(c0, min(c0 + tc, a + 1)):
                cover[a, c] += 1
    assert np.array_equal(cover, np.tril(np.ones((e, e), int)))
    assert 8 * len(gf.tile_map(d)) <= 320


@pytest.mark.parametrize("d", [41, 51, 123, 128])
def test_em_wide_columns_hold_every_tile(d):
    """The wide kernel (D > 40): its chunks of 256 pixels, and its columns
    in shared memory hold every tile's rows and columns at a stride of 4
    (mod 8) floats; the tiles cover the triangle as for the first kernel."""
    assert gf.em_chunk(d) == 256 and gf.em_chunk(gf.D_REGS) == 640
    stride = gf.em_wide_stride(d)
    assert stride % 8 == 4 and stride >= d + 1
    ta, tc = gf._EM_TILE
    e = d + 1
    cover = np.zeros((e, e), int)
    for a0, c0 in gf.tile_map(d):
        assert a0 + ta <= stride and c0 + tc <= stride and a0 < 256 and c0 < 256
        for a in range(a0, min(a0 + ta, e)):
            for c in range(c0, min(c0 + tc, a + 1)):
                cover[a, c] += 1
    assert np.array_equal(cover, np.tril(np.ones((e, e), int)))


@pytest.mark.parametrize("d", [3, 39, 40, 51, 123])
@pytest.mark.parametrize("k", [1, 5, 8])
def test_em_unpack_reads_the_tile_layout(d, k):
    """The wrapper's unpacking of K8's packed moments, on moments packed the
    way the kernel writes them (tile t's entry (i, c) at ta tc t + tc i + c
    of each component's block, ta x tc tiles): the scatter, sums and counts
    come back exactly as the plain version computes them."""
    rng = np.random.default_rng(d * 10 + k)
    b, n = 2, 50
    # small integers: every sum is exact, so the scatter is exactly symmetric
    x = torch.from_numpy(rng.integers(-8, 9, size=(b, d, n)).astype(np.float64))
    resp = torch.from_numpy(rng.integers(0, 5, size=(b, k, n)).astype(np.float64))
    xe = torch.cat([x, torch.ones(b, 1, n, dtype=x.dtype)], dim=1)  # (B, d + 1, N)
    full = torch.einsum("bjn,ban,bcn->bjac", resp, xe, xe)  # extended scatter
    tiles = gf.tile_map(d)
    ta, tc = gf._EM_TILE
    packed = torch.zeros(b, k, len(tiles) * ta * tc, dtype=x.dtype)
    for t, (a0, c0) in enumerate(tiles):
        for i in range(ta):
            for c in range(tc):
                if a0 + i <= d and c0 + c <= d:
                    packed[:, :, ta * tc * t + tc * i + c] = full[:, :, a0 + i, c0 + c]
    scat_idx, sums_idx, count_idx, per = gf._unpack_index(d, "cpu")
    assert per == packed.shape[2]
    assert torch.equal(packed[:, :, scat_idx], full[:, :, :d, :d])
    assert torch.equal(packed[:, :, sums_idx], full[:, :, d, :d])
    assert torch.equal(packed[:, :, count_idx], full[:, :, d, d])


@pytest.mark.parametrize("b, n, n_sm, expect", [
    (8, 9600, 132, (1, 15)),  # config2's fit grid: 120 blocks
    (8, 154401, 132, (16, 16)),  # config2's full resolution: 128 blocks
    (1, 257, 132, (1, 1)),
    (1, 154401, 132, (2, 121)),
    (200, 3001, 132, (5, 1)),  # the batch alone fills the card
])
def test_em_plan(b, n, n_sm, expect):
    """K8's plan: every chunk in exactly one block, about one wave of
    blocks."""
    chunks, nblk = gf.em_plan(b, n, n_sm)
    assert (chunks, nblk) == expect
    nchunks = -(-n // 640)
    assert (nblk - 1) * chunks < nchunks <= nblk * chunks
    assert b * nblk <= max(n_sm, b)


@pytest.mark.parametrize("b, n, n_sm, expect", [
    (8, 9600, 132, (3, 13)),  # config2's fit grid, 38 chunks of 256 an image
    (8, 154401, 132, (38, 16)),
    (1, 257, 132, (1, 2)),
])
def test_em_plan_wide(b, n, n_sm, expect):
    chunks, nblk = gf.em_plan(b, n, n_sm, gf.em_chunk(51))
    assert (chunks, nblk) == expect
    nchunks = -(-n // 256)
    assert (nblk - 1) * chunks < nchunks <= nblk * chunks
