"""PyTorch port: the with-features path's GMM solvers against the JAX
package's: the plain ``models/gmm.py::gmm_fit`` / ``gmm_predict`` (the
reference's XLA solver, with ``tol``, ``fit_pool`` + ``refine_iters`` and
``subsample``) and ``models/gmm_fused.py::gmm_fused_t`` (its fit buffer
pooled from the flat features; the JAX one with its Pallas kernels in
interpret mode).

Inputs: the port's config2 features of synthetic mosaics (seeds 106+),
64x96 frames. Bounds: labels >= 0.99 after Hungarian alignment; the plain
solver's responsibilities within 1e-3 (absolute) of the reference's on
99.5 % of the pixels and within 2e-2 on all (float32 EM on both sides,
summed in another order: a boundary pixel's responsibility moves with the
last bits of its Mahalanobis distances, ~1e3 at D = 39), columns matched
by the labels' Hungarian alignment. With ``tol`` the stop compares two
float32 mean log-likelihoods whose last bits differ between the two
implementations, so an image may stop one iteration apart (measured on
these inputs: after 23 and 24 iterations); that case holds the
responsibilities within 1e-3 on 99 % of the pixels, with no bound on the
rest, and the freeze itself exactly against the port's fixed count."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import gmm as tg
from gabor_color_image_segmentation_tpu_torch.models.gmm_fused import gmm_fused_t
from gabor_color_image_segmentation_tpu_torch.models.pipeline import compute_features
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

jg = importlib.import_module("gabor_color_image_segmentation_tpu.models.gmm")
jgp = importlib.import_module("gabor_color_image_segmentation_tpu.models.gmm_pallas")

torch.set_num_threads(2)

HW = (64, 96)
FLOOR = 0.99
RESP_TOL = 1e-3

# gmm_fit's (n_iter, tol, hw, fit_pool, refine_iters), then the share of
# pixels whose responsibilities lie within RESP_TOL and the bound on all
FITS = {
    "plain": (12, 0.0, None, 0, 0, 0.995, 2e-2),
    "tol": (30, 1e-3, None, 0, 0, 0.99, 1.0),
    "fit_pool_refine": (12, 0.0, HW, 1, 1, 0.995, 2e-2),
}


@pytest.fixture(scope="module")
def features():
    cfg = preset("config2").replace(batch_size=2)
    rgb = np.stack([synthetic_mosaic(h=HW[0], w=HW[1], n_regions=5, seed=106 + i)[0]
                    for i in range(2)])
    feats = compute_features(torch.from_numpy(rgb), cfg, make_bank(cfg.bank))
    return feats.reshape(2, HW[0] * HW[1], -1).contiguous().numpy()


def _aligned(got, ref):
    """(aligned labels, per-image agreement)."""
    al = np.stack([align_labels(got[i], ref[i]) for i in range(len(ref))])
    return al, [float((al[i] == ref[i]).mean()) for i in range(len(ref))]


def _matching(got, ref, k):
    """got's component j -> ref's, the Hungarian matching of the labels."""
    from scipy.optimize import linear_sum_assignment

    cont = np.zeros((k, k))
    np.add.at(cont, (got, ref), 1)
    rows, cols = linear_sum_assignment(-cont)
    return dict(zip(rows.tolist(), cols.tolist()))


@pytest.mark.parametrize("case", sorted(FITS))
def test_gmm_fit_matches_jax(features, case):
    n_iter, tol, hw, fit_pool, refine, share, most = FITS[case]
    fit = jax.vmap(lambda f: jg.gmm_fit(f, 5, n_iter, 1e-4, 10, tol, hw, fit_pool, refine))
    ref_l, ref_r, _ = fit(jnp.asarray(features))
    ref_l, ref_r = np.asarray(ref_l), np.asarray(ref_r)
    labels, resp, params = tg.gmm_fit(torch.from_numpy(features), 5, n_iter, 1e-4, 10, tol, hw,
                                      fit_pool, refine)
    assert labels.dtype == torch.int32 and tuple(resp.shape) == ref_r.shape
    assert tuple(params.covs.shape) == (2, 5, features.shape[2], features.shape[2])
    _, agree = _aligned(labels.numpy(), ref_l)
    assert min(agree) >= FLOOR, agree
    for i in range(2):
        match = _matching(labels[i].numpy(), ref_l[i], 5)
        err = np.abs(resp[i].numpy() - ref_r[i][:, [match[j] for j in range(5)]])
        assert (err.max(axis=1) <= RESP_TOL).mean() >= share and err.max() <= most, (
            i, err.max(), (err.max(axis=1) > RESP_TOL).mean())


def test_gmm_fit_tol_freezes_each_image(features):
    """With tol an image stops after iteration t + 1, t the first iteration
    whose mean log-likelihood (of the parameters after t iterations) moved
    by less than tol from the one before: its responsibilities equal the
    fixed-count fit of t + 1 iterations, image by image."""
    x = torch.from_numpy(features)
    _, resp, _ = tg.gmm_fit(x, 5, 30, 1e-4, 10, 2e-3)
    lls = torch.stack([tg._e_step(x, tg.gmm_fit(x, 5, n, 1e-4, 10)[2])[1] for n in range(30)])
    for i in range(2):
        moved = (lls[1:, i] - lls[:-1, i]).abs() < 2e-3
        stop = int(torch.nonzero(moved)[0, 0]) + 2 if bool(moved.any()) else 30
        assert stop < 30, "the fit never stopped early: pick a larger tol"
        assert torch.equal(resp[i], tg.gmm_fit(x, 5, stop, 1e-4, 10)[1][i]), (i, stop)


def test_gmm_fit_takes_one_image(features):
    labels, resp, params = tg.gmm_fit(torch.from_numpy(features[0]), 5, 4)
    batch, _, _ = tg.gmm_fit(torch.from_numpy(features[:1]), 5, 4)
    assert tuple(resp.shape) == (features.shape[1], 5) and tuple(params.means.shape) == (5, 39)
    assert torch.equal(labels, batch[0])


@pytest.mark.parametrize("subsample", [1, 3])
def test_gmm_predict_matches_jax(features, subsample):
    ref = np.asarray(jax.vmap(lambda f: jg.gmm_predict(f, 5, 12, 1e-4, subsample))(
        jnp.asarray(features)))
    got = tg.gmm_predict(torch.from_numpy(features), 5, 12, 1e-4, subsample)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    _, agree = _aligned(got.numpy(), ref)
    assert min(agree) >= FLOOR, agree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_fused_t_matches_jax(features, dtype):
    """The fused solver on the flat features, fit grid pooled once and one
    full-resolution refine pass (config2's schedule, 8 EM iterations)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    sched = (5, 8, 1e-4, 10, 1e-3, HW, 1, 1)
    ref = np.asarray(jgp.gmm_fused_t(jnp.asarray(features, jdt), *sched))
    xj = np.array(jnp.asarray(features, jdt).astype(jnp.float32))
    got = gmm_fused_t(torch.from_numpy(xj).to(tdt), *sched)
    assert got.dtype == torch.int32 and tuple(got.shape) == ref.shape
    _, agree = _aligned(got.numpy(), ref)
    assert min(agree) >= FLOOR, agree
