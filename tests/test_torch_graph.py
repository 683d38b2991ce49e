"""PyTorch port, n-cut and min-cut stage (models/graph.py and
models/kmeans.py::kmeans_batched) against the JAX package's models/graph.py
on the same numpy inputs.

Inputs: 64x96 mosaics, their superpixels (SLIC + connectivity, 800 target
cells so S > 512 and the affinity's median takes the 4x4-strided subsample
of even size), and 39-wide features drawn around a mean per ground-truth
region. Bounds: means within float32 rounding of a different summation
order (rtol 1e-5, atol 1e-6); affinities within rtol 1e-5 and the
cancellation of the expanded distance (atol 1e-5 at the median bandwidth,
a few eps * max |f|^2 / s2 at an explicit sigma); eigenvalues within 1e-5;
eigenvector subspaces equal (projector within 1e-4: vectors may differ by
sign or by a rotation inside the subspace, which the row-normalised k-means
does not see); region labels equal after alignment; kmeans_batched and
mincut_segment bit-equal to their references."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import GraphConfig
from gabor_color_image_segmentation_tpu.models import graph as jgraph
from gabor_color_image_segmentation_tpu.models import slic as jslic
from gabor_color_image_segmentation_tpu.ops.color import rgb_to_lab as jax_rgb_to_lab
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import graph as tgraph
from gabor_color_image_segmentation_tpu_torch.models.kmeans import kmeans, kmeans_batched

torch.set_num_threads(2)

H, W, N_SP, D = 64, 96, 800, 39


@pytest.fixture(scope="module")
def inputs():
    """(features (2, D, N) float32, superpixels (2, N) int32, S)."""
    rng = np.random.default_rng(11)
    gh, gw, _ = jslic.grid_shape(H, W, N_SP)
    feats, sps = [], []
    for i in range(2):
        rgb, gt = synthetic_mosaic(h=H, w=W, n_regions=5, seed=100 + i)
        lab = np.asarray(jax_rgb_to_lab(jnp.asarray(rgb)))
        sp = jslic.enforce_connectivity_device(jslic.slic(lab, N_SP, 5.0, 5)[None], gh * gw)
        sps.append(np.asarray(sp).reshape(-1))
        means = rng.normal(scale=1.5, size=(int(gt.max()) + 1, D))
        feats.append((means[gt.reshape(-1)] + rng.normal(size=(H * W, D))).T)
    return np.stack(feats).astype(np.float32), np.stack(sps).astype(np.int32), gh * gw


def _nhwc(f):  # (D, N) -> (N, D) as the JAX package takes one image's features
    return jnp.asarray(np.ascontiguousarray(f.T))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_superpixel_means(inputs, dtype):
    feats, sp, n_sp = inputs
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    x = torch.from_numpy(feats).to(tdt)
    means, counts = tgraph.superpixel_means(x, torch.from_numpy(sp), n_sp)
    assert means.dtype == torch.float32 and tuple(means.shape) == (2, n_sp, D)
    for i in range(2):
        xi = _nhwc(x[i].float().numpy()).astype(jnp.bfloat16 if dtype == "bfloat16"
                                                else jnp.float32)
        rm, rc = jgraph.superpixel_means(xi, jnp.asarray(sp[i]), n_sp)
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(rc))
        np.testing.assert_allclose(means[i].numpy(), np.asarray(rm), rtol=1e-5, atol=1e-6)


def test_median_takes_the_mean_of_the_middle_pair():
    x = torch.tensor([[4.0, 1.0, 3.0, 2.0], [5.0, 7.0, 6.0, 1.0]])
    np.testing.assert_array_equal(tgraph._median(x).numpy(),
                                  np.asarray(jnp.median(jnp.asarray(x.numpy()), axis=1)))
    assert not torch.equal(tgraph._median(x), torch.median(x, dim=1).values)


@pytest.mark.parametrize("sigma", [None, 0.7])
def test_affinity_matrix(inputs, sigma):
    feats, sp, n_sp = inputs
    assert n_sp > 512 and ((n_sp + 3) // 4) ** 2 % 2 == 0  # strided, even count
    f, counts = tgraph.superpixel_means(torch.from_numpy(feats), torch.from_numpy(sp), n_sp)
    counts[1, :5] = 0  # dead superpixels get zero rows and columns
    got = tgraph.affinity_matrix(f, sigma, counts, 0.1)
    # d2 = |f_i|^2 - 2 f_i.f_j + |f_j|^2 cancels: its float32 rounding is up
    # to a few eps * max |f|^2, which W carries divided by s2 (2 sigma^2)
    sq_max = float((f * f).sum(dim=2).max())
    atol = 1e-5 if sigma is None else 4 * 2.0**-23 * sq_max / (2 * sigma * sigma)
    for i in range(2):
        ref = jgraph.affinity_matrix(jnp.asarray(f[i].numpy()), sigma,
                                     jnp.asarray(counts[i].numpy()), 0.1)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref), rtol=1e-5, atol=atol)


def _l_sym(w):
    """The reference's L_sym of one (S, S) affinity (not symmetrised)."""
    deg = jnp.sum(w, axis=1)
    d = 1.0 / jnp.sqrt(jnp.maximum(deg, 1e-12))
    return jnp.eye(w.shape[0]) - d[:, None] * w * d[None, :]


@pytest.fixture(scope="module")
def affinity(inputs):
    feats, sp, n_sp = inputs
    f, counts = tgraph.superpixel_means(torch.from_numpy(feats), torch.from_numpy(sp), n_sp)
    return tgraph.affinity_matrix(f, None, counts, 0.1)


def test_eigh_symmetrises_as_jax(affinity):
    w = affinity[0].numpy()
    l = np.array(_l_sym(jnp.asarray(w)))
    assert not np.array_equal(l, l.T)  # the products are not exactly symmetric
    got = torch.linalg.eigh(tgraph._sym(torch.from_numpy(l))).eigenvalues
    ref = np.asarray(jnp.linalg.eigh(jnp.asarray(l))[0])
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


def test_subspace_spans_the_jax_subspace(affinity):
    w = affinity.numpy()
    ls = np.stack([np.asarray(_l_sym(jnp.asarray(w[i]))) for i in range(2)])
    got = tgraph.smallest_eigvecs_subspace(torch.from_numpy(ls), 8).numpy()
    for i in range(2):
        ref = np.asarray(jgraph.smallest_eigvecs_subspace(jnp.asarray(ls[i]), 8))
        np.testing.assert_allclose(got[i] @ got[i].T, ref @ ref.T, atol=1e-4)


@pytest.mark.parametrize("eig", ["eigh", "subspace"])
def test_spectral_labels(affinity, eig):
    got = tgraph.spectral_labels(affinity, 8, eig_method=eig).numpy()
    for i in range(2):
        ref = np.asarray(jgraph.spectral_labels(jnp.asarray(affinity[i].numpy()), 8,
                                                eig_method=eig))
        assert (align_labels(got[i], ref) == ref).mean() == 1.0


def test_ncut_regions(inputs):
    feats, sp, n_sp = inputs
    got = tgraph.ncut_regions(torch.from_numpy(feats), torch.from_numpy(sp), n_sp, 5,
                              None, "eigh", 0.1).numpy()
    for i in range(2):
        ref = np.asarray(jgraph.ncut_regions(_nhwc(feats[i]).reshape(H, W, D),
                                             jnp.asarray(sp[i].reshape(H, W)), n_sp, 5,
                                             None, "eigh", 0.1))
        assert (align_labels(got[i], ref) == ref).mean() == 1.0


def test_resolve_eig_method():
    g = GraphConfig(enabled=True)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert tgraph.resolve_eig_method(g, "bfloat16", cuda) == "subspace"
    assert tgraph.resolve_eig_method(g, "float32", cuda) == "eigh"
    assert tgraph.resolve_eig_method(g, "bfloat16", cpu) == "eigh"
    assert tgraph.resolve_eig_method(GraphConfig(eig_method="subspace"), "float32",
                                     cpu) == "subspace"


@pytest.mark.parametrize("k", [1, 3, 8])
def test_kmeans_batched_equals_kmeans(k):
    rng = np.random.default_rng(k)
    centres = rng.normal(scale=2.0, size=(3, 6, 8))
    x = centres[:, rng.integers(0, 6, size=400)] + rng.normal(size=(3, 400, 8))
    x = torch.from_numpy(x.astype(np.float32))
    got = kmeans_batched(x, k, 30)
    assert got.dtype == torch.int32
    for i in range(3):
        np.testing.assert_array_equal(got[i].numpy(), kmeans(x[i], k, 30)[0].numpy())


def test_mincut_segment_equals_jax(inputs):
    feats, sp, _ = inputs
    for i in range(2):
        f = np.ascontiguousarray(feats[i].T).reshape(H, W, D)
        s = sp[i].reshape(H, W)
        np.testing.assert_array_equal(tgraph._adjacency_pairs(s), jgraph._adjacency_pairs(s))
        for k, min_size in ((15.0, 2), (300.0, 10)):
            np.testing.assert_array_equal(tgraph.mincut_segment(f, s, k, min_size),
                                          jgraph.mincut_segment(f, s, k, min_size))
