"""PyTorch port, ``kmeans_fused_chw``'s own multigrid (``coarse_iters`` > 0:
maximin seeding and coarse Lloyd on the 2x2 twin, then ``refine_iters``
full-resolution passes), its ``pooled`` twin and its grouped tuple input,
against the JAX package's ``kmeans_fused_chw`` (its Pallas kernels in
interpret mode) on the same numpy inputs.

The setup is tests/test_kmeans_chw.py's test_chw_matches_reference_multigrid
(k = 4, 2 images of 26x22 blocks-plus-noise energies, 5 energy rows,
coarse_iters = refine_iters = 4). Bounds: labels after alignment >= 0.995
(the reference's own floor) and the centres, sorted per image, within rtol
and atol 2e-3 (tests/test_kmeans_chw.py's bound); the grouped input, the
pooled twin given or pooled here, and the same call in bfloat16 storage
against the reference's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import ClusterConfig
from gabor_color_image_segmentation_tpu.models import kmeans_chw as jchw
from gabor_color_image_segmentation_tpu.ops.features import _pool2x2_cm as jpool
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as tchw
from gabor_color_image_segmentation_tpu_torch.ops.features import _pool2x2_cm as tpool

torch.set_num_threads(2)

H, W, K = 26, 22, 4
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _mk_inputs(b, e, h, w, seed):
    """tests/test_kmeans_chw.py's _mk_inputs: piecewise-constant blocks plus
    noise, and uniform colour."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(b, e, 2, 2)).repeat(h // 2 + 1, 2).repeat(w // 2 + 1, 3)[
        :, :, :h, :w]
    energies = np.abs(base + 0.15 * rng.normal(size=(b, e, h, w))) * 3.0
    color = rng.uniform(0, 100, size=(b, h, w, 3))
    return energies.astype(np.float32), color.astype(np.float32)


@pytest.fixture(scope="module")
def problem():
    energies, color = _mk_inputs(2, 5, H, W, seed=7)
    cfg = ClusterConfig(method="kmeans", k=K, coarse_iters=4, refine_iters=4)
    a, b = jchw._affine_params(jnp.asarray(energies),
                               jchw.build_color4(jnp.asarray(color), jnp.float32), cfg, 1e-6)
    return energies, color, np.array(a), np.array(b)


def _agreement(got, ref) -> float:
    return min(float((align_labels(g.reshape(-1), r.reshape(-1)) == r.reshape(-1)).mean())
               for g, r in zip(got, ref))


def _both(problem, dtype):
    energies, color, a, b = problem
    jdt, tdt = DTYPES[dtype]
    jx = (jnp.asarray(energies).astype(jdt), jchw.build_color4(jnp.asarray(color), jdt))
    tx = (torch.from_numpy(energies).to(tdt), tchw.build_color4(torch.from_numpy(color), tdt))
    return jx, tx, (jnp.asarray(a), jnp.asarray(b)), (torch.from_numpy(a), torch.from_numpy(b))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_multigrid_matches_jax(problem, dtype):
    (je, jc), (te, tc), jaff, taff = _both(problem, dtype)
    ref_l, ref_c = jchw.kmeans_fused_chw(je, jc, jaff, K, coarse_iters=4, refine_iters=4)
    labels, centers = tchw.kmeans_fused_chw(te, tc, taff, K, coarse_iters=4, refine_iters=4)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (2, H, W)
    assert _agreement(labels.numpy(), np.asarray(ref_l)) >= 0.995
    np.testing.assert_allclose(np.sort(centers.numpy(), axis=1),
                               np.sort(np.asarray(ref_c), axis=1), rtol=2e-3, atol=2e-3)


def test_multigrid_twin_and_groups(problem):
    """The pooled twin handed in equals the twin pooled inside; a tuple of
    per-group buffers equals their concatenation; with_labels=False gives
    the same centres and no labels."""
    (je, jc), (te, tc), jaff, taff = _both(problem, "float32")
    labels, centers = tchw.kmeans_fused_chw(te, tc, taff, K, coarse_iters=4, refine_iters=4)
    twin = (tpool(te), tpool(tc))
    got_l, got_c = tchw.kmeans_fused_chw(te, tc, taff, K, coarse_iters=4, refine_iters=4,
                                         pooled=twin)
    assert torch.equal(got_l, labels) and torch.equal(got_c, centers)
    groups = (te[:, :2], te[:, 2:])
    got_l, got_c = tchw.kmeans_fused_chw(groups, tc, taff, K, coarse_iters=4, refine_iters=4)
    assert torch.equal(got_l, labels) and torch.equal(got_c, centers)
    none, got_c = tchw.kmeans_fused_chw(te, tc, taff, K, coarse_iters=4, refine_iters=4,
                                        with_labels=False)
    assert none is None and torch.equal(got_c, centers)
    # the reference's grouped input and its pooled twin give its own labels
    ref_l, _ = jchw.kmeans_fused_chw((je[:, :2], je[:, 2:]), jc, jaff, K, coarse_iters=4,
                                     refine_iters=4, pooled=(jpool(je), jpool(jc)))
    assert _agreement(labels.numpy(), np.asarray(ref_l)) >= 0.995


def test_single_grid_unchanged_without_coarse_iters(problem):
    """coarse_iters = 0 (the default) keeps the single-grid schedule: maximin
    at full resolution and up to n_iter passes, as the reference's."""
    (je, jc), (te, tc), jaff, taff = _both(problem, "float32")
    ref_l, _ = jchw.kmeans_fused_chw(je, jc, jaff, K, n_iter=12)
    labels, _ = tchw.kmeans_fused_chw(te, tc, taff, K, n_iter=12)
    assert _agreement(labels.numpy(), np.asarray(ref_l)) >= 0.995
    # and a frame under 2x2 has no twin: the multigrid falls back likewise
    one = tchw.kmeans_fused_chw(te[:, :, :1], tc[:, :, :1], taff, K, n_iter=12,
                                coarse_iters=4)
    assert torch.equal(one[0], tchw.kmeans_fused_chw(te[:, :, :1], tc[:, :, :1], taff, K,
                                                     n_iter=12)[0])
