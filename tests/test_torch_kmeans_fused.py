"""PyTorch port, K7 (models/kmeans_fused.py: lloyd_pass and the solver
kmeans_fused on a row-major (B, N, D) buffer) against the JAX package's
models/kmeans_pallas.py on the CPU, its Pallas kernel in interpret mode.

The same numpy blobs go to both: the JAX side in its ones-extended,
128-lane padded layout, the port as (B, N, D). Bounds: labels equal on
every pixel (the scores differ only in the order of a float32 dot); member
sums within 1e-5 relative of their largest value (float32 sums of the same
values in another order); counts exact; the solvers' labels equal on
>= 99.9 % of pixels and their centres within 1e-4."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models import kmeans_pallas as jkp
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _blobs(b, n, d, k, seed):
    """(B, N, D) float32: k Gaussian blobs per image."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=3.0, size=(b, k, d))
    lab = rng.integers(0, k, size=(b, n))
    return (np.take_along_axis(means, lab[:, :, None], 1)
            + rng.normal(size=(b, n, d))).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
# (B, N, D, k); the last past the 512 rows the card's K7 once took
@pytest.mark.parametrize("shape", [(2, 3000, 16, 4), (3, 1500, 7, 3), (1, 777, 5, 8),
                                   (1, 300, 600, 5)])
def test_lloyd_pass_plain_matches_kernel(dtype, shape):
    b, n, d, k = shape
    jdt, tdt = DTYPES[dtype]
    x = _blobs(b, n, d, k, seed=n + d)
    centers = x[:, :k] + 0.05
    x_ext, dp = jkp._extend(jnp.asarray(x), jdt)
    cext = np.zeros((b, 8, dp), np.float32)
    cext[:, :k, :d] = centers
    cext[:, :k, d] = 1.0
    ref_l, ref_s = jkp._lloyd_pass(x_ext, jnp.asarray(cext), k, jkp._block_for(n), n, True)
    xb = torch.from_numpy(np.array(jnp.asarray(x, jdt), np.float32)).to(tdt)
    labels, sums, counts = kf.lloyd_pass(xb, torch.from_numpy(centers), k)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (b, n)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_l)[:, :n])
    ref_s = np.asarray(ref_s, np.float32)
    np.testing.assert_array_equal(counts.numpy(), ref_s[:, :k, d])
    np.testing.assert_allclose(sums.numpy(), ref_s[:, :k, :d], rtol=1e-5,
                               atol=1e-5 * np.abs(ref_s[:, :k, :d]).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kmeans_fused_matches_jax_batched(dtype):
    """tests/test_kmeans.py::test_fused_pallas_batched's shapes: three
    images of 1500 pixels, k = 3, D = 7, 12 iterations."""
    jdt, tdt = DTYPES[dtype]
    x = _blobs(3, 1500, 7, 3, seed=21)
    ref_l, ref_c = jkp.kmeans_fused(jnp.asarray(x), 3, 12, jdt)
    labels, centers = kf.kmeans_fused(torch.from_numpy(x), 3, 12, tdt)
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (3, 1500)
    assert (labels.numpy() == np.asarray(ref_l)).mean(axis=1).min() >= 0.999
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref_c), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("init_stride", [1, 3])
def test_kmeans_fused_matches_jax_single_image(init_stride):
    """tests/test_kmeans.py::test_fused_pallas_matches_plain's shape: one
    (N, D) image of 3000 pixels, k = 4, D = 16, 15 iterations; seeded from
    every row and from every third."""
    x = _blobs(1, 3000, 16, 4, seed=22)[0]
    ref_l, ref_c = jkp.kmeans_fused(jnp.asarray(x), 4, 15, jnp.float32, init_stride)
    labels, centers = kf.kmeans_fused(torch.from_numpy(x), 4, 15, torch.float32, init_stride)
    assert tuple(labels.shape) == (3000,) and tuple(centers.shape) == (4, 16)
    assert (labels.numpy() == np.asarray(ref_l)).mean() >= 0.999
    np.testing.assert_allclose(centers.numpy(), np.asarray(ref_c), rtol=1e-4, atol=1e-4)


def test_kmeans_fused_stops_at_the_fixed_point(monkeypatch):
    """The solver stops after the first pass that leaves every centre
    unchanged, or after n_iter updates and one more pass for the labels."""
    x = torch.from_numpy(_blobs(2, 2000, 6, 3, seed=23))
    calls = []

    def counted(*args):
        calls.append(1)
        return kf.lloyd_pass_plain(*args)

    monkeypatch.setattr(kf, "lloyd_pass", counted)
    labels, centers = kf.kmeans_fused(x, 3, 50)
    free = len(calls)
    assert free < 50  # well-separated blobs converge early
    calls.clear()
    capped, _ = kf.kmeans_fused(x, 3, 1)
    assert len(calls) == 2
    calls.clear()
    again, same = kf.kmeans_fused(x, 3, free - 1)
    assert len(calls) == free and torch.equal(again, labels) and torch.equal(same, centers)
