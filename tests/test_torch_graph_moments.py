"""PyTorch port, the superpixel moments K16-K18 (models/graph_fused.py) and
the graph stage's superpixel_means against the JAX package on the CPU: its
three Pallas moments wrappers run in interpret mode, its superpixel_means
as XLA's one-hot matmul.

Inputs from a numpy seed: normal features, labels in [-1, S) (the -1s and
labels >= S add to no bucket), the JAX tests' geometries (S = 40 at D = 13,
S = 925 at D = 39). Bounds: counts exact; means within 1e-5 relative (the
JAX tests' bound: the reference sums the bf16 values in float32, the port
in float64 rounded once, so only the reference's order rounds). The
port's sums of bf16 values are exact in float64, hence free of the order
of the pixels (checked bit for bit)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.models import graph as jgraph
from gabor_color_image_segmentation_tpu.models import graph_pallas as jgp
from gabor_color_image_segmentation_tpu_torch.models import graph as tgraph
from gabor_color_image_segmentation_tpu_torch.models import graph_fused as gm

torch.set_num_threads(2)

GEOMETRIES = [(2, 5000, 13, 40), (2, 6000, 39, 925)]  # (B, N, D, S)
WRAPPERS = ["superpixel_moments_fused", "superpixel_moments_fused_t",
            "superpixel_moments_fused_nhwc"]


def _inputs(b, n, d, s, seed):
    """(labels (B, N) int32 in [-1, S], features (B, N, D) float32)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, s, (b, n))
    idx[:, ::97] = s  # outside [0, S): no bucket
    return idx.astype(np.int32), rng.standard_normal((b, n, d)).astype(np.float32)


def _means(sums, counts):
    return np.asarray(sums) / np.maximum(np.asarray(counts), 1.0)[..., None]


@pytest.mark.parametrize("name", WRAPPERS)
@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_moments_match_jax_wrapper(name, geometry):
    """Each entry point against the JAX wrapper of the same name (its Pallas
    kernel in interpret mode); the port's K17 takes the features
    channel-major, as the reference's kernel does after its own transpose."""
    b, n, d, s = geometry
    idx, feats = _inputs(b, n, d, s, seed=n + d)
    ref_s, ref_c = getattr(jgp, name)(jnp.asarray(idx), jnp.asarray(feats), s)
    x = torch.from_numpy(feats)
    if name.endswith("_t"):
        x = x.transpose(1, 2).contiguous()
    sums, counts = getattr(gm, name)(torch.from_numpy(idx), x, s)
    assert sums.dtype == counts.dtype == torch.float32
    assert tuple(sums.shape) == (b, s, d) and tuple(counts.shape) == (b, s)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_c))
    np.testing.assert_allclose(_means(sums, counts), _means(ref_s, ref_c), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_superpixel_means_matches_jax(dtype):
    """The graph stage's superpixel_means (K17 in the features' own dtype)
    against the JAX package's one-hot matmul, labels outside [0, S)
    included (its one-hot row of such a label is zero)."""
    b, n, d, s = 2, 6000, 39, 925
    idx, feats = _inputs(b, n, d, s, seed=7)
    tdt, jdt = {"float32": (torch.float32, jnp.float32),
                "bfloat16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    x = torch.from_numpy(feats).to(tdt).transpose(1, 2).contiguous()
    means, counts = tgraph.superpixel_means(x, torch.from_numpy(idx), s)
    for i in range(b):
        rm, rc = jgraph.superpixel_means(jnp.asarray(feats[i]).astype(jdt),
                                         jnp.asarray(idx[i]), s)
        np.testing.assert_array_equal(counts[i].numpy(), np.asarray(rc))
        np.testing.assert_allclose(means[i].numpy(), np.asarray(rm), rtol=1e-5, atol=1e-6)


def test_float32_features_keep_float32():
    """superpixel_means does not round float32 features to bfloat16 (the
    reference wrappers' default, kept by the three entry points)."""
    idx, feats = _inputs(1, 3000, 5, 12, seed=3)
    x = torch.from_numpy(feats).transpose(1, 2).contiguous()
    means, _ = tgraph.superpixel_means(x, torch.from_numpy(idx), 12)
    sums, counts = gm.superpixel_moments_plain(torch.from_numpy(idx), x, 12, True)
    assert torch.equal(means, sums / torch.clamp(counts, min=1.0)[:, :, None])
    bf16, _ = gm.superpixel_moments_fused_t(torch.from_numpy(idx), x, 12)
    assert not torch.equal(sums, bf16)


@pytest.mark.parametrize("channel_major", [False, True])
def test_plain_sums_are_free_of_pixel_order(channel_major):
    """In float64 the sums of bfloat16 values are exact: permuting the pixels
    gives the same bits, so the kernel's order and the plain version's
    cannot differ."""
    b, n, d, s = 2, 6000, 39, 925
    idx, feats = _inputs(b, n, d, s, seed=11)
    x = torch.from_numpy(feats).to(torch.bfloat16)
    perm = torch.from_numpy(np.random.default_rng(12).permutation(n))
    xp = x[:, perm]
    if channel_major:
        x, xp = x.transpose(1, 2), xp.transpose(1, 2)
    got = gm.superpixel_moments_plain(torch.from_numpy(idx), x, s, channel_major)
    ref = gm.superpixel_moments_plain(torch.from_numpy(idx)[:, perm], xp, s, channel_major)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_layouts_agree_and_inputs_are_checked():
    idx, feats = _inputs(2, 1000, 6, 30, seed=5)
    ti, x = torch.from_numpy(idx), torch.from_numpy(feats)
    rows = gm.superpixel_moments_fused(ti, x, 30)
    for got in (gm.superpixel_moments_fused_nhwc(ti, x, 30),
                gm.superpixel_moments_fused_t(ti, x.transpose(1, 2).contiguous(), 30)):
        assert torch.equal(got[0], rows[0]) and torch.equal(got[1], rows[1])
    with pytest.raises(ValueError, match="int32"):
        gm.superpixel_moments_fused(ti.long(), x, 30)
    with pytest.raises(ValueError, match="feats must be"):
        gm.superpixel_moments_fused_t(ti, x, 30)


@pytest.mark.parametrize("geometry", [(8, 154401, 39, 925), (8, 518400, 39, 405),
                                      (8, 154401, 39, 8192), (2, 40000, 39, 16384),
                                      (1, 7, 1, 1), (64, 154401, 39, 100000)])
def test_chunk_plan(geometry):
    """The kernel's chunks: whole tiles, covering N with no empty chunk;
    config3 (the first geometry) at >= 4 blocks per SM of an H100 (528);
    the float64 partials within PARTIAL_BYTES unless one chunk an image."""
    b, n, d, s = geometry
    chunk, n_chunks = gm.chunk_plan(b, n, s, d)
    assert chunk % gm.TILE == 0 and (n_chunks - 1) * chunk < n <= n_chunks * chunk
    assert n_chunks == 1 or b * n_chunks * s * (d + 1) * 8 <= gm.PARTIAL_BYTES
    if geometry == (8, 154401, 39, 925):
        assert chunk == gm.CHUNK and b * n_chunks >= 528


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_chunk_ranges_hold_every_label(dtype):
    """The kernel's two passes in plain torch: float64 sums per chunk, then
    the sums of the chunks whose [lo, hi] holds each label added in chunk
    order. No label falls outside its chunk's range, so the result is the
    plain version's: bit for bit in bfloat16, within one ulp in float32."""
    b, n, d, s = 2, 6000, 39, 925
    idx, feats = _inputs(b, n, d, s, seed=13)
    ti, x = torch.from_numpy(idx), torch.from_numpy(feats).to(dtype)
    chunk = 512
    ranges = gm.chunk_ranges(ti, s, chunk)
    assert tuple(ranges.shape) == (b, -(-n // chunk), 2)
    sums = torch.zeros((b, s, d), dtype=torch.float64)
    counts = torch.zeros((b, s), dtype=torch.float64)
    for k in range(ranges.shape[1]):
        lab = ti[:, k * chunk:(k + 1) * chunk].long()
        xk = x[:, k * chunk:(k + 1) * chunk].double()
        for i in range(b):
            lo, hi = ranges[i, k].tolist()
            keep = (lab[i] >= 0) & (lab[i] < s)
            valid = lab[i][keep]
            assert (lo, hi) == ((int(valid.min()), int(valid.max())) if valid.numel()
                                else (2**31 - 1, -1))
            # the chunk's float64 partials, kept only for [lo, hi]
            part = torch.zeros((s, d), dtype=torch.float64).index_add_(0, valid, xk[i][keep])
            cnt = torch.bincount(valid, minlength=s).double()
            held = torch.zeros(s, dtype=torch.bool)
            held[max(lo, 0):hi + 1] = True
            assert not bool(cnt[~held].any())
            sums[i, held] += part[held]
            counts[i, held] += cnt[held]
    ref_s, ref_c = gm.superpixel_moments_plain(ti, x, s)
    assert torch.equal(counts.float(), ref_c)
    got = sums.float()
    if dtype == torch.bfloat16:
        assert torch.equal(got, ref_s)
    else:
        ulp = torch.nextafter(ref_s.abs(), torch.full_like(ref_s, float("inf"))) - ref_s.abs()
        assert bool(((got - ref_s).abs() <= ulp).all())


def test_chunk_ranges_of_an_empty_chunk():
    idx = torch.tensor([[-1, 5, 7, 9, 3, 3]], dtype=torch.int32)
    assert gm.chunk_ranges(idx, 8, 2).tolist() == [[[5, 5], [7, 7], [3, 3]]]
    assert gm.chunk_ranges(torch.full((1, 4), -1, dtype=torch.int32), 8, 4).tolist() == [
        [[2**31 - 1, -1]]]
