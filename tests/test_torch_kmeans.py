"""PyTorch port: the k-means kernels' plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU), and the port's eager
k-means reference against the JAX one.

Tolerances: K2 on identical inputs and centres gives equal labels on
>= 99.99 % of pixels and sums within rtol 1e-4 (f32) / 1e-3 (bf16); K3's
centres within rtol and atol 2e-3 (tests/test_kmeans_chw.py's bound); K4
seeds the same pixels, so its centres agree to float32 rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import ClusterConfig
from gabor_color_image_segmentation_tpu.models.kmeans import (
    kmeans as jax_kmeans,
    kmeans_multigrid as jax_kmeans_multigrid,
    maximin_init as jax_maximin_init,
)
from gabor_color_image_segmentation_tpu.models import kmeans_chw as jchw
from gabor_color_image_segmentation_tpu.models.kmeans_pallas import (
    kmeans_coarse_centers_xp as jax_coarse,
    xt_geometry,
)
from gabor_color_image_segmentation_tpu.ops import features as jfeat
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.models import kmeans as tkm
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as tchw
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as tf
from gabor_color_image_segmentation_tpu_torch.models.kmeans_fused import (
    coarse_plan,
    coarse_route,
    kmeans_coarse_centers_xp,
    lloyd_rows_plan,
    lloyd_t_plan,
    maximin_t_plan,
)

torch.set_num_threads(2)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, e, h, w, seed):
    """Piecewise-constant blocks plus noise (tests/test_kmeans_chw.py)."""
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(b, e, 2, 2)).repeat(h // 2 + 1, 2).repeat(
        w // 2 + 1, 3)[:, :, :h, :w]
    energies = (np.abs(base + 0.15 * rng.normal(size=(b, e, h, w))) * 3.0)
    color = rng.uniform(0, 100, size=(b, h, w, 3))
    return energies.astype(np.float32), color.astype(np.float32)


def _both(x, jdt, tdt):
    """The same values as a JAX array and a torch tensor of one dtype."""
    j = jnp.asarray(x, jdt)
    return j, torch.from_numpy(np.array(j, np.float32)).to(tdt)


@pytest.fixture(scope="module")
def problem():
    energies, color = _inputs(2, 12, 37, 45, seed=5)
    cfg = ClusterConfig(k=5)
    a, b = jchw._affine_params(jnp.asarray(energies),
                               jchw.build_color4(jnp.asarray(color), jnp.float32),
                               cfg, 1e-6)
    return energies, color, np.asarray(a), np.asarray(b)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lloyd_chw_pass_matches_kernel(problem, dtype):
    jdt, tdt = DTYPES[dtype]
    energies, color, a, b_aff = problem
    bsz, e, h, w = energies.shape
    k, d, hb = 5, e + 3, jchw._HB
    rng = np.random.default_rng(7)
    centers = (a[:, None, :] * np.concatenate(
        [energies.reshape(bsz, e, -1), np.moveaxis(color, 3, 1).reshape(bsz, 3, -1)],
        axis=1)[:, :, rng.choice(h * w, k, replace=False)].transpose(0, 2, 1)
        + b_aff[:, None, :]).astype(np.float32)
    u = centers - b_aff[:, None, :]
    wc = jnp.asarray(a[:, None, :] * u).astype(jdt)  # operands in the storage dtype
    offs_v = np.sum(u * u, axis=2).astype(np.float32)
    wck = jnp.zeros((bsz, k, d + 1), jnp.float32).at[:, :, :d].set(wc.astype(jnp.float32))
    wce = jchw._expand_diag(wck[:, :, :e], hb).astype(jdt)
    wcc = jchw._expand_diag(wck[:, :, e:], hb).astype(jdt)
    offs = jnp.zeros((bsz, 8, 128), jnp.float32).at[:, :k, 0].set(offs_v)
    xe_j, xe_t = _both(energies, jdt, tdt)
    xc_j = jchw.build_color4(jnp.asarray(color), jdt)
    xc_t = tchw.build_color4(torch.from_numpy(color), tdt)
    ref_l, ref_se, ref_sc = jchw._lloyd_chw_pass(
        xe_j, xc_j, wce, wcc, offs, k, hb, True)
    wc_t = _t(wc)
    labels, sums, counts = tchw.lloyd_chw_pass(xe_t, xc_t, wc_t, _t(offs_v))
    assert labels.dtype == torch.int32 and tuple(labels.shape) == (bsz, h, w)
    same = (labels.numpy() == np.asarray(ref_l)).mean()
    assert same >= 0.9999, same
    ref_sums = np.concatenate([np.asarray(ref_se), np.asarray(ref_sc)[:, :, :3]], 2)
    rtol = 1e-4 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(sums.numpy(), ref_sums, rtol=rtol,
                               atol=rtol * np.abs(ref_sums).max())
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_sc)[:, :, 3])
    only = tchw.lloyd_chw_pass(xe_t, xc_t, wc_t, _t(offs_v), assign_only=True)
    assert torch.equal(only, labels)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_maximin_init_chw_matches_kernel(problem, dtype):
    jdt, tdt = DTYPES[dtype]
    energies, color, a, b_aff = problem
    xe_j, xe_t = _both(energies, jdt, tdt)
    ref = jchw._maximin_init_chw(
        xe_j, jchw.build_color4(jnp.asarray(color), jdt), jnp.asarray(a),
        jnp.asarray(b_aff), 5, jchw._HB, True)
    out = tchw._maximin_init_chw(
        xe_t, tchw.build_color4(torch.from_numpy(color), tdt), _t(a), _t(b_aff), 5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_coarse_centers_match_kernel(problem, dtype):
    """K3 on the reference's own padded xp buffer (its ones-row and padding
    unread) and on the port's (B, D, m) buffer built from the same rows."""
    jdt, tdt = DTYPES[dtype]
    energies, color, a, b_aff = problem
    bsz, e = energies.shape[:2]
    d = e + 3
    pe = jfeat._pool2x2_cm(jnp.asarray(energies, jdt))
    pc = jfeat._pool2x2_cm(jchw.build_color4(jnp.asarray(color), jdt))
    m = pe.shape[2] * pe.shape[3]
    dp, m_pad, _ = xt_geometry(m, d, jdt)
    xp = jfeat.assemble_xp_from_affine(pe, pc, jnp.asarray(a), jnp.asarray(b_aff),
                                       dp, m_pad, jdt)
    ref = np.asarray(jax_coarse(xp, 5, d, m, 6))
    xp_t = _t(xp).to(tdt)
    out = kmeans_coarse_centers_xp(xp_t, 5, d, m, 6)
    assert out.dtype == torch.float32 and tuple(out.shape) == (bsz, 5, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-3)
    compact = kmeans_coarse_centers_xp(xp_t[:, :d, :m].contiguous(), 5, d, m, 6)
    assert torch.equal(compact, out)


def test_eager_kmeans_matches_jax(problem):
    energies, color, a, b_aff = problem
    x = np.concatenate([energies[0].reshape(energies.shape[1], -1),
                        np.moveaxis(color[0], 2, 0).reshape(3, -1)], 0).T
    x = (x * a[0] + b_aff[0]).astype(np.float32)
    np.testing.assert_array_equal(
        tkm.maximin_init(torch.from_numpy(x), 5).numpy(),
        np.asarray(jax_maximin_init(jnp.asarray(x), 5)))
    ref_l, ref_c = jax_kmeans(jnp.asarray(x), 5, 12)
    lab, cen = tkm.kmeans(torch.from_numpy(x), 5, 12)
    assert (lab.numpy() == np.asarray(ref_l)).mean() >= 0.9999
    np.testing.assert_allclose(cen.numpy(), np.asarray(ref_c), rtol=1e-4, atol=1e-4)
    h, w = energies.shape[2:]
    ref_l, _ = jax_kmeans_multigrid(jnp.asarray(x), 5, (h, w), 4, 3, jnp.float32, 2, 2)
    lab, _ = tkm.kmeans_multigrid(torch.from_numpy(x), 5, (h, w), 4, 3, torch.float32, 2, 2)
    assert (lab.numpy() == np.asarray(ref_l)).mean() >= 0.9999


def _normalized(energies, color, a, b_aff):
    bsz, e, h, w = energies.shape
    raw = np.concatenate([energies.reshape(bsz, e, h * w),
                          np.moveaxis(color, 3, 1).reshape(bsz, 3, h * w)], 1)
    return np.swapaxes(raw, 1, 2) * a[:, None, :] + b_aff[:, None, :]


@pytest.mark.parametrize("warm_start", [False, True])
def test_kmeans_fused_chw_matches_eager(problem, warm_start):
    """The folded-affine CHW solver against the port's eager k-means on the
    normalised features (the structure of tests/test_kmeans_chw.py): seeded
    by its own maximin, or refining given centres as the pipeline's
    multigrid warm start does."""
    energies, color, a, b_aff = problem
    bsz = energies.shape[0]
    x = torch.from_numpy(_normalized(energies, color, a, b_aff).astype(np.float32))
    xc4 = tchw.build_color4(torch.from_numpy(color), torch.float32)
    affine = (_t(a), _t(b_aff))
    if warm_start:
        c0 = torch.stack([tkm.maximin_init(x[i], 5) for i in range(bsz)])
        labels, centers = tchw.kmeans_fused_chw(
            torch.from_numpy(energies), xc4, affine, 5, refine_iters=6, init_centers=c0)
        refs = [tkm.kmeans(x[i], 5, 6, centers0=c0[i]) for i in range(bsz)]
    else:
        labels, centers = tchw.kmeans_fused_chw(torch.from_numpy(energies), xc4,
                                                affine, 5, n_iter=12)
        refs = [tkm.kmeans(x[i], 5, 12) for i in range(bsz)]
    none, same = tchw.kmeans_fused_chw(torch.from_numpy(energies), xc4, affine, 5,
                                       n_iter=12, refine_iters=6, with_labels=False,
                                       init_centers=c0 if warm_start else None)
    assert none is None and torch.equal(same, centers)
    for i in range(bsz):
        ref = refs[i][0].numpy()
        got = labels[i].reshape(-1).numpy()
        assert (align_labels(got, ref) == ref).mean() >= 0.995
        np.testing.assert_allclose(centers[i].numpy(), refs[i][1].numpy(),
                                   rtol=2e-3, atol=2e-3)


# clusters of 1, 2, 4, 8, 16 CTAs a card of 132 SMs might hold at once (a
# GPC holds whole clusters only, so 8 and 16 fit fewer times than 132 / n)
ACTIVE = (132, 66, 32, 16, 7)


@pytest.mark.parametrize("b, n, d, esize, n_sm, expect", [
    (16, 154401, 243, 2, 132, (128, 3, 8, 151, 243)),  # config1 full resolution bf16
    (16, 38400, 243, 2, 132, (128, 3, 8, 38, 243)),  # config1's 2x2 twin
    (16, 154401, 243, 4, 132, (64, 3, 8, 302, 243)),  # config1's rows in float32
    (1, 154401, 39, 4, 132, (128, 4, 121, 10, 39)),  # config0 f32 batch 1
    (4, 154401, 243, 2, 114, (128, 3, 28, 44, 243)),  # a card of 114 SMs
    (2, 45, 10, 2, 132, (128, 4, 1, 1, 10)),  # fewer pixels than one tile
    (1, 100, 603, 2, 132, (64, 2, 2, 1, 603)),  # 603 rows: two stages of 64 pixels
    (1, 5000, 1203, 4, 132, (16, 1, 105, 3, 1203)),  # the last resort, one stage
    (300, 1000, 39, 2, 132, (128, 4, 1, 8, 39)),  # more images than SMs
])
def test_lloyd_plan(b, n, d, esize, n_sm, expect):
    """K2's plan: the widest tile (<= 128 pixels) whose two stages fit a
    CTA's shared memory, then the most stages (<= 4) that fit, its rows
    staged in one go; every tile in exactly one CTA; the batch's CTAs about
    one wave, one an SM."""
    plan = tchw.lloyd_plan(b, n, d, esize, n_sm)
    assert plan == expect
    p, stages, ctas, tpc, rb = plan
    assert rb == d
    ntiles = -(-n // p)
    assert (ctas - 1) * tpc < ntiles <= ctas * tpc
    assert b * ctas <= max(n_sm, b)
    fits = lambda q, s: tchw._lloyd_smem(d, q, s, esize) <= 227 * 1024  # noqa: E731
    assert fits(p, stages) and (stages == 4 or not fits(p, stages + 1))
    assert p == 128 or not fits(2 * p, min(2, stages))


@pytest.mark.parametrize("d, esize, rb", [
    (1651, 2, 240), (2691, 2, 256), (4099, 2, 256),  # bf16: 1,650 rows fit whole
    (1345, 4, 128), (2000, 4, 128),  # float32: 1,344 rows fit whole
])
def test_lloyd_plan_stages_rows_in_blocks(d, esize, rb):
    """Past the rows a whole tile can stage (fault 10), K2's plan stages a
    tile of 128 pixels in blocks of rb rows through three stages: the most
    rows (a multiple of 16) that fit, then blocks as even as that allows.
    At the old limit the plan is still the whole-tile one."""
    limit = {2: 1650, 4: 1344}[esize]
    assert tchw.lloyd_plan(1, 1000, limit, esize, 132)[4] == limit
    n = 321 * 481
    p, stages, ctas, tpc, got = tchw.lloyd_plan(1, n, d, esize, 132)
    assert (p, stages, got) == (128, 3, rb)
    assert rb % 16 == 0 and rb < d
    ntiles = -(-n // p)
    assert (ctas - 1) * tpc < ntiles <= ctas * tpc
    smem = lambda r: tchw._lloyd_smem(d, p, stages, esize, r)  # noqa: E731
    assert smem(rb) <= 227 * 1024
    blocks = -(-d // rb)
    most = max(r for r in range(16, d, 16) if smem(r) <= 227 * 1024)
    assert blocks == -(-d // most) and rb == 16 * -(-(-(-d // blocks)) // 16)


@pytest.mark.parametrize("d, expect", [(1, "k3"), (243, "k3"), (400, "k3"), (401, "blocked"),
                                       (483, "blocked"), (2691, "blocked")])
def test_coarse_route(d, expect):
    """The coarse warm start takes K3 up to the 400 rows its tiles hold,
    the blocked route (K6, K5) past them."""
    assert coarse_route(d) == expect


def test_coarse_centers_blocked_route_matches_jax(monkeypatch):
    """Past 400 rows (fault 11) the warm start takes the reference's blocked
    route, maximin steps (K6) then Lloyd updates (K5), here their plain
    versions: at d = 483 (480 energy rows, a 64x96 frame's 4x4 grid, k = 5,
    f32) against the JAX package's kmeans_coarse_centers_xp, which takes its
    blocked passes in f32 too (interpret mode), on the reference's padded
    buffer. Tolerance as test_coarse_centers_match_kernel."""
    energies, color = _inputs(2, 480, 64, 96, seed=11)
    cfg = ClusterConfig(k=5)
    xc4 = jchw.build_color4(jnp.asarray(color), jnp.float32)
    a, b_aff = jchw._affine_params(jnp.asarray(energies), xc4, cfg, 1e-6)
    pe = jfeat._pool2x2_cm(jfeat._pool2x2_cm(jnp.asarray(energies)))
    pc = jfeat._pool2x2_cm(jfeat._pool2x2_cm(xc4))
    d, m = 483, pe.shape[2] * pe.shape[3]
    assert m == 16 * 24
    dp, m_pad, _ = xt_geometry(m, d, jnp.float32)
    xp = jfeat.assemble_xp_from_affine(pe, pc, a, b_aff, dp, m_pad, jnp.float32)
    ref = np.asarray(jax_coarse(xp, 5, d, m, 6))
    assert coarse_route(d) == "blocked"
    calls = {"maximin_t_pass": 0, "lloyd_t_pass": 0}
    for name in calls:
        def counted(*args, _fn=getattr(tf, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(tf, name, counted)
    monkeypatch.setattr(tf, "kmeans_coarse_centers_xp_plain", None)  # K3's route not taken
    out = kmeans_coarse_centers_xp(_t(xp), 5, d, m, 6)
    assert calls == {"maximin_t_pass": 5, "lloyd_t_pass": 6}
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 5, d)
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("b, m, active, expect", [
    (16, 9600, ACTIVE, 8),  # config1: 16 clusters of 8 in one wave
    (16, 9600, (132, 66, 32, 14, 7), 16),  # 8: 2 waves of 1,328 px; 16: 3 of 728
    (1, 9600, ACTIVE, 16),
    (17, 1320, ACTIVE, 4),  # the 17th cluster of 8 would wait for a second wave
    (1, 5, ACTIVE, 8),  # fewer pixels than CTAs: 8 and 16 tie, the smaller wins
    (500, 9600, ACTIVE, 1),
    (4, 9600, (132, 66, 32, 16, 0), 8),  # no 16-CTA cluster fits
])
def test_coarse_plan(b, m, active, expect):
    """K3's CTAs per image: the cluster size with the least waves x work
    per CTA (ceil(m / ctas) + 128 pixels), the smaller on a tie."""
    ctas = coarse_plan(b, m, active)
    assert ctas == expect
    cost = {c: -(-b // n) * (-(-m // c) + 128)
            for c, n in zip((1, 2, 4, 8, 16), active) if n}
    assert cost[ctas] == min(cost.values())


@pytest.mark.parametrize("b, n, n_sm, expect", [
    (8, 9600, 132, 16),  # config2's fit grid: 128 CTAs of 600 pixels
    (1, 9600, 132, 38),  # no CTA under 256 pixels
    (2, 1, 132, 1),
    (8, 154401, 132, 16),
    (200, 154401, 132, 1),  # more images than SMs: one CTA an image
])
def test_lloyd_t_plan(b, n, n_sm, expect):
    """K5's CTAs per image: the SMs shared among the images, no CTA under
    256 pixels, at least one."""
    cpi = lloyd_t_plan(b, n, n_sm)
    assert cpi == expect and 1 <= cpi <= n


@pytest.mark.parametrize("b, n, n_sm, expect", [
    (8, 9600, 132, 16),  # config2's fit grid: 128 CTAs of 600 pixels
    (1, 100, 132, 1),  # N under one CTA's least range
    (16, 100, 132, 1),
    (1, 4096, 132, 16),  # no CTA under 256 pixels
    (16, 4096, 132, 8),  # the SMs shared among the images
    (1, 154401, 132, 132),
    (16, 154401, 132, 8),
    (200, 154401, 132, 1),  # more images than SMs: one CTA an image
])
def test_maximin_t_plan(b, n, n_sm, expect):
    """K6's CTAs per image: the SMs shared among the images, no CTA under
    256 pixels, at least one."""
    cpi = maximin_t_plan(b, n, n_sm)
    assert cpi == expect and 1 <= cpi <= n


@pytest.mark.parametrize("b, n, d, esize, n_sm, expect", [
    (16, 154401, 243, 2, 132, (8, 151, 128, 3, 243)),  # config1's rows, bf16
    (16, 154401, 243, 4, 132, (8, 302, 64, 3, 243)),  # config1's rows, float32
    (2, 20000, 1000, 2, 132, (63, 10, 32, 2, 1000)),  # past 512 rows, bf16
    (2, 20000, 1000, 4, 132, (66, 19, 16, 2, 1000)),  # past 512 rows, float32
    (1, 154401, 243, 2, 132, (121, 10, 128, 3, 243)),  # batch 1
    (300, 5000, 243, 2, 132, (1, 40, 128, 3, 243)),  # more images than SMs
    (2, 7, 1, 2, 132, (1, 1, 128, 4, 1)),  # N below one tile
    (2, 777, 2048, 2, 132, (7, 1, 128, 3, 256)),  # values staged in blocks, bf16
    (2, 257, 4096, 4, 132, (3, 1, 128, 3, 128)),  # values staged in blocks, float32
])
def test_lloyd_rows_plan(b, n, d, esize, n_sm, expect):
    """K7's plan: the widest tile (<= 128 pixels) whose two stages of rows
    fit a CTA's shared memory with the fragments, then the most stages
    (<= 4); past that, tiles of 128 pixels staged in blocks of values
    through three stages; every tile in exactly one CTA, the batch's CTAs
    about one wave."""
    plan = lloyd_rows_plan(b, n, d, esize, n_sm)
    assert plan == expect
    ctas, tpc, p, stages, vb = plan
    ntiles = -(-n // p)
    assert (ctas - 1) * tpc < ntiles <= ctas * tpc
    assert b * ctas <= max(n_sm, b)
    fits = lambda q, s, v=None: tf._rows_smem(d, q, s, esize, v) <= 227 * 1024  # noqa: E731
    if vb == d:
        assert fits(p, stages) and (stages == 4 or not fits(p, stages + 1))
        assert p == 128 or not fits(2 * p, 2)
    else:
        assert not fits(16, 2) and (p, stages) == (128, 3) and vb % 16 == 0
        assert fits(p, stages, vb) and vb < d
