"""The standardisation's wrappers on the CPU (ops/standardise.py): the
plain twins give the former helpers' outputs bit for bit, the wrappers
refuse what the kernels do not take, the launch plans cover the frames,
and a numpy walk of std_apply_kernel's tiles (csrc/standardise.cu's index
arithmetic, which only the card runs) rebuilds the plain twins' buffers.
No JAX; the kernels themselves are held in tests/test_torch_cuda.py."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as kc
from gabor_color_image_segmentation_tpu_torch.ops import features as ft
from gabor_color_image_segmentation_tpu_torch.ops import standardise as sd

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
FRAMES = [(7, 9), (15, 17), (20, 36), (33, 70)]


def _inputs(dt, b, e, h, w, seed, color_dt=None):
    g = torch.Generator().manual_seed(seed)
    xe = torch.randn((b, e, h, w), generator=g).abs_().to(dt)
    lab = torch.rand((b, 3, h, w), generator=g) * 100.0 - torch.tensor([0.0, 50.0, 50.0])[:, None,
                                                                                         None]
    xc4 = torch.cat([lab, torch.ones((b, 1, h, w))], dim=1).to(color_dt or dt)
    return xe, xc4


def _former_affine(xe, xc4, cluster_cfg, eps, pooled=None):
    """models/kmeans_chw.py::_affine_params as it read before the kernels."""
    b, e = xe.shape[:2]
    cw = cluster_cfg.color_weight * float(math.sqrt(e / 3.0))
    if not cluster_cfg.normalize:
        a = torch.cat([torch.ones((b, e)), torch.full((b, 3), cw)], dim=1)
        return ft.fold_coherence_affine(a, torch.zeros((b, e + 3)), xe, xc4, cluster_cfg, eps,
                                        pooled=pooled)

    def moments(x):
        xf = x.to(torch.float32)
        mean = xf.mean(dim=(2, 3))
        sq = xf.square().mean(dim=(2, 3))
        return mean, torch.sqrt(torch.clamp(sq - mean.square(), min=0.0))

    m_e, s_e = moments(xe)
    m_c, s_c = moments(xc4[:, :3])
    a_e, a_c = 1.0 / (s_e + eps), cw / (s_c + eps)
    a = torch.cat([a_e, a_c], dim=1)
    bb = torch.cat([-m_e * a_e, -m_c * a_c], dim=1)
    return ft.fold_coherence_affine(a, bb, xe, xc4, cluster_cfg, eps, pooled=pooled,
                                    s_full=torch.cat([s_e, s_c], dim=1))


# ---------------------------------------------------------------------------
# the plain twins against the former helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", FRAMES)
@pytest.mark.parametrize("levels", [1, 2, 3])
def test_pool2x2_is_repeated_pool(dtype, hw, levels):
    x = _inputs(DTYPES[dtype], 2, 3, *hw, seed=1)[0]
    want = got = plain = x
    for _ in range(levels):
        want = ft._pool2x2_cm(want)
        got, plain = sd.pool2x2(got), sd.pool2x2_plain(plain)
    assert torch.equal(got, want)
    assert torch.equal(plain, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["config1", "config2", "normalize_off", "no_twin", "static",
                                  "small"])
def test_affine_params_plain_is_former_helper(dtype, case):
    dt = DTYPES[dtype]
    cl1 = preset("config1").cluster
    cfg, hw, twin = {
        "config1": (cl1, (33, 41), True),
        "config2": (preset("config2").cluster, (33, 41), False),
        "normalize_off": (dataclasses.replace(cl1, normalize=False), (33, 41), True),
        "no_twin": (cl1, (40, 48), False),
        "static": (dataclasses.replace(cl1, cue_weight="static"), (33, 41), True),
        "small": (cl1, (15, 17), True),
    }[case]
    xe, xc4 = _inputs(dt, 2, 5, *hw, seed=2)
    pooled = (ft._pool2x2_cm(xe), ft._pool2x2_cm(xc4)) if twin else None
    want = _former_affine(xe, xc4, cfg, 1e-6, pooled)
    for got in (kc._affine_params(xe, xc4, cfg, 1e-6, pooled),
                sd.affine_params(xe, xc4, cfg, 1e-6, pooled),
                sd.affine_params_plain(xe, xc4, cfg, 1e-6, pooled)):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", FRAMES)
@pytest.mark.parametrize("pools", [(0,), (1,), (2,), (0, 1), (0, 2)])
def test_normalised_rows_plain_is_former_assembly(dtype, hw, pools):
    """The buffers as the pipeline assembled them before: the full
    resolution from the float32 colour, a pooled grid from the colour
    rounded to the storage dtype (build_color4(color, dtype))."""
    dt = DTYPES[dtype]
    xe, c4 = _inputs(dt, 2, 4, *hw, seed=3, color_dt=torch.float32)
    g = torch.Generator().manual_seed(4)
    a, b = torch.rand((2, 7), generator=g) + 0.5, torch.randn((2, 7), generator=g)
    got = sd.normalised_rows(xe, c4, a, b, pools)
    assert len(got) == len(pools)
    for buf, lv in zip(got, pools):
        pe, pc = xe, (c4 if lv == 0 else c4.to(dt))
        for _ in range(lv):
            pe, pc = ft._pool2x2_cm(pe), ft._pool2x2_cm(pc)
        assert torch.equal(buf, ft.assemble_xp_from_affine(pe, pc, a, b, dt))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pools", [(6,), (0, 6), (7,)])
def test_normalised_rows_past_max_pool(dtype, pools):
    """Fit grids deeper than one launch pools (gmm_fit_pool >= 6 on frames of
    16 MP or more) are taken and equal the former assembly."""
    dt = DTYPES[dtype]
    assert pools[-1] > sd.MAX_POOL
    xe, c4 = _inputs(dt, 1, 3, 130, 260, seed=9, color_dt=torch.float32)
    g = torch.Generator().manual_seed(10)
    a, b = torch.rand((1, 6), generator=g) + 0.5, torch.randn((1, 6), generator=g)
    got = sd.normalised_rows(xe, c4, a, b, pools)
    for buf, lv in zip(got, pools):
        pe, pc = xe, (c4 if lv == 0 else c4.to(dt))
        for _ in range(lv):
            pe, pc = ft._pool2x2_cm(pe), ft._pool2x2_cm(pc)
        assert buf.shape == (1, 6, (130 >> lv) * (260 >> lv))
        assert torch.equal(buf, ft.assemble_xp_from_affine(pe, pc, a, b, dt))


def test_pipeline_levels_match_former_levels():
    """The coarse buffer pooled once inside normalised_rows equals the former
    one built from the twins pooled by _pool2x2_cm (config1's two levels)."""
    xe, xc4 = _inputs(torch.bfloat16, 2, 6, 40, 56, seed=5)
    twin, pc0 = ft._pool2x2_cm(xe), ft._pool2x2_cm(xc4)
    a, b = kc._affine_params(xe, xc4, preset("config1").cluster, 1e-6, pooled=(twin, pc0))
    want = ft.assemble_xp_from_affine(ft._pool2x2_cm(twin), ft._pool2x2_cm(pc0), a, b,
                                      torch.bfloat16)
    (got,) = sd.normalised_rows(twin, pc0, a, b, (1,))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", ["three_dims", "int", "float64", "float16"])
def test_pool2x2_refuses(bad):
    x = torch.zeros((1, 2, 8, 8))
    arg = {"three_dims": x[0], "int": x.to(torch.int32), "float64": x.double(),
           "float16": x.half()}[bad]
    with pytest.raises(ValueError):
        sd.pool2x2(arg)


@pytest.mark.parametrize("bad", ["a_shape", "a_dtype", "b_shape", "color_rows", "color_hw",
                                 "color_bf16", "pools_empty", "pools_order", "pools_no_full",
                                 "pools_negative", "energies_int"])
def test_normalised_rows_refuses(bad):
    xe, xc4 = _inputs(torch.float32, 2, 4, 16, 16, seed=6)
    a, b = torch.ones((2, 7)), torch.zeros((2, 7))
    kw = dict(pe=xe, pc4=xc4, a=a, b_aff=b, pools=(0,))
    kw.update({"a_shape": {"a": torch.ones((2, 6))}, "a_dtype": {"a": a.double()},
               "b_shape": {"b_aff": torch.zeros((1, 7))}, "color_rows": {"pc4": xc4[:, :2]},
               "color_hw": {"pc4": xc4[:, :, :8]}, "color_bf16": {"pc4": xc4.bfloat16()},
               "pools_empty": {"pools": ()}, "pools_order": {"pools": (2, 0)},
               "pools_no_full": {"pools": (1, 2)}, "pools_negative": {"pools": (-1,)},
               "energies_int": {"pe": xe.to(torch.int32)}}[bad])
    with pytest.raises(ValueError):
        sd.normalised_rows(**kw)


@pytest.mark.parametrize("bad", ["color_shape", "twin_shape", "energies_dtype", "color_dtype",
                                 "color_bf16"])
def test_affine_params_refuses(bad):
    xe, xc4 = _inputs(torch.float32, 2, 4, 32, 32, seed=7)
    pooled = (ft._pool2x2_cm(xe), ft._pool2x2_cm(xc4))
    args = {"color_shape": (xe, xc4[:1], pooled), "twin_shape": (xe, xc4, (xe, xc4)),
            "energies_dtype": (xe.double(), xc4, None),
            "color_dtype": (xe, xc4.to(torch.int64), None),
            "color_bf16": (xe, xc4.bfloat16(), None)}[bad]
    with pytest.raises(ValueError):
        sd.affine_params(args[0], args[1], preset("config1").cluster, 1e-6, args[2])


# ---------------------------------------------------------------------------
# launch plans and the tile walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lv, full", [(0, True), (1, False), (1, True), (2, False),
                                      (2, True), (3, False), (5, False), (5, True)])
@pytest.mark.parametrize("hw", [(1, 1), (7, 9), (160, 240), (321, 481), (2160, 3840), (3, 5000)])
def test_apply_plan_covers_frame(hw, lv, full):
    h, w = hw
    logtw, rows_lim, cols_lim, ntx, ntiles, x = sd.apply_plan(h, w, lv, full, 40, 132)
    tw, sr = 1 << logtw, 2048 >> logtw
    assert (1 << lv) <= tw <= 2048 >> lv and sr % (1 << lv) == 0
    assert (rows_lim, cols_lim) == ((h, w) if full else ((h >> lv) << lv, (w >> lv) << lv))
    assert ntx * tw >= cols_lim > (ntx - 1) * tw or cols_lim == 0
    nty = ntiles // max(ntx, 1)
    assert nty * sr >= rows_lim > (nty - 1) * sr or rows_lim == 0
    assert 1 <= x <= max(ntiles, 1)


@pytest.mark.parametrize("level", [0, 2, 3])
@pytest.mark.parametrize("rows", [39, 3888])
def test_moments_plan(rows, level):
    for hc, wc in ((321, 481), (40, 60), (2, 2), (1, 7)):
        ns = sd.moments_plan(rows, hc, wc, level, 132)
        assert 1 <= ns <= max(1, -(-hc * wc // 256))
    assert sd.moments_plan(3888, 321, 481, 0, 132) == 5  # config1: ~31k values a block
    assert sd.moments_plan(39, 321, 481, 0, 132) == 7  # config0's one image: 2 waves


def _round(v, dt):
    return torch.from_numpy(np.asarray(v, np.float32)).to(dt).float().numpy()


def _walk_apply(src, h, w, lv, full, a, b, te, to):
    """std_apply_kernel on one row, tile by tile as the card walks them, in
    numpy: (the full-resolution row or None, the pooled row or None)."""
    logtw, rows_lim, cols_lim, ntx, ntiles, _ = sd.apply_plan(h, w, lv, full, 1, 132)
    tw, sr = 1 << logtw, 2048 >> logtw
    hl, wl = h >> lv, w >> lv
    fo = np.full(h * w, np.nan, np.float32) if full else None
    po = np.full(hl * wl, np.nan, np.float32) if lv else None

    def half(p, q):
        return _round(np.float32(0.5) * p + np.float32(0.5) * q, te)

    def affine(v):
        return _round(_round(v * np.float32(a), torch.float32) + np.float32(b), to)

    for t in range(ntiles):
        ty, tx = divmod(t, ntx)
        e = np.arange(2048)
        gi, gj = ty * sr + (e >> logtw), tx * tw + (e & (tw - 1))
        ok = (gi < rows_lim) & (gj < cols_lim)
        v = np.zeros(2048, np.float32)
        v[ok] = src[gi[ok] * w + gj[ok]]
        if full:
            fo[gi[ok] * w + gj[ok]] = affine(v[ok])
        if not lv:
            continue
        q = _round(v, te).reshape(sr, tw)
        for _ in range(lv):
            q = half(half(q[0::2, 0::2], q[1::2, 0::2]), half(q[0::2, 1::2], q[1::2, 1::2]))
        pi = ty * (sr >> lv) + np.arange(q.shape[0])[:, None]
        pj = tx * (tw >> lv) + np.arange(q.shape[1])[None, :]
        keep = (pi < hl) & (pj < wl)
        po[(pi * wl + pj)[keep]] = affine(q[keep])
    return fo, po


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", [(7, 9), (15, 17), (40, 1100), (5, 3000)])
@pytest.mark.parametrize("pools", [(0,), (1,), (0, 2), (3,)])
def test_apply_tile_walk_rebuilds_plain(dtype, hw, pools):
    dt = DTYPES[dtype]
    h, w = hw
    xe, c4 = _inputs(dt, 1, 1, h, w, seed=8, color_dt=torch.float32)
    a, b = torch.full((1, 4), 0.75), torch.full((1, 4), -0.25)
    want = sd.normalised_rows_plain(xe, c4, a, b, pools)
    lv, full = pools[-1], pools[0] == 0
    for r, src in enumerate((xe[0, 0], c4[0, 0], c4[0, 1], c4[0, 2])):
        fo, po = _walk_apply(src.float().numpy().reshape(-1), h, w, lv, full, 0.75, -0.25,
                             dt, dt)
        got = [x for x in (fo, po) if x is not None]
        for g, wnt in zip(got, want):
            assert np.array_equal(g, wnt[0, r].float().numpy())
