"""PyTorch port, the evaluation metrics and the data they read, against the
JAX package on the same numpy inputs.

Bounds: the synthetic data, the label utilities and the BSDS loader are
bit-equal to the JAX package's; the host metrics (``*_np``, copies) are
exactly equal to its ``*_np``, for the optimal and the greedy matcher; the
native greedy matcher gives the masks of its Python version; the tensor
metrics agree with the port's host metrics to 1e-12 (an exact int64
contingency, float64 sums), with the JAX package's float32 ``*_jax`` to
1e-5 absolute, and ``fboundary_torch``'s (P, R, F) with ``fboundary_jax``'s
to 1e-6 and with the host dilated form exactly."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.data import synthetic as jsyn
from gabor_color_image_segmentation_tpu.data.bsds import BSDS500 as JBSDS500
from gabor_color_image_segmentation_tpu.metrics import boundary as jbd
from gabor_color_image_segmentation_tpu.metrics import pri as jpri
from gabor_color_image_segmentation_tpu.metrics import region as jreg
from gabor_color_image_segmentation_tpu.utils import labels as jlabels
from gabor_color_image_segmentation_tpu.utils import visualize as jvis
from gabor_color_image_segmentation_tpu_torch import data as tdata
from gabor_color_image_segmentation_tpu_torch.data import bsds as tbsds
from gabor_color_image_segmentation_tpu_torch.metrics import boundary as bd
from gabor_color_image_segmentation_tpu_torch.metrics import pri, region
from gabor_color_image_segmentation_tpu_torch.utils import labels as tlabels
from gabor_color_image_segmentation_tpu_torch.utils import native
from gabor_color_image_segmentation_tpu_torch.utils import visualize as tvis

torch.set_num_threads(2)

H, W = 40, 56


def _maps(k: int, seed: int, h: int = H, w: int = W) -> np.ndarray:
    """A (h, w) int32 label map with values in [0, k): blocks of 8x8 pixels
    with random labels, a tenth of the pixels relabelled at random."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, k, (-(-h // 8), -(-w // 8)))
    lab = np.repeat(np.repeat(blocks, 8, 0), 8, 1)[:h, :w]
    noise = rng.random((h, w)) < 0.1
    lab[noise] = rng.integers(0, k, int(noise.sum()))
    return lab.astype(np.int32)


def _case(k: int, n_gts: int):
    pred = _maps(k, 100 + k)
    gts = [_maps(max(1, k + t - 1), 200 + 10 * k + t) for t in range(n_gts)]
    return pred, gts


# ---------------------------------------------------------------------------
# data and labels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [{"h": 37, "w": 53, "n_regions": 4, "seed": 3},
                                {"h": 24, "w": 64, "n_regions": 5, "seed": 11, "n_gts": 5},
                                {"h": 48, "w": 30, "n_regions": 2, "seed": 0, "n_gts": 1},
                                {"h": 32, "w": 32, "n_regions": 7, "seed": 9, "n_gts": 4,
                                 "texture_strength": 0.1, "noise": 0.05}])
def test_synthetic_mosaic_multigt_bit_equal(kw):
    rgb, gts = tdata.synthetic_mosaic_multigt(**kw)
    rgb_ref, gts_ref = jsyn.synthetic_mosaic_multigt(**kw)
    np.testing.assert_array_equal(rgb, rgb_ref)
    assert len(gts) == len(gts_ref) == kw.get("n_gts", 3)
    for g, r in zip(gts, gts_ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_synthetic_dataset_and_hsv_bit_equal():
    got = list(tdata.synthetic_dataset(3, h=20, w=28, seed=2000, n_gts=2))
    ref = list(jsyn.synthetic_dataset(3, h=20, w=28, seed=2000, n_gts=2))
    assert [g[0] for g in got] == [r[0] for r in ref] == ["synth0000", "synth0001", "synth0002"]
    for (_, rgb, gts), (_, rgb_ref, gts_ref) in zip(got, ref):
        np.testing.assert_array_equal(rgb, rgb_ref)
        for g, r in zip(gts, gts_ref):
            np.testing.assert_array_equal(g, r)
    from gabor_color_image_segmentation_tpu_torch.data.synthetic import _hsv_to_rgb

    for h in np.linspace(0.0, 1.0, 13):
        assert _hsv_to_rgb(h, 0.55, 0.75) == jsyn._hsv_to_rgb(h, 0.55, 0.75)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_relabel_and_agreement_bit_equal(seed):
    rng = np.random.default_rng(seed)
    lab = rng.integers(-3, 40, (17, 23)) * 7
    got = tlabels.relabel_contiguous(lab)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jlabels.relabel_contiguous(lab))
    a, b = rng.integers(0, 4, (2, 30, 31))
    assert tlabels.agreement_rate(a, b) == jlabels.agreement_rate(a, b)


# ---------------------------------------------------------------------------
# host metrics: exact copies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", list(range(1, 13)))
def test_host_metrics_equal_reference(k):
    pred, gts = _case(k, 1 + k % 4)
    for g in gts:
        assert pri.rand_index_np(pred, g) == jpri.rand_index_np(pred, g)
        assert region.voi_np(pred, g) == jreg.voi_np(pred, g)
        assert region.covering_np(pred, g) == jreg.covering_np(pred, g)
    assert pri.pri_np(pred, gts) == jpri.pri_np(pred, gts)
    assert region.mean_voi_np(pred, gts) == jreg.mean_voi_np(pred, gts)
    assert region.mean_covering_np(pred, gts) == jreg.mean_covering_np(pred, gts)
    for matcher in ("optimal", "greedy"):
        assert (bd.fboundary_np(pred, gts, matcher=matcher)
                == jbd.fboundary_np(pred, gts, matcher=matcher)), matcher
    np.testing.assert_array_equal(bd.boundaries_np(pred), jbd.boundaries_np(pred))
    assert bd.default_tolerance(H, W) == jbd.default_tolerance(H, W)


def test_host_metrics_need_a_ground_truth():
    pred = _maps(3, 0)
    for fn in (pri.pri_np, region.mean_voi_np, region.mean_covering_np):
        with pytest.raises(ValueError, match="at least one ground truth"):
            fn(pred, [])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_greedy_matcher_native_equals_plain(seed):
    """The C++ greedy matcher gives its Python version's masks (the same
    (distance, i, j) order), and both the reference's."""
    pred, gt = _maps(6, seed), _maps(5, 50 + seed)
    pb, gb = bd.boundaries_np(pred), bd.boundaries_np(gt)
    for tol in (1.0, 2.5, bd.default_tolerance(H, W)):
        pm, gm = bd._match_one_greedy(pb, gb, tol)
        pm_plain, gm_plain = bd._match_one_greedy_plain(pb, gb, tol)
        np.testing.assert_array_equal(pm, pm_plain)
        np.testing.assert_array_equal(gm, gm_plain)
        pm_ref, gm_ref = jbd._match_one_greedy(pb, gb, tol)
        np.testing.assert_array_equal(pm, pm_ref)
        np.testing.assert_array_equal(gm, gm_ref)
        opt_p, opt_g = bd._match_one(pb, gb, tol)
        assert opt_p.sum() == opt_g.sum() >= pm.sum() == gm.sum()


def test_native_build_and_empty_inputs():
    assert native.get_lib() is not None
    assert native.library_path().exists()
    pm, gm = native.greedy_match_native(np.zeros((0, 2), np.int32),
                                        np.array([[1, 2]], np.int32), 2.0)
    assert pm.shape == (0,) and gm.tolist() == [False]
    pm, gm = native.greedy_match_native(np.array([[0, 0], [0, 5], [0, 10]]),
                                        np.array([[1, 0], [1, 5]]), 2.0)
    assert pm.tolist() == [True, True, False] and gm.tolist() == [True, True]
    with pytest.raises(ValueError, match=r"\(n, 2\)"):
        native.greedy_match_native(np.zeros((3, 3), np.int32), np.zeros((1, 2), np.int32), 1.0)


def test_native_build_failure_raises(monkeypatch, tmp_path):
    """No g++: the matcher raises; it does not fall back to Python."""
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "library_path", lambda: tmp_path / "none.so")
    native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="needs g\\+\\+"):
            bd._match_one_greedy(np.eye(4, dtype=bool), np.eye(4, dtype=bool), 2.0)
    finally:
        native.get_lib.cache_clear()


# ---------------------------------------------------------------------------
# tensor metrics on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 5, 8, 12])
def test_torch_metrics_agree(k):
    pred, gts = _case(k, 3)
    n_pred = k
    n_gt = max(int(g.max()) for g in gts) + 1
    tp, tg = torch.from_numpy(pred), torch.from_numpy(np.stack(gts))
    jp, jg = jnp.asarray(pred), jnp.asarray(np.stack(gts))
    for t, g in enumerate(gts):
        ri = pri.rand_index_torch(tp, tg[t], n_pred, n_gt)
        voi = region.voi_torch(tp, tg[t], n_pred, n_gt)
        cov = region.covering_torch(tp, tg[t], n_pred, n_gt)
        assert ri.dtype == voi.dtype == cov.dtype == torch.float64
        assert abs(ri.item() - pri.rand_index_np(pred, g)) <= 1e-12
        assert abs(voi.item() - region.voi_np(pred, g)) <= 1e-12
        assert abs(cov.item() - region.covering_np(pred, g)) <= 1e-12
        assert abs(ri.item() - float(jpri.rand_index_jax(jp, jg[t], n_pred, n_gt))) <= 1e-5
        assert abs(voi.item() - float(jreg.voi_jax(jp, jg[t], n_pred, n_gt))) <= 1e-5
        assert abs(cov.item() - float(jreg.covering_jax(jp, jg[t], n_pred, n_gt))) <= 1e-5
    pr = pri.pri_torch(tp, tg, n_pred, n_gt).item()
    assert abs(pr - pri.pri_np(pred, gts)) <= 1e-12
    assert abs(pr - float(jpri.pri_jax(jp, jg, n_pred, n_gt))) <= 1e-5


def test_torch_contingency_is_exact_and_checks_bounds():
    pred, gts = _case(5, 2)
    cont = pri.contingency_torch(torch.from_numpy(pred), torch.from_numpy(np.stack(gts)), 5, 6)
    assert cont.dtype == torch.int64 and tuple(cont.shape) == (2, 5, 6)
    for t, g in enumerate(gts):
        ref = np.zeros((5, 6), np.int64)
        np.add.at(ref, (pred.reshape(-1), g.reshape(-1)), 1)
        np.testing.assert_array_equal(cont[t].numpy(), ref)
    with pytest.raises(ValueError, match=r"\[0, 4\)"):
        pri.rand_index_torch(torch.from_numpy(pred), torch.from_numpy(gts[0]), 4, 6)
    with pytest.raises(ValueError, match="must lie in"):
        region.voi_torch(torch.from_numpy(pred), torch.from_numpy(gts[0]) - 1, 5, 6)


@pytest.mark.parametrize("k", [1, 3, 7, 12])
def test_fboundary_torch_agrees(k):
    pred, gts = _case(k, 2)
    h, w = pred.shape
    for tol in (bd.default_tolerance(h, w), 1.0, 2.9, 4.5):
        for g in gts:
            got = bd.fboundary_torch(torch.from_numpy(pred), torch.from_numpy(g), tol)
            assert got.dtype == torch.float64 and tuple(got.shape) == (3,)
            ref = np.asarray(jbd.fboundary_jax(jnp.asarray(pred), jnp.asarray(g), tol))
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-6, rtol=0)
            assert tuple(got.tolist()) == bd.fboundary_dilated_np(pred, g, tol)


@pytest.mark.parametrize("radius", [0, 1, 3, 6, 24])
def test_truncated_sq_dt_bit_equal(radius):
    rng = np.random.default_rng(radius)
    mask = rng.random((23, 31)) < 0.03
    got = bd._truncated_sq_dt(torch.from_numpy(mask), radius)
    ref = np.asarray(jbd._truncated_sq_dt(jnp.asarray(mask), radius))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(bd.boundaries_torch(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jbd.boundaries_jax(jnp.asarray(mask))))


# ---------------------------------------------------------------------------
# BSDS loader and visualisation
# ---------------------------------------------------------------------------


@pytest.fixture()
def fake_bsds(tmp_path):
    """A BSDS500 layout, as tests/test_bsds_loader.py writes one: a
    landscape and a portrait image with three .mat ground truths each."""
    import cv2
    from scipy.io import savemat

    root = tmp_path / "BSDS500"
    for split in ("train", "val", "test"):
        (root / "images" / split).mkdir(parents=True)
        (root / "groundTruth" / split).mkdir(parents=True)
    rng = np.random.default_rng(0)

    def write(split, image_id, h, w):
        rgb = (rng.random((h, w, 3)) * 255).astype(np.uint8)
        cv2.imwrite(str(root / "images" / split / f"{image_id}.jpg"),
                    cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
        gt = np.zeros((1, 3), dtype=object)
        for i in range(3):
            gt[0, i] = {"Segmentation": rng.integers(1, 6, (h, w)).astype(np.uint16)}
        savemat(str(root / "groundTruth" / split / f"{image_id}.mat"), {"groundTruth": gt})

    write("test", "100007", 32, 48)  # landscape
    write("test", "100039", 48, 32)  # portrait (the loader transposes it)
    write("val", "200001", 32, 48)
    return str(root)


def test_bsds_loader_round_trip(fake_bsds, monkeypatch):
    assert tbsds.bsds_available(fake_bsds)
    ds, ref = tbsds.BSDS500(fake_bsds), JBSDS500(fake_bsds)
    assert ds.ids("test") == ref.ids("test") == ["100007", "100039"]
    for split in ("test", "val"):
        got, want = list(ds.iter_split(split)), list(ref.iter_split(split))
        assert len(got) == len(want) > 0
        for (gi, grgb, ggts), (ri, rrgb, rgts) in zip(got, want):
            assert gi == ri and grgb.shape == (32, 48, 3)
            np.testing.assert_array_equal(grgb, rrgb)
            assert len(ggts) == len(rgts) == 3
            for g, r in zip(ggts, rgts):
                assert g.dtype == np.int32 and g.min() == 0
                np.testing.assert_array_equal(g, r)
    assert len(list(ds.iter_split("test", limit=1))) == 1
    mat = f"{fake_bsds}/groundTruth/test/100007.mat"
    for g, r in zip(tbsds._load_gt_mat(mat), jbsds_load(mat)):
        np.testing.assert_array_equal(g, r)
    # the env var is read at call time
    monkeypatch.setenv("BSDS500_ROOT", fake_bsds)
    assert tbsds.bsds_available() and tbsds.BSDS500().root == fake_bsds
    monkeypatch.setenv("BSDS500_ROOT", str(fake_bsds) + "_missing")
    assert not tbsds.bsds_available()
    with pytest.raises(FileNotFoundError, match="BSDS500_ROOT"):
        tbsds.BSDS500()


def jbsds_load(path):
    from gabor_color_image_segmentation_tpu.data.bsds import _load_gt_mat

    return _load_gt_mat(path)


def test_visualize_equal_reference(tmp_path):
    import cv2

    rgb, gts = tdata.synthetic_mosaic_multigt(h=30, w=44, n_regions=4, seed=1)
    lab = gts[1]
    np.testing.assert_array_equal(tvis.label_colors(lab), jvis.label_colors(lab))
    np.testing.assert_array_equal(tvis.overlay(lab, rgb), jvis.overlay(lab, rgb))
    for with_rgb in (True, False):
        tvis.save_label_map(lab, str(tmp_path / "t.png"), rgb=rgb if with_rgb else None)
        jvis.save_label_map(lab, str(tmp_path / "j.png"), rgb=rgb if with_rgb else None)
        np.testing.assert_array_equal(cv2.imread(str(tmp_path / "t.png")),
                                      cv2.imread(str(tmp_path / "j.png")))
    assert math.isclose(bd.default_tolerance(30, 44), jbd.default_tolerance(30, 44))
