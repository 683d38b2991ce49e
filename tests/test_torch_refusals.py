"""PyTorch port: the configurations the pipeline once refused, each before
any work, and the ranges it takes on the card. The tests keep their names
from then; each now holds what runs in place of the refusal:

- k > 8 in the pixel clustering (config1's k-means, config2's GMM): the
  reference's NHWC solvers (plain torch), labels agreeing with the JAX
  package's;
- ``segment_batch``'s default ``with_features=True`` (the reference's):
  ``(labels, features)``, both agreeing with the JAX package's;
- the pixel clustering on a frame of fewer than 4,096 or more than
  2,000,000 pixels: the reference's route, by its own gate (the edges
  held against its ``_can_segment_transposed`` and ``fused_solver_ready``
  on a TPU backend, patched in), and a small frame run end to end;
- a wide bank and a wide feature buffer: K1 sizes its tiles and halos
  from the radii at launch and the GMM route takes the reference's range
  of feature rows (K8 and K9 D <= 128, K10 d <= 127), so these configs
  take the transposed path, on the card too (the route reads no device).

The JAX side pins ``feature_impl="pallas"`` (off the TPU its "auto" is the
modulated route): it runs K1 in interpret mode, as the port's "auto" runs
K1 (its plain version on the CPU). Bounds after Hungarian alignment:
labels >= 0.999 (float32); features within 1e-4 of the reference's
largest |feature| (float32; K1's bound, from energies computed apart)."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models import pipeline as jax_pipeline
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import chol, pipeline
from gabor_color_image_segmentation_tpu_torch.models import gmm_fused as gf
from gabor_color_image_segmentation_tpu_torch.models import kmeans as tkm
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank

jax_kmeans = importlib.import_module("gabor_color_image_segmentation_tpu.models.kmeans")

torch.set_num_threads(2)


def _jax_cfg(cfg):
    """The JAX package's config equal to the port's ``cfg`` (field for
    field), with K1 pinned."""
    j = jax_preset(cfg.name)
    return j.replace(
        bank=type(j.bank)(**dataclasses.asdict(cfg.bank)),
        cluster=type(j.cluster)(**dataclasses.asdict(cfg.cluster)),
        graph=type(j.graph)(**dataclasses.asdict(cfg.graph)),
        batch_size=cfg.batch_size, dtype=cfg.dtype, tile_hw=cfg.tile_hw,
        feature_impl="pallas")


def _jax_segment(rgb, cfg, with_features):
    jc = _jax_cfg(cfg)
    labels, feats = jax_pipeline.segment_batch(rgb, jc, jax_make_bank(jc.bank), with_features)
    return np.asarray(labels), (None if feats is None else np.asarray(feats))


def _agreement(a, b):
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


@pytest.fixture
def solvers(monkeypatch):
    """The fused solvers the pixel clustering reached (kmeans_fused_t,
    gmm_fused_t); the plain ones leave no mark."""
    seen = []
    for mod, name in ((kf, "kmeans_fused_t"), (pipeline, "gmm_fused_t")):
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kw):
            seen.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, spy)
    return seen


@pytest.fixture
def tpu_reference(monkeypatch):
    """The reference's dispatch as on its TPU: its gates read the backend
    (routes only: its Pallas kernels then refuse the CPU)."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")


def _with_k(name, k):
    cfg = preset(name).replace(batch_size=1)
    return cfg.replace(cluster=dataclasses.replace(cfg.cluster, k=k))


def _with_bank(name, **bank):
    cfg = preset(name).replace(batch_size=1)
    return cfg.replace(bank=dataclasses.replace(cfg.bank, **bank))


# (bank fields, the radii they give): conv radius 16 past 15, smoothing
# radius 25 past 24, the radii K1's tiles were once sized for
WIDE_BANKS = {"conv_radius_16": ({"max_ksize": 33}, (16, 24)),
              "smooth_radius_25": ({"smooth_truncate": 3.1}, (15, 25))}


@pytest.mark.parametrize("name", ["config1", "config2"])
def test_k_above_8_names_item_14(name, solvers):
    """k = 10 leaves the transposed path for the reference's plain NHWC
    solvers (kmeans_multigrid, gmm_predict), labels agreeing with the JAX
    package's; k = 8 keeps the transposed path."""
    rgb = synthetic_mosaic(h=32, w=40, n_regions=5, seed=111)[0][None]
    cfg = _with_k(name, 10)
    assert not pipeline._can_segment_transposed(cfg, 64, 64)
    assert pipeline._can_segment_transposed(_with_k(name, 8), 64, 64)
    labels, feats = segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert solvers == [] and feats is None
    assert int(labels.min()) >= 0 and int(labels.max()) < 10
    agree = _agreement(labels.numpy(), _jax_segment(rgb, cfg, False)[0])
    assert min(agree) >= 0.999, agree


def test_k_does_not_bind_the_graph_stage():
    """config3's clustering is the n-cut's, so the solver's k is unused: the
    graph stage runs with k = 10 and gives its n_regions labels."""
    cfg = _with_k("config3", 10).replace(graph=dataclasses.replace(
        preset("config3").graph, n_superpixels=16, n_regions=4))
    assert not pipeline._can_segment_transposed(cfg, 32, 40)
    rgb = synthetic_mosaic(h=32, w=40, n_regions=4, seed=112)[0][None]
    labels, _ = segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert int(labels.min()) >= 0 and int(labels.max()) < 4


@pytest.mark.parametrize("case", sorted(WIDE_BANKS))
def test_wide_bank_passes_the_card_check(case):
    """The wide bank takes the transposed path (K1 at its radii) on the card
    as on the CPU: the route reads no device, and K1's inputs build."""
    fields, radii = WIDE_BANKS[case]
    cfg = _with_bank("config0", **fields)
    assert (cfg.bank.max_conv_radius, cfg.bank.max_smooth_radius) == radii
    assert pipeline._can_segment_transposed(cfg, 64, 64)
    groups = bank_tensors(make_bank(cfg.bank), "cpu")
    assert max(g.p for g in groups) == radii[0] and max(g.r for g in groups) == radii[1]
    assert not pipeline._can_segment_transposed(_with_bank("config3", **fields), 32, 40)


def test_card_feature_row_limits_are_the_references():
    """The wrappers' card-side limits: K8 and K9 at the reference K9's lane
    width, K10 one less (its ones row sits at index d < dp <= 128)."""
    from gabor_color_image_segmentation_tpu.models.chol_pallas import _LANES

    assert gf.D_MAX == chol.D_MAX == _LANES
    assert chol.D_PARAMS_MAX == _LANES - 1


def test_sixteen_kernel_bank_passes_the_card_check():
    cfg = _with_bank("config2", scales=(2.0, 3.0, 4.0, 8.0))
    assert cfg.bank.n_kernels == 16
    assert gf.D_REGS < 3 * cfg.bank.n_kernels + 3 == 51 <= gf.D_MAX
    assert pipeline._can_segment_transposed(cfg, 64, 64)


@pytest.mark.parametrize("case", sorted(WIDE_BANKS))
def test_wide_bank_runs_on_the_cpu(case):
    fields, _ = WIDE_BANKS[case]
    cfg = _with_bank("config0", **fields)
    rgb = synthetic_mosaic(h=64, w=64, n_regions=3, seed=7)[0][None]
    labels, feats = segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert feats is None and labels.dtype == torch.int32
    assert tuple(labels.shape) == (1, 64, 64)
    assert 0 <= int(labels.min()) and int(labels.max()) < cfg.cluster.k


@pytest.mark.parametrize("name", ["config0", "config3"])
def test_default_with_features_names_item_14(name):
    """The default with_features=True returns the labels and the (B, H, W,
    D) features (config3: the graph stage's, its modulated route at batch
    1), both agreeing with the JAX package's."""
    rgb = synthetic_mosaic(h=64, w=64, n_regions=4, seed=113)[0][None]
    cfg = preset(name).replace(batch_size=1)
    if name == "config3":
        cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, n_superpixels=64, n_regions=4,
                                                    slic_compactness=10.0,
                                                    affinity_sigma_scale=1.0))
    labels, feats = segment_batch(rgb, cfg, device="cpu")
    ref_l, ref_f = _jax_segment(rgb, cfg.replace(feature_impl="auto") if name == "config3"
                                else cfg, True)
    assert feats.dtype == torch.float32 and tuple(feats.shape) == ref_f.shape == (1, 64, 64, 39)
    assert np.abs(feats.numpy() - ref_f).max() <= 1e-4 * np.abs(ref_f).max()
    agree = _agreement(labels.numpy(), ref_l)
    assert min(agree) >= 0.999, agree


# frames of N = 4,095, 4,096, 2,000,000 and 2,000,001 pixels: the edges of
# the reference's transposed range (True: the transposed path)
PIXEL_EDGES = {(63, 65): False, (64, 64): True, (1000, 2000): True, (3, 666667): False}


@pytest.mark.parametrize("hw", sorted(PIXEL_EDGES))
@pytest.mark.parametrize("name", ["config0", "config1", "config2"])
def test_pixel_count_range_names_item_14(name, hw, tpu_reference):
    """The route at the edges of the pixel range equals the reference's on
    its TPU: the labels-only transposed path inside [4096, 2,000,000], and
    the with-features solver's fused route inside [4096, 10,000,000]
    (k-means) or [4096, 2,000,000] (GMM, as the reference's pipeline)."""
    cfg = preset(name).replace(batch_size=1)
    jc = _jax_cfg(cfg).replace(feature_impl="auto")
    assert pipeline._can_segment_transposed(cfg, *hw) == PIXEL_EDGES[hw]
    assert jax_pipeline._can_segment_transposed(jc, *hw) == PIXEL_EDGES[hw]
    n, k = hw[0] * hw[1], cfg.cluster.k
    n_max = tkm.SOLVER_N_MAX if cfg.cluster.method == "kmeans" else tkm.PIPELINE_N_MAX
    assert tkm.fused_solver_ready(k, n, n_max) == jax_kmeans.fused_solver_ready(k, n, n_max)
    assert tkm.fused_solver_ready(k, n, n_max) == (4096 <= n <= n_max)


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_pixel_count_range_does_not_bind_the_graph_stage(name, tpu_reference):
    """The graph stage never takes the transposed path, at any N, as the
    reference's."""
    cfg = preset(name).replace(batch_size=1)
    for hw in ((63, 65), (64, 64)):
        assert not pipeline._can_segment_transposed(cfg, *hw)
        assert not jax_pipeline._can_segment_transposed(_jax_cfg(cfg), *hw)


@pytest.mark.parametrize("name", ["config0", "config2"])
def test_small_frame_is_refused_before_any_work(name, solvers):
    """A 32x40 frame (1,280 pixels) runs through segment_batch and
    segment_images on the plain NHWC solvers, as the reference's, labels
    agreeing with the JAX package's."""
    cfg = preset(name).replace(batch_size=1)
    rgb = synthetic_mosaic(h=32, w=40, n_regions=4, seed=114)[0][None]
    labels, _ = segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert solvers == []
    assert torch.equal(pipeline.segment_images(rgb, cfg, device="cpu"), labels)
    agree = _agreement(labels.numpy(), _jax_segment(rgb, cfg, False)[0])
    assert min(agree) >= 0.999, agree


def test_pixel_count_range_is_the_references(tpu_reference):
    """The port's copies of the bounds equal the reference's: its
    SOLVER_N_MAX and PIPELINE_N_MAX, and fused_solver_eligible's lower
    bound and k bound (on a TPU backend, patched in)."""
    from gabor_color_image_segmentation_tpu.models.kmeans_pallas import (
        fused_solver_eligible,
    )

    assert (tkm.SOLVER_N_MAX, tkm.PIPELINE_N_MAX) == (jax_kmeans.SOLVER_N_MAX,
                                                      jax_kmeans.PIPELINE_N_MAX)
    lo, hi = tkm.FUSED_N_MIN, tkm.PIPELINE_N_MAX
    assert [fused_solver_eligible(5, n, n_max=hi) for n in (lo - 1, lo, hi, hi + 1)] == [
        False, True, True, False]
    assert fused_solver_eligible(tkm.FUSED_K_MAX, lo) and not fused_solver_eligible(
        tkm.FUSED_K_MAX + 1, lo)
