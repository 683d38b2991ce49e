"""PyTorch port: the pipeline's refusals of what it does not run yet, each a
NotImplementedError naming its ROADMAP item or fault, raised before any
work and never a move to the CPU.

- k > 8 in the pixel clustering (config1's k-means, config2's GMM): the
  reference sends it to its NHWC solver, ROADMAP queue 1 item 14.
- No refusal of a wide bank: K1 sizes its tiles and halos from the radii
  at launch (ROADMAP queue 3 fault 2, repaired), so a bank whose conv
  radius passes 15 or whose smoothing radius passes 24 passes the check on
  the card too. The check allocates nothing, so a CPU machine can ask it
  about ``torch.device("cuda")``; on the CPU the same config runs through
  the plain K1.
- No refusal of a wide feature buffer: on the card the GMM route takes the
  reference's range of feature rows (K8 and K9 D <= 128, K10 d <= 127, the
  limits of the reference's K9 and K10; ROADMAP queue 3 fault 6,
  repaired), so config2 with a 16-kernel bank (D = 51) passes the check.
- ``segment_batch``'s default ``with_features=True`` (the reference's):
  the features are item 14's, so the default raises instead of returning
  ``(labels, None)``.
- The pixel clustering (config0's and config1's k-means, config2's GMM) on
  a frame of fewer than 4,096 or more than 2,000,000 pixels: the reference
  clusters such frames on its NHWC path, item 14 (ROADMAP queue 3 fault
  7). The graph stage has no such gate. The refusal cases above use frames
  inside the range and match their own refusal's text, so each fails
  without its refusal."""

import dataclasses

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import chol, pipeline
from gabor_color_image_segmentation_tpu_torch.models import gmm_fused as gf
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch

torch.set_num_threads(2)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")


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
def test_k_above_8_names_item_14(name):
    x = torch.zeros((1, 64, 64, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match=r"k=10 > 8 yet: ROADMAP queue 1 item 14"):
        segment_batch(x, _with_k(name, 10), with_features=False, device="cpu")
    # k = 8 is ported: the check passes (on a frame inside the pixel range)
    pipeline._check_supported(_with_k(name, 8), False, (64, 64), CPU)


def test_k_does_not_bind_the_graph_stage():
    """config3's clustering is the n-cut's, so the solver's k is unused."""
    pipeline._check_supported(_with_k("config3", 10), False, (64, 96), CUDA)


@pytest.mark.parametrize("case", sorted(WIDE_BANKS))
def test_wide_bank_passes_the_card_check(case):
    fields, radii = WIDE_BANKS[case]
    cfg = _with_bank("config0", **fields)
    assert (cfg.bank.max_conv_radius, cfg.bank.max_smooth_radius) == radii
    pipeline._check_supported(cfg, False, (64, 64), CUDA)
    pipeline._check_supported(cfg, False, (64, 64), CPU)
    pipeline._check_supported(_with_bank("config3", **fields), False, (32, 40), CUDA)


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
    pipeline._check_supported(cfg, False, (64, 64), CUDA)
    pipeline._check_supported(cfg, False, (64, 64), CPU)


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
    x = np.zeros((1, 64, 64, 3), dtype=np.uint8)
    with pytest.raises(NotImplementedError,
                       match=r"with_features=True yet: ROADMAP queue 1 item 14"):
        segment_batch(x, preset(name).replace(batch_size=1), device="cpu")



# frames of N = 4,095, 4,096, 2,000,000 and 2,000,001 pixels: the edges of
# the reference's transposed range (refused: False)
PIXEL_EDGES = {(63, 65): False, (64, 64): True, (1000, 2000): True, (3, 666667): False}


@pytest.mark.parametrize("hw", sorted(PIXEL_EDGES))
@pytest.mark.parametrize("name", ["config0", "config1", "config2"])
def test_pixel_count_range_names_item_14(name, hw):
    """The pixel clustering outside N in [4096, 2,000,000] raises naming item
    14, on the card and on the CPU, from the check that allocates nothing."""
    cfg = preset(name).replace(batch_size=1)
    for dev in (CUDA, CPU):
        if PIXEL_EDGES[hw]:
            pipeline._check_supported(cfg, False, hw, dev)
        else:
            with pytest.raises(NotImplementedError, match="item 14") as err:
                pipeline._check_supported(cfg, False, hw, dev)
            assert f"{hw[0] * hw[1]} pixels" in str(err.value)


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_pixel_count_range_does_not_bind_the_graph_stage(name):
    pipeline._check_supported(preset(name).replace(batch_size=1), False, (63, 65), CUDA)


@pytest.mark.parametrize("name", ["config0", "config2"])
def test_small_frame_is_refused_before_any_work(name):
    """A 32x40 frame (1,280 pixels) raises from segment_batch and
    segment_images, before the batch is read."""
    cfg = preset(name).replace(batch_size=1)
    x = torch.zeros((1, 32, 40, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="item 14"):
        segment_batch(x, cfg, with_features=False, device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        pipeline.segment_images(x, cfg, device="cpu")


def test_pixel_count_range_is_the_references(monkeypatch):
    """The port's copies of the bounds equal the reference's: its
    PIPELINE_N_MAX, and fused_solver_eligible's lower bound, which holds on
    a TPU backend only (patched here; the JAX package is unchanged)."""
    import jax

    from gabor_color_image_segmentation_tpu.models.kmeans import PIPELINE_N_MAX
    from gabor_color_image_segmentation_tpu.models.kmeans_pallas import (
        fused_solver_eligible,
    )

    assert pipeline.PIXELS_MAX == PIPELINE_N_MAX
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    lo, hi = pipeline.PIXELS_MIN, PIPELINE_N_MAX
    assert [fused_solver_eligible(5, n, n_max=hi) for n in (lo - 1, lo, hi, hi + 1)] == [
        False, True, True, False]
