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
  ``(labels, None)``."""

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
    x = torch.zeros((1, 16, 16, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="item 14"):
        segment_batch(x, _with_k(name, 10), with_features=False, device="cpu")
    # k = 8 is ported: the check passes
    pipeline._check_supported(_with_k(name, 8), False, (16, 16), CPU)


def test_k_does_not_bind_the_graph_stage():
    """config3's clustering is the n-cut's, so the solver's k is unused."""
    pipeline._check_supported(_with_k("config3", 10), False, (64, 96), CUDA)


@pytest.mark.parametrize("case", sorted(WIDE_BANKS))
def test_wide_bank_passes_the_card_check(case):
    fields, radii = WIDE_BANKS[case]
    cfg = _with_bank("config0", **fields)
    assert (cfg.bank.max_conv_radius, cfg.bank.max_smooth_radius) == radii
    pipeline._check_supported(cfg, False, (32, 40), CUDA)
    pipeline._check_supported(cfg, False, (32, 40), CPU)
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
    pipeline._check_supported(cfg, False, (32, 40), CUDA)
    pipeline._check_supported(cfg, False, (32, 40), CPU)


@pytest.mark.parametrize("case", sorted(WIDE_BANKS))
def test_wide_bank_runs_on_the_cpu(case):
    fields, _ = WIDE_BANKS[case]
    cfg = _with_bank("config0", **fields)
    rgb = synthetic_mosaic(h=32, w=40, n_regions=3, seed=7)[0][None]
    labels, feats = segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert feats is None and labels.dtype == torch.int32
    assert tuple(labels.shape) == (1, 32, 40)
    assert 0 <= int(labels.min()) and int(labels.max()) < cfg.cluster.k


@pytest.mark.parametrize("name", ["config0", "config3"])
def test_default_with_features_names_item_14(name):
    x = np.zeros((1, 16, 16, 3), dtype=np.uint8)
    with pytest.raises(NotImplementedError, match="item 14"):
        segment_batch(x, preset(name).replace(batch_size=1), device="cpu")

