"""Shared by tests/test_torch_published_with_features_*.py: the port's
default path, ``segment_batch(with_features=True)``, against the JAX
package's ``segment_batch`` at the presets' published 321x481 frame
(the bench's generator, 5 regions), as a batch of two seeds.

Routes as the reference runs them off its TPU: its energies pinned to K1
(``feature_impl="pallas"``, its Pallas kernel in interpret mode), but for
config3 in float32, whose graph stage takes the modulated route
(``"auto"``), as the port's does. The port runs its card's route on the
CPU (the kernels' plain versions).

Bounds: labels after Hungarian alignment, the minimum over the batch,
>= 0.999 (float32) / >= 0.99 (bfloat16, on images whose reference bf16
and f32 labels themselves agree >= 0.99); features of the reference's
shape within 1e-4 (float32) / 2e-2 (bfloat16) of its largest |feature|
(K1's bounds)."""

from __future__ import annotations

import numpy as np
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models.pipeline import (
    segment_batch as jax_segment_batch,
)
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch

FLOOR = {"float32": 0.999, "bfloat16": 0.99}
FEATURE_BOUND = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def mosaics(seeds) -> np.ndarray:
    return np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=s)[0] for s in seeds])


def agreement(a, b) -> list:
    return [float((align_labels(a[i], b[i]) == b[i]).mean()) for i in range(len(a))]


def jax_config(name, batch, dtype, impl="pallas"):
    return jax_preset(name).replace(batch_size=len(batch), dtype=dtype, feature_impl=impl)


def reference(name, batch, dtype, impl="pallas"):
    """The reference's (labels, float32 features) on ``batch``."""
    cfg = jax_config(name, batch, dtype, impl)
    labels, feats = jax_segment_batch(batch, cfg, jax_make_bank(cfg.bank))
    return np.asarray(labels), np.asarray(feats).astype(np.float32)


def port(name, batch, dtype, with_features=True):
    """The port's (labels, features) on ``batch``, on the CPU."""
    cfg = preset(name).replace(batch_size=len(batch), dtype=dtype)
    return segment_batch(batch, cfg, with_features=with_features, device="cpu")


def check_features(feats: torch.Tensor, ref: np.ndarray, dtype: str, bound=None) -> float:
    """The port's features have the reference's shape, the mode's dtype
    (bf16 from K1 in bf16 mode, else float32) and lie within ``bound``
    (FEATURE_BOUND by default) of its largest |feature|; returns the
    error over the peak."""
    bound = FEATURE_BOUND[dtype] if bound is None else bound
    assert feats.dtype == TORCH_DTYPE[dtype] and tuple(feats.shape) == ref.shape
    err = float(np.abs(feats.to(torch.float32).numpy() - ref).max() / np.abs(ref).max())
    assert err <= bound, err
    return err


def check_labels(got, ref, dtype: str, ref_f32=None, k=None) -> list:
    """Aligned agreement of the port's labels with the reference's, the
    minimum over the batch at the mode's floor; in bf16 first the
    reference's stability (its bf16 labels against ``ref_f32``)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape and got.min() >= 0
    if k is not None:
        assert got.max() < k
    if dtype == "bfloat16":
        stable = agreement(ref, ref_f32)
        assert min(stable) >= FLOOR[dtype], f"borderline test image: {stable}"
    agree = agreement(got, ref)
    assert min(agree) >= FLOOR[dtype], agree
    return agree
