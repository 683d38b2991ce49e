"""Evaluation metrics of the port: BSDS500 PRI, boundary-F, VoI and
segmentation covering (host numpy versions, copied, and tensor versions
that run on their inputs' device)."""

from gabor_color_image_segmentation_tpu_torch.metrics.pri import (
    pri_np,
    pri_torch,
    rand_index_np,
)
from gabor_color_image_segmentation_tpu_torch.metrics.region import (
    covering_np,
    covering_torch,
    mean_covering_np,
    mean_voi_np,
    voi_np,
    voi_torch,
)

__all__ = [
    "rand_index_np",
    "pri_np",
    "pri_torch",
    "voi_np",
    "mean_voi_np",
    "covering_np",
    "mean_covering_np",
    "voi_torch",
    "covering_torch",
]
