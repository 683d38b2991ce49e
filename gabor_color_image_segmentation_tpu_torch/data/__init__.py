"""Data layer of the port: the seeded synthetic mosaics (one ground truth
or several), the label mazes that stress the connectivity pass, and the
BSDS500 loader (numpy, with cv2 and scipy.io imported when it reads)."""

from gabor_color_image_segmentation_tpu_torch.data.bsds import BSDS500, bsds_available
from gabor_color_image_segmentation_tpu_torch.data.synthetic import (
    connectivity_maze,
    synthetic_dataset,
    synthetic_mosaic,
    synthetic_mosaic_multigt,
)

__all__ = ["BSDS500", "bsds_available", "connectivity_maze", "synthetic_dataset",
           "synthetic_mosaic", "synthetic_mosaic_multigt"]
