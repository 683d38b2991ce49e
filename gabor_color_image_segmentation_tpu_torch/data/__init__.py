"""Data layer of the port: the seeded synthetic mosaics and the label
mazes that stress the connectivity pass (numpy only)."""

from gabor_color_image_segmentation_tpu_torch.data.synthetic import (
    connectivity_maze,
    synthetic_mosaic,
)

__all__ = ["connectivity_maze", "synthetic_mosaic"]
