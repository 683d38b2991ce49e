"""Data layer of the port: the seeded synthetic mosaics (numpy only)."""

from gabor_color_image_segmentation_tpu_torch.data.synthetic import synthetic_mosaic

__all__ = ["synthetic_mosaic"]
