"""gpubench: the benchmark of gabor_color_image_segmentation_tpu_torch on one
NVIDIA card (see harness.py)."""
