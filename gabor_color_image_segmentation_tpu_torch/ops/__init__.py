"""Feature stage of the port: colour transform, Gabor bank, fused energies
(kernel K1), the standardisation-affine helpers and the per-image table
lookup (kernel K15)."""

from gabor_color_image_segmentation_tpu_torch.ops.bank import GaborBank, gabor_kernel, gaussian_kernel_1d, make_bank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab, srgb_to_linear

__all__ = ["rgb_to_lab", "srgb_to_linear", "GaborBank", "gabor_kernel", "gaussian_kernel_1d",
           "make_bank"]
