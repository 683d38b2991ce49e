"""Clustering and graph stages and pipeline of the port: the eager k-means
reference, the CHW Lloyd and maximin kernels (K2, K4), the coarse
warm-start kernel (K3), the (B, D, N) Lloyd and maximin kernels (K5, K6),
the row-major Lloyd pass behind ``kmeans_fused`` (K7), the precision
Cholesky (K9) and the fused moments -> parameters step (K10), the GMM's EM
pass (K8), SLIC (K11-K13), connectivity enforcement (K14), the
superpixel moments (K16-K18), the n-cut and min-cut graph stage and the
labels-only pipeline."""

# ``models.kmeans`` stays the module (the reference's package binds the
# function to that name); its ``kmeans`` is models.kmeans.kmeans
from gabor_color_image_segmentation_tpu_torch.models.kmeans import maximin_init

__all__ = ["maximin_init"]
