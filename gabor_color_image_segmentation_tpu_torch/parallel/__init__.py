"""Parallel execution layer of the port (counterpart of the JAX package's
parallel/): a single-controller device mesh, data-parallel batch sharding,
and spatial tiling of large frames with halo exchange and the distributed
cut chain."""

from gabor_color_image_segmentation_tpu_torch.parallel.sharding import (
    make_mesh,
    segment_batch_sharded,
)

__all__ = ["make_mesh", "segment_batch_sharded"]
