"""gabor_color_image_segmentation_tpu_torch — the PyTorch / CUDA port.

A second package beside the JAX reference ``gabor_color_image_segmentation_tpu``
with the same layout (``ops/``, ``models/``, ``data/``, ``utils/``): each
port module pairs with one reference module. It imports torch, numpy and
scipy, never JAX and no module of the reference package: what it needs of
the reference's JAX-free modules (``config``, ``data.synthetic``,
``utils.labels``) it keeps as its own copies.

Every Pallas kernel the port's path runs has a counterpart written by hand
in CUDA C++ for Hopper (``csrc/``, built by ``_kernels.py``), and beside it
a plain PyTorch version of the same math that serves CPU tensors.

Covered so far: the labels-only paths of ``config0`` and ``config1``
(k-means), ``config2`` (per-image GMM), ``config3`` (SLIC superpixels
and the spectral n-cut) and ``config4`` (tiled 4K features pooled per
window, the graph stage on the pooled grid), through
``models/pipeline.py::segment_batch``, and
the graph stage's host-side min-cut through ``segment_images``; both run on
the card unless the caller passes ``device="cpu"``. ``benchmark.py`` (behind
``cli bench``) times the labels-only path device-resident.
"""

from gabor_color_image_segmentation_tpu_torch.config import (
    PRESETS,
    BankConfig,
    ClusterConfig,
    GraphConfig,
    PipelineConfig,
    preset,
)

__all__ = ["BankConfig", "ClusterConfig", "GraphConfig", "PipelineConfig", "PRESETS",
           "preset"]
