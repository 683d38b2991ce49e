"""SLIC superpixels on the card, kernel K11 (counterpart of the JAX
package's models/slic_pallas.py::slic_batch).

K11 ``slic_batch`` (csrc/slic.cu) replaces
``models/slic_pallas.py::_slic_all_kernel_w3``: every Lloyd iteration and
the final assignment of a batch, 2 * n_iter + 1 launches from one C call,
no host sync. It computes the exact-float32 SLIC of ``slic_plain``
(models/slic.py), in the same order of operations, where the TPU kernel
scored in bf16x3 with a penalty dot over a 128-lane candidate window: those
answer Mosaic's missing float32 dot and the TPU's tiling, not the problem.
The wrapper launches K11 for CUDA tensors and runs ``slic_plain`` for CPU
tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.models.slic import (
    slic_geometry,
    slic_init_centroids,
    slic_plain,
)


def slic_batch(lab: torch.Tensor, n_superpixels: int, ruler: float = 10.0,
               n_iter: int = 10) -> torch.Tensor:
    """(B, H, W, 3) float32 Lab -> (B, H, W) int32 superpixel labels in
    [0, gh * gw)."""
    _kernels.check(lab.dim() == 4 and lab.shape[3] == 3, "lab must be (B, H, W, 3)")
    _kernels.check(lab.dtype == torch.float32, f"lab must be float32, got {lab.dtype}")
    _kernels.check(n_iter >= 0, f"n_iter must be >= 0, got {n_iter}")
    if _kernels.use_plain(lab):
        return slic_plain(lab, n_superpixels, ruler, n_iter)
    b, h, w, _ = lab.shape
    gh, gw, sw = slic_geometry(h, w, n_superpixels, ruler)
    lab = lab.contiguous()
    cent = slic_init_centroids(lab, gh, gw)  # updated in place by the kernel
    labels = torch.empty((b, h, w), dtype=torch.int32, device=lab.device)
    _kernels.launch("gcis_slic", lab.data_ptr(), cent.data_ptr(), labels.data_ptr(),
                    b, h, w, gh, gw, n_iter, float(np.float32(gh / h)),
                    float(np.float32(gw / w)), float(np.float32(sw)))
    slic_batch.launches += 1
    return labels


slic_batch.launches = 0
