"""SLIC connectivity enforcement on the card, kernel K14 (counterpart of the
JAX package's models/connectivity_pallas.py).

K14 ``enforce_connectivity_fused`` (csrc/connectivity.cu) replaces
``models/connectivity_pallas.py::_enforce_kernel``: a fixed schedule of
launches over the whole card (tile union-find, border merge, sizes, a
renumbering scan, the city-block distance to the kept pixels, pointer
jumping), with no host sync. It computes
``models/slic.py::enforce_connectivity_bfs_plain``, whose output is
bit-equal to ``enforce_connectivity_plain``, itself bit-equal to the
reference's ``enforce_connectivity_device``. The wrapper launches K14 for
CUDA tensors and runs ``enforce_connectivity_plain`` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from gabor_color_image_segmentation_tpu_torch import _kernels
from gabor_color_image_segmentation_tpu_torch.models.slic import (
    connectivity_defaults,
    enforce_connectivity_plain,
)

_CHUNK = 1024  # pixels per renumbering chunk (csrc/connectivity.cu's CH)


def enforce_connectivity_fused(labels: torch.Tensor, n_sp: int,
                               min_size: Optional[int] = None,
                               s_max: Optional[int] = None) -> torch.Tensor:
    """(B, H, W) int32 SLIC labels -> (B, H, W) int32 4-connected superpixels
    in [0, s_max); min_size defaults to the cell area / 4, s_max to n_sp."""
    _kernels.check(labels.dim() == 3, "labels must be (B, H, W)")
    _kernels.check(labels.dtype == torch.int32, f"labels must be int32, got {labels.dtype}")
    if _kernels.use_plain(labels):
        return enforce_connectivity_plain(labels, n_sp, min_size, s_max)
    b, h, w = labels.shape
    min_size, s_max = connectivity_defaults(h, w, n_sp, min_size, s_max)
    labels = labels.contiguous()
    out = torch.empty_like(labels)
    comp, count, buf = (torch.empty_like(labels) for _ in range(3))  # scratch
    tot = torch.empty((b, -(-h * w // _CHUNK)), dtype=torch.int32, device=labels.device)
    _kernels.launch("gcis_enforce_connectivity", labels.data_ptr(), out.data_ptr(),
                    comp.data_ptr(), count.data_ptr(), buf.data_ptr(), tot.data_ptr(),
                    b, h, w, min_size, s_max)
    enforce_connectivity_fused.launches += 1
    return out


enforce_connectivity_fused.launches = 0
