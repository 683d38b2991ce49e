"""Data-parallel batch sharding over a device mesh (counterpart of the JAX
package's parallel/sharding.py).

The image batch splits over the mesh's ``batch`` axis; each shard runs the
port's whole per-image program, ``models/pipeline.py::segment_batch``, on
its own images on its own device, with no collective at all (the reference
runs the same per-shard program inside ``shard_map``, whose HLO holds zero
collectives). So every kernel of ``segment_batch`` runs per shard.

The shard's own batch size picks routes, as it does inside the reference's
``shard_map``: at a local batch of 1 the graph stage takes the modulated
route, and the kernel plans take the local batch. Sharded labels therefore
equal ``segment_batch`` run shard by shard, bit for bit; agreement with
one whole-batch call is a reading.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch
from gabor_color_image_segmentation_tpu_torch.parallel.mesh import (
    Mesh,
    gather_rows,
)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None) -> Mesh:
    """1-D data-parallel mesh (axis ``batch``) over the first n devices.
    ``devices`` defaults to every CUDA card (raises RuntimeError with none;
    pass e.g. ``devices=["cpu"] * 8`` for the CPU); entries may repeat."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh takes the NVIDIA cards by default and found none "
                "(torch.cuda.is_available() is False); pass devices=, e.g. "
                "devices=[\"cpu\"] * 8"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        if len(devices) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devices)}")
        devices = devices[:n_devices]
    return Mesh(devices, ("batch",))


def make_sharded_fn(cfg, bank, mesh: Mesh, with_features: bool = True):
    """Data-parallel segmenter: (B, H, W, 3) -> (labels (B, H, W) int32,
    features (B, H, W, D) or None), both on the mesh's first device. Each
    shard of ``mesh`` (axis ``batch``) runs ``segment_batch`` on its B / n
    images on its device; no collective is called."""
    devs = mesh.axis_devices("batch")
    n = len(devs)

    def fn(rgb):
        if isinstance(rgb, np.ndarray):
            rgb = torch.from_numpy(rgb)
        b = rgb.shape[0]
        if b % n:
            raise ValueError(f"B={b} must divide over {n} batch shards")
        bl = b // n
        outs = [segment_batch(rgb[i * bl:(i + 1) * bl], cfg, bank, with_features, dev)
                for i, dev in enumerate(devs)]
        labels = gather_rows([o[0] for o in outs], devs[0])
        feats = gather_rows([o[1] for o in outs], devs[0]) if with_features else None
        return labels, feats

    return fn


def segment_batch_sharded(rgb, cfg, bank, mesh: Mesh, with_features: bool = True
                          ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(B, H, W, 3) batch sharded over mesh('batch') -> (labels, features or
    None) gathered on the mesh's first device. B must divide by the mesh
    size. ``bank`` None builds it from cfg.bank."""
    return make_sharded_fn(cfg, bank, mesh, with_features)(rgb)
