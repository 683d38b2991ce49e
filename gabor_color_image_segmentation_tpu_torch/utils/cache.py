"""HDF5 feature cache (the port's copy of the JAX package's utils/cache.py).

Features cached once per (image id, config fingerprint) let an experiment
re-cluster with another k or method without running the filter bank again.
The keys and the file layout are the reference's (the dataset
``<fingerprint>/<image_id>``, gzip level 1), and the fingerprint of a
config is the reference's, so a file written by either package is read by
the other. ``h5py`` is imported inside the methods, as the reference does:
the module imports without it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Union

import numpy as np
import torch


class FeatureCache:
    """Append-only HDF5 store keyed by (image_id, config fingerprint)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    @staticmethod
    def fingerprint(cfg) -> str:
        blob = json.dumps(dataclasses.asdict(cfg.bank), sort_keys=True) + cfg.color_space
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def _key(self, image_id: str, fp: str) -> str:
        return f"{fp}/{image_id}"

    def get(self, image_id: str, cfg) -> Optional[np.ndarray]:
        """The cached features of ``image_id`` under ``cfg`` (numpy), or None."""
        import h5py

        if not os.path.exists(self.path):
            return None
        key = self._key(image_id, self.fingerprint(cfg))
        with h5py.File(self.path, "r") as f:
            if key in f:
                return f[key][...]
        return None

    def put(self, image_id: str, cfg, features: Union[np.ndarray, torch.Tensor]) -> None:
        """Store ``features``: a numpy array, or a tensor on any device
        (copied to the host; bfloat16 widened to float32, which numpy and
        HDF5 hold)."""
        import h5py

        if isinstance(features, torch.Tensor):
            t = features.detach()
            if t.dtype == torch.bfloat16:
                t = t.to(torch.float32)
            features = t.cpu().numpy()
        key = self._key(image_id, self.fingerprint(cfg))
        with h5py.File(self.path, "a") as f:
            if key in f:
                del f[key]
            f.create_dataset(key, data=features, compression="gzip", compression_opts=1)
