"""BSDS500 dataset loader (the port's copy of the JAX package's
data/bsds.py).

Reads a standard on-disk BSDS500 layout::

    <root>/images/{train,val,test}/<id>.jpg
    <root>/groundTruth/{train,val,test}/<id>.mat   (MATLAB cell of structs)

``bsds_available()`` gates dataset-dependent code; without the dataset the
synthetic stand-in (data/synthetic.py) gives the same (id, image, [gts])
items. BSDS images are 481x321 or 321x481; portrait images are transposed
on load so that every batch is a uniform (321, 481) landscape tensor.
``cv2`` and ``scipy.io`` are imported only when a file is read.
"""

from __future__ import annotations

import os
from typing import Iterator, List, Optional, Tuple

import numpy as np

# the checkout's data directory, the reference's in-repo default root
_REPO_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "data", "BSDS500")


def _default_roots():
    # env read at call time (not import) so that callers can repoint it
    return (os.environ.get("BSDS500_ROOT", ""), _REPO_DATA)


def _find_root(root: Optional[str] = None) -> Optional[str]:
    candidates = [root] if root else list(_default_roots())
    for c in candidates:
        if c and os.path.isdir(os.path.join(c, "images")):
            return c
    return None


def bsds_available(root: Optional[str] = None) -> bool:
    return _find_root(root) is not None


def _load_gt_mat(path: str) -> List[np.ndarray]:
    """Load the human segmentations from a BSDS groundTruth .mat file."""
    from scipy.io import loadmat

    m = loadmat(path)
    gts = []
    for cell in m["groundTruth"][0]:
        seg = cell["Segmentation"][0, 0]
        gts.append(np.asarray(seg, dtype=np.int32) - 1)  # 1-based -> 0-based
    return gts


class BSDS500:
    """Thin dataset wrapper yielding (id, rgb uint8 HxWx3, [gt int32 HxW])."""

    def __init__(self, root: Optional[str] = None, landscape: bool = True):
        r = _find_root(root)
        if r is None:
            raise FileNotFoundError(
                "BSDS500 not found; set BSDS500_ROOT or pass root=. "
                "Use data.synthetic for a stand-in."
            )
        self.root = r
        self.landscape = landscape

    def ids(self, split: str) -> List[str]:
        d = os.path.join(self.root, "images", split)
        return sorted(os.path.splitext(f)[0] for f in os.listdir(d) if f.endswith(".jpg"))

    def load(self, split: str, image_id: str) -> Tuple[np.ndarray, List[np.ndarray]]:
        import cv2

        img_path = os.path.join(self.root, "images", split, image_id + ".jpg")
        bgr = cv2.imread(img_path, cv2.IMREAD_COLOR)
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        gt_path = os.path.join(self.root, "groundTruth", split, image_id + ".mat")
        gts = _load_gt_mat(gt_path) if os.path.exists(gt_path) else []
        if self.landscape and rgb.shape[0] > rgb.shape[1]:
            rgb = np.transpose(rgb, (1, 0, 2))[:, ::-1]
            gts = [np.transpose(g)[:, ::-1] for g in gts]
        return rgb, gts

    def iter_split(
        self, split: str, limit: Optional[int] = None
    ) -> Iterator[Tuple[str, np.ndarray, List[np.ndarray]]]:
        for i, image_id in enumerate(self.ids(split)):
            if limit is not None and i >= limit:
                return
            rgb, gts = self.load(split, image_id)
            yield image_id, rgb, gts
