"""End-to-end demo of the PyTorch port: segment a synthetic texture mosaic
with three pipeline families (k-means, GMM, SLIC + n-cut), score against
ground truth, and save overlays. Runs on the NVIDIA card by default, or on
the CPU with ``--device cpu``; no dataset needed. With BSDS500_ROOT set,
pass --bsds <image-id> to use a real image instead. Saving the overlays
needs cv2 (``--no-save`` skips them).

Run: python examples/demo_torch.py [--device cpu] [--out-dir out/] [--bsds 100075]
"""

import argparse
import os

import numpy as np

from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.metrics import pri_np
from gabor_color_image_segmentation_tpu_torch.metrics.boundary import fboundary_np
from gabor_color_image_segmentation_tpu_torch.models.pipeline import (
    segment_image,
    segment_images,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="demo_out")
    ap.add_argument("--bsds", default=None, help="BSDS500 image id")
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--hw", type=int, nargs=2, default=(321, 481),
                    help="synthetic mosaic height and width")
    ap.add_argument("--no-save", action="store_true", help="skip the overlay images")
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)

    if args.bsds:
        from gabor_color_image_segmentation_tpu_torch.data.bsds import BSDS500
        rgb, gts = BSDS500().load("test", args.bsds)
    else:
        rgb, gt = synthetic_mosaic(h=args.hw[0], w=args.hw[1], n_regions=5, seed=args.seed)
        gts = [gt]

    runs = [
        ("kmeans", preset("config0")),
        ("gmm", preset("config0").replace(cluster=preset("config2").cluster)),
        ("slic_ncut", preset("config3")),
    ]
    rows = []
    for name, cfg in runs:
        if cfg.graph.enabled:
            labels = segment_images(rgb[None], cfg, device=args.device)[0]
        else:
            labels = segment_image(rgb, cfg, device=args.device)[0]
        labels = labels.cpu().numpy()
        pri = pri_np(labels, gts)
        p, r, f = fboundary_np(labels, gts)
        out = os.path.join(args.out_dir, f"{name}.png")
        if not args.no_save:
            from gabor_color_image_segmentation_tpu_torch.utils.visualize import save_label_map
            save_label_map(labels, out, rgb=rgb)
        print(f"{name:10s} regions={len(np.unique(labels)):3d} "
              f"PRI={pri:.4f} F={f:.4f} (P={p:.3f} R={r:.3f})"
              + ("" if args.no_save else f" -> {out}"))
        rows.append((name, labels, pri, f))
    return rows


if __name__ == "__main__":
    main()
