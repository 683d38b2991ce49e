#!/usr/bin/env python3
"""Where the PyTorch port's config3 kernel path and all-plain path part
ways, stage by stage, on one NVIDIA card (batch 8 of 321x481 mosaics, seeds
100...):

    python3 experiments/torch_config3_stages.py [--dtype bfloat16|float32]
        [--regions R]

(R ground-truth regions per mosaic, 5 by default; the preset cuts 8.)

K11, K14 and K15 are bit-equal to their plain versions (chip_smoke.py phase
3), so the two paths can differ only through K1's energies. For each image
this prints: the share of K1's energies that differ from the plain version's
and the largest difference of the superpixel means the two give; the three
smallest gaps of L_sym's spectrum around the cut (lambda_8 - lambda_7,
lambda_9 - lambda_8, in float64); and the pixel agreement after alignment of
the region labels from the kernel's and the plain version's features, with
the subspace eigensolver and with the dense eigh, and of the two solvers on
the kernel's features.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import graph  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import fused  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import (  # noqa: E402
    bank_tensors,
    make_bank,
)
from gabor_color_image_segmentation_tpu_torch.ops.precision import (  # noqa: E402
    set_policy,
    storage_dtype,
)
from gabor_color_image_segmentation_tpu_torch.utils.labels import align_labels  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    ap.add_argument("--regions", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    set_policy()
    dev = torch.device("cuda")
    cfg = preset("config3").replace(dtype=args.dtype)
    g = cfg.graph
    dt = storage_dtype(cfg.dtype)
    rgb = np.stack([synthetic_mosaic(h=321, w=481, n_regions=args.regions, seed=100 + i)[0]
                    for i in range(cfg.batch_size)])
    x = torch.from_numpy(rgb).to(dev)
    b, h, w, _ = rgb.shape
    color = pl._color_transform(x, "lab")
    groups = bank_tensors(make_bank(cfg.bank), dev)
    ek, _ = fused.gabor_energies_fused(color, groups, dt, pooled=False)
    ep, _ = fused.gabor_energies_fused_plain(color, groups, dt, pooled=False)
    c4 = pl.build_color4(color, dt)

    def features(e):
        a, b_aff = pl._affine_params(e, c4, cfg.cluster, 1e-6)
        return pl.assemble_xp_from_affine(e, c4, a, b_aff, dt)

    fk, fp = features(ek), features(ep)
    _, sp, n_sp = pl._graph_front(x, cfg, make_bank(cfg.bank))

    def regions(f, eig):
        r = graph.ncut_regions(f, sp, n_sp, g.n_regions, g.affinity_sigma, eig,
                               g.affinity_sigma_scale)
        return torch.gather(r, 1, sp.long()).cpu().numpy()

    out = {(src, eig): regions(f, eig) for src, f in (("kernel", fk), ("plain", fp))
           for eig in ("subspace", "eigh")}
    mk, _ = graph.superpixel_means(fk, sp, n_sp)
    mp, counts = graph.superpixel_means(fp, sp, n_sp)
    aff = graph.affinity_matrix(mk, g.affinity_sigma, counts, g.affinity_sigma_scale)
    deg = aff.double().sum(dim=2)
    d = 1.0 / torch.sqrt(torch.clamp(deg, min=1e-12))
    lsym = torch.eye(n_sp, dtype=torch.float64, device=dev) - d[:, :, None] * aff.double() \
        * d[:, None, :]
    evals = torch.linalg.eigvalsh(lsym).cpu().numpy()
    card = torch.cuda.get_device_name(0)
    print(f"config3 batch {b} {args.dtype}, {args.regions}-region mosaics, {card}: K1 "
          f"energies differing from the plain version "
          f"{float((ek != ep).float().mean()):.3e} of all values")

    def agree(a, r):
        return float((align_labels(a, r) == r).mean())

    k = g.n_regions
    for i in range(b):
        gaps = np.diff(evals[i, k - 2:k + 1])
        print(f"image {i}: means max |diff| {float((mk[i] - mp[i]).abs().max()):.3e}; "
              f"gaps lambda_{k}-lambda_{k - 1} {gaps[0]:.3e}, lambda_{k + 1}-lambda_{k} "
              f"{gaps[1]:.3e}; kernel vs plain features, subspace "
              f"{agree(out['kernel', 'subspace'][i], out['plain', 'subspace'][i]):.6f}, eigh "
              f"{agree(out['kernel', 'eigh'][i], out['plain', 'eigh'][i]):.6f}; subspace vs "
              f"eigh on the kernel's features "
              f"{agree(out['kernel', 'subspace'][i], out['kernel', 'eigh'][i]):.6f}", flush=True)


if __name__ == "__main__":
    main()
