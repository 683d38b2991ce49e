#!/usr/bin/env python3
"""Where the PyTorch port's graph-stage kernel path and all-plain path part
ways, stage by stage, on one NVIDIA card, at config3 (batch 8 of 321x481)
or config4 (batch 8 of 2160x3840, the graph on the 540x960 pooled grid),
on mosaics with seeds 100...:

    python3 experiments/torch_graph_stages.py [--preset config3|config4]
        [--dtype bfloat16 [float32]] [--regions R]

(R ground-truth regions per mosaic, 5 by default.)

K11 or K13, K14 and K15 are bit-equal to their plain versions (chip_smoke.py
phase 3), so the two paths can differ only through K1's energies (tiled and
pooled per window at config4). For each image this prints: the share of
K1's energies that differ from the plain version's and the largest
difference of the superpixel means the two give; L_sym's spectrum around
the cut into k regions on the kernel path's features (in float64: the two
gaps lambda_k - lambda_{k-1} and lambda_{k+1} - lambda_k, how many
eigenvalues lie below 1e-9, how many live superpixels have no nonzero
affinity to any other, and how many connected components the graph of
nonzero affinities has); and the pixel agreement after alignment of the
region labels from the kernel's and the plain version's features, with the
subspace eigensolver and with the dense eigh, and of the two solvers on the
kernel's features. When more than k eigenvalues are 0 the k smallest
eigenvectors are any basis of a larger null space, and the cut is not
determined by the features.

With config4 it then runs a second witness at the CPU tests' toy geometry
(batch 2 of 192x256, tile (96, 128), 48 superpixels, the banded SLIC forced
by a gate of 0): the all-plain path on the card against the same path on
the CPU, each eigensolver pinned on both sides, agreement per image, with
the spectrum of the card's all-plain features.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import graph  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic as sl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import fused, lookup, tiled  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.utils.labels import align_labels  # noqa: E402


@contextlib.contextmanager
def swapped(pairs):
    """Set each (module, name) to its value for the block."""
    saved = [(mod, name, getattr(mod, name)) for (mod, name), _ in pairs]
    for (mod, name), fn in pairs:
        setattr(mod, name, fn)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


PLAIN_K1 = [((pl, "gabor_energies_fused"), fused.gabor_energies_fused_plain),
            ((tiled, "gabor_energies_fused"), fused.gabor_energies_fused_plain)]
PLAIN_GRAPH = [((graph, "slic_batch"),
                lambda lab, n_sp, ruler, n_iter, impl: sl.slic_plain(lab, n_sp, ruler, n_iter)),
               ((graph, "enforce_connectivity_fused"), sl.enforce_connectivity_plain),
               ((graph, "table_lookup"), lookup.table_lookup_plain)]


def agree(a: np.ndarray, r: np.ndarray) -> float:
    return float((align_labels(a, r) == r).mean())


def spectrum(feats: torch.Tensor, sp: torch.Tensor, n_sp: int, g) -> list:
    """Per image, L_sym's spectrum around the cut into g.n_regions, as a
    line of text (see the module's docstring)."""
    k = g.n_regions
    means, counts = graph.superpixel_means(feats, sp, n_sp)
    aff = graph.affinity_matrix(means, g.affinity_sigma, counts, g.affinity_sigma_scale)
    deg = aff.double().sum(dim=2)
    d = 1.0 / torch.sqrt(torch.clamp(deg, min=1e-12))
    lsym = torch.eye(n_sp, dtype=torch.float64, device=aff.device) \
        - d[:, :, None] * aff.double() * d[:, None, :]
    evals = torch.linalg.eigvalsh(lsym).cpu().numpy()
    aff, alive = aff.cpu().numpy(), (counts > 0).cpu().numpy()
    lines = []
    for i in range(aff.shape[0]):
        a = aff[i][np.ix_(alive[i], alive[i])]
        off = a - np.diag(np.diag(a))
        isolated = int((off.max(axis=1) <= 0).sum())
        n_comp = connected_components(csr_matrix(a > 0), directed=False)[0]
        gaps = np.diff(evals[i, k - 2:k + 1])
        lines.append(f"lambda_{k}-lambda_{k - 1} {gaps[0]:.3e}, lambda_{k + 1}-lambda_{k} "
                     f"{gaps[1]:.3e}, lambda_1..{k + 1} "
                     f"{np.array2string(evals[i, :k + 1], precision=3)}, "
                     f"{int((evals[i] < 1e-9).sum())} eigenvalues < 1e-9, {isolated} isolated "
                     f"of {int(alive[i].sum())} live superpixels, {n_comp} components")
    return lines


def stages(name: str, dtype: str, rgb: np.ndarray, dev: torch.device) -> None:
    cfg = preset(name).replace(dtype=dtype)
    g = cfg.graph
    bank = make_bank(cfg.bank)
    x = torch.from_numpy(rgb).to(dev)
    b, h, w, _ = rgb.shape
    ek, _ = pl.compute_energies(x, cfg, bank, g.pool)
    with swapped(PLAIN_K1):
        ep, _ = pl.compute_energies(x, cfg, bank, g.pool)
    differ = float((ek != ep).float().mean())
    del ek, ep
    fk, sp, n_sp = pl._graph_front(x, cfg, bank)
    with swapped(PLAIN_K1):
        fp, sp_p, _ = pl._graph_front(x, cfg, bank)
    assert torch.equal(sp, sp_p), "the superpixels depend on K1"

    def regions(f, eig):
        r = graph.ncut_regions(f, sp, n_sp, g.n_regions, g.affinity_sigma, eig,
                               g.affinity_sigma_scale)
        return torch.gather(r, 1, sp.long()).cpu().numpy()

    out = {(src, eig): regions(f, eig) for src, f in (("kernel", fk), ("plain", fp))
           for eig in ("subspace", "eigh")}
    mk, _ = graph.superpixel_means(fk, sp, n_sp)
    mp, _ = graph.superpixel_means(fp, sp, n_sp)
    spec = spectrum(fk, sp, n_sp, g)
    card = torch.cuda.get_device_name(0)
    print(f"{name} batch {b} of {h}x{w} {dtype} (graph on {h >> g.pool}x{w >> g.pool}, "
          f"S={n_sp}, {g.n_regions}-region cut), {card}: K1 energies differing from the "
          f"plain version {differ:.3e} of all values", flush=True)
    for i in range(b):
        print(f"image {i}: means max |diff| {float((mk[i] - mp[i]).abs().max()):.3e}; "
              f"{spec[i]}; kernel vs plain features, subspace "
              f"{agree(out['kernel', 'subspace'][i], out['plain', 'subspace'][i]):.6f}, eigh "
              f"{agree(out['kernel', 'eigh'][i], out['plain', 'eigh'][i]):.6f}; subspace vs "
              f"eigh on the kernel's features "
              f"{agree(out['kernel', 'subspace'][i], out['kernel', 'eigh'][i]):.6f}", flush=True)


def plain_card_vs_cpu(dtype: str, dev: torch.device) -> None:
    """config4's all-plain path on the card and on the CPU, at the toy
    geometry of the CPU tests, each eigensolver pinned on both sides."""
    rgb = np.stack([synthetic_mosaic(h=192, w=256, n_regions=5, seed=100 + i)[0]
                    for i in range(2)])
    base = preset("config4").replace(batch_size=2, dtype=dtype, tile_hw=(96, 128))
    for eig in ("eigh", "subspace"):
        cfg = base.replace(graph=dataclasses.replace(base.graph, n_superpixels=48,
                                                     eig_method=eig))
        with swapped(PLAIN_K1 + PLAIN_GRAPH + [((sf, "_SLIC_FUSE_BYTES"), 0)]):
            card, _ = pl.segment_batch(rgb, cfg, with_features=False, device=dev)
            cpu, _ = pl.segment_batch(rgb, cfg, with_features=False, device="cpu")
            if eig == "eigh":
                feats, sp, n_sp = pl._graph_front(torch.from_numpy(rgb).to(dev), cfg,
                                                  make_bank(cfg.bank))
                spec = spectrum(feats, sp, n_sp, cfg.graph)
        card, cpu = card.cpu().numpy(), cpu.numpy()
        print(f"config4 toy 2x192x256 {dtype}, {eig}: all-plain on the card vs all-plain on "
              f"the CPU, per image {[round(agree(card[i], cpu[i]), 6) for i in range(2)]}",
              flush=True)
    for i in range(2):
        print(f"config4 toy 2x192x256 {dtype}, image {i}, the card's all-plain features: "
              f"{spec[i]}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="config3", choices=["config3", "config4"])
    ap.add_argument("--dtype", nargs="+", default=["bfloat16"],
                    choices=["bfloat16", "float32"])
    ap.add_argument("--regions", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    set_policy()
    dev = torch.device("cuda")
    cfg = preset(args.preset)
    h, w = (321, 481) if args.preset == "config3" else cfg.image_hw
    with ProcessPoolExecutor(max_workers=min(cfg.batch_size, os.cpu_count() or 1),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        pairs = list(pool.map(synthetic_mosaic, [h] * cfg.batch_size, [w] * cfg.batch_size,
                              [args.regions] * cfg.batch_size,
                              [100 + i for i in range(cfg.batch_size)]))
    rgb = np.stack([p[0] for p in pairs])
    del pairs
    for dtype in args.dtype:
        stages(args.preset, dtype, rgb, dev)
        torch.cuda.empty_cache()
    if args.preset == "config4":
        for dtype in args.dtype:
            plain_card_vs_cpu(dtype, dev)


if __name__ == "__main__":
    main()
