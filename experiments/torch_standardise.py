"""The standardisation on the card (csrc/standardise.cu) at the benchmark
cells' shapes: its time beside the plain stage and the bytes bound, and the
labels of the stage against the plain stage.

  python3 experiments/torch_standardise.py [--seeds 4] [--ptxas] [--no-labels]

For config1 (16 x 321 x 481, bf16: K1's energies and twin) and config2 (50
x 321 x 481, bf16: K1's energies, float32 colour) it runs the calls the
pipeline makes inside its ``assemble`` and ``assemble_xp`` spans, once
through the kernels and once through their plain twins on the card, in
turns (kernels, plain, plain, kernels; CUDA events), and each kernel
wrapper alone; the bound is the bytes the stage must move (each input read
once, each output written once) over 3.35 TB/s. Then ``segment_batch`` on
``--seeds`` batches of each cell's size with the kernels against the same
call with the pipeline's standardisation on its plain twins: the per-image
label mismatch (after matching ids), median and worst. Writes a JSON line
to chiprun_out/torch_standardise.json. Needs the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

from _turns import HBM_BYTES_PER_MS, ROOT, card_line, cuda_ms, ptxas  # noqa: E402

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models.gmm import gmm_fit_levels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import build_color4  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import standardise as sd  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.fused import gabor_energies_fused  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.utils.labels import align_labels  # noqa: E402

PLAIN = {"affine_params": sd.affine_params_plain, "normalised_rows": sd.normalised_rows_plain,
         "pool2x2": sd.pool2x2_plain}
KERNELS = {"affine_params": sd.affine_params, "normalised_rows": sd.normalised_rows,
           "pool2x2": sd.pool2x2}


def frames(b, seed):
    return np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=seed + i)[0]
                     for i in range(b)])


def inputs(name, dev):
    cfg = preset(name).replace(dtype="bfloat16")
    b = 16 if name == "config1" else 50
    rgb = torch.from_numpy(frames(b, 7000)).to(dev)
    color = rgb_to_lab(rgb.float() / 255.0)
    energies, twin = gabor_energies_fused(color, bank_tensors(make_bank(cfg.bank), dev),
                                          torch.bfloat16, pooled=name == "config1")
    return cfg, color, energies, twin


def stage(name, cfg, color, energies, twin, fns):
    """The pipeline's assemble and assemble_xp calls for the cell, through
    ``fns`` (the kernels or the plain twins): the buffers they write."""
    dt = energies.dtype
    c = cfg.cluster
    if name == "config1":
        xc4 = build_color4(color, dt)
        pc0 = fns["pool2x2"](xc4)
        a, b = fns["affine_params"](energies, xc4, c, 1e-6, (twin, pc0))
        return (pc0, a, b) + fns["normalised_rows"](twin, pc0, a, b, (1,))
    c4 = build_color4(color, torch.float32)
    a, b = fns["affine_params"](energies, c4, c, 1e-6)
    lv = gmm_fit_levels(321, 481, c.gmm_fit_pool)[2]
    return (a, b) + fns["normalised_rows"](energies, c4, a, b, (0, lv))


def stage_bytes(name, color, energies, twin):
    """Each input read once, each output written once: the stage's least traffic."""
    b, e, h, w = energies.shape
    n = h * w
    if name == "config1":
        m = (h // 4) * (w // 4)
        return energies.nbytes + twin.nbytes + b * 3 * n * 4 + b * (e + 3) * m * 2
    m = (h // 4) * (w // 4)
    return energies.nbytes + b * 3 * n * 4 + b * (e + 3) * (n + m) * 2


def kernel_ms(name, cfg, color, energies, twin):
    """Each kernel wrapper alone, ms a call."""
    dt = energies.dtype
    c = cfg.cluster
    out = {}
    if name == "config1":
        xc4 = build_color4(color, dt)
        pc0 = sd.pool2x2(xc4)
        out["pool2x2 colour"] = cuda_ms(lambda: sd.pool2x2(xc4), inner=10)
        out["moments full"] = cuda_ms(lambda: sd._moments(energies, xc4, 0, 321, 481), inner=5)
        out["moments twin (coherence)"] = cuda_ms(lambda: sd._moments(twin, pc0, 2, 40, 60),
                                                  inner=10)
        out["affine_params"] = cuda_ms(lambda: sd.affine_params(energies, xc4, c, 1e-6,
                                                                (twin, pc0)), inner=5)
        a, b = sd.affine_params(energies, xc4, c, 1e-6, (twin, pc0))
        out["normalised_rows coarse"] = cuda_ms(
            lambda: sd.normalised_rows(twin, pc0, a, b, (1,)), inner=10)
    else:
        c4 = build_color4(color, torch.float32)
        out["moments full"] = cuda_ms(lambda: sd._moments(energies, c4, 0, 321, 481), inner=5)
        out["affine_params"] = cuda_ms(lambda: sd.affine_params(energies, c4, c, 1e-6), inner=5)
        a, b = sd.affine_params(energies, c4, c, 1e-6)
        out["normalised_rows full + fit"] = cuda_ms(
            lambda: sd.normalised_rows(energies, c4, a, b, (0, 2)), inner=5)
    return {k: round(v, 4) for k, v in out.items()}


def mismatch(name, seeds, dev):
    """Per-image label mismatch of segment_batch with the kernels against
    the plain stage, over ``seeds`` batches: (median, worst, images)."""
    cfg = preset(name).replace(dtype="bfloat16")
    b = 16 if name == "config1" else 50
    bank = make_bank(cfg.bank)
    per = []
    for s in range(seeds):
        rgb = frames(b, 9000 + 1000 * s)
        got, _ = pipeline.segment_batch(rgb, cfg, bank, with_features=False)
        for k, fn in PLAIN.items():
            setattr(pipeline, k, fn)
        try:
            want, _ = pipeline.segment_batch(rgb, cfg, bank, with_features=False)
        finally:
            for k, fn in KERNELS.items():
                setattr(pipeline, k, fn)
        got, want = got.cpu().numpy(), want.cpu().numpy()
        per += [float((align_labels(got[i], want[i]) != want[i]).mean()) for i in range(b)]
    return statistics.median(per), max(per), len(per)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--no-labels", action="store_true")
    args = ap.parse_args(argv)
    set_policy()
    dev = torch.device("cuda")
    _kernels.library()
    card = card_line()
    print(f"card: {card}, torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    if args.ptxas:
        ptxas(_kernels._CSRC, ["standardise.cu"], "standardise")
    result = {"card": card}
    for name in ("config1", "config2"):
        cfg, color, energies, twin = inputs(name, dev)
        new = stage(name, cfg, color, energies, twin, KERNELS)
        plain = stage(name, cfg, color, energies, twin, PLAIN)
        torch.cuda.synchronize()
        ia = 1 if name == "config1" else 0  # where (a, b) sits in the stage's buffers
        a_rel = ((new[ia] - plain[ia]).abs() / plain[ia].abs()).max().item()
        again = stage(name, cfg, color, energies, twin, KERNELS)
        bits = all(torch.equal(x, y) for x, y in zip(new, again))
        # the buffers from the plain twins' affine, through the kernels
        if name == "config1":
            pooled_equal = torch.equal(new[0], plain[0])
            ref = sd.normalised_rows(twin, plain[0], plain[1], plain[2], (1,))
            bufs_equal = pooled_equal and torch.equal(ref[0], plain[3])
        else:
            c4 = build_color4(color, torch.float32)
            ref = sd.normalised_rows(energies, c4, plain[0], plain[1], (0, 2))
            bufs_equal = all(torch.equal(x, y) for x, y in zip(ref, plain[2:]))
        del new, plain, again, ref
        times = []
        for fns in (KERNELS, PLAIN, PLAIN, KERNELS):
            times.append(cuda_ms(lambda: stage(name, cfg, color, energies, twin, fns), inner=3))
        nbytes = stage_bytes(name, color, energies, twin)
        bound_ms = nbytes / HBM_BYTES_PER_MS
        k_ms = statistics.mean([times[0], times[3]])
        res = {"stage_ms": round(k_ms, 4), "plain_ms": round(statistics.mean(times[1:3]), 4),
               "turns_ms": [round(t, 4) for t in times], "bytes": nbytes,
               "bound_ms": round(bound_ms, 4), "share_of_bound": round(bound_ms / k_ms, 4),
               "buffers_bit_equal_given_affine": bufs_equal, "two_calls_bit_equal": bits,
               "a_max_rel_vs_plain": a_rel,
               "kernels_ms": kernel_ms(name, cfg, color, energies, twin)}
        del color, energies, twin
        torch.cuda.empty_cache()
        if not args.no_labels:
            med, worst, n = mismatch(name, args.seeds, dev)
            res["labels_vs_plain"] = {"median_image_mismatch": med,
                                      "worst_image_mismatch": worst, "images": n}
        result[name] = res
        print(f"{name}: {json.dumps(res)}", flush=True)
    out = ROOT / "chiprun_out" / "torch_standardise.json"
    out.parent.mkdir(exist_ok=True)
    with out.open("a") as f:
        f.write(json.dumps(result) + "\n")


if __name__ == "__main__":
    main()
