#!/usr/bin/env python3
"""Time K1 and K14 on one NVIDIA card at the main paths' shapes, against
their plain versions, and print their compile statistics.

    python3 experiments/torch_k1_k14.py

K1 (``gabor_energies_fused``) at config1 (16 x 321 x 481 bf16, with the
twin) and with a wide bank (conv radius 32, smoothing radius 50); K14
(``enforce_connectivity_fused``) on a fragmented random map at config3's
grid (8 x 321 x 481, S = 925) and config4's pooled grid (8 x 540 x 960, S
= 405), and on the spiral maze with its kept block in a corner. Each line:
max error against the plain version, kernel ms (median of 5 calls after a
warm-up, CUDA events), the card's name and power limit. With
``--ptxas`` it also compiles csrc/gabor_energies.cu and
csrc/connectivity.cu once with ``-Xptxas -v`` and prints registers,
shared memory and spills; with ``--profile`` it prints torch.profiler's
device time by kernel for one config1 K1 call.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.config import BankConfig, preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import (  # noqa: E402
    connectivity_maze,
    synthetic_mosaic,
)
from gabor_color_image_segmentation_tpu_torch.models import connectivity as cn  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic as sl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import fused  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank  # noqa: E402


def cuda_ms(fn, reps=5):
    fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def ptxas() -> None:
    nvcc = _kernels._find_nvcc()
    for src in ("gabor_energies.cu", "connectivity.cu"):
        res = subprocess.run([nvcc, *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                              str(_kernels._CSRC / src), "-o", "/dev/null"],
                             capture_output=True, text=True)
        lines = [ln for ln in (res.stdout + res.stderr).splitlines()
                 if "registers" in ln or "spill" in ln or "error" in ln.lower()]
        print(f"ptxas {src}:\n  " + "\n  ".join(lines), flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if "--ptxas" in sys.argv:
        ptxas()
    _kernels.library()
    dev = torch.device("cuda")
    rgb = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=100 + i)[0]
                    for i in range(16)])
    color = pl._color_transform(torch.from_numpy(rgb).to(dev), "lab")
    for name, bank, batch in (("config1", preset("config1").bank, 16),
                              ("radii 32/50", BankConfig(scales=(2.0, 11.0), orientations=2,
                                                         max_ksize=65, smoothing=1.5), 2)):
        groups = bank_tensors(make_bank(bank), dev)
        x = color[:batch]
        for dt in (torch.bfloat16, torch.float32):
            out, tw = fused.gabor_energies_fused(x, groups, dt)
            ref, rtw = fused.gabor_energies_fused_plain(x, groups, dt)
            torch.cuda.synchronize()
            peak = ref.float().abs().max().item()
            err = max((out.float() - ref.float()).abs().max().item(),
                      (tw.float() - rtw.float()).abs().max().item()) / peak
            del ref, rtw
            ms = cuda_ms(lambda: fused.gabor_energies_fused(x, groups, dt))
            print(f"K1 {name} {tuple(x.shape)} {dt}: err {err:.3e} of the peak, "
                  f"{ms:.4f} ms ({card})", flush=True)
            if "--profile" in sys.argv and name == "config1" and dt == torch.bfloat16:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    fused.gabor_energies_fused(x, groups, dt)
                    torch.cuda.synchronize()
                print(prof.key_averages().table(sort_by="self_cuda_time_total",
                                                row_limit=8), flush=True)
                # each launch in order, beside its group's radii (p, r)
                radii = [(g.p, g.r) for g in groups]
                launches = [e for e in prof.events() if "_kernel" in e.name
                            and ("gabor_mag" in e.name or "smooth" in e.name)]
                for k, e in enumerate(launches):
                    print(f"  launch {k}: {e.name.split('(')[0][-22:]} group radii "
                          f"{radii[k // 2]}: {e.device_time_total / 1e3:.4f} ms", flush=True)
    del color
    torch.cuda.empty_cache()
    rng = np.random.default_rng(14)
    for (h, w, s) in ((321, 481, 925), (540, 960, 405)):
        base = rng.integers(0, s, ((h + 7) // 8, (w + 7) // 8))
        frag = np.kron(base, np.ones((8, 8), int))[:h, :w]
        frag = np.where(rng.random((h, w)) < 0.25, rng.integers(0, s, (h, w)), frag)
        maze = connectivity_maze(h, w, "corner")
        for what, lab_np, n_sp, min_size in (("fragmented", frag, s, None),
                                            ("maze, corner kept", maze, 16, 5)):
            lab = torch.from_numpy(np.stack([lab_np] * 8).astype(np.int32)).to(dev)
            got = cn.enforce_connectivity_fused(lab, n_sp, min_size)
            ref = sl.enforce_connectivity_plain(lab, n_sp, min_size)
            torch.cuda.synchronize()
            ndiff = int((got != ref).sum())
            ms = cuda_ms(lambda: cn.enforce_connectivity_fused(lab, n_sp, min_size))
            r = sl.connectivity_readings(lab[:1], n_sp, min_size)
            print(f"K14 8x{h}x{w} {what}: {ndiff} pixels differ, {ms:.4f} ms; {r} ({card})",
                  flush=True)


if __name__ == "__main__":
    main()
