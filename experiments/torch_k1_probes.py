#!/usr/bin/env python3
"""Where K1's time goes, by switching its phases off, on one NVIDIA card.

    python3 experiments/torch_k1_probes.py

Builds csrc/gabor_energies.cu five times into the git-ignored ``_build/``
(text-patched copies, the source itself untouched): as it is, and with
one phase of the magnitude launch switched off each time (the row pass's
tap loops, the column pass with the demodulation, the staging copies,
the magnitude store), then times both launches of each config1 scale
group (16 x 321 x 481, bf16 out; median of 5 calls, CUDA events). The
outputs of the patched builds are meaningless: only their times are read.
Prints the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import fused  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank  # noqa: E402

# (name, source text, its replacement): each probe guards one phase
PROBES = [
    ("full", None, None),
    ("no row-pass taps", "    tap_run<MOD ? 2 : 1>(taps, ntap,",
     "    if (0) tap_run<MOD ? 2 : 1>(taps, ntap,"),
    ("no column pass or demodulation", "    if (cols) {", "    if (0) {"),
    ("no staging copies", "      __pipeline_memcpy_async(s.mr",
     "      if (0) __pipeline_memcpy_async(s.mr"),
    ("no magnitude store", "      if (i0 + y < H && j0 + xo < W) mp[",
     "      if (0 && i0 + y < H && j0 + xo < W) mp["),
]


def build() -> list[Path]:
    src = (_kernels._CSRC / "gabor_energies.cu").read_text()
    src = src.replace('#include "common.cuh"', f'#include "{_kernels._CSRC / "common.cuh"}"')
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._find_nvcc()
    libs, procs = [], []
    for k, (_, old, new) in enumerate(PROBES):
        text = src if old is None else src.replace(old, new)
        if old is not None and text == src:
            sys.exit(f"probe {k}: pattern not found in gabor_energies.cu")
        cu = _kernels.BUILD_DIR / f"k1_probe{k}.cu"
        cu.write_text(text)
        lib = _kernels.BUILD_DIR / f"k1_probe{k}.so"
        procs.append(subprocess.Popen([nvcc, *_kernels.NVCC_FLAGS, "-shared", str(cu), "-o",
                                       str(lib)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        libs.append(lib)
    for proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(log)
    return libs


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    libs = build()
    dev = torch.device("cuda")
    rgb = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=100 + i)[0]
                    for i in range(16)])
    x = fused._centered(pl._color_transform(torch.from_numpy(rgb).to(dev), "lab"))
    groups = bank_tensors(make_bank(preset("config1").bank), dev)
    b, c, h, w = x.shape
    e = sum(g.n * c for g in groups)
    out = torch.empty((b, e, h, w), dtype=torch.bfloat16, device=dev)
    twin = torch.empty((b, e, h // 2, w // 2), dtype=torch.bfloat16, device=dev)
    mag = torch.empty((b, max(g.n for g in groups) * c, h, w), device=dev)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    for (name, _, _), path in zip(PROBES, libs):
        fn = ctypes.CDLL(str(path)).gcis_gabor_group
        fn.argtypes = [p_] * 13 + [i_] * 10 + [p_]
        fn.restype = i_
        for g in groups:
            # bf16 mode's inputs, as ops/fused.py hands them over
            env = fused._round_storage(g.env, True)
            taps = (fused.smooth_taps(g, False, True), fused.smooth_taps(g, True, True),
                    fused.smooth_table(g, h, False, True), fused.smooth_table(g, w, False, True),
                    fused.smooth_table(g, h, True, True), fused.smooth_table(g, w, True, True))

            def run():
                rc = fn(x.data_ptr(), mag.data_ptr(), out.data_ptr(), twin.data_ptr(),
                        env.data_ptr(), g.freqs.data_ptr(), g.mus.data_ptr(),
                        *(t.data_ptr() for t in taps),
                        b, c, h, w, g.n, g.p, g.r, e, 0, 1,
                        torch.cuda.current_stream().cuda_stream)
                if rc:
                    sys.exit(f"gcis_gabor_group failed: CUDA error {rc}")

            run()
            times = []
            for _ in range(5):
                t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0.record()
                run()
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1))
            print(f"K1 probe [{name}] group radii ({g.p}, {g.r}), both launches: "
                  f"{statistics.median(times):.4f} ms ({card})", flush=True)


if __name__ == "__main__":
    main()
