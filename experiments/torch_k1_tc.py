#!/usr/bin/env python3
"""K1's bf16 route (banded products on the tensor cores) on one NVIDIA card.

    python3 experiments/torch_k1_tc.py [--check] [--ptxas] [--parent DIR] [--probes] [--reps N]

``--check``: K1 in bf16 against its plain version on the same CUDA tensors
(small banks whose bands fit the registers and banks past them, at 37x53
and 64x96; config1's bank at 37x53 and 321x481, two frames): the share of
equal values and the largest difference over the peak, energies and twin;
config1 in float32 against 1e-4 of the peak; ``tc_groups`` a call.
``--ptxas``: registers, shared memory and spills of ``gabor_energies.cu``.
Always: config1's batch (16 x 321 x 481, bf16, the benchmark cell's), each
kernel's device time from a profiler trace of 3 calls, and the whole call
with CUDA events against the cell's least time (``gpubench/yardstick.py``).
``--parent DIR`` (a ``git archive`` of the parent commit): the parent's K1
built from its source and bound with its C signature (13 pointers), timed
in turns parent, change, change, parent. ``--probes``: the source rebuilt
with one phase of a kernel switched off at a time (text-patched copies in
``_build/``, outputs meaningless), each kernel's time. Prints the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from _turns import ROOT, build, card_line, cuda_ms, ptxas, source  # noqa: E402

from gabor_color_image_segmentation_tpu_torch.config import BankConfig, preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import fused  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402

BANKS = {
    "small": BankConfig(scales=(2.0, 4.0, 8.0), orientations=3, frequencies=(0.12,)),
    "smooth_radius_25": dataclasses.replace(preset("config0").bank, smooth_truncate=3.1),
    "radii_32_50": BankConfig(scales=(2.0, 11.0), orientations=2, max_ksize=65, smoothing=1.5),
    "radii_300": BankConfig(scales=(2.0, 100.0), orientations=1, frequencies=(0.12,),
                            max_ksize=601, smoothing=1.0),
    "config1": preset("config1").bank,
}
_P, _I = ctypes.c_void_p, ctypes.c_int
# (name, [(source text, its replacement)]): each probe switches one phase off
# or changes one plan
HM = "      band_mma<false>(bd, v{}, L.ldv, 16 * jb, 16 * ib, lane, g{});"
PROBES = [
    ("mag: no modulation", [("      while (t < L.rx) {", "      while (0) {")]),
    ("mag: no vertical products", [("      band_mma<true>(bd, pl ? mi : mr,",
                                    "      if (0) band_mma<true>(bd, pl ? mi : mr,")]),
    ("mag: no horizontal products", [(HM.format("r", "r"), "if (0) " + HM.format("r", "r")),
                                     (HM.format("i", "i"), "if (0) " + HM.format("i", "i"))]),
    ("mag: no stores", [("      if (oi < H && oj < ldw)", "      if (0)")]),
    ("mag: no plane waves", [("    if (jj + 1 < n) waves(jj + 1);", "    if (0) waves(jj + 1);")]),
    ("mag: 32-row tiles", [("mag_plans[4][2] = {{64, 0},", "mag_plans[4][2] = {{32, 0},")]),
    ("smooth: 32-row tiles", [("smooth_plans[4][2] = {{64, 0},",
                               "smooth_plans[4][2] = {{32, 0},")]),
    ("smooth: no staging copies", [("        gcis::cp_async16(dst,",
                                    "        if (0) gcis::cp_async16(dst,")]),
    ("smooth: no vertical products", [("      band_mma<true>(bd, sm, L.lds,",
                                       "      if (0) band_mma<true>(bd, sm, L.lds,")]),
    ("smooth: no horizontal products", [("    band_mma<false>(bd, second ? pv : v,",
                                         "    if (0) band_mma<false>(bd, second ? pv : v,")]),
    ("smooth: no stores", [("j < ow; j += 32) op[", "j < 0; j += 32) op["),
                           ("j < ow2; j += 32) tp[", "j < 0; j += 32) tp[")]),
]


def lab_batch(b, h, w, dev):
    rgb = np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0] for i in range(b)])
    return pl._color_transform(torch.from_numpy(rgb).to(dev), "lab").contiguous()


def check(dev):
    for name, bank in BANKS.items():
        groups = bank_tensors(make_bank(bank), dev)
        shapes = [(37, 53), (321, 481)] if name == "config1" else [(37, 53), (64, 96)]
        for h, w in shapes:
            img = torch.randn((2, h, w, 3), generator=torch.Generator().manual_seed(1)).to(dev)
            n0 = fused.gabor_energies_fused.tc_groups
            out, twin = fused.gabor_energies_fused(img, groups, torch.bfloat16)
            tc = fused.gabor_energies_fused.tc_groups - n0
            ref, ref_twin = fused.gabor_energies_fused_plain(img, groups, torch.bfloat16)
            torch.cuda.synchronize()
            peak = ref.float().abs().max().item()
            readings = []
            for got, want in ((out, ref), (twin, ref_twin)):
                readings.append(f"equal {(got == want).float().mean().item():.6f} max diff/peak "
                                f"{((got.float() - want.float()).abs().max().item() / peak):.3e}")
            print(f"check bf16 {name} {h}x{w} radii {[(g.p, g.r) for g in groups]}: energies "
                  f"{readings[0]}; twin {readings[1]}; tc_groups +{tc}", flush=True)
    groups = bank_tensors(make_bank(BANKS["config1"]), dev)
    img = torch.randn((2, 321, 481, 3), generator=torch.Generator().manual_seed(0)).to(dev)
    n0 = fused.gabor_energies_fused.tc_groups
    out, twin = fused.gabor_energies_fused(img, groups, torch.float32)
    ref, ref_twin = fused.gabor_energies_fused_plain(img, groups, torch.float32)
    torch.cuda.synchronize()
    peak = ref.abs().max().item()
    print(f"check f32 config1 321x481: max diff/peak energies "
          f"{(out - ref).abs().max().item() / peak:.3e}, twin "
          f"{(twin - ref_twin).abs().max().item() / peak:.3e} (contract 1e-4); tc_groups "
          f"+{fused.gabor_energies_fused.tc_groups - n0}", flush=True)


def parent_k1(parent: Path, groups, x):
    """The parent's K1 (its FMA tap loops in bf16) as a function of no
    arguments, on x (B, C, H, W) centred float32."""
    (lib,) = build([source(parent / "gabor_color_image_segmentation_tpu_torch" / "csrc",
                           "gabor_energies.cu")], ["parent_gabor_energies"],
                   {"gcis_gabor_group": [_P] * 13 + [_I] * 10 + [_P]})
    b, c, h, w = x.shape
    e = sum(g.n * c for g in groups)
    out = torch.empty((b, e, h, w), dtype=torch.bfloat16, device=x.device)
    twin = torch.empty((b, e, h // 2, w // 2), dtype=torch.bfloat16, device=x.device)
    mag = torch.empty((b, max(g.n for g in groups) * c, h, w), device=x.device)
    args = []
    for g in groups:
        env = fused._round_storage(g.env, True)
        taps = (fused.smooth_taps(g, False, True), fused.smooth_taps(g, True, True),
                fused.smooth_table(g, h, False, True), fused.smooth_table(g, w, False, True),
                fused.smooth_table(g, h, True, True), fused.smooth_table(g, w, True, True))
        args.append((g, env, taps))

    def run():
        goff = 0
        for g, env, taps in args:
            rc = lib.gcis_gabor_group(x.data_ptr(), mag.data_ptr(), out.data_ptr(),
                                      twin.data_ptr(), env.data_ptr(), g.freqs.data_ptr(),
                                      g.mus.data_ptr(), *(t.data_ptr() for t in taps),
                                      b, c, h, w, g.n, g.p, g.r, e, goff, 1,
                                      torch.cuda.current_stream().cuda_stream)
            if rc:
                sys.exit(f"parent gcis_gabor_group: CUDA error {rc}")
            goff += g.n * c
    return run, (out, twin)


def probes(groups, x):
    """Each probe's kernel times on x (B, C, H, W) centred float32, bf16."""
    csrc = ROOT / "gabor_color_image_segmentation_tpu_torch" / "csrc"
    texts = [source(csrc, "gabor_energies.cu")]
    texts += [source(csrc, "gabor_energies.cu", edits) for _, edits in PROBES]
    libs = build(texts, [f"k1_tc_probe{k}" for k in range(len(texts))],
                 {"gcis_gabor_group": [_P] * 19 + [_I] * 10 + [_P]})
    b, c, h, w = x.shape
    e = sum(g.n * c for g in groups)
    out = torch.empty((b, e, h, w), dtype=torch.bfloat16, device=x.device)
    twin = torch.empty((b, e, h // 2, w // 2), dtype=torch.bfloat16, device=x.device)
    mag = torch.empty((b, max(g.n for g in groups) * c, h, fused.mag_pitch(w)),
                      dtype=torch.bfloat16, device=x.device)
    tables = [fused.band_tables(g, h, w, True) for g in groups]
    for (name, _), lib in zip([("as built", None)] + PROBES, libs):
        def run():
            goff = 0
            for g, tab in zip(groups, tables):
                rc = lib.gcis_gabor_group(x.data_ptr(), mag.data_ptr(), out.data_ptr(),
                                          twin.data_ptr(), None, g.freqs.data_ptr(),
                                          g.mus.data_ptr(), *([None] * 6),
                                          *(t.data_ptr() for t in tab),
                                          b, c, h, w, g.n, g.p, g.r, e, goff, 1,
                                          torch.cuda.current_stream().cuda_stream)
                if rc:
                    sys.exit(f"probe {name}: CUDA error {rc}")
                goff += g.n * c
        print(f"probe [{name}]: " + ", ".join(f"{k} {v:.4f}" for k, v in
                                              sorted(kernel_split(run).items())), flush=True)


def kernel_split(fn, calls=3):
    """Device ms a call of each K1 kernel, from a profiler trace."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None) or getattr(ev, "self_cuda_time_total", 0)
        for k in ("gabor_mag_kernel", "smooth_kernel"):
            if k in ev.key:
                split[k] = split.get(k, 0.0) + us / 1e3 / calls
    return split


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    set_policy()
    print(card_line(), flush=True)
    csrc = ROOT / "gabor_color_image_segmentation_tpu_torch" / "csrc"
    if "--ptxas" in sys.argv:
        ptxas(csrc, ["gabor_energies.cu"], "change")
    dev = torch.device("cuda")
    if "--check" in sys.argv:
        check(dev)
    reps = int(sys.argv[sys.argv.index("--reps") + 1]) if "--reps" in sys.argv else 5
    lab = lab_batch(16, 321, 481, dev)
    groups = bank_tensors(make_bank(BANKS["config1"]), dev)

    def change():
        return fused.gabor_energies_fused(lab, groups, torch.bfloat16)

    sys.path.insert(0, str(ROOT))
    from gpubench import yardstick
    bank = json.loads((ROOT / "gpubench" / "configs" / "config1-bf16.json").read_text())["bank"]
    least, by = yardstick.least_seconds(
        *yardstick.energies_counts(16, 321, 481, 3, bank, True, "bfloat16"),
        yardstick.PEAKS["bf16_tensor_flop_per_s"])
    split = kernel_split(change)
    print("config1 16x321x481 bf16, device ms a call by kernel: "
          + ", ".join(f"{k} {v:.4f}" for k, v in sorted(split.items())), flush=True)
    x = fused._centered(lab)
    if "--probes" in sys.argv:
        probes(groups, x)
    run_parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve()
        run_parent, par_out = parent_k1(parent, groups, x)
        run_parent()
        out, twin = change()
        torch.cuda.synchronize()
        print(f"parent vs change energies equal {(out == par_out[0]).float().mean().item():.6f}, "
              f"twin {(twin == par_out[1]).float().mean().item():.6f}", flush=True)
        print("parent " + ", ".join(f"{k} {v:.4f}" for k, v in
                                    sorted(kernel_split(run_parent).items())), flush=True)
    order = ("parent", "change", "change", "parent") if run_parent else ("change",)
    for who in order:
        ms = cuda_ms(run_parent if who == "parent" else change, inner=3, reps=reps)
        print(f"K1 {who}: {ms:.4f} ms a call, {100 * 1e3 * least / ms:.4f} % of its least "
              f"time {1e3 * least:.4f} ms ({by})", flush=True)


if __name__ == "__main__":
    main()
