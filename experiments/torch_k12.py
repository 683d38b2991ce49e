#!/usr/bin/env python3
"""Time K12 (``slic_fused.slic_w5``, the one-launch banded SLIC) on one
NVIDIA card against a parent commit's kernel in turns, K13's loop against
the parent's, K12 by cluster shape and K12 with one phase off.

    python3 experiments/torch_k12.py [--parent DIR] [--ptxas] [--shapes] [--probes] [--quick]
                                     [--sass] [--profile]

Frames (synthetic mosaics, seeds 100...; 10 iterations, ruler 10): K12's
8x321x481 with 400 superpixels (S = 384), the same at batch 1, and the
extremes of the range ``slic_route(h, w, S, "w5")`` admits, 8x1052x16 and
8x1422x16 with S = 12,000 and 8x1422x127 with S = 10; K13 at config4's
pooled grid, 8x540x960 with S = 405.

``--parent DIR``: a checkout of the parent commit (``git archive``
unpacked into a git-ignored directory); its csrc/slic_banded.cu is built
into a shared library of its own (common.cuh and slic_common.cuh inlined)
and bound with the parent's signatures (commit 6094e00: K12 one
cooperative launch that updates the centroids in place, K13's pass and
update as now). Then, parent, change, change, parent in turns: K12 at each
frame (a call is a copy of the seed centroids and one launch, for both
commits: the parent's kernel writes them), its labels compared with the
parent's; K13's loop (11 passes, 10 updates, seed copy included) and one
K13 pass with partials at config4's pooled grid, labels and partials
compared bit for bit.

Then the change alone: K12's plan at each frame (cluster shape, CTAs an
image, groups, waves, where the partials live, shared memory) beside the
wrapper's time host to host (seeding included) and the bound chip_smoke.py
computes. ``--shapes``: K12 at every cluster shape the card holds
(``slic_fused.W5_SHAPES``, clusters of 1-16 CTAs of 1, 2 or 4 groups of
256 threads, pieces 128 or 64 columns wide), the plan's choice marked, with
the plan model's cost.
``--probes``: K12 rebuilt from text-patched copies of csrc/slic_banded.cu
into the git-ignored ``_build/``, each with one phase off (K12_PROBES),
timed at the plan's shape at 8x321x481 and at batch 1; the outputs of a
probe are meaningless, only its time is read. ``--ptxas`` prints
registers, shared memory and spills of both commits' slic_banded.cu.
``--profile``: one call of K12 rebuilt with clock64() counters
(PROFILE_EDITS) at K12's frame and batch 1: the cycles of a row step's
Lab loads, scoring and whole run, of a piece's prologue and reduction, of
the cluster barrier's wait, the update and an iteration's passes.
``--quick``: K12's frame and batch 1 only, no K13. ``--sass`` writes
K12's SASS (cuobjdump) to chiprun_out/k12_sass.txt.

Timing: CUDA events, the mean of 20 back-to-back calls behind a sleep
kernel, median of 5, with the helpers of ``_turns.py``. Every line carries
the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic as sl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab  # noqa: E402
from _turns import bound, build, card_line, cuda_ms, ptxas, source  # noqa: E402

INNER = 20
N_ITER, RULER = 10, 10.0
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the parent's signatures (commit 6094e00)
PARENT_SIGNATURES = {
    "gcis_slic_w5": [_P] * 4 + [_I] * 9 + [_F] * 3 + [_P],
    "gcis_slic_band_pass": [_P] * 4 + [_I] * 8 + [_F] * 3 + [_P],
    "gcis_slic_band_update": [_P] * 2 + [_I] * 7 + [_P],
}
# (tag, batch, h, w, superpixels)
FRAMES = [("K12's frame", 8, 321, 481, 400), ("batch 1", 1, 321, 481, 400),
          ("extreme S", 8, 1052, 16, 12000), ("extreme bands", 8, 1422, 16, 12000),
          ("extreme pixels", 8, 1422, 127, 10)]
K13_FRAME = (8, 540, 960, 405)

# (name, edits) of slic_banded.cu: K12 with one phase off
K12_PROBES = [
    ("as built", []),
    ("probe: no pass but the last", [
        ("    for (int q = p0 + group; q < p1; q += NG) {",
         "    for (int q = p0 + group; q < (last ? p1 : p0); q += NG) {")]),
    ("probe: no update", [
        ("    for (int e = tid; e < nt; e += NG * NT) {  // the table's new centroids",
         "    for (int e = tid; e < 0; e += NG * NT) {  // the table's new centroids")]),
    ("probe: no cluster barrier", [
        ("cluster.sync();  // the iteration's barrier: every piece's partials are written",
         "__syncthreads();")]),
    ("probe: no moments", [("        if (!want) continue;\n", "        continue;\n")]),
    ("probe: one candidate a pixel", [
        ("for (int k = 0; k < 9; ++k) {  // the 3x3 cells, ascending ids",
         "for (int k = 0; k < 1; ++k) {")]),
    ("probe: no run-end flush", [("    flush<true>(stage, wslots, wmask, nrec, lane);\n  }",
                                  "  }")]),
    ("probe: no Lab loads", [("  z0 = lb[3 * i];\n  z1 = lb[3 * i + 1];\n  z2 = lb[3 * i + 2];",
                              "  z0 = 50.f + (float)(i & 7);\n  z1 = 1.f;\n  z2 = (float)(i & 3);")]),
    ("variant: the pass inlined", [("__device__ void w5_pass(", "__device__ __forceinline__ void w5_pass(")]),
    ("variant: 128 registers", [("__launch_bounds__(NG * NT, 4 / NG)", "__launch_bounds__(NG * NT, 1)")]),

]

# K12 with clock64() counters (lane 0 of each warp, thread 0 of each CTA)
# summed into a device array that gcis_w5_prof reads and zeroes: rows and
# the cycles of their Lab loads and scoring, of whole runs, of a piece's
# prologue and of its partials' reduction, of the cluster barrier's wait,
# of the update and of an iteration's passes
PROF_NAMES = ["rows", "load cycles", "score cycles", "run cycles", "piece prologue cycles",
              "piece reduction cycles", "cluster barrier cycles", "update cycles",
              "pass cycles (an iteration's)"]
PROFILE_EDITS = [
    ("namespace {\n\nconstexpr int NT = 256;",
     "__device__ unsigned long long w5_prof_counts[9];\n"
     "#define PROF(i, v) atomicAdd(&w5_prof_counts[i], (unsigned long long)(v))\n"
     "namespace {\n\nconstexpr int NT = 256;"),
    ("  group_sync(bar);  // the group's previous piece is done with smem\n",
     "  const long long q0 = clock64();\n  group_sync(bar);  // the group's previous piece\n"),
    ("  if (want && tid < NWARP * MASKW) masks[tid] = 0u;  // no slot touched yet\n  group_sync(bar);\n",
     "  if (want && tid < NWARP * MASKW) masks[tid] = 0u;  // no slot touched yet\n  group_sync(bar);\n"
     "  if (tid == 0) PROF(4, clock64() - q0);\n"),
    ("    double s0 = 0.0, s1 = 0.0, s2 = 0.0;\n    // pixel (y, x) with Lab z",
     "    double s0 = 0.0, s1 = 0.0, s2 = 0.0;\n    const long long r0c = clock64();\n"
     "    long long dl = 0, ds = 0;\n    // pixel (y, x) with Lab z"),
    ("      if (col) {\n        lab_at(lb, (long)y * g.w + x, a0, a1, a2);\n"
     "        if (two) lab_at(lb, (long)(y + 1) * g.w + x, b0, b1, b2);\n      }\n",
     "      const long long p0c = clock64();\n"
     "      if (col) {\n        lab_at(lb, (long)y * g.w + x, a0, a1, a2);\n"
     "        if (two) lab_at(lb, (long)(y + 1) * g.w + x, b0, b1, b2);\n      }\n"
     "      { float u; asm volatile(\"add.f32 %0, %1, %2;\" : \"=f\"(u) : \"f\"(a0), \"f\"(b0)); "
     "asm volatile(\"add.f32 %0, %1, %2;\" : \"=f\"(u) : \"f\"(a1), \"f\"(b1)); "
     "asm volatile(\"add.f32 %0, %1, %2;\" : \"=f\"(u) : \"f\"(a2), \"f\"(b2)); }\n"
     "      const long long p1c = clock64();\n      dl += p1c - p0c;\n"),
    ("        label(y, sa);\n        if (two) label(y + 1, sb);\n      }\n",
     "        label(y, sa);\n        if (two) label(y + 1, sb);\n      }\n"
     "      { int u; asm volatile(\"add.s32 %0, %1, %2;\" : \"=r\"(u) : \"r\"(sa), \"r\"(sb)); }\n"
     "      ds += clock64() - p1c;\n"),
    ("    if (cnt > 0) stage[nrec++ * 32 + lane] = Rec{{s0, s1, s2}, cur, x * cnt, cnt, sy};\n"
     "    flush<true>(stage, wslots, wmask, nrec, lane);\n  }\n",
     "    if (cnt > 0) stage[nrec++ * 32 + lane] = Rec{{s0, s1, s2}, cur, x * cnt, cnt, sy};\n"
     "    flush<true>(stage, wslots, wmask, nrec, lane);\n"
     "    if (lane == 0) { PROF(0, ye - ys); PROF(1, dl); PROF(2, ds); PROF(3, clock64() - r0c); }\n  }\n"),
    ("  if (!want) return;\n  group_sync(bar);\n  for (int j = tid; j < nloc; j += NT) {  // the piece's candidates",
     "  if (!want) return;\n  const long long e0c = clock64();\n  group_sync(bar);\n"
     "  for (int j = tid; j < nloc; j += NT) {  // the piece's candidates"),
    ("    out[5] = (double)c;\n  }\n}\n\n// K12's plan table",
     "    out[5] = (double)c;\n  }\n  if (tid == 0) PROF(5, clock64() - e0c);\n}\n\n// K12's plan table"),
    ("    const int par = it & 1;\n    for (int q = p0 + group; q < p1; q += NG) {",
     "    const int par = it & 1;\n    const long long i0c = clock64();\n"
     "    for (int q = p0 + group; q < p1; q += NG) {"),
    ("    cluster.sync();  // the iteration's barrier: every piece's partials are written\n",
     "    const long long i1c = clock64();\n"
     "    cluster.sync();  // the iteration's barrier: every piece's partials are written\n"
     "    const long long i2c = clock64();\n"
     "    if (tid == 0) { PROF(6, i2c - i1c); PROF(8, i1c - i0c); }\n"),
    ("    __syncthreads();  // the table is whole before any group's next pass\n",
     "    __syncthreads();  // the table is whole before any group's next pass\n"
     "    if (tid == 0) PROF(7, clock64() - i2c);\n"),
]
PROFILE_TAIL = """
GCIS_API int gcis_w5_prof(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, w5_prof_counts, sizeof(w5_prof_counts));
  unsigned long long zero[9] = {0};
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(w5_prof_counts, zero, sizeof(zero));
  return (int)err;
}
"""


def timed(fn):
    """The mean of INNER back-to-back calls behind a sleep kernel, median
    of 5."""
    return cuda_ms(fn, inner=INNER, hold_ms=INNER * cuda_ms(fn))


def ok(rc: int) -> None:
    if rc != 0:
        sys.exit(f"a C entry point returned CUDA error {rc}")


def mosaics(b, h, w, dev):
    rgb = np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0] for i in range(b)])
    return rgb_to_lab(torch.from_numpy(rgb).to(dev)).contiguous()


def k12_bound(lab, n_sp):
    """chip_smoke.py's bound of the whole loop: the Lab read and the labels
    written once; <= 9 candidates at 12 operations a pixel in each
    assignment, 11 a centroid, 6 sums a pixel in each update."""
    b, h, w, _ = lab.shape
    gh, gw, _ = sl.grid_shape(h, w, n_sp)
    n_cand = int(sl._candidates(h, w, gh, gw, lab.device)[1].sum()) * b
    flops = (N_ITER + 1) * (n_cand * 12 + b * gh * gw * 11) + N_ITER * b * h * w * 6
    return bound(lab.numel() * 4 + b * h * w * 4, flops)


class K12:
    """A frame's inputs and the change's and the parent's K12 calls."""

    def __init__(self, lab, n_sp, plib=None):
        b, h, w, _ = lab.shape
        self.lab, self.n_sp = lab, n_sp
        self.bp = sf._band_plan(h, w, n_sp)
        self.sw = sl.slic_geometry(h, w, n_sp, RULER)[2]
        self.plan = sf.slic_w5_plan(h, w, n_sp, b, sf.w5_active(h, w, n_sp, lab.device.index))
        self.cent0 = sl.slic_init_centroids(lab, self.bp["gh"], self.bp["gw"])
        self.cent = self.cent0.clone()
        self.labels = torch.empty((b, h, w), dtype=torch.int32, device=lab.device)
        self.plib = plib
        if plib is not None:
            ncp = -(-w // sf._BAND_COLS)
            self.pparts = torch.empty((b, self.bp["n_bands"], ncp,
                                       self.bp["w_rows"] * self.bp["gw"], 6),
                                      dtype=torch.float64, device=lab.device)
            self.plabels = torch.empty_like(self.labels)

    def change(self, plan=None):
        self.cent.copy_(self.cent0)
        sf.w5_launch(self.lab, self.cent, self.labels, plan or self.plan, N_ITER, self.sw)
        return self.labels

    def parent(self):
        b, h, w, _ = self.lab.shape
        bp = self.bp
        self.cent.copy_(self.cent0)
        ok(self.plib.gcis_slic_w5(
            self.lab.data_ptr(), self.cent.data_ptr(), self.plabels.data_ptr(),
            self.pparts.data_ptr(), b, h, w, bp["gh"], bp["gw"], bp["w_rows"],
            bp["band_rows"], sf._BAND_COLS, N_ITER, *sf._scales(h, w, bp, self.sw),
            torch.cuda.current_stream().cuda_stream))
        return self.plabels


class K13Loop:
    """K13's banded loop on one commit's C entry points (11 passes, 10
    updates, the seed centroids copied first), and one pass with partials."""

    def __init__(self, lib, lab, n_sp):
        b, h, w, _ = lab.shape
        self.lib, self.lab = lib, lab
        self.bp = bp = sf._band_plan(h, w, n_sp)
        sw = sl.slic_geometry(h, w, n_sp, RULER)[2]
        self.cent0 = sl.slic_init_centroids(lab, bp["gh"], bp["gw"])
        self.cent = self.cent0.clone()
        self.labels = torch.empty((b, h, w), dtype=torch.int32, device=lab.device)
        self.ncp = -(-w // sf._BAND_COLS)
        self.parts = torch.empty((b, bp["n_bands"], self.ncp, bp["w_rows"] * bp["gw"], 6),
                                 dtype=torch.float64, device=lab.device)
        self.geom = (b, h, w, bp["gh"], bp["gw"], bp["w_rows"], bp["band_rows"])
        self.scales = sf._scales(h, w, bp, sw)

    def one_pass(self, parts=True):
        ok(self.lib.gcis_slic_band_pass(
            self.lab.data_ptr(), self.cent.data_ptr(), self.labels.data_ptr(),
            self.parts.data_ptr() if parts else None, *self.geom, sf._BAND_COLS, *self.scales,
            torch.cuda.current_stream().cuda_stream))

    def loop(self):
        b, h, _, gh, gw, wr, br = self.geom
        stream = torch.cuda.current_stream().cuda_stream
        self.cent.copy_(self.cent0)
        for _ in range(N_ITER):
            self.one_pass()
            ok(self.lib.gcis_slic_band_update(self.parts.data_ptr(), self.cent.data_ptr(), b, h,
                                              gh, gw, wr, br, self.ncp, stream))
        self.one_pass(parts=False)
        return self.labels


def turns(tag, parent_fn, change_fn, card):
    """parent, change, change, parent."""
    p1, c1, c2, p2 = timed(parent_fn), timed(change_fn), timed(change_fn), timed(parent_fn)
    print(f"{tag}: parent {p1:.4f} / {p2:.4f} ms, change {c1:.4f} / {c2:.4f} ms "
          f"(change / parent {(c1 + c2) / (p1 + p2):.3f}) ({card})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = card_line()
    print(card, torch.__version__, torch.version.cuda, flush=True)
    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve() / (
            "gabor_color_image_segmentation_tpu_torch/csrc")
    if "--ptxas" in sys.argv:
        ptxas(_kernels._CSRC, ["slic_banded.cu"], "change")
        if parent is not None:
            ptxas(parent, ["slic_banded.cu"], "parent")
    lib = _kernels.library()
    if "--sass" in sys.argv:  # K12's SASS, for reading its inner loop
        out = ROOT / "chiprun_out" / "k12_sass.txt"
        out.parent.mkdir(exist_ok=True)
        cuobjdump = Path(_kernels._find_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(cuobjdump), "-sass", str(_kernels.library_path())],
                              capture_output=True, text=True).stdout
        keep, on = [], False
        for line in sass.splitlines():
            if "Function :" in line:
                on = "slic_w5_kernel" in line
            if on:
                keep.append(line)
        out.write_text("\n".join(keep))
        print(f"K12's SASS: {len(keep)} lines in {out}", flush=True)
    plib = None
    if parent is not None:
        (plib,) = build([source(parent, "slic_banded.cu")], ["parent_slic_banded"],
                        PARENT_SIGNATURES)
    dev = torch.device("cuda")
    labs = {}
    for tag, b, h, w, n_sp in FRAMES[:2] if "--quick" in sys.argv else FRAMES:
        key = (h, w)
        if key not in labs:
            labs[key] = mosaics(8, h, w, dev)
        lab = labs[key][:b]
        k12 = K12(lab, n_sp, plib)
        got = k12.change().clone()
        ref = sf.slic_banded_plain(lab, n_sp, RULER, N_ITER)
        torch.cuda.synchronize()
        pl = k12.plan
        b_ms, b_by = k12_bound(lab, n_sp)
        print(f"K12 [{tag} {b}x{h}x{w} S={pl['gh'] * pl['gw']}] plan: {pl['ctas']} CTAs an "
              f"image x {pl['groups']} groups of 256 threads, pieces {pl['cw']} columns "
              f"wide, {pl['waves']} wave(s) of "
              f"{pl['active']} co-resident clusters, {pl['kmax']} pieces a CTA at most, "
              f"partials in {'shared' if pl['parts_in_smem'] else 'global'} memory, "
              f"{pl['smem']} B of shared memory; labels equal to the plain loop "
              f"{torch.equal(got, ref)}; wrapper {timed(lambda: sf.slic_w5(lab, n_sp, RULER, N_ITER)):.4f} ms "
              f"host to host, kernel with the seed copy {timed(k12.change):.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}) ({card})", flush=True)
        if plib is not None:
            same = torch.equal(k12.parent(), got)
            turns(f"K12 in turns [{tag} {b}x{h}x{w}, S = {n_sp}] labels equal to the parent's "
                  f"{same}", k12.parent, k12.change, card)
        if "--shapes" in sys.argv and tag != "batch 1":
            act = sf.w5_active(h, w, n_sp, dev.index or 0)
            for shape in sf.W5_SHAPES:
                if act[shape] < 1:
                    continue
                sp = sf.slic_w5_plan(h, w, n_sp, b, {shape: act[shape]})
                ms = timed(lambda: k12.change(sp))
                mark = " (the plan's)" if shape == (pl["ctas"], pl["groups"], pl["cw"]) else ""
                print(f"  shape {shape[0]:2d} CTAs x {shape[1]} groups, pieces {shape[2]} "
                      f"columns wide{mark}: {act[shape]} "
                      f"co-resident, {sp['waves']} wave(s), partials "
                      f"{'shared' if sp['parts_in_smem'] else 'global'}, model "
                      f"{sp['waves'] * max(sp['work'])}: {ms:.4f} ms ({card})", flush=True)
        if "--profile" in sys.argv and tag in ("K12's frame", "batch 1"):
            (plib_p,) = build([source(_kernels._CSRC, "slic_banded.cu", PROFILE_EDITS)
                               + PROFILE_TAIL], ["profile_k12"],
                              dict(_kernels._SIGNATURES, gcis_w5_prof=[_P]))
            counts = np.zeros(9, dtype=np.uint64)
            _kernels.library = lambda: plib_p
            try:
                ok(plib_p.gcis_w5_prof(counts.ctypes.data))
                torch.cuda.synchronize()
                k12.change()
                torch.cuda.synchronize()
                ok(plib_p.gcis_w5_prof(counts.ctypes.data))
            finally:
                _kernels.library = lib_fn
            steps = max(int(counts[0]), 1)
            print(f"  profile [{tag}]: " + ", ".join(
                f"{n} {int(v)}" for n, v in zip(PROF_NAMES, counts))
                + f"; a row: load {int(counts[1]) / steps:.0f}, score "
                f"{int(counts[2]) / steps:.0f}, all {int(counts[3]) / steps:.0f} cycles ({card})",
                flush=True)
        if "--probes" in sys.argv and tag in ("K12's frame", "batch 1"):
            names = [f"probe_k12_{k}" for k in range(len(K12_PROBES))]
            libs = build([source(_kernels._CSRC, "slic_banded.cu", e) for _, e in K12_PROBES],
                         names, _kernels._SIGNATURES)
            for (name, _), plib_k in zip(K12_PROBES, libs):
                _kernels.library = lambda plib_k=plib_k: plib_k
                try:
                    ms = timed(k12.change)
                finally:
                    _kernels.library = lib_fn
                print(f"  {name} [{tag}]: {ms:.4f} ms ({card})", flush=True)
        del k12

    if "--quick" in sys.argv:
        return
    # K13 at config4's pooled grid, in turns against the parent
    b, h, w, n_sp = K13_FRAME
    lab = mosaics(b, h, w, dev)
    now = K13Loop(lib, lab, n_sp)
    got = now.loop().clone()
    ref = sf.slic_banded_plain(lab, n_sp, RULER, N_ITER)
    torch.cuda.synchronize()
    print(f"K13 [{b}x{h}x{w} S = {n_sp}] loop labels equal to the plain loop "
          f"{torch.equal(got, ref)} ({card})", flush=True)
    if plib is not None:
        old = K13Loop(plib, lab, n_sp)
        same = torch.equal(old.loop(), got)
        now.one_pass()
        old.one_pass()
        torch.cuda.synchronize()
        same_pass = torch.equal(old.labels, now.labels) and torch.equal(old.parts, now.parts)
        turns(f"K13 loop in turns [{b}x{h}x{w}, S = {n_sp}] labels equal to the parent's {same}",
              old.loop, now.loop, card)
        turns(f"K13 pass in turns [{b}x{h}x{w}, S = {n_sp}] labels and partials equal to the "
              f"parent's {same_pass}", old.one_pass, now.one_pass, card)


lib_fn = _kernels.library

if __name__ == "__main__":
    main()
