#!/usr/bin/env python3
"""Time K6 on one NVIDIA card against a parent commit's in turns in one
process, beside a one-launch floor.

    python3 experiments/torch_k6_k7.py [--parent DIR] [--ptxas] [--probes]

``--parent DIR``: a checkout of the parent commit (``git archive``
unpacked into a git-ignored directory); its csrc/maximin_t.cu is built
into a shared library of its own and bound with the parent's signature
(commit c69d643): K6 ``gcis_maximin_t`` (a pass launch of 256-pixel blocks
and a select launch, its block partials allocated a call as the parent's
wrapper did). Then:

- K6 of both commits compared: seeds and running minima at config2's fit
  grid;
- parent, change, change, parent: K6 at config2's fit grid, (8, 39, 9600)
  of three blobs, bf16 and f32, and at full resolution (8, 39, 154401)
  bf16, a non-reset step from a seeded running minimum.

Then the change alone: an empty kernel back to back (the one-launch floor)
beside K6's bytes bounds; K6 at (2, 12024, 9600) (the parent refused
D > 10,240); K6 by CTAs an image (1-32, the plan's choice marked) at the
fit grid in both dtypes. (K7, which this script once timed past 512 rows,
is timed by experiments/torch_k2_k7.py.) ``--ptxas`` prints registers,
shared memory and spills of both commits' maximin_t.cu. ``--probes``
rebuilds K6 from text-patched copies of csrc/maximin_t.cu (common.cuh
inlined) into the git-ignored ``_build/``, each with one phase off or one
constant changed, timed at the fit grid in both dtypes: K6_PROBES lists
them.

Timing: CUDA events, the mean of 50 back-to-back calls behind a sleep
kernel, median of 5 (as chip_smoke.py, for calls under 1 ms), with the
helpers of ``_turns.py``. Every line carries the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402
from _turns import (  # noqa: E402
    blobs,
    bound,
    build,
    card_line,
    cuda_ms,
    empty_launch,
    ptxas,
    source,
)

INNER = 50
_P, _I = ctypes.c_void_p, ctypes.c_int
# the parent's signatures (commit c69d643)
PARENT_SIGNATURES = {"gcis_maximin_t": [_P] * 6 + [_I] * 5 + [_P]}


# (name, edits) of maximin_t.cu: K6 with one phase off (the outputs of a
# "probe:" are meaningless, only its time is read) or one constant changed
K6_PROBES = [
    ("as built", []),
    ("256 threads", [("constexpr int NT = 512;", "constexpr int NT = 256;")]),
    ("320 threads", [("constexpr int NT = 512;", "constexpr int NT = 320;")]),
    ("384 threads", [("constexpr int NT = 512;", "constexpr int NT = 384;")]),
    ("640 threads", [("constexpr int NT = 512;", "constexpr int NT = 640;")]),
    ("1024 threads", [("constexpr int NT = 512;", "constexpr int NT = 1024;")]),
    ("rows unrolled by 8", [("#pragma unroll 4\n  for (int ch = 0; ch < rows; ++ch) {",
                             "#pragma unroll 8\n  for (int ch = 0; ch < rows; ++ch) {")]),
    ("probe: no row copies", [("cp_async16(buf + row * rs + cc * 16, valid ? src : a0, valid);",
                               "")]),
    ("probe: no probe loads", [("p[e] = round_to<T>(pb[r0 + e]);", "p[e] = 1.f;"),
                               ("s = fmaf(pb[ch], pb[ch], s);", "s += 1.f;")]),
    ("probe: no sums", [("  for (int ch = 0; ch < rows; ++ch) {\n    const T* row",
                         "  for (int ch = 0; ch < 0; ++ch) {\n    const T* row")]),
    ("probe: no dmin loads", [("old[h] = db[base + tid + h * NT];", "old[h] = 0.f;")]),
    ("probe: no dmin stores", [("          db[base + p] = dm;", "")]),
    ("probe: no CTA argmax", [("  m = block_argmax(m, scratch);", "")]),
    ("probe: a relaxed count", [("atom.add.acq_rel.gpu.global.u32",
                                 "atom.add.relaxed.gpu.global.u32")]),
    ("probe: no last-CTA work", [("  if (!last) return;", "  return;")]),
    ("probe: no column copy", [("best[(long)b * D + ch] = gcis::ld(xb, ch * n + win);",
                                "(void)win;")]),
]


def timed(fn):
    """The mean of INNER back-to-back calls behind a sleep kernel, median
    of 5."""
    return cuda_ms(fn, inner=INNER, hold_ms=INNER * cuda_ms(fn))


def k6_bytes(x):
    """K6's bytes: the buffer read once, dmin read and written."""
    b, d, n = x.shape
    return b * n * (d * x.element_size() + 8), b * n * 4 * d


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = card_line()
    print(card, flush=True)
    parent = None
    if "--parent" in sys.argv:
        parent = Path(sys.argv[sys.argv.index("--parent") + 1]).resolve() / (
            "gabor_color_image_segmentation_tpu_torch/csrc")
    if "--ptxas" in sys.argv:
        ptxas(_kernels._CSRC, ["maximin_t.cu"], "change")
        if parent is not None:
            ptxas(parent, ["maximin_t.cu"], "parent")
    _kernels.library()
    set_policy()
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    # K6's inputs: config2's fit grid in both dtypes, full resolution in
    # bf16, the probe a column of the buffer and the running minimum seeded
    # by a reset step from the mean
    b, d, n = 8, 39, 9600
    x32 = blobs(b, d, n, 5, dev)
    bufs = {"bf16": x32.to(torch.bfloat16), "f32": x32,
            "bf16 full resolution": blobs(b, d, 154401, 8, dev).to(torch.bfloat16)}
    state = {}
    for tag, xb in bufs.items():
        dm = torch.empty((xb.shape[0], xb.shape[2]), device=dev)
        probe = kf.maximin_t_pass_plain(xb, xb.float().mean(dim=2), dm, True)
        state[tag] = (xb, probe, dm)

    def k6_change(tag):
        xb, probe, dm = state[tag]
        return lambda: kf.maximin_t_pass(xb, probe, dm, False)

    floor = timed(empty_launch())
    bounds = {t: bound(*k6_bytes(xb))[0] for t, xb in bufs.items()}
    print(f"one-launch floor (an empty kernel, back to back): {floor:.4f} ms; K6 bytes bounds: "
          + ", ".join(f"{t} {v:.5f}" for t, v in bounds.items()) + f" ms ({card})", flush=True)

    if parent is not None:
        plib = build([source(parent, "maximin_t.cu")], ["parent_maximin_t"],
                     PARENT_SIGNATURES)

        def k6_parent(tag, dm=None):
            xb, probe, dm0 = state[tag]
            dm = dm0 if dm is None else dm

            def call():
                bb, dd, nn = xb.shape
                nblk = -(-nn // 256)
                bestv = torch.empty((bb, nblk), device=dev)
                besti = torch.empty((bb, nblk), dtype=torch.int32, device=dev)
                best = torch.empty((bb, dd), device=dev)
                rc = plib[0].gcis_maximin_t(
                    xb.data_ptr(), probe.data_ptr(), dm.data_ptr(), bestv.data_ptr(),
                    besti.data_ptr(), best.data_ptr(), bb, dd, nn,
                    _kernels.storage_code(xb.dtype), 0, stream())
                if rc:
                    sys.exit(f"parent K6: CUDA error {rc}")
                return best
            return call

        for tag in bufs:
            xb, probe, dm = state[tag]
            dp, dc = dm.clone(), dm.clone()
            pp = k6_parent(tag, dp)()
            pc = kf.maximin_t_pass(xb, probe, dc, False)
            torch.cuda.synchronize()
            print(f"parent vs change K6 {tag}: seeds equal {torch.equal(pp, pc)}, running "
                  f"minima max abs diff {(dp - dc).abs().max().item():.3e} of "
                  f"{dp.abs().max().item():.4g} ({card})", flush=True)
        for turn, who in enumerate(("parent", "change", "change", "parent")):
            k6 = k6_parent if who == "parent" else k6_change
            parts = [f"{t} {timed(k6(t)):.4f}" for t in bufs]
            print(f"turn {turn + 1} {who}: K6 ({b}, {d}, {n}) ms: {'; '.join(parts)} ({card})",
                  flush=True)

    # K6 past 10,240 rows, and by CTAs an image
    xw = blobs(2, 12024, n, 9, dev)
    for tag, xb in (("bf16", xw.to(torch.bfloat16)), ("f32", xw)):
        dm = torch.empty((2, n), device=dev)
        probe = kf.maximin_t_pass_plain(xb, xb.float().mean(dim=2), dm, True)
        ms = timed(lambda: kf.maximin_t_pass(xb, probe, dm, False))
        print(f"K6 (2, 12024, {n}) {tag}: {ms:.4f} ms, bytes bound "
              f"{bound(*k6_bytes(xb))[0]:.4f} ({card})", flush=True)
    del xw
    plan = kf.maximin_t_plan
    for tag in ("bf16", "f32"):
        chosen = plan(b, n, n_sm)
        row = []
        for cpi in sorted({1, 4, 8, 16, 32, chosen}):
            kf.maximin_t_plan = lambda *_, c=cpi: c
            try:
                row.append(f"{cpi}{'*' if cpi == chosen else ''}: {timed(k6_change(tag)):.4f}")
            finally:
                kf.maximin_t_plan = plan
        print(f"K6 ({b}, {d}, {n}) {tag} by CTAs an image (* the plan's) ms: "
              f"{', '.join(row)} ({card})", flush=True)

    if "--probes" in sys.argv:
        libs = build([source(_kernels._CSRC, "maximin_t.cu", e) for _, e in K6_PROBES],
                     [f"probe_maximin_t_{i}" for i in range(len(K6_PROBES))],
                     {"gcis_maximin_t": _kernels._SIGNATURES["gcis_maximin_t"]})
        cpi = plan(b, n, n_sm)
        for tag in ("bf16", "f32"):
            xb, probe, dm = state[tag]
            ref = kf.maximin_t_pass(xb, probe, dm.clone(), False)
            bestv = torch.empty((b, cpi), device=dev)
            besti = torch.empty((b, cpi), dtype=torch.int32, device=dev)
            best = torch.empty((b, d), device=dev)
            for (name, _), lib in zip(K6_PROBES, libs):
                counters = torch.zeros(b, dtype=torch.int32, device=dev)
                dmp = dm.clone()

                def call():
                    rc = lib.gcis_maximin_t(xb.data_ptr(), probe.data_ptr(), dmp.data_ptr(),
                                            bestv.data_ptr(), besti.data_ptr(), best.data_ptr(),
                                            counters.data_ptr(), b, d, n,
                                            _kernels.storage_code(xb.dtype), 0, cpi, stream())
                    if rc:
                        sys.exit(f"K6 probe {name}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                print(f"K6 probe [{name}] ({b}, {d}, {n}) {tag}, {cpi} CTAs an image: seeds as "
                      f"built {torch.equal(best, ref)}; {timed(call):.4f} ms ({card})", flush=True)


if __name__ == "__main__":
    main()
