#!/usr/bin/env python3
"""Time K5 and K10 on one NVIDIA card, the change's kernels against a
parent commit's, in turns in one process, beside a one-launch floor.

    python3 experiments/torch_k5_k10.py [--parent DIR] [--ptxas] [--probes]

``--parent DIR``: a checkout of the parent commit (``git archive``
unpacked into a git-ignored directory); its csrc/lloyd_t.cu and
csrc/precision_chol.cu are built into shared libraries of their own (one
nvcc each, next to this checkout's build) and their C entry points bound
with the parent's signatures: K5 ``gcis_lloyd_t`` (a block of 256 pixels,
then an ordered sum of the blocks' partials: two launches, the partials
allocated a call as the parent's wrapper did) and K10
``gcis_precision_chol_params`` (a 256-thread block a matrix). Then parent,
change, change, parent:

- K5 at config2's fit grid, (8, 39, 9600) of three blobs, k = 5, bf16 and
  f32, with sums and labels only, and at (2, 1503, 9600) f32, k = 8, the
  widest rows the parent took at k = 8 (the change stages them in blocks
  of at most 512 rows); the two kernels' labels and sums compared;
- K10 at the EM loop's shape, M = 8 x 5 = 40 matrices of d = 39, on the
  moments of a hard split of that buffer (m = 9600 pixels).

Then the change alone: an empty kernel back to back (the one-launch
floor, beside the bytes bounds); K5 by CTAs an image (1-32, the plan's
choice marked) in both dtypes and at full resolution (8, 39, 154401);
K10 beside K9 on the same C (``_moments_to_params``') and cuSOLVER at
d = 8, 39, 64 and 127 (M = 40). ``--ptxas`` prints registers,
shared memory and spills of the change's and the parent's lloyd_t.cu and
precision_chol.cu. ``--probes`` rebuilds K5 from text-patched copies of
csrc/lloyd_t.cu into the git-ignored ``_build/`` (the source untouched),
each with one phase off, timed at the fit grid in bf16 with sums and
labels only: K5_PROBES lists them.

Timing: CUDA events, the mean of 50 back-to-back calls behind a sleep
kernel, median of 5 (as chip_smoke.py, for calls under 1 ms), with the
helpers of ``_turns.py``. Every line carries the card's name and power
limit.
"""

from __future__ import annotations

import ctypes
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import chol  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import gmm_fused as gf  # noqa: E402
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
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the parent's signatures (commit 3e02e75)
PARENT_SIGNATURES = {"gcis_lloyd_t": [_P] * 5 + [_I] * 6 + [_P],
                     "gcis_precision_chol_params": [_P] * 6 + [_I] * 2 + [_F] * 2 + [_P]}
# (name, edits) of lloyd_t.cu: K5 with one phase off (the outputs are
# meaningless, only the times are read)
K5_PROBES = [
    ("as built", []),
    ("128 registers a thread", [("__global__ void __launch_bounds__(NT) lloyd_t_kernel(",
                                 "__global__ void __maxnreg__(128) lloyd_t_kernel(")]),
    ("sums 3 rows a warp", [("constexpr int RG = 4; ", "constexpr int RG = 3; ")]),
    ("640 threads", [("constexpr int NT = 512;", "constexpr int NT = 640;")]),
    ("1024 threads", [("constexpr int NT = 512;", "constexpr int NT = 1024;")]),
    ("probe: no score rows", [("  for (int ch = 0; ch < rows; ++ch) {\n    const T* row",
                               "  for (int ch = 0; ch < 0; ++ch) {\n    const T* row")]),
    ("probe: no sums rows", [("for (int p = lane; p < nv; p += 32) {",
                              "for (int p = lane; p < 0; p += 32) {")]),
    ("probe: no cross-CTA sum", [("    for (int r = 0; r < ctas; ++r) s += __ldcg",
                                  "    for (int r = 0; r < 0; ++r) s += __ldcg")]),
    ("probe: no tile loads", [("    cp_async16(buf + row * rs + cc * 16, valid ? src : a0, valid);",
                               "")]),
    ("probe: no centre loads", [("round_to<T>(cb[q * D + r0 + ch]) : 0.f;", "1.f : 0.f;"),
                                ("s = fmaf(cb[warp * D + ch], cb[warp * D + ch], s);",
                                 "s += 1.f;")]),
    ("probe: no label stores", [("            labels[(long)b * n + base + tid + h * NT] = l;",
                                 "")]),
    ("probe: a relaxed count", [("atom.add.acq_rel.gpu.global.u32", "atom.add.relaxed.gpu.global.u32")]),
    ("probe: no partial stores", [("mine[e] = part[e];", "(void)mine;")]),
]


def timed(fn):
    """The mean of INNER back-to-back calls behind a sleep kernel, median
    of 5."""
    return cuda_ms(fn, inner=INNER, hold_ms=INNER * cuda_ms(fn))


def moments_of(x, k, seed):
    """(counts, sums, scatter) of a random hard split of x into k clusters
    (float32, as the EM's first pass hands K10)."""
    rng = np.random.default_rng(seed)
    hard = torch.from_numpy(rng.integers(0, k, size=(x.shape[0], x.shape[2]))).to(x.device)
    return gf._init_moments(x, hard, k)


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
        ptxas(_kernels._CSRC, ["lloyd_t.cu", "precision_chol.cu"], "change")
        if parent is not None:
            ptxas(parent, ["lloyd_t.cu", "precision_chol.cu"], "parent")
    _kernels.library()
    set_policy()
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    reg = 1e-4

    # the inputs: K5 at config2's fit grid, K10 on a hard split's moments
    b, d, n, k = 8, 39, 9600, 5
    x32 = blobs(b, d, n, 5, dev)
    bufs = {"bf16": x32.to(torch.bfloat16), "f32": x32}
    rng = np.random.default_rng(6)
    centers = torch.from_numpy(rng.normal(scale=2.0, size=(b, k, d)).astype(np.float32)).to(dev)
    mom = moments_of(x32, k, 7)
    k5_bounds = {t: bound(b * n * (d * xb.element_size() + 4) + b * k * (d + 1) * 4,
                          b * n * (2 * k * d + d))
                 for t, xb in bufs.items()}
    k10_bound = bound(b * k * 2 * (d * d + d + 1) * 4, b * k * (d ** 3 + 3 * d * d))

    # K5 past 512 rows (a tile's rows staged in blocks), at the widest the
    # parent took at k = 8 (k * D <= 12,024)
    wide = blobs(2, 1503, n, 9, dev)
    wide_c = torch.from_numpy(rng.normal(scale=2.0, size=(2, 8, 1503)).astype(np.float32)).to(dev)

    def k5_change(xb, c=centers, assign_only=False):
        return lambda: kf.lloyd_t_pass(xb, c, assign_only)

    def k10_change():
        return chol.precision_chol_params(*mom, n, reg)

    floor = timed(empty_launch())  # the one-launch floor
    print(f"one-launch floor (an empty kernel, back to back): {floor:.4f} ms; bytes bounds: "
          f"K5 bf16 {k5_bounds['bf16'][0]:.5f}, f32 {k5_bounds['f32'][0]:.5f}, K10 "
          f"{k10_bound[0]:.5f} ms ({card})", flush=True)

    if parent is not None:
        plib = build([source(parent, "lloyd_t.cu"), source(parent, "precision_chol.cu")],
                     ["parent_lloyd_t", "parent_precision_chol"], PARENT_SIGNATURES)

        def k5_parent(xb, c=centers, assign_only=False):
            def call():
                (bb, dd, nn), kk = xb.shape, c.shape[1]
                labels = torch.empty((bb, nn), dtype=torch.int32, device=dev)
                partial = sums = None
                if not assign_only:
                    partial = torch.empty((bb, -(-nn // 256), kk, dd + 1), device=dev)
                    sums = torch.empty((bb, kk, dd + 1), device=dev)
                rc = plib[0].gcis_lloyd_t(
                    xb.data_ptr(), c.data_ptr(), labels.data_ptr(),
                    None if assign_only else partial.data_ptr(),
                    None if assign_only else sums.data_ptr(), bb, dd, nn, kk,
                    _kernels.storage_code(xb.dtype), int(assign_only), stream())
                if rc:
                    sys.exit(f"parent K5: CUDA error {rc}")
                return labels, sums
            return call

        def k10_parent():
            pt = torch.empty((b, k, d, d), device=dev)
            bias = torch.empty((b, k, d), device=dev)
            const = torch.empty((b, k), device=dev)
            rc = plib[1].gcis_precision_chol_params(
                mom[0].data_ptr(), mom[1].data_ptr(), mom[2].data_ptr(), pt.data_ptr(),
                bias.data_ptr(), const.data_ptr(), b * k, d, float(n), reg, stream())
            if rc:
                sys.exit(f"parent K10: CUDA error {rc}")
            return pt, bias, const

        for tag, xb, c in [(t, xb, centers) for t, xb in bufs.items()] + [
                ("f32 D=1503 k=8", wide, wide_c)]:
            pl_, ps = k5_parent(xb, c)()
            cl, cs, cc = kf.lloyd_t_pass(xb, c)
            torch.cuda.synchronize()
            dd = xb.shape[1]
            print(f"parent vs change K5 {tag}: labels equal {torch.equal(pl_, cl)}, counts "
                  f"equal {torch.equal(ps[:, :, dd], cc)}, sums max abs diff "
                  f"{(ps[:, :, :dd] - cs).abs().max().item():.3e} ({card})", flush=True)
        pp, pb, pc = k10_parent()
        cp, cb, cc = k10_change()
        torch.cuda.synchronize()
        print(f"parent vs change K10: P^T max abs diff {(pp - cp).abs().max().item():.3e}, "
              f"bias {(pb - cb).abs().max().item():.3e}, const "
              f"{(pc - cc).abs().max().item():.3e} ({card})", flush=True)
        for turn, who in enumerate(("parent", "change", "change", "parent")):
            k5 = k5_parent if who == "parent" else k5_change
            k10 = k10_parent if who == "parent" else k10_change
            parts = [f"{tag} {timed(k5(xb)):.4f} (labels only "
                     f"{timed(k5(xb, assign_only=True)):.4f})" for tag, xb in bufs.items()]
            print(f"turn {turn + 1} {who}: K5 ({b}, {d}, {n}) k={k} ms: {'; '.join(parts)}; "
                  f"K5 (2, 1503, {n}) f32 k=8 {timed(k5(wide, wide_c)):.4f}; "
                  f"K10 (M={b * k}, d={d}) {timed(k10):.4f} ms ({card})", flush=True)

    # K5 by CTAs an image, beside the plan's choice
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = kf.lloyd_t_plan
    for tag, xb in list(bufs.items()) + [("bf16 full resolution",
                                          blobs(b, d, 154401, 8, dev).to(torch.bfloat16))]:
        nn = xb.shape[2]
        chosen = plan(b, nn, n_sm)
        row = []
        for cpi in sorted({1, 4, 8, 16, 32, chosen}):
            kf.lloyd_t_plan = lambda *_, c=cpi: c
            try:
                row.append(f"{cpi}{'*' if cpi == chosen else ''}: "
                           f"{timed(k5_change(xb)):.4f}")
            finally:
                kf.lloyd_t_plan = plan
        print(f"K5 ({b}, {d}, {nn}) {tag} k={k} by CTAs an image (* the plan's) ms: "
              f"{', '.join(row)} ({card})", flush=True)

    if "--probes" in sys.argv:
        xb = bufs["bf16"]
        ref = kf.lloyd_t_pass(xb, centers)
        cpi = plan(b, n, n_sm)
        libs = build([source(_kernels._CSRC, "lloyd_t.cu", e) for _, e in K5_PROBES],
                     [f"probe_lloyd_t_{i}" for i in range(len(K5_PROBES))],
                     {"gcis_lloyd_t": _kernels._SIGNATURES["gcis_lloyd_t"]})
        labels = torch.empty((b, n), dtype=torch.int32, device=dev)
        sums = torch.empty((b, k, d + 1), device=dev)
        part = torch.empty((b, cpi, k, d + 1), dtype=torch.float64, device=dev)
        counters = torch.zeros(b, dtype=torch.int32, device=dev)
        for (name, _), lib in zip(K5_PROBES, libs):
            def call(assign_only=False):
                rc = lib.gcis_lloyd_t(xb.data_ptr(), centers.data_ptr(), labels.data_ptr(),
                                      *(None if assign_only else t.data_ptr()
                                        for t in (sums, part, counters)),
                                      b, d, n, k, 1, int(assign_only), cpi, stream())
                if rc:
                    sys.exit(f"K5 probe {name}: CUDA error {rc}")

            call()
            torch.cuda.synchronize()
            same = torch.equal(labels, ref[0]) and torch.equal(sums[:, :, d], ref[2])
            print(f"K5 probe [{name}] ({b}, {d}, {n}) bf16 k={k}, {cpi} CTAs an image: "
                  f"labels and counts as built {same}; {timed(call):.4f} ms with sums, "
                  f"{timed(lambda: call(True)):.4f} labels only ({card})", flush=True)

    # K10 beside K9 on the same C and cuSOLVER, by d
    for dd in (8, 39, 64, 127):
        xd = blobs(b, dd, n, 100 + dd, dev)
        md = moments_of(xd, k, dd)
        _, _, cov = chol._moments_to_params(*md, n, reg)
        cov = cov.reshape(b * k, dd, dd).contiguous()
        pt10 = chol.precision_chol_params(*md, n, reg)[0]
        pt9 = chol.precision_chol(cov)[0]
        torch.cuda.synchronize()
        same = torch.equal(pt10.reshape(b * k, dd, dd), pt9)
        bd = bound(b * k * 2 * (dd * dd + dd + 1) * 4, b * k * (dd ** 3 + 3 * dd * dd))
        print(f"K10 (M={b * k}, d={dd}): {timed(lambda: chol.precision_chol_params(*md, n, reg)):.4f}"
              f" ms, K9 on its C {timed(lambda: chol.precision_chol(cov)):.4f} ms (P^T "
              f"bit-equal {same}), cuSOLVER {timed(lambda: chol.precision_chol_plain(cov)):.4f} "
              f"ms, bound {bd[0]:.5f} ({bd[1]}) ({card})", flush=True)


if __name__ == "__main__":
    main()
