#!/usr/bin/env python3
"""Time K9 and K11 on one NVIDIA card, the change's kernels against a
parent commit's, in turns in one process, with K9's time by matrix order
and phase probes of K11's pass.

    python3 experiments/torch_k9_k11.py [--parent DIR] [--ptxas] [--probes]

``--parent DIR``: a checkout of the parent commit (``git archive``
unpacked into a git-ignored directory); its csrc/precision_chol.cu and
csrc/slic.cu are built into shared libraries of their own (one nvcc each,
next to this checkout's build) and their C entry points bound with the
parent's signatures: K9 ``gcis_precision_chol`` (a block a matrix), K11
``gcis_slic`` (a thread a pixel, a block a superpixel's window). Then
parent, change, change, parent:

- K9 at the EM loop's shape, M = 40 matrices of d = 39 (config2's batch
  8 x k = 5), on covariances shaped as the EM's (clusters of fewer points
  than rows plus reg_covar I), beside cuSOLVER (``torch.linalg.cholesky``
  + ``solve_triangular``, the plain version);
- K11 at config3: eight 321x481 mosaics' Lab, 925 superpixels, ruler 5,
  10 iterations; the two kernels' labels compared (0 pixels may differ).

Then the change alone: K9 by d (M = 40) beside its bytes bound and
cuSOLVER, and its backward error; K11's single pass with partials, labels
only, and one update, each beside its bound; with ``--probes`` the pass
rebuilt from text-patched copies of csrc/slic.cu into the git-ignored
``_build/`` (the source untouched), each with one phase off: no Lab loads,
no moments flushes, one candidate a pixel (their outputs are meaningless,
only their times are read). ``--ptxas`` prints registers, shared memory
and spills of the change's precision_chol.cu, slic.cu, slic_banded.cu and
em_pass.cu, and of the parent's slic_banded.cu.

Timing: CUDA events, the median of 5 calls, or for a call under 1 ms the
median of 5 means over 50 back-to-back calls behind a sleep kernel (as
chip_smoke.py); the K11 loops always as 20 back-to-back calls (the parent's
single call reads over 1 ms, the change's under it), beside the single-call
reading and the kernels' own time in one call from torch.profiler. Every
line carries the card's name and power limit.
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
from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import chol  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic as sl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402
from _turns import bound, build, card_line, cuda_ms, ptxas, source  # noqa: E402

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the parent's signatures (commit 5cbbf56)
PARENT_SIGNATURES = {"gcis_precision_chol": [_P] * 3 + [_I] * 2 + [_P],
                     "gcis_slic": [_P] * 3 + [_I] * 6 + [_F] * 3 + [_P]}

# (name, edits) of precision_chol.cu: K9 with other row batches, and with
# one phase off (their outputs are meaningless, only their times are read)
K9_PROBES = [
    ("as built", []),
    ("row batches of 4", [("constexpr int RB = 8;", "constexpr int RB = 4;")]),
    ("row batches of 16", [("constexpr int RB = 8;", "constexpr int RB = 16;")]),
    ("probe: no row updates", [("for (int i0 = j + KB; i0 < n; i0 += RB) {",
                                "for (int i0 = n; i0 < n; i0 += RB) {")]),
    ("probe: no pivot chain", [("      r[t] = __frcp_rn(w[t]);", "      r[t] = 1.f;"),
                               ("        lb[t][s] = w[s] * r[s];", "        lb[t][s] = 0.f;")]),
]

# (name, edits) of slic.cu: the K11 pass with one phase off
K11_PROBES = [
    ("as built", []),
    ("probe: no Lab loads", [("        z0 = px[0];\n        z1 = px[1];\n        z2 = px[2];\n",
                              "        z0 = 1.f + x;\n        z1 = 2.f;\n        z2 = 3.f;\n")]),
    ("probe: no moments flushes", [("flush(stage, wslots, wmask, nrec, lane);", "")]),
    ("probe: one candidate a pixel", [("for (int gy = gy0; gy <= gy1; ++gy) {",
                                       "for (int gy = gy0; gy <= gy0; ++gy) {"),
                                      ("for (int gx = gx0; gx <= gx1; ++gx) {",
                                       "for (int gx = gx0; gx <= gx0; ++gx) {")]),
]


def timed(fn):
    single = cuda_ms(fn)
    return single if single >= 1.0 else cuda_ms(fn, inner=50, hold_ms=50 * single)


def back_to_back(fn, inner=20):
    """(mean ms over ``inner`` back-to-back calls behind a sleep kernel,
    median of 5; the single-call reading): host time per call hidden."""
    single = cuda_ms(fn)
    return cuda_ms(fn, inner=inner, hold_ms=inner * single), single


def device_ms(fn) -> float:
    """The card's kernel time in one call of ``fn`` (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / 1e3


def em_covariances(m: int, d: int, dev) -> torch.Tensor:
    """(m, d, d) float32 covariances shaped as the EM's: clusters of fewer
    points than rows, plus reg_covar I (cond ~1e3-1e6)."""
    rng = np.random.default_rng(100 + d)
    covs = []
    for i in range(m):
        pts = rng.normal(size=(max(1, d // 2 + i % 7), d)) * rng.uniform(0.2, 3.0, size=d)
        pts -= pts.mean(axis=0)
        covs.append(pts.T @ pts / len(pts) + 1e-4 * np.eye(d))
    return torch.from_numpy(np.stack(covs).astype(np.float32)).to(dev)


def backward_error(covs, pt) -> float:
    c64, x = covs.double(), pt.double()
    eye = torch.eye(c64.shape[-1], dtype=torch.float64, device=c64.device).expand_as(c64)
    lt = torch.linalg.solve_triangular(x, eye, upper=False)
    return (torch.linalg.matrix_norm(lt @ lt.transpose(1, 2) - c64)
            / torch.linalg.matrix_norm(c64)).max().item()


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
        ptxas(_kernels._CSRC, ["precision_chol.cu", "slic.cu", "slic_banded.cu", "em_pass.cu"],
              "change")
        if parent is not None:
            ptxas(parent, ["slic_banded.cu"], "parent")
    _kernels.library()
    set_policy()
    dev = torch.device("cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    # the inputs: K9 at the EM loop's shape, K11 at config3
    covs = em_covariances(40, 39, dev)
    g3 = preset("config3").graph
    rgb = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=100 + i)[0]
                    for i in range(8)])
    lab = pl._color_transform(torch.from_numpy(rgb).to(dev), "lab")
    bsz, h, w, _ = lab.shape
    n_sp, ruler, iters = g3.n_superpixels, g3.slic_compactness, g3.slic_iters
    gh, gw, sw = sl.slic_geometry(h, w, n_sp, ruler)
    n_cand = int(sl._candidates(h, w, gh, gw, dev)[1].sum()) * bsz
    loop_bound = bound(lab.numel() * 4 + bsz * h * w * 4,
                       (iters + 1) * (n_cand * 12 + bsz * gh * gw * 11) + iters * bsz * h * w * 6)
    k9_bound = bound(40 * 39 * (2 * 39 + 1) * 4, 40 * 39 ** 3)

    def k9_change():
        return chol.precision_chol(covs)

    def k11_change():
        return sf.slic_w3(lab, n_sp, ruler, iters)

    ref_labels = k11_change()
    torch.cuda.synchronize()
    if parent is not None:
        plib = build([source(parent, "precision_chol.cu"), source(parent, "slic.cu")],
                     ["parent_precision_chol", "parent_slic"], PARENT_SIGNATURES)
        pt_p = torch.empty_like(covs)
        dg_p = torch.empty((40, 39), device=dev)
        lab_c = lab.contiguous()

        def k9_parent():
            rc = plib[0].gcis_precision_chol(covs.data_ptr(), pt_p.data_ptr(), dg_p.data_ptr(),
                                             40, 39, stream())
            if rc:
                sys.exit(f"parent K9: CUDA error {rc}")

        def k11_parent():
            cent = sl.slic_init_centroids(lab_c, gh, gw)
            labels = torch.empty((bsz, h, w), dtype=torch.int32, device=dev)
            rc = plib[1].gcis_slic(lab_c.data_ptr(), cent.data_ptr(), labels.data_ptr(), bsz,
                                   h, w, gh, gw, iters, float(np.float32(gh / h)),
                                   float(np.float32(gw / w)), float(np.float32(sw)), stream())
            if rc:
                sys.exit(f"parent K11: CUDA error {rc}")
            return labels

        ndiff = int((k11_parent() != ref_labels).sum())
        k9_parent()
        torch.cuda.synchronize()
        print(f"parent vs change: K11 labels differ on {ndiff} pixels; K9 backward error "
              f"parent {backward_error(covs, pt_p):.3e}, change "
              f"{backward_error(covs, k9_change()[0]):.3e} ({card})", flush=True)
        for turn, who in enumerate(("parent", "change", "change", "parent")):
            k9, k11 = (k9_parent, k11_parent) if who == "parent" else (k9_change, k11_change)
            loop_ms, loop_single = back_to_back(k11)
            print(f"turn {turn + 1} {who}: K9 (40, 39, 39) {timed(k9):.4f} ms (bound "
                  f"{k9_bound[0]:.5f}, {k9_bound[1]}); K11 config3 {bsz}x{h}x{w} S={gh * gw} "
                  f"{iters} iterations {loop_ms:.4f} ms back to back (a single call "
                  f"{loop_single:.4f}; the centroids' seeding included), its kernels "
                  f"{device_ms(k11):.4f} ms on the card (profiler), bound {loop_bound[0]:.4f} "
                  f"({loop_bound[1]}) ({card})", flush=True)

    # K9 by matrix order, beside cuSOLVER
    for d in (1, 8, 16, 32, 39, 51, 64, 65, 96, 123, 128):
        c = em_covariances(40, d, dev)
        pt, _ = chol.precision_chol(c)
        torch.cuda.synchronize()
        b_ms = bound(40 * d * (2 * d + 1) * 4, 40 * d ** 3)[0]
        print(f"K9 (40, {d}, {d}): {timed(lambda: chol.precision_chol(c)):.4f} ms, cuSOLVER "
              f"{timed(lambda: chol.precision_chol_plain(c)):.4f} ms, bound {b_ms:.5f} ms, "
              f"backward error {backward_error(c, pt):.3e} ({card})", flush=True)

    # K11's pass and update alone, at centroids three plain iterations off the grid
    plan = sf.slic_w3_plan(h, w, n_sp)
    cent = sl.slic_init_centroids(lab, gh, gw)
    for _ in range(3):
        cent = sf.slic_w3_update_plain(cent, sf.slic_w3_pass_plain(lab, cent, plan, sw)[1], plan)
    lk, pk = sf.slic_w3_pass(lab, cent, n_sp, sw)
    pass_b = bound(lab.numel() * 4 + lk.numel() * 4, n_cand * 12)
    upd_b = bound(pk.numel() * 8 + cent.numel() * 8, 0)
    print(f"K11 plan at config3: tiles of {plan['ty']}x{plan['tx']} cells, "
          f"{plan['nty']}x{plan['ntx']} a frame, {plan['cells']} hoisted cells a tile", flush=True)
    print(f"K11 one pass: with partials {timed(lambda: sf.slic_w3_pass(lab, cent, n_sp, sw)):.4f}"
          f" ms, labels only "
          f"{timed(lambda: sf.slic_w3_pass(lab, cent, n_sp, sw, partials=False)):.4f} ms, bound "
          f"{pass_b[0]:.4f} ({pass_b[1]}); one update "
          f"{timed(lambda: sf.slic_w3_update(cent.clone(), pk, h, w, n_sp)):.4f} ms (a "
          f"centroid clone included), bound {upd_b[0]:.5f} ({upd_b[1]}) ({card})", flush=True)

    if "--probes" in sys.argv:
        c39 = em_covariances(40, 39, dev)
        pt, dg = torch.empty_like(c39), torch.empty((40, 39), device=dev)
        for (name, _), lib in zip(K9_PROBES, build(
                [source(_kernels._CSRC, "precision_chol.cu", e) for _, e in K9_PROBES],
                [f"probe_chol_{k}" for k in range(len(K9_PROBES))],
                {"gcis_precision_chol": _kernels._SIGNATURES["gcis_precision_chol"]})):
            def call():
                rc = lib.gcis_precision_chol(c39.data_ptr(), pt.data_ptr(), dg.data_ptr(), 40, 39,
                                             stream())
                if rc:
                    sys.exit(f"K9 {name}: CUDA error {rc}")
            call()
            torch.cuda.synchronize()
            print(f"K9 [{name}] (40, 39, 39): {timed(call):.4f} ms, backward error "
                  f"{backward_error(c39, pt):.3e} ({card})", flush=True)
        variants = [source(_kernels._CSRC, "slic.cu", e) for _, e in K11_PROBES]
        libs = build(variants, [f"probe_slic_{k}" for k in range(len(variants))],
                     {"gcis_slic_w3_pass": _kernels._SIGNATURES["gcis_slic_w3_pass"]})
        rows, cols = sf._w3_bounds(h, w, n_sp, str(dev))
        fy, fx, swf = sf._scales(h, w, plan, sw)
        labels = torch.empty((bsz, h, w), dtype=torch.int32, device=dev)
        parts = torch.empty_like(pk)
        for (name, _), lib in zip(K11_PROBES, libs):
            for partials in (True, False):
                def call():
                    rc = lib.gcis_slic_w3_pass(
                        lab.data_ptr(), cent.data_ptr(), labels.data_ptr(),
                        parts.data_ptr() if partials else None, rows.data_ptr(),
                        cols.data_ptr(), bsz, h, w, gh, gw, plan["ty"], plan["tx"], fy, fx,
                        swf, stream())
                    if rc:
                        sys.exit(f"K11 {name}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                same = torch.equal(labels, lk) and (not partials or torch.equal(parts, pk))
                print(f"K11 pass [{name}] {'with partials' if partials else 'labels only'}: "
                      f"equal to the pass {same}, {timed(call):.4f} ms ({card})", flush=True)


if __name__ == "__main__":
    main()
