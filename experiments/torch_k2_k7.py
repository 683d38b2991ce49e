#!/usr/bin/env python3
"""Time K7 and K2's blocked form on one NVIDIA card, against a parent
commit's kernels in turns in one process, and check K2's bits where the
parent's plan fits.

    python3 experiments/torch_k2_k7.py [--parent DIR] [--ptxas] [--variants] [--probes]

``--parent DIR``: a checkout of the parent commit (``git archive``
unpacked into a git-ignored directory); its csrc/lloyd_chw.cu and
csrc/lloyd_rows.cu are built into shared libraries of their own (one nvcc
each) and bound with the parent's signatures (commit 0601826): K2
``gcis_lloyd_chw`` (no rows a block, no sums scratch) and K7
``gcis_lloyd_rows`` (a kernel of 1,024-pixel blocks up to 512 rows, a wide
kernel of 128-pixel blocks past them, and a second launch adding the
blocks' partials). Then:

- K2's bits: labels, sums and counts of both commits bit-equal at config1's
  full-resolution and 2x2-twin passes (bf16, from K3's centres) and at
  config0 (f32, from maximin seeds), with sums and labels only, under the
  parent's plan (the change keeps it wherever a whole tile fits);
- parent, change, change, parent: K2 at those three shapes with sums, and
  K7 at config1's standardised rows (16, 154401, 243) bf16, k = 5, and at
  (2, 20000, 1000) bf16 and f32, k = 8.

Then the change alone: K2 past the rows a whole tile stages (fault 10;
the parent refused them) at one 321x481 frame of blobs with E = 1,700 and
2,688 (bf16) and 1,400 (f32) energy rows, and K7 at (2, 20000, D), D =
2,048 and 4,096 (values staged in blocks), each beside its plain version
and its bytes bound, with its plan. ``--variants`` times K7 at config1's
rows and at (2, 20000, 1000) with the plan's tile and stages forced to
other values that fit, and K2 at E = 2,688 bf16 and 1,400 f32 with its
blocked tile forced to 64 and 32 pixels (the rows a block re-planned to
fit). ``--probes`` rebuilds K7 from text-patched copies of
csrc/lloyd_rows.cu (common.cuh inlined) into the git-ignored ``_build/``,
each with one phase off or one constant changed (K7_PROBES), and times
each at config1's rows and at (2, 20000, 1000) in both dtypes (a probe's
outputs are meaningless; "256 threads" is checked against the plain
labels). ``--ptxas`` prints registers, shared memory and spills of both
commits' lloyd_chw.cu and lloyd_rows.cu.

Timing: CUDA events; a call under 1 ms is the mean of 50 back-to-back calls
behind a sleep kernel, median of 5, else the median of 5 single calls (as
chip_smoke.py), with the helpers of ``_turns.py``. Every line carries the
card's name and power limit.
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
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as kc  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import features as ft  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402
from _turns import bound, build, card_line, cuda_ms, ptxas, source  # noqa: E402

INNER = 50
_P, _I = ctypes.c_void_p, ctypes.c_int
# the parent's signatures (commit 0601826)
PARENT_SIGNATURES = {"gcis_lloyd_chw": [_P] * 7 + [_I] * 10 + [_P],
                     "gcis_lloyd_rows": [_P] * 5 + [_I] * 5 + [_P]}


# (name, edits) of lloyd_rows.cu: K7 with one phase off or one constant
# changed
K7_PROBES = [
    ("as built", []),
    ("256 threads", [("constexpr int NT = 512;", "constexpr int NT = 256;")]),
    ("probe: no sums", [("for (int m0 = warp; m0 < nmt; m0 += NWARP * MT_GROUP) {",
                         "for (int m0 = warp; m0 < 0; m0 += NWARP * MT_GROUP) {")]),
    ("probe: no score chunks", [("        chunk(kc, c[0]);\n        if (kc + ks < nkc) chunk(kc + ks, c[1]);",
                                 "        (void)kc;")]),
    # the tile's copy gone, its mbarrier expecting no bytes (whole tiles)
    ("probe: no copies", [("            mbar_expect(mbar + slot, bytes);\n"
                           "            bulk_copy(dst, a0, bytes, mbar + slot);",
                           "            mbar_expect(mbar + slot, 0);")]),
    # no CTA counts itself done (the counters untouched), no image's sums
    ("probe: no reduction", [("  if (tid == 0) last = count_done(cnt + 1 + grp) == (unsigned)gsz - 1;",
                              "  return;")]),
]


def timed(fn):
    """The mean of INNER back-to-back calls behind a sleep kernel (median of
    5) for a call under 1 ms, else the median of 5 single calls."""
    single = cuda_ms(fn)
    return single if single >= 1.0 else cuda_ms(fn, inner=INNER, hold_ms=INNER * single)


def stream():
    return torch.cuda.current_stream().cuda_stream


def k2_cases(dev):
    """[(tag, xe, xc4, wc, offs)] as the pipeline builds them (config1's
    full resolution and twin from K3's centres, config0 f32 from its
    maximin seeds): experiments/torch_k2_k13.py's inputs."""
    from torch_k2_k13 import k2_inputs

    return k2_inputs(dev)


def rows_case(dev, b, n, d, k, seed):
    """(B, n, d) float32 rows of k blobs ~4 noise radii apart and, as
    centres, the blob means moved by 0.1 noise."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=4.0, size=(b, k, d))
    lab = rng.integers(0, k, size=(b, n))
    x = np.take_along_axis(means, lab[:, :, None], 1) + rng.normal(size=(b, n, d))
    c = means + 0.1 * rng.normal(size=means.shape)
    return (torch.from_numpy(x.astype(np.float32)).to(dev),
            torch.from_numpy(c.astype(np.float32)).to(dev))


def k7_bound(x, k):
    b, n, d = x.shape
    return bound(x.numel() * x.element_size() + b * n * 4, b * n * (2 * k * d + d))


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
        ptxas(_kernels._CSRC, ["lloyd_chw.cu", "lloyd_rows.cu"], "change")
        if parent is not None:
            ptxas(parent, ["lloyd_chw.cu", "lloyd_rows.cu"], "parent")
    _kernels.library()
    set_policy()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    k2 = k2_cases(dev)
    rows, c1 = config1_rows(dev)
    k7 = [("config1 rows (16, 154401, 243) bf16 k=5", rows, c1, 5)]
    xw, cw = rows_case(dev, 2, 20000, 1000, 8, 7)
    k7 += [("(2, 20000, 1000) bf16 k=8", xw.to(torch.bfloat16), cw, 8),
           ("(2, 20000, 1000) f32 k=8", xw, cw, 8)]

    if parent is not None:
        plib = build([source(parent, "lloyd_chw.cu"), source(parent, "lloyd_rows.cu")],
                     ["parent_lloyd_chw", "parent_lloyd_rows"], PARENT_SIGNATURES)

        def k2_parent(xe, xc4, wc, offs, assign_only=False):
            b, e, h, w = xe.shape
            n, k = h * w, wc.shape[1]
            p, s, ctas, tpc, rb = kc.lloyd_plan(b, n, e + 3, xe.element_size(), n_sm)
            assert rb == e + 3, "the parent's K2 stages whole tiles only"
            labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
            partial = torch.empty((b, ctas, k, e + 4), device=dev)
            sums = torch.empty((b, k, e + 4), device=dev)
            rc = plib[0].gcis_lloyd_chw(xe.data_ptr(), xc4.data_ptr(), wc.data_ptr(),
                                        offs.data_ptr(), labels.data_ptr(), partial.data_ptr(),
                                        sums.data_ptr(), b, e, n, k,
                                        _kernels.storage_code(xe.dtype), p, s, ctas, tpc,
                                        int(assign_only), stream())
            if rc:
                sys.exit(f"parent K2: CUDA error {rc}")
            return labels if assign_only else (labels, sums[:, :, :e + 3], sums[:, :, e + 3])

        def k7_parent(x, c, k):
            b, n, d = x.shape
            labels = torch.empty((b, n), dtype=torch.int32, device=dev)
            partial = torch.empty((b, -(-n // 128), k, d + 1), device=dev)
            sums = torch.empty((b, k, d + 1), device=dev)
            rc = plib[1].gcis_lloyd_rows(x.data_ptr(), c.data_ptr(), labels.data_ptr(),
                                         partial.data_ptr(), sums.data_ptr(), b, d, n, k,
                                         _kernels.storage_code(x.dtype), stream())
            if rc:
                sys.exit(f"parent K7: CUDA error {rc}")
            return labels, sums[:, :, :d], sums[:, :, d]

        for tag, xe, xc4, wc, offs in k2:
            par, chg = k2_parent(xe, xc4, wc, offs), kc.lloyd_chw_pass(xe, xc4, wc, offs)
            lpar = k2_parent(xe, xc4, wc, offs, True)
            lchg = kc.lloyd_chw_pass(xe, xc4, wc, offs, True)
            torch.cuda.synchronize()
            print(f"parent vs change K2 {tag}: labels, sums and counts bit-equal "
                  f"{all(torch.equal(a, g) for a, g in zip(par, chg))}, labels only "
                  f"bit-equal {torch.equal(lpar, lchg)} ({card})", flush=True)
        for tag, x, c, k in k7:
            par, chg = k7_parent(x, c, k), kf.lloyd_pass(x, c, k)
            plain = kf.lloyd_pass_plain(x, c, k)
            torch.cuda.synchronize()
            print(f"parent vs change K7 {tag}: labels equal {torch.equal(par[0], chg[0])}, "
                  f"sums max diff {(par[1] - chg[1]).abs().max().item():.3e}; labels against "
                  f"the plain version: parent {int((par[0] != plain[0]).sum())} differ, change "
                  f"{int((chg[0] != plain[0]).sum())} ({card})", flush=True)
        for turn, who in enumerate(("parent", "change", "change", "parent")):
            parts = []
            for tag, xe, xc4, wc, offs in k2:
                fn = k2_parent if who == "parent" else kc.lloyd_chw_pass
                parts.append(f"K2 {tag} {timed(lambda: fn(xe, xc4, wc, offs)):.4f}")
            for tag, x, c, k in k7:
                fn = k7_parent if who == "parent" else kf.lloyd_pass
                parts.append(f"K7 {tag} {timed(lambda: fn(x, c, k)):.4f}")
            print(f"turn {turn + 1} {who} ms: {'; '.join(parts)} ({card})", flush=True)

    # the change alone: each K7 shape beside its bound and plain version
    for tag, x, c, k in k7:
        ctas, tpc, p, s, vb = kf.lloyd_rows_plan(x.shape[0], x.shape[1], x.shape[2],
                                                 x.element_size(), n_sm)
        b_ms, b_by = k7_bound(x, k)
        ms, plain = timed(lambda: kf.lloyd_pass(x, c, k)), timed(lambda: kf.lloyd_pass_plain(x, c, k))
        print(f"K7 {tag}: {ms:.4f} ms, plain {plain:.4f}, bound {b_ms:.4f} ({b_by}), "
              f"{100 * b_ms / ms:.1f} % of it; plan {ctas} CTAs an image x {tpc} tiles of {p} "
              f"px, {s} stages, values a block {vb} ({card})", flush=True)
    del k2

    # K2 past the rows a whole tile stages, on blobs with the means as centres
    for e_b, dt in ((1700, torch.bfloat16), (2688, torch.bfloat16), (1400, torch.float32)):
        x, c = rows_case(dev, 1, 321 * 481, e_b + 3, 5, e_b)
        x = x.transpose(1, 2).reshape(1, e_b + 3, 321, 481)
        xe = x[:, :e_b].to(dt).contiguous()
        xc4 = torch.cat([x[:, e_b:], torch.ones((1, 1, 321, 481), device=dev)], 1).to(dt)
        del x
        wc = c.to(dt).float()
        offs = wc.square().sum(dim=2)
        got, again = kc.lloyd_chw_pass(xe, xc4, wc, offs), kc.lloyd_chw_pass(xe, xc4, wc, offs)
        ref = kc.lloyd_chw_pass_plain(xe, xc4, wc, offs)
        torch.cuda.synchronize()
        err = ((got[1] - ref[1]).abs().max() / ref[1].abs().max()).item()
        p, s, ctas, tpc, rb = kc.lloyd_plan(1, 321 * 481, e_b + 3, xe.element_size(), n_sm)
        b_ms, b_by = bound(321 * 481 * ((e_b + 3) * xe.element_size() + 4), 0)
        ms = timed(lambda: kc.lloyd_chw_pass(xe, xc4, wc, offs))
        plain = timed(lambda: kc.lloyd_chw_pass_plain(xe, xc4, wc, offs))
        print(f"K2 E={e_b} {'bf16' if dt == torch.bfloat16 else 'f32'} 1x321x481 blobs k=5: "
              f"labels equal {torch.equal(got[0], ref[0])}, counts equal "
              f"{torch.equal(got[2], ref[2])}, sums rel err {err:.2e}, two launches bit-equal "
              f"{all(torch.equal(a, g) for a, g in zip(got, again))}; {ms:.4f} ms, plain "
              f"{plain:.4f}, bound {b_ms:.4f} ({b_by}), {100 * b_ms / ms:.1f} % of it; plan "
              f"{ctas} CTAs x {tpc} tiles of {p} px, {s} stages, rows a block {rb} ({card})",
              flush=True)
        del xe, xc4

    # K7 with its values staged in blocks
    for dd in (2048, 4096):
        x, c = rows_case(dev, 2, 20000, dd, 8, dd)
        for tag, xr in (("bf16", x.to(torch.bfloat16)), ("f32", x)):
            lk, sk, nk = kf.lloyd_pass(xr, c, 8)
            lp, sp, np_ = kf.lloyd_pass_plain(xr, c, 8)
            torch.cuda.synchronize()
            b_ms, b_by = k7_bound(xr, 8)
            vb = kf.lloyd_rows_plan(2, 20000, dd, xr.element_size(), n_sm)[4]
            print(f"K7 (2, 20000, {dd}) {tag} k=8, values in blocks of {vb}: "
                  f"{timed(lambda: kf.lloyd_pass(xr, c, 8)):.4f} ms, plain "
                  f"{timed(lambda: kf.lloyd_pass_plain(xr, c, 8)):.4f}, bound {b_ms:.4f} "
                  f"({b_by}); labels equal {torch.equal(lk, lp)}, counts equal "
                  f"{torch.equal(nk, np_)}, sums rel err "
                  f"{((sk - sp).abs().max() / sp.abs().max()).item():.2e} ({card})", flush=True)
        del x, xr

    if "--probes" in sys.argv:
        libs = build([source(_kernels._CSRC, "lloyd_rows.cu", e) for _, e in K7_PROBES],
                     [f"probe_lloyd_rows_{i}" for i in range(len(K7_PROBES))],
                     {"gcis_lloyd_rows": _kernels._SIGNATURES["gcis_lloyd_rows"]})
        library = _kernels.library
        for (name, _), lib in zip(K7_PROBES, libs):
            _kernels.library = lambda lib=lib: lib
            try:
                parts = []
                for tag, x, c, k in k7:
                    ms = timed(lambda: kf.lloyd_pass(x, c, k))
                    same = torch.equal(kf.lloyd_pass(x, c, k)[0], kf.lloyd_pass_plain(x, c, k)[0])
                    parts.append(f"{tag} {ms:.4f} (labels equal {same})")
            finally:
                _kernels.library = library
            print(f"K7 probe [{name}] ms: {'; '.join(parts)} ({card})", flush=True)
        kf._T_COUNTERS.clear()  # the probes' counters: fresh zeroed ones from here

    if "--variants" in sys.argv:
        for e_b, dt in ((2688, torch.bfloat16), (1400, torch.float32)):
            x, c = rows_case(dev, 1, 321 * 481, e_b + 3, 5, e_b)
            x = x.transpose(1, 2).reshape(1, e_b + 3, 321, 481)
            xe = x[:, :e_b].to(dt).contiguous()
            xc4 = torch.cat([x[:, e_b:], torch.ones((1, 1, 321, 481), device=dev)], 1).to(dt)
            del x
            wc = c.to(dt).float()
            offs = wc.square().sum(dim=2)
            ref = kc.lloyd_chw_pass_plain(xe, xc4, wc, offs)[0]
            planned, tile = kc.lloyd_plan, kc._BLOCK_TILE
            row = []
            for pp in (128, 64, 32):
                kc._BLOCK_TILE = (pp, 3)
                try:
                    forced = planned(1, 321 * 481, e_b + 3, xe.element_size(), n_sm)
                    kc.lloyd_plan = lambda *_, q=forced: q
                    same = torch.equal(kc.lloyd_chw_pass(xe, xc4, wc, offs)[0], ref)
                    ms = timed(lambda: kc.lloyd_chw_pass(xe, xc4, wc, offs))
                    only = timed(lambda: kc.lloyd_chw_pass(xe, xc4, wc, offs, True))
                finally:
                    kc.lloyd_plan, kc._BLOCK_TILE = planned, tile
                row.append(f"P {pp} (rows a block {forced[4]}): {ms:.4f}, labels only "
                           f"{only:.4f}, labels equal {same}")
            print(f"K2 E={e_b} {'bf16' if dt == torch.bfloat16 else 'f32'} blocked tile by "
                  f"pixels ms: {'; '.join(row)} ({card})", flush=True)
            del xe, xc4

        plan = kf.lloyd_rows_plan
        for tag, x, c, k in k7:
            b, n, d = x.shape
            es = x.element_size()
            chosen = plan(b, n, d, es, n_sm)
            row = []
            for p in (128, 64, 32, 16):
                for s in (2, 3, 4):
                    if kf._rows_smem(d, p, s, es) > kf._ROWS_SMEM:
                        continue
                    ntiles = -(-n // p)
                    ctas = min(ntiles, max(1, n_sm // b))
                    tpc = -(-ntiles // ctas)
                    forced = (-(-ntiles // tpc), tpc, p, s, d)
                    kf.lloyd_rows_plan = lambda *_, q=forced: q
                    try:
                        ms = timed(lambda: kf.lloyd_pass(x, c, k))
                    finally:
                        kf.lloyd_rows_plan = plan
                    row.append(f"P {p} S {s}{'*' if forced == chosen else ''}: {ms:.4f}")
            print(f"K7 {tag} by tile and stages (* the plan's) ms: {', '.join(row)} ({card})",
                  flush=True)


def config1_rows(dev):
    """config1's standardised features laid out (16, 154401, 243) bf16 and
    K3's centres on its 4x4 grid: the rows and centres K7 is timed on (as
    chip_smoke.py's)."""
    from gabor_color_image_segmentation_tpu_torch.config import preset
    from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
    from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl
    from gabor_color_image_segmentation_tpu_torch.ops import fused
    from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank

    cfg = preset("config1")
    rgb = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=100 + i)[0]
                    for i in range(16)])
    color = pl._color_transform(torch.from_numpy(rgb).to(dev), "lab")
    e, tw = fused.gabor_energies_fused(color, bank_tensors(make_bank(cfg.bank), dev),
                                       torch.bfloat16)
    xc4 = kc.build_color4(color, torch.bfloat16)
    pc0 = ft._pool2x2_cm(xc4)
    a, b = kc._affine_params(e, xc4, cfg.cluster, 1e-6, pooled=(tw, pc0))
    xp = ft.assemble_xp_from_affine(ft._pool2x2_cm(tw), ft._pool2x2_cm(pc0), a, b,
                                    torch.bfloat16)
    centres = kf.kmeans_coarse_centers_xp(xp, 5, xp.shape[1], xp.shape[2],
                                          cfg.cluster.coarse_iters)
    rows = ft.assemble_xp_from_affine(e, xc4, a, b, torch.bfloat16)
    return rows.transpose(1, 2).contiguous(), centres


if __name__ == "__main__":
    main()
