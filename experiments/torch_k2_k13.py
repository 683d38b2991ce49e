#!/usr/bin/env python3
"""Time K2 and K13 on one NVIDIA card at the main paths' shapes, by design
variant, against their plain versions, and print their compile statistics.

    python3 experiments/torch_k2_k13.py [--ptxas] [--quick] [--probes] [--k13-variants] [--e2e]

K2 (``lloyd_chw_pass``) on config1's features (16, 240, 321, 481) bf16 at
full resolution and on the 2x2 twin (16, 240, 160, 240), with sums and
labels only, from K3's centres as the pipeline takes them, and on config0's
(1, 36, 321, 481) float32 features from maximin seeds; each with the tile's
pixels and the ring's stages forced to a few values beside ``lloyd_plan``'s
(the CTAs an image follow, one an SM; ``--quick`` times the plan's choice
only). Each line: labels
equal to the plain version, the sums' error against the plain sums' largest
magnitude, kernel ms, the plain version's ms, the bound (bytes: the D rows
read once, the labels written once) and its share, the bytes the CTAs of an
SM have in flight while one stage is scored, and the card's name and power
limit.

K13 (``slic_band_pass`` and ``slic_band_update``) and the banded loop
(``slic_banded``) on eight 540x960 mosaics' Lab (config4's pooled grid's
shape, 405 superpixels; made at that size, not pooled from 4K, which takes
minutes on the host): one pass with partials by column-piece width, one
pass labels only, one update, the whole 10-iteration loop (two loops
bit-equal and equal to the plain loop), and K12 (``slic_w5``) and K11
(``slic_w3``) at 8x321x481 with 400 superpixels beside K13's loop.

Timing: CUDA events, the median of 5 calls, or for a call under 1 ms the
median of 5 means over 50 back-to-back calls behind a sleep kernel. The
script also runs on a checkout without ``lloyd_plan`` (an older K2): it then
times the default launch only, so one call can time two commits in turns.
``--ptxas`` compiles csrc/lloyd_chw.cu and csrc/slic_banded.cu once with
``-Xptxas -v`` and prints registers, shared memory and spills.
``--probes`` builds csrc/lloyd_chw.cu again into the git-ignored
``_build/`` as text-patched copies (the source itself untouched), each with
one phase switched off (the staging copies, the scores' mma loop, the
sums' mma), and times each on config1's
full-resolution rows with sums and labels only at the plan's launch; the
outputs of the patched builds are meaningless, only their times are read.
``--k13-variants`` builds csrc/slic_banded.cu the same way with the pass
kernel's launch bounds asking for 5 and 6 blocks an SM, and as probes with
one phase off (the Lab loads, all candidates but the first, the moments'
flushes), and times one pass with partials and one labels only at 128-
and 160-column pieces with each (labels checked against the plain pass;
the probes' are meaningless). ``--e2e`` times ``segment_batch`` end to end (host uint8 in, host
int32 labels out; median of 11 calls after one) at config1 batch 16 bf16,
config0 batch 1 f32 and config4's SLIC alone (K13's loop inside
``slic_batch`` on the 540x960 Lab), with K2's and K13's launches counted.
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as kc  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic as sl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import features as ft  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import fused  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402
from _turns import bound, card_line, cuda_ms, ptxas  # noqa: E402

K2_VARIANTS = ((128, 2), (128, 3), (128, 4), (64, 3), (32, 3))
# (name, [(source text, its replacement), ...]): each probe switches one K2
# phase off (the staging probe turns the TMA path off too, so that no wait
# is left on an mbarrier that nothing completes)
K2_PROBES = [
    ("full", []),
    ("no staging copies",
     [("auto bulk = [&](long p0) { return p0 + P + 16 / es <= n; };",
       "auto bulk = [&](long p0) { return p0 < 0; };"),
      ("          cp_async16(dst + r", "          if (0) cp_async16(dst + r")]),
    ("no score mma", [("      for (int k0 = 0; k0 < g.nkc; k0 += 4) {",
                       "      for (int k0 = 0; k0 < 0; k0 += 4) {")]),
    ("no sums mma", [("            for (int s = 0; s < SX; ++s)\n",
                      "            for (int s = 0; s < 0; ++s)\n")]),
]


def timed(fn):
    single = cuda_ms(fn)
    return single if single >= 1.0 else cuda_ms(fn, inner=50, hold_ms=50 * single)


# (name, edits) of slic_banded.cu: the pass kernel's launch bounds, and
# probes with one phase switched off (their outputs are meaningless)
K13_VARIANTS = [
    ("as built", []),
    ("launch bounds 5 blocks an SM",
     [("__global__ void __launch_bounds__(NT) slic_band_pass_kernel(",
       "__global__ void __launch_bounds__(NT, 5) slic_band_pass_kernel(")]),
    ("launch bounds 6 blocks an SM",
     [("__global__ void __launch_bounds__(NT) slic_band_pass_kernel(",
       "__global__ void __launch_bounds__(NT, 6) slic_band_pass_kernel(")]),
    ("probe: no Lab loads", [("const float4 f = src[v];",
                              "const float4 f = make_float4(1.f, 2.f, 3.f, (float)v);")]),
    ("probe: one candidate a pixel", [("for (int gy = gy0; gy <= gy1; ++gy) {",
                                       "for (int gy = gy0; gy <= gy0; ++gy) {"),
                                      ("for (int gx = gx0; gx <= gx1; ++gx) {",
                                       "for (int gx = gx0; gx <= gx0; ++gx) {")]),
    ("probe: no flushes", [("flush(stage, wslots, wmask, nrec, lane);", "")]),
]


def probe_libs(source: str, variants: list, entry: str) -> list:
    """``source`` built once per variant (one nvcc each, all started
    together), with ``entry`` bound as _kernels binds it."""
    src = (_kernels._CSRC / source).read_text()
    for inc in ("common.cuh", "slic_common.cuh"):
        src = src.replace(f'#include "{inc}"', f'#include "{_kernels._CSRC / inc}"')
    _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _kernels._find_nvcc()
    outs, procs = [], []
    for k, (_, edits) in enumerate(variants):
        text = src
        for old, new in edits:
            if old not in text:
                sys.exit(f"variant {k}: pattern not found in {source}: {old!r}")
            text = text.replace(old, new)
        cu = _kernels.BUILD_DIR / f"probe_{Path(source).stem}_{k}.cu"
        cu.write_text(text)
        out = cu.with_suffix(".so")
        procs.append(subprocess.Popen([nvcc, *_kernels.NVCC_FLAGS, "-shared", str(cu), "-o",
                                       str(out)], stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        outs.append(out)
    libs = []
    for proc, out in zip(procs, outs):
        log = proc.communicate()[0]
        if proc.returncode:
            sys.exit(f"probe build failed:\n{log}")
        lib = ctypes.CDLL(str(out))
        getattr(lib, entry).argtypes = _kernels._SIGNATURES[entry]
        getattr(lib, entry).restype = ctypes.c_int
        libs.append(lib)
    return libs


def probe_k2(dev, card) -> None:
    libs = probe_libs("lloyd_chw.cu", K2_PROBES, "gcis_lloyd_chw")
    tag, xe, xc4, wc, offs = k2_inputs(dev)[0]
    b, e, h, w = xe.shape
    n, k, es = h * w, wc.shape[1], xe.element_size()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    p, stages, ctas, tpc, rb = kc.lloyd_plan(b, n, e + 3, es, n_sm)
    labels = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    partial = torch.empty((b, ctas, k, e + 4), dtype=torch.float32, device=dev)
    sums = torch.empty((b, k, e + 4), dtype=torch.float32, device=dev)
    b_ms = bound(b * n * ((e + 3) * es + 4), 0)[0]
    for (name, _), lib in zip(K2_PROBES, libs):
        for assign_only in (False, True):
            def call():
                rc = lib.gcis_lloyd_chw(
                    xe.data_ptr(), xc4.data_ptr(), wc.data_ptr(), offs.data_ptr(),
                    labels.data_ptr(), partial.data_ptr(), sums.data_ptr(), None, b, e, n, k,
                    _kernels.storage_code(xe.dtype), p, stages, rb, ctas, tpc,
                    int(assign_only), torch.cuda.current_stream().cuda_stream)
                if rc:
                    sys.exit(f"probe {name}: CUDA error {rc}")
            ms = timed(call)
            print(f"K2 probe [{name}] {tag} {'labels only' if assign_only else 'with sums'}: "
                  f"{ms:.4f} ms, bound {b_ms:.4f} ({card})", flush=True)


def mosaics(n, h=321, w=481):
    return np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0]
                     for i in range(n)])


def k2_inputs(dev):
    """[(tag, xe, xc4, wc, offs)]: config1's full-resolution and twin rows
    with K3's centres folded, and config0's float32 rows with its maximin
    seeds folded, as the pipeline builds them."""
    out = []

    def folded(affine, centers, dt):
        a, b = affine
        u = centers - b[:, None, :]
        return (a[:, None, :] * u).to(dt).float(), u.square().sum(dim=2)

    cfg = preset("config1")
    color = pl._color_transform(torch.from_numpy(mosaics(16)).to(dev), "lab")
    groups = bank_tensors(make_bank(cfg.bank), dev)
    e, tw = fused.gabor_energies_fused(color, groups, torch.bfloat16)
    xc4 = kc.build_color4(color, torch.bfloat16)
    pc0 = ft._pool2x2_cm(xc4)
    affine = kc._affine_params(e, xc4, cfg.cluster, 1e-6, pooled=(tw, pc0))
    pe2, pc2 = ft._pool2x2_cm(tw), ft._pool2x2_cm(pc0)
    xp = ft.assemble_xp_from_affine(pe2, pc2, affine[0], affine[1], torch.bfloat16)
    d, m = xp.shape[1], xp.shape[2]
    centers = kf.kmeans_coarse_centers_xp(xp, cfg.cluster.k, d, m, cfg.cluster.coarse_iters)
    wc, offs = folded(affine, centers, torch.bfloat16)
    out += [("config1 full resolution bf16", e, xc4, wc, offs),
            ("config1 2x2 twin bf16", tw, pc0, wc, offs)]
    cfg0 = preset("config0")
    color = pl._color_transform(torch.from_numpy(mosaics(1)).to(dev), "lab")
    e0, tw0 = fused.gabor_energies_fused(color, bank_tensors(make_bank(cfg0.bank), dev),
                                         torch.float32)
    xc0 = kc.build_color4(color, torch.float32)
    aff0 = kc._affine_params(e0, xc0, cfg0.cluster, 1e-6, pooled=(tw0, ft._pool2x2_cm(xc0)))
    c0 = kc._maximin_init_chw(e0, xc0, aff0[0], aff0[1], cfg0.cluster.k)
    out.append(("config0 f32 batch 1", e0, xc0, *folded(aff0, c0, torch.float32)))
    return out


def time_k2(dev, card, quick) -> None:
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    planned = getattr(kc, "lloyd_plan", None)
    for tag, xe, xc4, wc, offs in k2_inputs(dev):
        b, e, h, w = xe.shape
        n, k, d, es = h * w, wc.shape[1], e + 3, xe.element_size()
        lp, sp, cp = kc.lloyd_chw_pass_plain(xe, xc4, wc, offs)
        scale = sp.abs().max().item()
        b_ms, b_by = bound(b * n * (d * es + 4), b * n * (2 * k * d + d))
        variants = [None]
        if planned is not None and not quick:
            variants += list(K2_VARIANTS)
        for v in variants:
            if v is None:
                plan = planned(b, n, d, es, n_sm) if planned else None
                name = "plan" if planned else "default launch"
            else:
                p, s = v
                if kc._lloyd_smem(d, p, s, es) > kc._SMEM_CTA:
                    continue
                ntiles = -(-n // p)
                ctas = min(ntiles, max(1, n_sm // b))
                tpc = -(-ntiles // ctas)
                plan = (p, s, -(-ntiles // tpc), tpc, d)
                if planned and plan == planned(b, n, d, es, n_sm):
                    continue
                name = f"P {p}, S {s}"
                kc.lloyd_plan = lambda *_, q=plan: q
            for assign_only in (False, True):
                if assign_only:
                    got = kc.lloyd_chw_pass(xe, xc4, wc, offs, True)
                    same, err = (got == lp).float().mean().item(), 0.0
                else:
                    got, gs, gc = kc.lloyd_chw_pass(xe, xc4, wc, offs)
                    again = kc.lloyd_chw_pass(xe, xc4, wc, offs)
                    same = (got == lp).float().mean().item()
                    err = (gs - sp).abs().max().item() / scale
                    bits = all(torch.equal(x, y) for x, y in zip((got, gs, gc), again))
                torch.cuda.synchronize()
                ms = timed(lambda: kc.lloyd_chw_pass(xe, xc4, wc, offs, assign_only))
                plain = timed(lambda: kc.lloyd_chw_pass_plain(xe, xc4, wc, offs, assign_only))
                fly = ""
                if plan is not None:
                    p, s, ctas, tpc, _ = plan
                    fly = (f"{ctas} CTAs an image x {tpc} tiles of {p} px, {s} stages, "
                           f"{kc._lloyd_smem(d, p, s, es) / 1024:.1f} KB a CTA (one an SM), "
                           f"{max(1, s - 1) * d * (p * es + 16) / 1024:.0f} KB in flight an "
                           f"SM; ")
                print(f"K2 {tag} {tuple(xe.shape)} k={k} "
                      f"{'labels only' if assign_only else 'with sums'} [{name}]: {fly}"
                      f"labels equal {same:.6f}"
                      + ("" if assign_only else f", sums err {err:.2e} of {scale:.4g}, "
                         f"two launches bit-equal {bits}")
                      + f"; {ms:.4f} ms, plain {plain:.4f}, bound {b_ms:.4f} ({b_by}), "
                      f"{100 * b_ms / ms:.1f} % of it ({card})", flush=True)
            if planned is not None:
                kc.lloyd_plan = planned
        del xe, xc4, lp, sp, cp
        torch.cuda.empty_cache()


def k13_variants(dev, card) -> None:
    libs = probe_libs("slic_banded.cu", K13_VARIANTS, "gcis_slic_band_pass")
    g4 = preset("config4").graph
    lab = pl._color_transform(torch.from_numpy(mosaics(8, 540, 960)).to(dev), "lab")
    bsz, h, w, _ = lab.shape
    bp = sf._band_plan(h, w, g4.n_superpixels)
    _, _, sw = sl.slic_geometry(h, w, g4.n_superpixels, g4.slic_compactness)
    cent = sl.slic_init_centroids(lab, bp["gh"], bp["gw"])
    fy, fx, swf = sf._scales(h, w, bp, sw)
    for (name, _), lib in zip(K13_VARIANTS, libs):
        for cols in (128, 160):
            ref = sf.slic_band_pass_plain(lab, cent, bp, sw, cols=cols)
            labels = torch.empty((bsz, h, w), dtype=torch.int32, device=dev)
            parts = torch.empty_like(ref[1])
            for partials in (True, False):
                def call():
                    rc = lib.gcis_slic_band_pass(
                        lab.data_ptr(), cent.data_ptr(), labels.data_ptr(),
                        parts.data_ptr() if partials else None, bsz, h, w, bp["gh"], bp["gw"],
                        bp["w_rows"], bp["band_rows"], cols, fy, fx, swf,
                        torch.cuda.current_stream().cuda_stream)
                    if rc:
                        sys.exit(f"K13 {name}: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                same = torch.equal(labels, ref[0]) and (not partials or torch.equal(parts, ref[1]))
                print(f"K13 pass [{name}] {cols}-column pieces "
                      f"{'with partials' if partials else 'labels only'}: bit-equal {same}, "
                      f"{timed(call):.4f} ms ({card})", flush=True)


def time_k13(dev, card) -> None:
    g4 = preset("config4").graph
    lab = pl._color_transform(torch.from_numpy(mosaics(8, 540, 960)).to(dev), "lab")
    bsz, h, w, _ = lab.shape
    n_sp, ruler, iters = g4.n_superpixels, g4.slic_compactness, g4.slic_iters
    bp = sf._band_plan(h, w, n_sp)
    _, _, sw = sl.slic_geometry(h, w, n_sp, ruler)
    cent = sl.slic_init_centroids(lab, bp["gh"], bp["gw"])
    for _ in range(3):  # centroids off the grid, as a pass meets them
        _, parts = sf.slic_band_pass_plain(lab, cent, bp, sw)
        cent = sf.slic_band_update_plain(cent, parts, bp)
    n_cand = int(sl._candidates(h, w, bp["gh"], bp["gw"], dev)[1].sum()) * bsz
    pass_b = bound(lab.numel() * 4 + bsz * h * w * 4, n_cand * 12)
    geo = (f"8x{h}x{w} S={bp['n_sp']} (grid {bp['gh']}x{bp['gw']}, {bp['n_bands']} bands of "
           f"{bp['band_rows']} rows, window {bp['w_rows']}x{bp['gw']})")
    lp, pp = sf.slic_band_pass_plain(lab, cent, bp, sw)
    for cols in sorted({w, 256, 160, 140, sf._BAND_COLS, 64}, reverse=True):
        lk, pk = sf.slic_band_pass(lab, cent, bp, sw, cols=cols)
        lq, pq = sf.slic_band_pass_plain(lab, cent, bp, sw, cols=cols)
        torch.cuda.synchronize()
        ms = timed(lambda: sf.slic_band_pass(lab, cent, bp, sw, cols=cols))
        print(f"K13 pass {geo} with partials, {cols}-column pieces: labels and partials "
              f"bit-equal {torch.equal(lk, lq) and torch.equal(pk, pq)}, {ms:.4f} ms, bound "
              f"{pass_b[0]:.4f} ({pass_b[1]}) ({card})", flush=True)
    ms = timed(lambda: sf.slic_band_pass(lab, cent, bp, sw, partials=False))
    same = torch.equal(sf.slic_band_pass(lab, cent, bp, sw, partials=False)[0], lp)
    print(f"K13 pass {geo} labels only: bit-equal {same}, {ms:.4f} ms, plain "
          f"{timed(lambda: sf.slic_band_pass_plain(lab, cent, bp, sw, partials=False)):.4f} "
          f"({card})", flush=True)
    up = sf.slic_band_update(cent.clone(), pp.contiguous(), bp, h)
    same = torch.equal(up, sf.slic_band_update_plain(cent, pp, bp))
    ms = timed(lambda: sf.slic_band_update(cent.clone(), pp, bp, h))
    clone = timed(lambda: cent.clone())
    print(f"K13 update {geo}: bit-equal {same}, {ms:.4f} ms (with a {clone:.4f} ms clone of "
          f"the centroids), plain {timed(lambda: sf.slic_band_update_plain(cent, pp, bp)):.4f}"
          f" ({card})", flush=True)
    args = (lab, n_sp, ruler, iters)
    got, again, ref = sf.slic_banded(*args), sf.slic_banded(*args), sf.slic_banded_plain(*args)
    torch.cuda.synchronize()
    loop_b = bound(lab.numel() * 4 + bsz * h * w * 4,
                   (iters + 1) * (n_cand * 12 + bsz * bp["n_sp"] * 11) + iters * bsz * h * w * 6)
    ms = timed(lambda: sf.slic_banded(*args))
    print(f"K13 loop {geo}, {iters} iterations ({iters + 1} passes, {iters} updates): "
          f"{int((got != ref).sum())} pixels differ from the plain loop, two loops bit-equal "
          f"{torch.equal(got, again)}, {ms:.4f} ms, plain {timed(lambda: sf.slic_banded_plain(*args)):.4f}, "
          f"bound {loop_b[0]:.4f} ({loop_b[1]}) ({card})", flush=True)
    del lab, cent, pp, lp
    lab5 = pl._color_transform(torch.from_numpy(mosaics(8)).to(dev), "lab")
    args = (lab5, 400, ruler, iters)
    ref = sf.slic_banded(*args)
    for name, fn in (("K12 slic_w5", sf.slic_w5), ("K13 slic_banded", sf.slic_banded),
                     ("K11 slic_w3", sf.slic_w3)):
        same = (fn(*args) == ref).float().mean(dim=(1, 2)).min().item()
        print(f"{name} 8x321x481 S=400, {iters} iterations: labels equal to K13's loop per "
              f"image min {same:.6f}, {timed(lambda: fn(*args)):.4f} ms ({card})", flush=True)


def e2e(dev, card) -> None:
    def host_ms(fn, reps=11):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times), min(times), max(times)

    for name, cfg, rgb in (("config1 batch 16 bf16", preset("config1"), mosaics(16)),
                           ("config0 batch 1 f32", preset("config0").replace(batch_size=1),
                            mosaics(1))):
        kc.lloyd_chw_pass.launches = 0
        med, lo, hi = host_ms(lambda: pl.segment_batch(rgb, cfg, with_features=False,
                                                       device="cuda")[0].cpu())
        print(f"e2e {name}: {med:.2f} ms/batch (median of 11, range {lo:.2f}..{hi:.2f}), "
              f"lloyd_chw_pass launches {kc.lloyd_chw_pass.launches} ({card})", flush=True)
    g4 = preset("config4").graph
    lab = pl._color_transform(torch.from_numpy(mosaics(8, 540, 960)).to(dev), "lab")
    sf.slic_band_pass.launches = 0
    med, lo, hi = host_ms(lambda: sf.slic_batch(lab, g4.n_superpixels, g4.slic_compactness,
                                                g4.slic_iters).cpu())
    print(f"e2e config4's SLIC (slic_batch on 8x540x960 Lab): {med:.2f} ms (median of 11, "
          f"range {lo:.2f}..{hi:.2f}), slic_band_pass launches {sf.slic_band_pass.launches} "
          f"({card})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = card_line()
    print(card, flush=True)
    if "--ptxas" in sys.argv:
        ptxas(_kernels._CSRC, ["lloyd_chw.cu", "slic_banded.cu"], "change")
    _kernels.library()
    set_policy()
    dev = torch.device("cuda")
    if "--probes" in sys.argv:
        probe_k2(dev, card)
    if "--k13-variants" in sys.argv:
        k13_variants(dev, card)
    if "--e2e" in sys.argv:
        e2e(dev, card)
    time_k2(dev, card, "--quick" in sys.argv)
    time_k13(dev, card)


if __name__ == "__main__":
    main()
