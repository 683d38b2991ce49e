#!/usr/bin/env python3
"""K8's EM moments against float64 on one NVIDIA card, at config2's
shapes, beside the plain pass and, with ``--parent``, a parent commit's
K8 on the same inputs.

    python3 experiments/torch_em_moments.py [--parent DIR] [--ptxas] [--batch 50]
                                            [--iters 0,10] [--wide 51,123]

Inputs: ``--batch`` 321x481 five-region mosaics (seeds 100, 101, ...)
through the pipeline's own front end (``pipeline._normalised_buffer``, the
fit grid pooled as ``_segment_gmm`` pools it), bf16, so the buffers are
config2's full-resolution (B, 39, 154401) and fit-grid (B, 39, 9600)
buffers. K8's inputs are the GMM's after its k-means init (iteration 0)
and after more EM iterations on the fit grid (each of ``--iters``; the
plain pass, float32 parameters). The wide kernel (40 < D <= 128) runs on
the same frames through banks of 16 kernels (D = 51: scales 1.5, 2, 4, 8)
and 40 kernels (D = 123: ten scales), each D of ``--wide``.

On each buffer with moments: K8 (``gmm_fused.em_pass``), the plain pass
(``em_pass_plain``: float32 scores and responsibilities, float64 sums
rounded once) and the parent's K8 against the plain pass computed in
float64 throughout. Each line gives, for counts, sums and scatter, the
largest distance of an entry from float64 over each component's largest
entry (max(count, max_a sum r x_a^2), as tests/test_torch_cuda.py
scales it), the log-likelihood's relative distance, whether two launches
give the same bits, the labels' agreement with the plain pass, and the
kernels' ms (CUDA events, median of 5; the mean of 50 back-to-back calls
behind a sleep kernel for a call under 1 ms) in turns: parent, change,
change, parent. The float64 pass runs a few images at a time.

``--parent DIR``: a checkout of the parent commit (``git archive``
unpacked into a git-ignored directory); its csrc/em_pass.cu is built into
a library of its own and called with the parent's signature (a float32
partial buffer). ``--ptxas`` prints registers, shared memory and spills of
the change's em_pass.cu (and the parent's). ``--variants`` builds text-
patched copies of em_pass.cu into the git-ignored ``_build/`` (``VARIANTS``:
one design choice changed each, the source untouched) and prints each
one's ptxas line, its distance from float64 and its ms on config2's D = 39
buffers, in turns with the change; then it stops.
"""

from __future__ import annotations

import ctypes
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gabor_color_image_segmentation_tpu_torch import _kernels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import gmm_fused as gf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models.gmm import gmm_fit_levels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models.kmeans_chw import build_color4  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import features as ft  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402
from _turns import build, card_line, cuda_ms, ptxas, source  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURE = {"gcis_em_pass": [_P] * 8 + [_I] * 8 + [_P]}  # the parent's and the change's
WIDE_SCALES = {51: (1.5, 2.0, 4.0, 8.0),
               123: (1.5, 2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0, 12.0, 14.0)}
F64_BLOCK = 2  # images a float64 pass takes at a time


def _sizes(run, fold):
    """Edits of em_pass.cu's float32 run length and the chunks a fold spans."""
    return [("constexpr int RUN = 32;", f"constexpr int RUN = {run};"),
            ("constexpr int FOLD = 4;", f"constexpr int FOLD = {fold};")]


# (name, [(old, new), ...]) text patches of em_pass.cu, each against the
# change's source
VARIANTS = [
    ("run8_fold4", _sizes(8, 4)),
    ("run16_fold4", _sizes(16, 4)),
    ("run16_fold8", _sizes(16, 8)),
    ("run32_fold1", _sizes(32, 1)),
    ("run32_fold8", _sizes(32, 8)),
    ("no_runs_fold1", _sizes(1 << 20, 1)),
]


def timed(fn):
    single = cuda_ms(fn)
    return single if single >= 1.0 else cuda_ms(fn, inner=50, hold_ms=50 * single)


def buffers(rgb, cfg, dev):
    """(x, fit): the normalised full-resolution buffer and the fit grid, as
    ``pipeline._segment_gmm`` builds them."""
    bank = make_bank(cfg.bank)
    x, energies, color, (a, b_aff) = pl._normalised_buffer(rgb, cfg, bank)
    dtype = x.dtype
    pe, pc = energies, build_color4(color, dtype)
    for _ in range(gmm_fit_levels(rgb.shape[1], rgb.shape[2], cfg.cluster.gmm_fit_pool)[2]):
        pe, pc = ft._pool2x2_cm(pe), ft._pool2x2_cm(pc)
    fit = ft.assemble_xp_from_affine(pe, pc, a, b_aff, dtype)
    return x, fit


def states(fit, k, reg, iters):
    """{iteration: K8's inputs}: after the k-means init's hard moments, and
    after each count of plain EM iterations on the fit grid in ``iters``."""
    labels, _ = kf.kmeans_fused_t_xt(fit, k, 10)
    m = fit.shape[2]
    params = gf._moments_to_params(*gf._init_moments(fit, labels, k), m, reg)
    out = {}
    for it in range(max(iters) + 1):
        if it in iters:
            out[it] = gf._params_to_kernel_inputs(*params)
        if it < max(iters):
            _, _, *mom = gf.em_pass_plain(fit, *gf._params_to_kernel_inputs(*params))
            params = gf._moments_to_params(*mom, m, reg)
    return out


def in_blocks(fn, x, inputs, blk):
    """fn over images [s, s + blk) at a time, outputs concatenated."""
    parts = [fn(x[s:s + blk], *(t[s:s + blk] for t in inputs))
             for s in range(0, x.shape[0], blk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def distance(out, r64):
    """(ll relative distance, {moment: distance over the component's
    largest entry}) from the float64 pass, largest over images and
    components."""
    b, k = r64[2].shape
    scale = torch.maximum(r64[2], torch.diagonal(r64[4], dim1=2, dim2=3).amax(dim=2))
    scale = scale.clamp(min=1e-30)
    e_ll = ((out[1].double() - r64[1]).abs() / r64[1].abs()).max().item()
    e_m = {name: ((g.double() - r).abs().reshape(b, k, -1).amax(dim=2) / scale).max().item()
           for name, g, r in zip(("counts", "sums", "scatter"), out[2:], r64[2:])}
    return e_ll, e_m


def parent_em_pass(lib, partial_dtype="float32"):
    """Another build's K8 through its C entry, wrapped as gmm_fused.em_pass
    wraps it, with a partial buffer of ``partial_dtype`` (the parent's
    float32)."""
    def call(x, pt, bias, const, moments=True):
        b, d, n = x.shape
        k = bias.shape[1]
        dev = str(x.device)
        scat_idx, sums_idx, count_idx, tri = gf._unpack_index(d, dev)
        codes = gf._tile_codes(d, k, dev)
        width = k * tri + 1
        chunks, nblk = gf.em_plan(b, n, torch.cuda.get_device_properties(x.device)
                                  .multi_processor_count, gf.em_chunk(d))
        labels = torch.empty((b, n), dtype=torch.int32, device=x.device)
        partial = torch.empty((b, nblk, width), dtype=getattr(torch, partial_dtype),
                              device=x.device)
        packed = torch.empty((b, width), dtype=torch.float32, device=x.device)
        rc = lib.gcis_em_pass(x.data_ptr(), pt.data_ptr(), bias.data_ptr(), const.data_ptr(),
                              codes.data_ptr(), labels.data_ptr(), partial.data_ptr(),
                              packed.data_ptr(), b, d, n, k, chunks, codes.numel(),
                              _kernels.storage_code(x.dtype), int(moments),
                              torch.cuda.current_stream().cuda_stream)
        if rc:
            sys.exit(f"parent K8: CUDA error {rc}")
        if not moments:
            return labels
        per = packed[:, : k * tri].reshape(b, k, tri)
        return (labels, packed[:, k * tri], per[:, :, count_idx], per[:, :, sums_idx],
                per[:, :, scat_idx])
    return call


def report(tag, buf, inputs, kernels, card):
    """One buffer: each kernel's distance from float64 beside the plain
    pass's, two launches' bits, labels, and the kernels' ms in turns."""
    r64 = in_blocks(lambda *a: gf.em_pass_plain(*a), buf,
                    tuple(t.double() for t in inputs), F64_BLOCK)
    plain = in_blocks(lambda *a: gf.em_pass_plain(*a), buf, inputs, F64_BLOCK)
    rows = [("plain", plain, None)]
    for who, fn in kernels:
        got, again = fn(buf, *inputs), fn(buf, *inputs)
        torch.cuda.synchronize()
        same = all(torch.equal(g, a) for g, a in zip(got, again))
        rows.append((who, got, same))
    for who, out, same in rows:
        e_ll, e_m = distance(out, r64)
        agree = (out[0] == plain[0]).float().mean().item()
        bits = "" if same is None else f", two launches bit-equal {same}"
        print(f"{tag} {tuple(buf.shape)} {who}: from float64 counts {e_m['counts']:.3e}, "
              f"sums {e_m['sums']:.3e}, scatter {e_m['scatter']:.3e}, worst "
              f"{max(e_m.values()):.3e}; ll {e_ll:.3e}; labels equal to the plain pass's "
              f"{agree:.6f}{bits} ({card})", flush=True)
    del r64, plain, rows
    order = [w for w in ("parent", "change", "change", "parent") if w in dict(kernels)]
    for moments in (True, False):
        ms = {}
        for who in order:
            fn = dict(kernels)[who]
            ms.setdefault(who, []).append(timed(lambda: fn(buf, *inputs, moments=moments)))
        line = ", ".join(f"{who} {' / '.join(f'{v:.4f}' for v in vals)} ms"
                         for who, vals in ms.items())
        print(f"{tag} {tuple(buf.shape)} {'with moments' if moments else 'labels only'}: "
              f"{line} ({card})", flush=True)


def variant_ptxas(text: str, name: str) -> None:
    """ptxas's registers and spills of em_kernel in a patched source."""
    import subprocess

    cu = _kernels.BUILD_DIR / f"ptxas_{name}.cu"
    cu.write_text(text)
    res = subprocess.run([_kernels._find_nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                          str(cu), "-o", "/dev/null"], capture_output=True, text=True)
    lines = (res.stdout + res.stderr).splitlines()
    out = []
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and "em_kernel" in ln and "bfloat16" in ln:
            out += [s.strip() for s in lines[i + 1:i + 3]]
    print(f"ptxas {name}: " + " | ".join(out), flush=True)


def variants(parent_call, card) -> None:
    """VARIANTS beside the change (and the parent) on config2's D = 39
    buffers: ptxas, distance from float64 on the fit grid, ms in turns."""
    texts = [(name, source(_kernels._CSRC, "em_pass.cu", edits)) for name, edits in VARIANTS]
    for name, text in texts:
        variant_ptxas(text, name)
    libs = build([text for _, text in texts], [f"variant_{n}" for n, _ in texts], SIGNATURE)
    calls = [("change", gf.em_pass)] + [(n, parent_em_pass(lib, "float64"))
                                        for (n, _), lib in zip(texts, libs)]
    if parent_call is not None:
        calls.insert(0, ("parent", parent_call))
    dev = torch.device("cuda")
    batch = 50
    rgb = torch.from_numpy(np.stack([synthetic_mosaic(h=321, w=481, n_regions=5,
                                                      seed=100 + i)[0]
                                     for i in range(batch)])).to(dev)
    cfg = preset("config2").replace(dtype="bfloat16")
    x, fit = buffers(rgb, cfg, dev)
    inputs = states(fit, cfg.cluster.k, cfg.cluster.gmm_reg_covar, [0])[0]
    r64 = in_blocks(lambda *a: gf.em_pass_plain(*a), fit, tuple(t.double() for t in inputs),
                    F64_BLOCK)
    for name, fn in calls:
        e_ll, e_m = distance(fn(fit, *inputs), r64)
        print(f"variant {name}: fit grid worst from float64 {max(e_m.values()):.3e}", flush=True)
    for buf, where in ((fit, "fit grid"), (x, "full resolution")):
        for moments in (True, False):
            ms = {}
            for turn in range(2):
                for name, fn in (calls if turn == 0 else calls[::-1]):
                    ms.setdefault(name, []).append(
                        timed(lambda: fn(buf, *inputs, moments=moments)))
            print(f"variants {where} {tuple(buf.shape)} "
                  f"{'with moments' if moments else 'labels only'}: "
                  + ", ".join(f"{n} {' / '.join(f'{v:.4f}' for v in vals)}"
                              for n, vals in ms.items()) + f" ms ({card})", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    args = sys.argv[1:]

    def opt(name, default):
        return args[args.index(name) + 1] if name in args else default

    batch = int(opt("--batch", "50"))
    iters = sorted({int(v) for v in opt("--iters", "0,10").split(",")})
    wide = [int(v) for v in opt("--wide", "51,123").split(",") if v]
    parent = Path(opt("--parent", "")).resolve() / (
        "gabor_color_image_segmentation_tpu_torch/csrc") if "--parent" in args else None
    card = card_line()
    print(card, flush=True)
    if "--ptxas" in args:
        ptxas(_kernels._CSRC, ["em_pass.cu"], "change")
        if parent is not None:
            ptxas(parent, ["em_pass.cu"], "parent")
    _kernels.library()
    set_policy()
    dev = torch.device("cuda")
    kernels = [("change", gf.em_pass)]
    if parent is not None:
        (plib,) = build([source(parent, "em_pass.cu")], ["parent_em_pass"], SIGNATURE)
        kernels.insert(0, ("parent", parent_em_pass(plib)))
    if "--variants" in args:
        variants(dict(kernels).get("parent"), card)
        return

    rgb = torch.from_numpy(np.stack([synthetic_mosaic(h=321, w=481, n_regions=5,
                                                      seed=100 + i)[0]
                                     for i in range(batch)])).to(dev)
    base = preset("config2").replace(dtype="bfloat16")
    c2 = base.cluster
    for d in [39] + wide:
        cfg = base if d == 39 else base.replace(
            bank=dataclasses.replace(base.bank, scales=WIDE_SCALES[d]))
        x, fit = buffers(rgb, cfg, dev)
        assert x.shape[1] == d, (x.shape, d)
        for it, inputs in states(fit, c2.k, c2.gmm_reg_covar, iters).items():
            for name, buf in (("fit grid", fit), ("full resolution", x)):
                report(f"D={d} iteration {it} {name}", buf, inputs, kernels, card)
        del x, fit
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
