#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each, stopping with a non-zero exit at the first failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the Hopper kernels from ``csrc/`` with nvcc;
3. each kernel K1-K4 against its plain PyTorch version on the card, at the
   main path's shapes (config1: batch 16 of 321x481 in bf16; config0:
   batch 1 in f32 and bf16), with the error against its stated bound and
   the median time of each over a few runs (CUDA events);
4. ``segment_batch(uint8 -> int32 labels, with_features=False)`` end to end
   at config1 batch 16 bf16 and config0 batch 1 f32: ms/batch and MP/s
   from host uint8 in to host int32 labels out, each kernel's launch count
   in that run (every one must be > 0), and agreement with the all-plain
   path on the card, and the Rand index against the mosaics' ground truth
   (a reading, not a gate);
5. where the time goes: a ``torch.profiler`` table of one config1 call;
6. a JSON line of the kernels, then the last line
   ``{"ok": true, "device": {...}}``.

Tolerances (also in the tests): energies and twin <= 1e-4 * peak (f32),
<= 2e-2 * peak (bf16); Lloyd labels equal on >= 99.99 % of pixels, sums
within rtol 1e-4 (f32) / 1e-3 (bf16); coarse centres within rtol and atol
2e-3; maximin picks the same pixels, running minima within rtol 1e-5;
end-to-end labels after alignment >= 0.999 (f32) / >= 0.99 (bf16).
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import numpy as np


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def rand_index(pred: np.ndarray, gt: np.ndarray) -> float:
    """Rand index of two label maps from their contingency table (the
    formula of the reference's metrics/pri.py, which loads JAX)."""
    pred, gt = pred.reshape(-1).astype(np.int64), gt.reshape(-1).astype(np.int64)
    kg = int(gt.max()) + 1
    cont = np.bincount(pred * kg + gt, minlength=(int(pred.max()) + 1) * kg)
    cont = cont.reshape(-1, kg).astype(np.float64)

    def pairs(x):
        return float((x * (x - 1)).sum() / 2.0)

    total = pred.size * (pred.size - 1) / 2.0
    return (total + 2.0 * pairs(cont) - pairs(cont.sum(1)) - pairs(cont.sum(0))) / total


def main() -> None:
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, device {torch.cuda.get_device_name(0)}",
          flush=True)

    from gabor_color_image_segmentation_tpu.config import preset
    from gabor_color_image_segmentation_tpu.data import synthetic_mosaic
    from gabor_color_image_segmentation_tpu.utils.labels import align_labels
    from gabor_color_image_segmentation_tpu_torch import _kernels
    from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as kc
    from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf
    from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl
    from gabor_color_image_segmentation_tpu_torch.ops import features as ft
    from gabor_color_image_segmentation_tpu_torch.ops import fused
    from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank
    from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy

    t0 = time.perf_counter()
    _kernels.library()
    print(f"phase 2: built {_kernels.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    set_policy()
    dev = torch.device("cuda")
    kernels = {  # wrapper -> JSON entry
        "gabor_energies_fused": (fused.gabor_energies_fused,
                                 "gabor_energies.cu", "ops/fused_pallas.py:115"),
        "lloyd_chw_pass": (kc.lloyd_chw_pass, "lloyd_chw.cu", "models/kmeans_chw.py:130"),
        "kmeans_coarse_centers_xp": (kf.kmeans_coarse_centers_xp, "coarse_centers.cu",
                                     "models/kmeans_pallas.py:573"),
        "maximin_chw_pass": (kc.maximin_chw_pass, "maximin_chw.cu",
                             "models/kmeans_chw.py:341"),
    }
    record = {name: {} for name in kernels}

    def cuda_ms(fn, reps=5):
        fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def report(name, shape, abs_err, err, bound, ok, kern_fn, plain_fn, main_shape):
        """``err`` is measured in the bound's units; ``abs_err`` is the max
        absolute difference of the outputs, for the JSON line."""
        ms, plain_ms = cuda_ms(kern_fn), cuda_ms(plain_fn)
        print(f"phase 3: {name} [{shape}] max abs err {abs_err:.3e}, err {err:.3e} "
              f"(bound {bound}) kernel {ms:.3f} ms plain {plain_ms:.3f} ms ({card})",
              flush=True)
        check(ok, f"{name} [{shape}] disagrees with its plain version: {err} vs {bound}")
        if main_shape:
            record[name].update(max_abs_err=float(abs_err), ms=ms, plain_ms=plain_ms)

    def mosaics(n, h=321, w=481):
        """(rgb (n, h, w, 3) uint8, ground truth (n, h, w)): the bench's
        5-region mosaics, seeds 100, 101, ..."""
        pairs = [synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i) for i in range(n)]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    # ---- phase 3: kernels against their plain versions ---------------------
    def compare_features(cfg, rgb, dtype, tag, main_shape):
        dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        color = pl._color_transform(torch.from_numpy(rgb).to(dev), "lab")
        groups = bank_tensors(make_bank(cfg.bank), dev)
        e, tw = fused.gabor_energies_fused(color, groups, dt)
        pe, pt = fused.gabor_energies_fused_plain(color, groups, dt)
        torch.cuda.synchronize()
        peak = pe.float().abs().max().item()
        abs_err = max((e.float() - pe.float()).abs().max().item(),
                      (tw.float() - pt.float()).abs().max().item())
        rel = abs_err / peak
        bound = 1e-4 if dt == torch.float32 else 2e-2
        report("gabor_energies_fused", tag, abs_err, rel, f"{bound}*peak={bound * peak:.4g}",
               rel <= bound,
               lambda: fused.gabor_energies_fused(color, groups, dt),
               lambda: fused.gabor_energies_fused_plain(color, groups, dt), main_shape)
        del pe, pt
        xc4 = kc.build_color4(color, dt)
        pc0 = ft._pool2x2_cm(xc4)
        affine = kc._affine_params(e, xc4, cfg.cluster, 1e-6, pooled=(tw, pc0))
        return e, tw, xc4, pc0, affine, dt

    def compare_lloyd(xe, xc4, affine, centers, dt, tag, main_shape):
        a, b = affine
        u = centers - b[:, None, :]
        wc = (a[:, None, :] * u).to(dt).float()
        offs = u.square().sum(dim=2)
        lk, sk, ck = kc.lloyd_chw_pass(xe, xc4, wc, offs)
        lp, sp, cp = kc.lloyd_chw_pass_plain(xe, xc4, wc, offs)
        only = kc.lloyd_chw_pass(xe, xc4, wc, offs, assign_only=True)
        torch.cuda.synchronize()
        same = (lk == lp).float().mean().item()
        rtol = 1e-4 if dt == torch.float32 else 1e-3
        scale = sp.abs().max().item()
        err = (sk - sp).abs().max().item()
        ok = (same >= 0.9999 and err <= rtol * scale and torch.equal(only, lk))
        report("lloyd_chw_pass", f"{tag} labels equal {same:.6f}", err, err,
               f"{rtol}*{scale:.4g}", ok,
               lambda: kc.lloyd_chw_pass(xe, xc4, wc, offs),
               lambda: kc.lloyd_chw_pass_plain(xe, xc4, wc, offs), main_shape)

    def compare_maximin(xe, xc4, affine, tag, main_shape):
        a, _ = affine
        bsz, e, h, w = xe.shape
        a2 = a * a
        probe = torch.cat([xe.float().mean(dim=(2, 3)),
                           xc4[:, :3].float().mean(dim=(2, 3))], dim=1)
        dk = torch.zeros((bsz, h, w), device=dev)
        dp = torch.zeros((bsz, h, w), device=dev)
        abs_err, err, same = 0.0, 0.0, True
        for step in range(5):
            pk = kc.maximin_chw_pass(xe, xc4, a2, probe, dk, step < 2)
            pp = kc.maximin_chw_pass_plain(xe, xc4, a2, probe, dp, step < 2)
            torch.cuda.synchronize()
            same = same and torch.equal(pk, pp)
            abs_err = max(abs_err, (dk - dp).abs().max().item())
            err = max(err, ((dk - dp).abs() / dp.abs().clamp(min=1e-30)).max().item())
            probe = pk
        report("maximin_chw_pass", f"{tag} same pixels {same}", abs_err, err,
               "1e-5 (rel)",
               same and err <= 1e-5,
               lambda: kc.maximin_chw_pass(xe, xc4, a2, probe, dk, False),
               lambda: kc.maximin_chw_pass_plain(xe, xc4, a2, probe, dp, False),
               main_shape)

    cfg1 = preset("config1").replace(batch_size=16, dtype="bfloat16")
    rgb16, gt16 = mosaics(16)
    tag = "config1 16x321x481 bf16"
    e, tw, xc4, pc0, affine, dt = compare_features(cfg1, rgb16, "bfloat16", tag, True)
    pe2, pc2 = ft._pool2x2_cm(tw), ft._pool2x2_cm(pc0)
    d, m = e.shape[1] + 3, pe2.shape[2] * pe2.shape[3]
    xp = ft.assemble_xp_from_affine(pe2, pc2, affine[0], affine[1], dt)
    ck = kf.kmeans_coarse_centers_xp(xp, 5, d, m, cfg1.cluster.coarse_iters)
    cp = kf.kmeans_coarse_centers_xp_plain(xp, 5, d, m, cfg1.cluster.coarse_iters)
    torch.cuda.synchronize()
    err = (ck - cp).abs().max().item()
    report("kmeans_coarse_centers_xp", f"{tag} 4x4 grid {tuple(xp.shape)}", err, err,
           "2e-3 (rtol and atol)", torch.allclose(ck, cp, rtol=2e-3, atol=2e-3),
           lambda: kf.kmeans_coarse_centers_xp(xp, 5, d, m, cfg1.cluster.coarse_iters),
           lambda: kf.kmeans_coarse_centers_xp_plain(xp, 5, d, m,
                                                     cfg1.cluster.coarse_iters), True)
    compare_lloyd(e, xc4, affine, ck, dt, f"{tag} full resolution", True)
    compare_lloyd(tw, pc0, affine, ck, dt, f"{tag} 2x2 twin", False)
    del e, tw, xc4, pc0, xp

    cfg0 = preset("config0").replace(batch_size=1)
    rgb1, gt1 = mosaics(1)
    for dtype in ("float32", "bfloat16"):
        tag0 = f"config0 1x321x481 {'f32' if dtype == 'float32' else 'bf16'}"
        e, tw, xc4, pc0, affine, dt = compare_features(cfg0, rgb1, dtype, tag0, False)
        compare_maximin(e, xc4, affine, tag0, dtype == "float32")
        c0 = kc._maximin_init_chw(e, xc4, affine[0], affine[1], cfg0.cluster.k)
        compare_lloyd(e, xc4, affine, c0, dt, tag0, False)
    del e, tw, xc4, pc0

    # ---- phase 4: end to end ----------------------------------------------
    @contextlib.contextmanager
    def plain_kernels():
        """Route the pipeline through the plain versions (on the card)."""
        swaps = [(pl, "gabor_energies_fused", fused.gabor_energies_fused_plain),
                 (pl, "kmeans_coarse_centers_xp", kf.kmeans_coarse_centers_xp_plain),
                 (kc, "lloyd_chw_pass", kc.lloyd_chw_pass_plain),
                 (kc, "maximin_chw_pass", kc.maximin_chw_pass_plain)]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    runs = [(cfg1, rgb16, gt16, "config1 batch 16 bf16"),
            (cfg0, rgb1, gt1, "config0 batch 1 f32")]
    for wrapper, *_ in kernels.values():
        wrapper.launches = 0
    outputs = []
    for cfg, rgb, gt, label in runs:
        def run():
            x = torch.from_numpy(rgb).to(dev)
            labels, _ = pl.segment_batch(x, cfg, with_features=False)
            return labels.cpu()

        t0 = time.perf_counter()
        first = run()
        warm = time.perf_counter() - t0
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        mp = rgb.shape[0] * rgb.shape[1] * rgb.shape[2] / 1e6 / (ms / 1e3)
        check(torch.equal(out, first), f"{label}: labels differ between runs")
        outputs.append((cfg, rgb, gt, label, out))
        print(f"phase 4: {label}: {ms:.2f} ms/batch (median of 5, first call "
              f"{warm:.2f} s), {mp:.2f} MP/s, host uint8 in -> host int32 labels "
              f"out, {card}", flush=True)
    counts = {name: wrapper.launches for name, (wrapper, *_) in kernels.items()}
    print(f"phase 4: launches in the end-to-end runs {counts}", flush=True)
    for name, n in counts.items():
        check(n > 0, f"{name} was never launched on the main path")
    for cfg, rgb, gt, label, out in outputs:
        check(out.dtype == torch.int32 and tuple(out.shape) == rgb.shape[:3],
              f"{label}: labels {out.dtype} {tuple(out.shape)}")
        check(int(out.min()) >= 0 and int(out.max()) < cfg.cluster.k,
              f"{label}: labels outside [0, k)")
        with plain_kernels():
            ref, _ = pl.segment_batch(torch.from_numpy(rgb).to(dev), cfg)
        ref = ref.cpu().numpy()
        floor = 0.99 if cfg.dtype == "bfloat16" else 0.999
        agree = min(float((align_labels(out[i].numpy(), ref[i]) == ref[i]).mean())
                    for i in range(len(ref)))
        print(f"phase 4: {label}: kernel path vs all-plain path on the card, "
              f"min aligned agreement {agree:.6f} (floor {floor})", flush=True)
        check(agree >= floor, f"{label}: kernel path disagrees with the plain path")
        pri = [rand_index(out[i].numpy(), gt[i]) for i in range(len(gt))]
        print(f"phase 4: {label}: Rand index against the mosaics' ground truth, "
              f"mean {statistics.mean(pri):.4f}, min {min(pri):.4f} (a reading; "
              f"the gate is the agreement above)", flush=True)

    # ---- phase 5: where the time goes -------------------------------------
    from torch.profiler import ProfilerActivity, profile

    x = torch.from_numpy(rgb16).to(dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        pl.segment_batch(x, cfg1)
        torch.cuda.synchronize()
    print(f"phase 5: one config1 batch 16 bf16 call under torch.profiler ({card})")
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"gabor_color_image_segmentation_tpu_torch/csrc/{src}",
         "replaces": f"gabor_color_image_segmentation_tpu/{where}",
         "launches": counts[name], **record[name]}
        for name, (_, src, where) in kernels.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
