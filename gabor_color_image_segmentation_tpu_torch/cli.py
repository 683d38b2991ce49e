"""gaborseg-torch CLI, the port's counterpart of the JAX package's cli.py:
run / eval / bench / info.

    gaborseg-torch run  --preset config0 --image img.jpg --out seg.png
    gaborseg-torch eval --preset config3 --split test --out results.jsonl --resume
    gaborseg-torch bench --preset config1 --iters 50
    gaborseg-torch info --preset config1

``--device`` (default ``cuda``) picks where ``run``, ``eval`` and ``bench`` segment;
``--device cpu`` runs the plain PyTorch versions on the CPU. The kernels'
build is cached by source hash in the package's ``_build/``, so the CLI
sets up no compilation cache of its own.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import tempfile

import numpy as np


def _add_preset_args(p):
    p.add_argument("--preset", default="config0")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--k", type=int, default=None, help="cluster count override")
    p.add_argument("--method", choices=["kmeans", "gmm"], default=None)
    p.add_argument("--cut", choices=["ncut", "mincut"], default=None)
    p.add_argument("--color-space", choices=["lab", "rgb"], default=None)
    p.add_argument(
        "--feature-impl", choices=["auto", "direct", "modulated", "pallas"], default=None
    )
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None)
    p.add_argument(
        "--cue-weight", choices=["static", "coherence"], default=None,
        help="feature cue weighting; 'coherence' with --coherence-pow 2 is "
        "the measured recommendation for texture-dominated imagery "
        "(BASELINE.md round-4 ablation)",
    )
    p.add_argument("--coherence-pow", type=float, default=None)
    p.add_argument("--feature-set", choices=["full", "color", "texture"], default=None)
    p.add_argument(
        "--device", default="cuda",
        help="where to segment: cuda (the default) or cpu (the plain PyTorch versions)",
    )


def _build_cfg(args):
    from gabor_color_image_segmentation_tpu_torch.config import preset

    cfg = preset(args.preset)
    if args.batch:
        cfg = cfg.replace(batch_size=args.batch)
    if args.k:
        cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, k=args.k))
    if args.method:
        cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, method=args.method))
    if args.cut:
        cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, enabled=True, cut=args.cut))
    if args.color_space:
        cfg = cfg.replace(color_space=args.color_space)
    if args.feature_impl:
        cfg = cfg.replace(feature_impl=args.feature_impl)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.cue_weight:
        cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, cue_weight=args.cue_weight))
    if args.coherence_pow is not None:
        cfg = cfg.replace(
            cluster=dataclasses.replace(cfg.cluster, coherence_pow=args.coherence_pow))
    if args.feature_set:
        cfg = cfg.replace(cluster=dataclasses.replace(cfg.cluster, feature_set=args.feature_set))
    return cfg


def cmd_run(args):
    from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_images

    cfg = _build_cfg(args)
    if args.image:
        import cv2

        bgr = cv2.imread(args.image, cv2.IMREAD_COLOR)
        if bgr is None:
            sys.exit(f"cannot read image: {args.image}")
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
    else:
        from gabor_color_image_segmentation_tpu_torch.data.synthetic import synthetic_mosaic

        rgb, _ = synthetic_mosaic(h=321, w=481, n_regions=5, seed=args.seed)
    labels = segment_images(rgb[None], cfg, device=args.device)[0].cpu().numpy()
    print(
        json.dumps(
            {
                "shape": list(labels.shape),
                "n_regions": int(len(np.unique(labels))),
                "preset": args.preset,
            }
        )
    )
    if args.out:
        from gabor_color_image_segmentation_tpu_torch.utils.visualize import save_label_map

        save_label_map(labels, args.out, rgb=rgb)
        print(f"wrote {args.out}", file=sys.stderr)


def cmd_eval(args):
    from gabor_color_image_segmentation_tpu_torch.eval import (
        evaluate,
        evaluate_sweep,
        load_split,
    )

    cfg = _build_cfg(args)
    data = load_split(args.split, limit=args.limit)
    if args.sweep_k:
        ks = [int(k) for k in args.sweep_k.split(",")]
        out = args.out or os.path.join(tempfile.gettempdir(), "gaborseg_torch_sweep")
        summary = evaluate_sweep(data, cfg, ks, out_path=out, device=args.device)
    else:
        summary = evaluate(
            data,
            cfg,
            out_path=args.out,
            resume=args.resume,
            profile_dir=args.profile,
            debug_nans=args.debug_nans,
            device=args.device,
        )
    print(json.dumps(summary))


def cmd_bench(args):
    from gabor_color_image_segmentation_tpu_torch.benchmark import run_benchmark
    from gabor_color_image_segmentation_tpu_torch.config import preset

    if args.measure_cpu:
        sys.exit("gaborseg-torch bench --measure-cpu: the port imports no golden/ module, "
                 "so it cannot time the CPU golden path; vs_baseline divides by the JAX "
                 "package's stored CPU_BASELINE_MP_S (`gaborseg bench --measure-cpu` "
                 "measures it)")
    cfg = _build_cfg(args)  # every preset-override flag (--k, --method, ...)
    if not args.dtype:
        cfg = cfg.replace(dtype="bfloat16")  # the bench's default is production mode
    # an unmodified preset -> run_benchmark divides by the stored CPU baseline
    stock = cfg == preset(args.preset).replace(dtype=cfg.dtype, batch_size=cfg.batch_size)
    print(
        json.dumps(
            run_benchmark(
                preset_name=args.preset,
                batch_size=cfg.batch_size,
                iters=args.iters,
                dtype=cfg.dtype,
                subsample=args.subsample,
                cfg=None if stock else cfg,
                device=args.device,
            )
        )
    )


def cmd_info(args):
    from gabor_color_image_segmentation_tpu_torch.config import PRESETS
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

    cfg = _build_cfg(args)
    bank = make_bank(cfg.bank)
    print(
        json.dumps(
            {
                "preset": cfg.name,
                "presets": sorted(PRESETS),
                "n_kernels": bank.n_kernels,
                "groups": [
                    {
                        "sigma": g.sigma,
                        "ksize": g.ksize,
                        "n_kernels": len(g.kernel_indices),
                        "smooth_sigma": g.smooth_sigma,
                    }
                    for g in bank.groups
                ],
                "max_halo": cfg.bank.max_halo,
                "feature_dim": 3 * bank.n_kernels + 3,
                "config": dataclasses.asdict(cfg),
            },
            indent=2,
        )
    )


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gaborseg-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="segment one image")
    _add_preset_args(p_run)
    p_run.add_argument("--image", default=None, help="input image (else synthetic)")
    p_run.add_argument("--out", default=None, help="output overlay png")
    p_run.add_argument("--seed", type=int, default=0)
    p_run.set_defaults(fn=cmd_run)

    p_eval = sub.add_parser("eval", help="evaluate a split")
    _add_preset_args(p_eval)
    p_eval.add_argument("--split", default="test")
    p_eval.add_argument("--limit", type=int, default=None)
    p_eval.add_argument("--out", default=None, help="per-image jsonl path")
    p_eval.add_argument("--resume", action="store_true")
    p_eval.add_argument("--profile", default=None,
                        help="directory for a torch.profiler Chrome trace of the loop")
    p_eval.add_argument("--debug-nans", action="store_true",
                        help="check every operation's and kernel's floating-point "
                        "outputs for NaN, as the JAX package's jax_debug_nans: the first "
                        "one raises FloatingPointError naming it (slow: each check waits "
                        "for the device)")
    p_eval.add_argument(
        "--sweep-k",
        default=None,
        help="comma list of region/cluster counts; reports ODS/OIS-style "
        "best-k aggregation (BSDS operating-point protocol analog)",
    )
    p_eval.set_defaults(fn=cmd_eval)

    p_bench = sub.add_parser("bench", help="end-to-end throughput (device-resident MP/s)")
    _add_preset_args(p_bench)
    p_bench.add_argument("--iters", type=int, default=50)
    p_bench.add_argument("--subsample", type=int, default=1)
    p_bench.add_argument("--measure-cpu", action="store_true",
                         help="not carried: the port cannot time the golden path (exits 1)")
    p_bench.set_defaults(fn=cmd_bench)

    p_info = sub.add_parser("info", help="describe a preset / bank")
    _add_preset_args(p_info)
    p_info.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
