#!/usr/bin/env python3
"""Time K3 and K8 on one NVIDIA card at the main paths' shapes, by design
variant, against their plain versions, and print their compile statistics.

    python3 experiments/torch_k3_k8.py [--ptxas] [--profile]

K3 (``kmeans_coarse_centers_xp``) on config1's pooled buffer (16, 243,
9600) in bf16 and in float32, and at batch 1, with the cluster's CTAs per
image forced to 1, 2, 4, 8 and 16 (``coarse_plan`` picks 8 at batch 16 and
16 at batch 1); K8 (``em_pass``) at config2 (batch 8, bf16 and f32) on the
fit grid with moments, at full resolution with moments and labels only,
with the chunks a block walks forced to a few values beside ``em_plan``'s.
Each line: max error against the plain version, kernel ms (CUDA events: the
median of 5 calls, or for a call under 1 ms the median of 5 means over 50
back-to-back calls behind a sleep kernel), the plain version's ms, the
bound and the card's name and power limit. ``--ptxas`` compiles
csrc/coarse_centers.cu and csrc/em_pass.cu once with ``-Xptxas -v`` and
prints registers, shared memory and spills; ``--profile`` prints
torch.profiler's device time by kernel for one K3 call and one config2 EM
solve at bf16; ``--ties`` prints, for K3 in float32 on blobs that k-means
splits (5 clusters, 3 blobs: tests/test_torch_cuda.py's ``_buffer``), the
kernel's and the plain version's centres per image and the smallest
relative score gap of any pixel after each of the plain version's first
passes: a gap near float32's rounding is a tie that two dot orders break
differently.
"""

from __future__ import annotations

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
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as kc  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models.gmm import gmm_fit_levels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import features as ft  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops import fused  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy  # noqa: E402
from _turns import HBM_BYTES_PER_MS, bound, card_line, cuda_ms, ptxas  # noqa: E402



def timed(fn):
    single = cuda_ms(fn)
    return single if single >= 1.0 else cuda_ms(fn, inner=50, hold_ms=50 * single)


def mosaics(n):
    return np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=100 + i)[0]
                     for i in range(n)])


def config1_buffer(dev):
    """config1's pooled (16, 243, 9600) bf16 buffer, as the pipeline builds it."""
    cfg = preset("config1")
    color = pl._color_transform(torch.from_numpy(mosaics(16)).to(dev), "lab")
    groups = bank_tensors(make_bank(cfg.bank), dev)
    e, tw = fused.gabor_energies_fused(color, groups, torch.bfloat16)
    xc4 = kc.build_color4(color, torch.bfloat16)
    pc0 = ft._pool2x2_cm(xc4)
    affine = kc._affine_params(e, xc4, cfg.cluster, 1e-6, pooled=(tw, pc0))
    pe2, pc2 = ft._pool2x2_cm(tw), ft._pool2x2_cm(pc0)
    return ft.assemble_xp_from_affine(pe2, pc2, affine[0], affine[1], torch.bfloat16)


def config2_buffers(dev, dt):
    """config2's (x, fit) buffers (8 images) and K8's inputs from the GMM
    init's hard split, as the EM loop's first iteration takes them."""
    cfg = preset("config2")
    c2 = cfg.cluster
    color = pl._color_transform(torch.from_numpy(mosaics(cfg.batch_size)).to(dev), "lab")
    groups = bank_tensors(make_bank(cfg.bank), dev)
    e, _ = fused.gabor_energies_fused(color, groups, dt, pooled=False)
    c4 = kc.build_color4(color, torch.float32)
    a, b_aff = kc._affine_params(e, c4, c2, 1e-6)
    x = ft.assemble_xp_from_affine(e, c4, a, b_aff, dt)
    pe, pc = e, kc.build_color4(color, dt)
    for _ in range(gmm_fit_levels(321, 481, c2.gmm_fit_pool)[2]):
        pe, pc = ft._pool2x2_cm(pe), ft._pool2x2_cm(pc)
    fit = ft.assemble_xp_from_affine(pe, pc, a, b_aff, dt)
    labels, _ = kf.kmeans_fused_t_xt(fit, c2.k, 10)  # the pipeline's init iterations
    params = gf._moments_to_params(*gf._init_moments(fit, labels, c2.k), fit.shape[2],
                                   c2.gmm_reg_covar)
    return x, fit, gf._params_to_kernel_inputs(*params)


def ties(dev) -> None:
    rng = np.random.default_rng(1320 + 23 + 5)  # the card test's batch17_queued seed
    b, d, n, k = 17, 23, 1320, 5
    means = rng.normal(scale=2.0, size=(b, 3, d))
    lab = rng.integers(0, 3, size=(b, n))
    x = np.take_along_axis(means, lab[:, :, None], 1) + rng.normal(size=(b, n, d))
    xp = torch.from_numpy(np.swapaxes(x, 1, 2).astype(np.float32)).to(dev)
    x64 = xp.double()
    diff = (kf.kmeans_coarse_centers_xp(xp, k, d, n, 8)
            - kf.kmeans_coarse_centers_xp_plain(xp, k, d, n, 8)).abs().amax(dim=(1, 2))
    print(f"K3 ties: f32 (17, 23, 1320) k = 5 on 3 blobs, kernel vs plain per image "
          f"{[float(f'{v:.3g}') for v in diff.tolist()]}", flush=True)
    for it in range(1, 5):
        c = kf.kmeans_coarse_centers_xp_plain(xp, k, d, n, it).double()
        s = c.square().sum(2)[:, :, None] - 2 * torch.bmm(c, x64)
        mag = c.square().sum(2)[:, :, None] + 2 * torch.bmm(c.abs(), x64.abs())
        top = torch.topk(-s, 2, dim=1).values
        gap = ((top[:, 0] - top[:, 1]) / mag.amax(dim=1)).amin(dim=1)
        print(f"K3 ties: after {it} plain passes, smallest relative score gap per image "
              f"{[float(f'{v:.2g}') for v in gap.tolist()]}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs an NVIDIA card")
    card = card_line()
    print(card, flush=True)
    if "--ptxas" in sys.argv:
        ptxas(_kernels._CSRC, ["coarse_centers.cu", "em_pass.cu"], "change")
    _kernels.library()
    set_policy()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan_k3, plan_k8 = kf.coarse_plan, gf.em_plan
    if "--ties" in sys.argv:
        ties(dev)

    xp = config1_buffer(dev)
    iters, k = preset("config1").cluster.coarse_iters, 5
    b, d, m = xp.shape
    for name, xq in (("bf16", xp), ("f32", xp.float()), ("bf16 batch 1", xp[:1].contiguous())):
        ref = kf.kmeans_coarse_centers_xp_plain(xq, k, d, m, iters)
        plain_ms = timed(lambda: kf.kmeans_coarse_centers_xp_plain(xq, k, d, m, iters))
        nbytes = xq.numel() * xq.element_size()
        b_ms, b_by = bound(nbytes, xq.shape[0] * m * (k * 3 * d + iters * (2 * k * d + d)))
        floor = (k + 1 + iters) * nbytes / HBM_BYTES_PER_MS
        chosen = plan_k3(xq.shape[0], m, kf._active_clusters(
            d, _kernels.storage_code(xq.dtype), torch.cuda.current_device()))
        print(f"K3 config1 {name}: clusters of {kf.COARSE_CLUSTERS} CTAs held at once "
              f"{kf._active_clusters(d, _kernels.storage_code(xq.dtype), torch.cuda.current_device())}",
              flush=True)
        for ctas in kf.COARSE_CLUSTERS:
            kf.coarse_plan = lambda *_, c=ctas: c
            out = kf.kmeans_coarse_centers_xp(xq, k, d, m, iters)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            ms = timed(lambda: kf.kmeans_coarse_centers_xp(xq, k, d, m, iters))
            print(f"K3 config1 {name} {tuple(xq.shape)} CTAs/image {ctas}"
                  f"{' (plan)' if ctas == chosen else ''}: err {err:.3e}, {ms:.4f} ms, "
                  f"plain {plain_ms:.4f}, bound {b_ms:.4f} ({b_by}), design floor "
                  f"{floor:.4f} ({card})", flush=True)
        kf.coarse_plan = plan_k3
    if "--profile" in sys.argv:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            kf.kmeans_coarse_centers_xp(xp, k, d, m, iters)
            torch.cuda.synchronize()
        print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=6),
              flush=True)
    del xp
    torch.cuda.empty_cache()

    for dt in (torch.bfloat16, torch.float32):
        x, fit, inputs = config2_buffers(dev, dt)
        bsz, d, _ = x.shape
        kk = inputs[1].shape[1]
        for buf, where, moments in ((fit, "fit grid", True), (x, "full resolution", True),
                                    (x, "full resolution labels only", False)):
            n = buf.shape[2]
            ref = gf.em_pass_plain(buf, *inputs, moments=moments)
            plain_ms = timed(lambda: gf.em_pass_plain(buf, *inputs, moments=moments))
            flops = bsz * n * (kk * d * (d + 1) + (kk * (d + 1) * (d + 2) if moments else 0))
            b_ms, b_by = bound(bsz * n * (d * buf.element_size() + 4), flops)
            chosen, nblk = plan_k8(bsz, n, n_sm)
            for chunks in sorted({1, 2, 4, chosen, 2 * chosen}):
                gf.em_plan = lambda b_, n_, s_, c=chunks: (c, -(-(-(-n_ // 640)) // c))
                out = gf.em_pass(buf, *inputs, moments=moments)
                torch.cuda.synchronize()
                got, want = (out, ref) if moments else ((out,), (ref,))
                same = (got[0] == want[0]).float().mean().item()
                err = max([0.0] + [(g - r).abs().max().item() for g, r in zip(got[1:], want[1:])])
                ms = timed(lambda: gf.em_pass(buf, *inputs, moments=moments))
                nb = -(-(-(-n // 640)) // chunks)
                print(f"K8 config2 {'bf16' if dt == torch.bfloat16 else 'f32'} {where} "
                      f"{tuple(buf.shape)} chunks/block {chunks}{' (plan)' if chunks == chosen else ''}"
                      f" ({bsz * nb} blocks): labels equal {same:.6f}, max abs err {err:.3e}, "
                      f"{ms:.4f} ms, plain {plain_ms:.4f}, bound {b_ms:.4f} ({b_by}), "
                      f"{flops / ms / 1e9:.2f} TFLOP/s ({card})", flush=True)
            gf.em_plan = plan_k8
        if "--profile" in sys.argv and dt == torch.bfloat16:
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                c2 = preset("config2").cluster
                gf.gmm_fused_t_xt(x, kk, c2.n_iter, c2.gmm_reg_covar, 10, c2.gmm_tol, fit, 1)
                torch.cuda.synchronize()
            print(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=10),
                  flush=True)
        del x, fit, inputs
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
