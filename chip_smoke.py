#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, one line each, stopping with a non-zero exit at the first failure:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the Hopper kernels from ``csrc/`` with nvcc (one process per
   source, all started together);
3. each kernel against its plain PyTorch version on the card, at the main
   paths' shapes, with the error against its stated bound and the time of
   each (CUDA events: the median of 5 single calls, or, for a call whose
   single launch reads under 1 ms, the median of 5 means over 50
   back-to-back calls, the single-launch reading printed beside it):
   K1-K4 at config1 (batch 16 of 321x481, bf16) and config0 (batch 1, f32
   and bf16), K2 launched twice (labels and sums bit-equal), its labels-only
   pass timed too, both beside its bytes bound with its plan (CTAs an
   image, tiles, stages, bytes in flight), K3 also on config1's buffer in
   float32 and at batch 1, each K3 call launched twice (bit-equal) and
   beside its design floor (k + 1 + iters reads of its buffer); K2 past
   the rows a whole tile stages (its rows staged in blocks) on a 1x321x481
   frame of blobs with E = 2,688 (bf16) and 1,400 (f32) energy rows, with
   its plan; K7 (one pass, launched twice: bit-equal, beside its bound and
   its plan, and the whole ``kmeans_fused``, whose run with the counts set
   to 0 just before it and read just after is K7's path) on config1's
   standardised features laid out (16, 154401, 243) in bf16 (the pass in
   f32 too), and one pass past 512 rows at (2, 20000, 1000), k = 8, in
   bf16 and f32; K1
   (no twin), K5 (launched twice: bit-equal; one device kernel in a
   profile of one call, with its CTAs an image), K6 (the same checks, its
   time beside its bytes bound and one empty launch; and five steps on a
   (2, 12024, 9600) buffer), K8 (the fit grid and
   full resolution, with moments and labels only, each launched twice:
   bit-equal), K9 and K10 (on the first EM pass's moments and on
   well-conditioned ones; K10 launched twice: bit-equal, its P^T bit-equal
   to K9's on the plain chain's C, so its C is the plain chain's) at
   config2 (batch 8, f32 and bf16); K9 also at
   d = 39, 64, 65 and 128 on EM-shaped and well-conditioned matrices (d =
   129 raises, as the reference's), K8 at D = 51 and 123 on fit-grid
   buffers in both dtypes with moments and labels only, and K10 at d = 123
   on a D = 123 pass's moments;
   K1 at config3 (bf16, no twin) and at any radius: config0's bank widened
   to conv radius 16 and to smoothing radius 25, and a bank of radii 32
   and 50 (batch 2, both dtypes), each K1 line with its achieved TFLOP/s
   beside its bound; K11 (SLIC: labels equal to ``slic_plain`` on every
   pixel and two launches bit-equal at config3, at batch 1 and on a frame
   of one grid row; one pass with partials and one update bit-equal to
   their plain versions, each timed beside its bound; and ``slic_batch`` on a frame whose band plan
   misses a band's candidate rows, 8x1288x481 with config3's S = 900, with
   the counts set to 0 just before it and read just after: K11 launched
   once, no K12 or K13, labels equal to ``slic_plain``'s), K14 (connectivity,
   on K11's output, on a
   fragmented random map, on the spiral maze with its kept block in a
   corner and on a map with no surviving component, each with the union-
   find rounds, adoption steps, largest adoption distance and absorbed
   share the pass meets) and K15 (table lookup, with ``torch.gather`` as
   the library call; and with a table of 50,000 entries) at config3
   (batch 8); K13
   (the banded SLIC loop, two loops bit-equal) at config4's pooled grid
   (batch 8 of 540x960, S = 405), one pass (labels and partials) and one
   update bit-equal to their plain versions, timed with a labels-only pass
   beside the pass's bound, with K11 there and one pass by column-piece
   width as readings, and K14 and K15 on K13's output there (config4's
   min_size, a (8, 405) table, K14 also on the spiral maze); K12 (the
   one-launch w5 SLIC, a thread-block cluster an image, its plan on a line
   of its own) at 8x321x481 with 400 superpixels, K13's loop bit-equal to
   it, with K11 and K13 there as readings, and at the extremes of the
   range ``slic_route(h, w, S, "w5")`` admits (8x1052x16 and 8x1422x16 with
   S = 12,000, 8x1422x127 with S = 10), bit-equal to the plain banded loop
   and to K13's, two calls bit-equal; K12's path, ``slic_batch(...,
   plan="w5")`` with the counts set to 0 just before it and read just
   after, one K12 launch and no other SLIC kernel; K16-K18
   (superpixel sums and counts, with one ``index_add_`` as the library
   call) on the graph stage's own features and connected superpixels at
   config3 (S = 925) and config4's pooled grid (S = 405), and on config3's
   features with S = 8,192 (a raster block map and uniform random labels
   in [-1, S]), bf16 and f32, each launched twice, with the kernel's chunk
   ranges; tiled K1 at config4 (batch 8 of 2160x3840, pool 2) against
   untiled K1 plus pooling (a reading of the tiling's cost) and against
   the plain tiled path on batch 1; the modulated route's energies (plain
   torch, the reference's graph route in float32) at config3 and config4
   f32 beside K1's route in bf16, as readings;
4. ``segment_batch(uint8 -> int32 labels, with_features=False)`` end to end
   at config1 batch 16 bf16 and, with a 160-kernel bank (E = 480 energy
   rows: the warm start's blocked route, K6 and K5, and no K3), batch 2
   bf16 and f32, config0 batch 1 f32, config2 batch 8 bf16
   and f32 (with ``gmm_fused._FUSED_PREP`` off, the default, and on; and
   with a 16-kernel bank, D = 51 feature rows),
   config3 batch 8 bf16 and f32 and config4 batch 8 of 2160x3840
   bf16 and f32, and one config3 min-cut call of ``segment_images`` (batch
   2): ms/batch and MP/s from host uint8 in to host int32 labels out;
   each path runs with the launch counts set to 0 just before it and read
   just after, and every kernel of the path must have launched (config4:
   K13's passes and its updates, and not K11; config2 with the switch on:
   K10 and not K9; the graph stage in bf16 K1 and not the modulated route,
   in f32 the modulated route and not K1); agreement with the all-plain
   path on the card (for the graph stage, with both paths handed the same
   energies, see GRAPH_NOTE; for config2 with the switch on, with the
   switch off);
   the Rand index against the mosaics' ground truth (the port's
   ``metrics.pri.rand_index_np``; a reading, not a gate); for config4's
   cells, as readings, the affinity the graph stage builds from the
   pipeline's own features and superpixels: live superpixels per image,
   the median of d2, s2, whether W is 0 between every two live
   superpixels and the live ids whose W_ii is 1; config2's bf16
   labels against its f32 labels, image by image (a reading: the
   reference's own bf16-vs-f32 measure of a stable image); the eight 4K mosaics (bench seeds 100-107) are made on the host
   in worker processes while the kernels build, outside any timed window;
5. where the time goes: ``torch.profiler`` tables of one config1 call,
   one config2 bf16 call with ``_FUSED_PREP`` off and one with it on, one
   config3 call in each dtype and one config4 bf16 call (the full tables go
   to ``out_dir``);
6. the evaluation surface: ``eval.evaluate`` on the card over
   ``load_split("test", limit=8)`` (eight synthetic 321x481 mosaics with
   three ground truths each) at config1 bf16 (one batch of 8; K1, K3, K2
   launched) and config0 f32 (batch 1; K1, K4, K2 launched), no image
   failed, every row's metrics equal to the host metrics of
   ``segment_images``' labels for the same batches (recomputed in worker
   processes), the tensor metrics on the card (Rand index, VoI, covering,
   dilated boundary F) against the host ones on those labels; mean PRI,
   boundary F and the loop's MP/s as readings; then the CLI's ``info
   --preset config1`` and ``run --preset config0 --device cuda``, their
   JSON checked;
7. the with-features path, ``segment_batch(uint8 -> (int32 labels,
   (B, H, W, D) features))`` with the reference's default
   ``with_features=True``: config1 batch 16 bf16 at full width (D = 243;
   K1, then ``kmeans_batch``'s transposed multigrid solver, K6 and K5) and
   config2 batch 8 bf16 (``gmm_fused_t``: K6, K5, K9, K8), each against
   the all-plain path on the card (labels after alignment, the features by
   the reference's measure, max |d| / max |ref| <= 2e-2, K1's bf16 bound),
   with its labels-only path's labels as a reading, ms/batch (median of 5)
   and launches a call; config0 on one 2160x3840 frame in f32 with
   ``tile_hw`` (432, 768) (K1 on 25 windows, ``kmeans_fused_t`` at N =
   8,294,400, D = 39) against the all-plain path; K5 and K6 each against
   its plain version on a (1, 243, 8,294,400) bf16 buffer (D * N = 2.02e9
   elements, the largest the route hands them); config3 batch 8 bf16 with
   ``cue_weight="coherence"`` (the gate hands both paths K1's energies, as
   phase 4's); config4 at its published geometry, batch 2 of 2160x3840
   bf16 (K1 on 25 windows a frame, K13, K14, K17, K15), its labels
   bit-equal to its labels-only path's and its pooled (2, 540, 960, 39)
   features within 2e-2 of the peak of the all-plain path's (the gates;
   the labels against the all-plain path and its ms/batch readings);
   config1 with k = 10 (the plain solver on the card, its ms/batch a
   reading);
8. ``parallel/`` on meshes whose shards all sit on ``cuda:0`` (one process
   drives the shards in lockstep): the data-parallel leg
   ``segment_batch_sharded`` at config1 batch 16 bf16 and config3 batch 8
   bf16 over 8 batch shards, with and without features, labels (and
   features) bit-equal to ``segment_batch`` run shard by shard, no
   collective, agreement with the whole-batch call a reading;
   ``segment_tiled`` with the real config1 bank on one 320x480 frame over 8
   space shards (the modulated route, K5 each shard's Lloyd pass, 20 passes
   a shard), aligned agreement with the untiled ``segment_image`` >= 0.999;
   ``segment_tiled_batch`` at config4 as published, 2 frames of 2160x3840
   on a (2, 4) batch x space mesh (K17 and K15 on each shard), its labels
   against the untiled config4 path, the sharded connectivity bit-equal to
   K14 on the same sharded SLIC labels, K5, K17 and K15 each against its
   plain version on one strip; collectives by kind, the fixpoint loops'
   host syncs and ms a call printed as readings;
9. the reference's entry points on the kernels: ``graph.graph_segment_batch``
   (the graph stage the pipeline calls) on the features and Lab of phase
   4's config3 batch 8 bf16 cell (K11, K14, K17, K15) and config4's pooled
   8x540x960 grid (K13's passes and updates, K14, K17, K15), its labels
   bit-equal to phase 4's and phase 4's bit-equal to the stage composed by
   hand (``_graph_front``, ``ncut_regions``, K15, the unpooling), with its
   launches; ``ncut_segment`` on image 0 bit-equal to
   ``graph_segment_batch`` on the batch of one; ``slic`` on one 321x481
   frame bit-equal to ``slic_batch`` on the batch of 8 (one K11 launch);
   ``enforce_connectivity_device`` bit-equal to K14 and its plain version;
   ``slic_batch(impl="fused")`` bit-equal to "auto" on config3's frame and
   raising on a frame the reference's ``slic_fused_eligible`` refuses;
   ``kmeans_fused_chw(coarse_iters=15, refine_iters=1)`` on config1's
   16x321x481 energies (K4 and K2 on the twin, K2 at full resolution) in
   bf16 (K1's twin handed in) and f32 (pooled inside) against its plain
   version (aligned agreement >= 0.99 bf16, >= 0.999 f32), launches and ms
   a call; ``evaluate(debug_nans=True)`` over ``load_split("test",
   limit=2)`` at config1 bf16 (K1, K3, K2) and config3 bf16 (K1, K11, K14,
   K17, K15): no FloatingPointError, rows equal to the mode off's, both
   times;
10. the benchmark core (``benchmark.py``): ``run_benchmark`` for each
   preset at its published batch in bf16, labels only (config0-config3
   five iterations, config4 two), device-resident MP/s and ``vs_baseline``
   (the JAX package's CPU golden table) printed beside the card's name and
   power limit; gated: the four keys, a finite positive value equal to the
   timed loop's MP/s, each preset's kernels launched inside the timed loop
   (the counts set to 0 just before ``benchmark._timed_loop`` and read just
   after; added to the totals), the modulated route not run, and the timed
   loop's label checksum equal to the untimed loop's over the same
   iterations; then ``cli bench --preset config1 --iters 5`` on the card
   prints one JSON line with the four keys;
11. a JSON line of the kernels (time, plain time, bound, library call), then
   the last line ``{"ok": true, "device": {...}}``.

Tolerances (also in the tests): energies <= 1e-4 * peak (f32), <= 2e-2 *
peak (bf16); Lloyd labels equal on >= 99.99 % of pixels, sums within rtol
1e-4 (f32) / 1e-3 (bf16), two K2 launches bit-equal; coarse centres within rtol and atol 2e-3 and
two K3 launches bit-equal;
two K5 launches bit-equal; maximin picks the same pixels, running minima within rtol 1e-5 (K4) or
within 1e-5 of the largest distance (K6, whose expanded form cancels near
the probe; two K6 launches bit-equal); K2 past the rows a whole tile
stages on blobs: labels and counts equal, sums within rtol 1e-4; EM labels
equal on >= 99.99 %, and, held with the plain version against the plain
version in float64, the log-likelihood within max(rtol 1e-5, twice the
plain version's error) and the moments within max(1e-6 of each
component's summed magnitude, twice the plain version's error), two K8
launches bit-equal;
SLIC labels equal on every pixel (K11 against ``slic_plain``, K12 and K13
against their plain banded loop, K13's loop against K12, two calls of
each; K11's and K13's passes and updates bit-equal); connectivity and
lookup bit-equal; precision Cholesky within 5e-4 relative of cuSOLVER on well-conditioned
matrices, and on the EM's ill-conditioned covariances, where two float32
inverses differ entry by entry by up to cond * eps, a backward error
||L L^T - C||_F / ||C||_F <= 2e-5 (L the float64 inverse of P^T) and
|diag * P^T_ii - 1| <= 1e-6, a gate the run checks rejects a P^T perturbed
by 1e-5 or zeroed; K10 the same on its P^T, two launches bit-equal, its P^T
bit-equal to K9's on the plain chain's C, and against float64 on its own
P^T: bias within 1e-5 of sum |P^T_ij mu_j|, const within 1e-5 of the sum
of its terms' magnitudes (entry by entry within 5e-4, 2e-4 and 1e-4 of the
plain version on well-conditioned moments); K7's pass labels equal on
>= 99.99 % (past 512 rows on every pixel, counts equal), sums within rtol
1e-3 of their largest value, two launches bit-equal, the whole
``kmeans_fused`` >= 0.99 of each image's labels equal to the solver on the
plain pass; K16-K18 every value equal to the plain version in bf16 (float64
sums of bf16 values are exact), within one ulp in f32, counts equal, and two
launches bit-equal; end-to-end labels
after alignment >= 0.999 (f32) / >= 0.99 (bf16); with features, the
features within max |d| <= 2e-2 (bf16) / 1e-4 (f32) of the largest
|feature|, K5 and K6 on the 2.02e9-element buffer as in phase 3; the card's Rand index,
VoI and covering within 1e-12 of the host metrics, its dilated boundary F
equal to the host form's.

Bounds (``bound_ms``): the larger of the bytes the function must move (each
input read once, each output written once) over 3.35 TB/s and its
operations over 67 TFLOP/s (float32 on the CUDA cores, an FMA counted as
two), both computed from this run's shapes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

HBM_BYTES_PER_MS = 3.35e9  # H100 SXM HBM3, 3.35 TB/s
F32_FLOP_PER_MS = 67e9  # H100 SXM float32 outside the tensor cores, 67 TFLOP/s
# A call whose single launch reads under SHORT_MS ms is timed as the mean
# over INNER back-to-back calls between one pair of events (median of 5
# pairs): a lone launch between two events times the launch latency too.
# A sleep kernel (CYCLES_PER_MS cycles a ms, the H100's 1.98 GHz boost
# clock rounded up) holds the card while the host queues the calls.
SHORT_MS = 1.0
INNER = 50
CYCLES_PER_MS = 2.0e6
# K9's gates on the EM's covariances. P^T must be the exact precision factor
# of a covariance within 2e-5 of C, normwise (a backward-stable float32
# factorisation gives about d * eps = 2.3e-6 at d = 39), and diag must be
# 1 / P^T's diagonal within 1e-6 (a few float32 roundings).
CHOL_BACKWARD_TOL = 2e-5
CHOL_DIAG_TOL = 1e-6
# Why config3's all-plain agreement is a reading: the n-cut's discrete steps
# (the eigenvectors at a cut with gaps of ~1e-4, k-means on the embedding)
# turn the ulp-level differences between K1 and its plain version (2e-5 of
# the bf16 energies, the f32 ones in their last bits) into whole superpixels
# changing region; experiments/torch_graph_stages.py measures it. At
# config4 the cut is not determined at all, in the reference as in the port
# (experiments/torch_published_stages.py config4): connectivity keeps a few
# of its 405 superpixels, so the median of d2 over all 405^2 entries is 0,
# s2 is clamped to 1e-12, W is 0 between every two live superpixels and 1
# on the diagonal only where d2_ii rounds to exactly 0, and L_sym is a
# diagonal of 0s and 1s whose null space is larger than the 5 regions.
# K1 is held at config3's and config4's shapes in phase 3, and the gate
# hands both paths the same energies.
GRAPH_NOTE = ", a reading for the graph stage: the gate is the next line"
# K11's time at config3 before its tiled redesign (a thread a pixel, a block
# a superpixel's window; H100 80GB HBM3 at 700 W, this script's reading),
# printed beside its time now
K11_BEFORE_MS = 1.4560


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def host_metrics(labels: np.ndarray, gts: list) -> dict:
    """The port's host metrics of one label map against its ground truths,
    as eval.evaluate's rows name them (run in worker processes in phase 6)."""
    from gabor_color_image_segmentation_tpu_torch.metrics.boundary import fboundary_np
    from gabor_color_image_segmentation_tpu_torch.metrics.pri import pri_np
    from gabor_color_image_segmentation_tpu_torch.metrics.region import (
        mean_covering_np,
        mean_voi_np,
    )

    p, r, f = fboundary_np(labels, gts)
    return {"pri": pri_np(labels, gts), "precision": p, "recall": r, "f_boundary": f,
            "voi": mean_voi_np(labels, gts), "covering": mean_covering_np(labels, gts)}


def bound(nbytes: float, flops: float):
    """(least time in ms, what bounds it) for moving ``nbytes`` and doing
    ``flops`` float32 operations on one H100."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, flops / F32_FLOP_PER_MS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    from gabor_color_image_segmentation_tpu_torch import _kernels
    from gabor_color_image_segmentation_tpu_torch.config import BankConfig, preset
    from gabor_color_image_segmentation_tpu_torch.data import (
        connectivity_maze,
        synthetic_mosaic,
    )
    from gabor_color_image_segmentation_tpu_torch.metrics.pri import rand_index_np
    from gabor_color_image_segmentation_tpu_torch.models import chol
    from gabor_color_image_segmentation_tpu_torch.models import connectivity as cn
    from gabor_color_image_segmentation_tpu_torch.models import gmm_fused as gf
    from gabor_color_image_segmentation_tpu_torch.models import graph as gr
    from gabor_color_image_segmentation_tpu_torch.models import graph_fused as gm
    from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as kc
    from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf
    from gabor_color_image_segmentation_tpu_torch.models import pipeline as pl
    from gabor_color_image_segmentation_tpu_torch.models import slic as sl
    from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf
    from gabor_color_image_segmentation_tpu_torch.models.gmm import gmm_fit_levels
    from gabor_color_image_segmentation_tpu_torch.ops import features as ft
    from gabor_color_image_segmentation_tpu_torch.config import GraphConfig
    from gabor_color_image_segmentation_tpu_torch.ops import fused, lookup, modulated, tiled
    from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank
    from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy

    # config4's eight 4K mosaics take seconds each on the host: made in
    # worker processes while the kernels build and the earlier phases run
    cfg4 = preset("config4")  # batch 8 of 2160x3840
    workers = ProcessPoolExecutor(max_workers=cfg4.batch_size,
                                  mp_context=multiprocessing.get_context("spawn"))
    pending4 = [workers.submit(synthetic_mosaic, *cfg4.image_hw, 5, 100 + i)
                for i in range(cfg4.batch_size)]

    t0 = time.perf_counter()
    _kernels.library()
    print(f"phase 2: built {_kernels.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    set_policy()
    dev = torch.device("cuda")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "chiprun_out")
    kernels = {  # wrapper -> (wrapper, source, TPU kernel it replaces)
        "gabor_energies_fused": (fused.gabor_energies_fused,
                                 "gabor_energies.cu", "ops/fused_pallas.py:115"),
        "lloyd_chw_pass": (kc.lloyd_chw_pass, "lloyd_chw.cu", "models/kmeans_chw.py:130"),
        "kmeans_coarse_centers_xp": (kf.kmeans_coarse_centers_xp, "coarse_centers.cu",
                                     "models/kmeans_pallas.py:573"),
        "maximin_chw_pass": (kc.maximin_chw_pass, "maximin_chw.cu",
                             "models/kmeans_chw.py:341"),
        "lloyd_t_pass": (kf.lloyd_t_pass, "lloyd_t.cu", "models/kmeans_pallas.py:171"),
        "maximin_t_pass": (kf.maximin_t_pass, "maximin_t.cu",
                           "models/kmeans_pallas.py:304"),
        "lloyd_pass": (kf.lloyd_pass, "lloyd_rows.cu", "models/kmeans_pallas.py:68"),
        "em_pass": (gf.em_pass, "em_pass.cu", "models/gmm_pallas.py:90"),
        "precision_chol": (chol.precision_chol, "precision_chol.cu",
                           "models/chol_pallas.py:112"),
        "precision_chol_params": (chol.precision_chol_params, "precision_chol.cu",
                                  "models/chol_pallas.py:118"),
        "slic_w3": (sf.slic_w3, "slic.cu", "models/slic_pallas.py:351"),
        "slic_band_pass": (sf.slic_band_pass, "slic_banded.cu", "models/slic_pallas.py:241"),
        "slic_w5": (sf.slic_w5, "slic_banded.cu", "models/slic_pallas.py:265"),
        "enforce_connectivity_fused": (cn.enforce_connectivity_fused, "connectivity.cu",
                                       "models/connectivity_pallas.py:168"),
        "table_lookup": (lookup.table_lookup, "lookup.cu", "ops/lookup.py:24"),
        "superpixel_moments_fused": (gm.superpixel_moments_fused, "superpixel_moments.cu",
                                     "models/graph_pallas.py:52"),
        "superpixel_moments_fused_t": (gm.superpixel_moments_fused_t,
                                       "superpixel_moments.cu", "models/graph_pallas.py:143"),
        "superpixel_moments_fused_nhwc": (gm.superpixel_moments_fused_nhwc,
                                          "superpixel_moments.cu",
                                          "models/graph_pallas.py:221"),
    }
    record = {name: {"library_ms": None} for name in kernels}
    # every launch counter: the kernels', and K13's update launch, which
    # belongs to K13's line of the JSON
    counters = {name: wrapper for name, (wrapper, *_) in kernels.items()}
    counters["slic_band_update"] = sf.slic_band_update

    def cuda_ms(fn, reps=5, inner=1, hold_ms=0.0):
        """Median over ``reps`` pairs of CUDA events of the mean time of
        ``inner`` back-to-back calls of ``fn``, after one warm-up call. With
        ``hold_ms`` a sleep kernel of that length is queued before each
        pair, so the host has queued the calls before the card reaches them
        and its time per call does not enter the reading."""
        fn()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            if hold_ms:
                torch.cuda._sleep(int(hold_ms * CYCLES_PER_MS))
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    def timed(fn):
        """(ms, the single-launch reading): a call whose single launch
        reads under SHORT_MS is timed again as the mean over INNER
        back-to-back calls, where one pair of events no longer times the
        launch's latency with it."""
        single = cuda_ms(fn)
        if single >= SHORT_MS:
            return single, single
        return cuda_ms(fn, inner=INNER, hold_ms=INNER * single), single

    def kernels_in_one_call(fn):
        """Names of the device kernels one call of ``fn`` launches, from a
        torch.profiler trace of the call. A trace with no device activity
        at all (CUPTI dropped one such trace of K5's call in a run whose
        trace of K6's call, just before, was whole) says nothing of the
        call: it is taken again, at most three times in all."""
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            names = [ev.name for ev in prof.events() if ev.device_type == DeviceType.CUDA]
            if names:
                break
        return names

    def timing_note(single):
        return (f"mean of {INNER} back-to-back calls, median of 5" if single < SHORT_MS
                else "median of 5 single calls")

    def report(name, shape, abs_err, err, bound_txt, ok, kern_fn, plain_fn, main=None):
        """``err`` is measured in the bound's units; ``abs_err`` is the max
        absolute difference of the outputs, for the JSON line. ``main`` =
        (bytes, flops) of the call when this is the shape the JSON line
        reports."""
        (ms, single), (plain_ms, _) = timed(kern_fn), timed(plain_fn)
        print(f"phase 3: {name} [{shape}] max abs err {abs_err:.3e}, err {err:.3e} "
              f"(bound {bound_txt}) kernel {ms:.4f} ms (single launch {single:.4f}; "
              f"{timing_note(single)}) plain {plain_ms:.4f} ms ({card})", flush=True)
        check(ok, f"{name} [{shape}] disagrees with its plain version: {err} vs {bound_txt}")
        if main is not None:
            b_ms, b_by = bound(*main)
            record[name].update(max_abs_err=float(abs_err), ms=ms, plain_ms=plain_ms,
                                bound_ms=b_ms, bound_by=b_by, timing=timing_note(single),
                                ms_single_launch=single)
        return ms

    def chol_errors(covs, pt, diag):
        """Per matrix of a precision Cholesky: (backward error
        ||L L^T - C||_F / ||C||_F, with L the float64 inverse of P^T;
        diag error max_i |diag_i * P^T_ii - 1|). NaN where P^T is
        singular."""
        c64, x = covs.double(), pt.double()
        eye = torch.eye(c64.shape[-1], dtype=torch.float64, device=dev).expand_as(c64)
        lt = torch.linalg.solve_triangular(x, eye, upper=False)
        back = (torch.linalg.matrix_norm(lt @ lt.transpose(1, 2) - c64)
                / torch.linalg.matrix_norm(c64))
        dg = (diag.double() * torch.diagonal(x, dim1=1, dim2=2) - 1).abs().amax(dim=1)
        return back, dg

    def chol_ok(covs, pt, diag):
        back, dg = chol_errors(covs, pt, diag)
        return bool(torch.isfinite(back).all() and back.max() <= CHOL_BACKWARD_TOL
                    and dg.max() <= CHOL_DIAG_TOL
                    and torch.count_nonzero(torch.triu(pt, 1)) == 0)

    def check_params(moments, m, reg, what, tag, main):
        """K10 on one EM pass's moments against its plain chain: P^T by its
        backward error against the float32 covariance the plain chain forms
        (the kernel forms the same bits), a zero upper triangle, and bias
        and const against float64 evaluated on the kernel's own P^T,
        bounded by the magnitudes they sum; against the float64 chain as a
        reading (cond * eps)."""
        bsz, k, d = moments[1].shape
        nmat = bsz * k
        pk10, bk10, ck10 = chol.precision_chol_params(*moments, m, reg)
        pp10, bp10, cp10 = chol.precision_chol_params_plain(*moments, m, reg)
        again10 = chol.precision_chol_params(*moments, m, reg)
        _, mu32, cov32 = gf._moments_to_params(*moments, m, reg)
        covs10 = cov32.reshape(nmat, d, d)
        pt9 = chol.precision_chol(covs10)[0]
        torch.cuda.synchronize()
        # K10 shares K9's factorisation, so its P^T equals K9's on the plain
        # chain's C bit for bit exactly when it forms that C bit for bit
        bits10 = all(torch.equal(g, a) for g, a in zip((pk10, bk10, ck10), again10))
        c_bits = torch.equal(pk10.reshape(nmat, d, d), pt9)
        print(f"phase 3: precision_chol_params [{what}] two launches bit-equal {bits10}, "
              f"P^T bit-equal to precision_chol's on the plain chain's C (its C bit-equal) "
              f"{c_bits}", flush=True)
        check(bits10 and c_bits, f"precision_chol_params [{what}] is not bit-stable or does not "
              "form the plain chain's C")
        pt10 = pk10.reshape(nmat, d, d)
        back10, _ = chol_errors(covs10, pt10, 1.0 / torch.diagonal(pt10, dim1=1, dim2=2))
        p64, mu64 = pk10.double(), mu32.double()
        b_err = ((bk10.double() - (p64 @ mu64[..., None])[..., 0]).abs()
                 / (p64.abs() @ mu64.abs()[..., None])[..., 0].clamp(min=1e-30)).max().item()
        logw = torch.log((moments[0].double() + 10.0 * torch.finfo(torch.float32).eps) / m)
        logp = torch.log(torch.diagonal(p64, dim1=2, dim2=3))
        c_ref = logw + logp.sum(dim=2) - 0.5 * d * 1.8378770664093453
        c_mag = logw.abs() + logp.abs().sum(dim=2) + 0.5 * d * 1.8378770664093453
        c_err = ((ck10.double() - c_ref).abs() / c_mag).max().item()
        m64 = [t.double() for t in moments]
        w64, mu_64, cov64 = gf._moments_to_params(*m64, m, reg)
        l64 = torch.linalg.cholesky(cov64)
        pt64 = torch.linalg.solve_triangular(
            l64, torch.eye(d, dtype=torch.float64, device=dev).expand_as(cov64), upper=False)
        bias64 = (pt64 @ mu_64[..., None])[..., 0]
        const64 = (torch.log(w64) - torch.log(torch.diagonal(l64, dim1=2, dim2=3)).sum(dim=2)
                   - 0.5 * d * 1.8378770664093453)

        def vs64(b_, c_):
            return ((b_.double() - bias64).abs().max().item(),
                    (c_.double() - const64).abs().max().item())

        (bk64, ck64), (bp64, cp64) = vs64(bk10, ck10), vs64(bp10, cp10)
        print(f"phase 3: precision_chol_params [{what}] backward "
              f"error {back10.max().item():.3e} (bound {CHOL_BACKWARD_TOL:g}); on its own "
              f"P^T in float64: bias {b_err:.3e} (bound 1e-5), const {c_err:.3e} (bound "
              f"1e-5); against the float64 chain (a reading, cond * eps): bias max abs "
              f"kernel {bk64:.3e}, plain {bp64:.3e}; const kernel {ck64:.3e}, plain "
              f"{cp64:.3e}", flush=True)
        ok10 = bool(torch.isfinite(back10).all() and back10.max() <= CHOL_BACKWARD_TOL
                    and torch.count_nonzero(torch.triu(pk10, 1)) == 0
                    and b_err <= 1e-5 and c_err <= 1e-5)
        report("precision_chol_params", f"{tag} d={d}",
               max((a - r).abs().max().item() for a, r in ((pk10, pp10), (bk10, bp10),
                                                           (ck10, cp10))),
               back10.max().item(), f"backward error {CHOL_BACKWARD_TOL:g}; bias and const "
               "1e-5 of their magnitudes; upper triangle zero", ok10,
               lambda: chol.precision_chol_params(*moments, m, reg),
               lambda: chol.precision_chol_params_plain(*moments, m, reg),
               (nmat * 2 * (d * d + d + 1) * 4, nmat * (d ** 3 + 3 * d * d))
               if main else None)

    def check_em(buf, inputs, tag, moments, main):
        """K8 against its plain version on ``buf`` (B, D, N): labels equal on
        >= 99.99 % of pixels, two launches bit-equal, and with moments the
        log-likelihood and moments held, with the plain version's, against
        the plain version in float64."""
        bsz, d, npx = buf.shape
        k = inputs[1].shape[1]
        dt = buf.dtype
        got = gf.em_pass(buf, *inputs, moments=moments)
        ref = gf.em_pass_plain(buf, *inputs, moments=moments)
        again = gf.em_pass(buf, *inputs, moments=moments)
        torch.cuda.synchronize()
        if not moments:
            got, ref, again = (got,), (ref,), (again,)
        same = (got[0] == ref[0]).float().mean().item()
        bits = all(torch.equal(g, a) for g, a in zip(got, again))
        ok, abs_err, err, tol = same >= 0.9999 and bits, 0.0, 0.0, 1e-4
        if moments:
            # Long float32 reductions (154,401 pixels at full resolution)
            # in two orders: both are held against the plain version in
            # float64. Rounding grows with the summed magnitudes, not
            # with the sums (normalised features cancel), so each
            # component's error is scaled by max(count, max_a sum r
            # x_a^2), which bounds sum |terms| of every one of its
            # entries.
            r64 = gf.em_pass_plain(buf, *(t.double() for t in inputs))
            scale = torch.maximum(r64[2], torch.diagonal(r64[4], dim1=2, dim2=3)
                                  .amax(dim=2))

            def err64(out):
                """(ll relative error, moments error) against float64."""
                e_ll = ((out[1].double() - r64[1]).abs() / r64[1].abs()).max().item()
                e_m = 0.0
                for g, r in zip(out[2:], r64[2:]):
                    diff = (g.double() - r).abs().reshape(bsz, k, -1).amax(dim=2)
                    e_m = max(e_m, (diff / scale).max().item())
                return e_ll, e_m

            (ll_k, err), (ll_p, err_p) = err64(got), err64(ref)
            tol = max(1e-6, 2.0 * err_p)
            ok = ok and ll_k <= max(1e-5, 2.0 * ll_p)
            abs_err = max((g - r).abs().max().item() for g, r in zip(got[2:], ref[2:]))
            print(f"phase 3: em_pass [{tag}] against float64: ll rel kernel "
                  f"{ll_k:.3e}, plain {ll_p:.3e}; moments (of the summed magnitude) "
                  f"kernel {err:.3e}, plain {err_p:.3e}", flush=True)
        flops = bsz * npx * (k * d * (d + 1) + (k * (d + 1) * (d + 2) if moments else 0))
        report("em_pass", f"{tag} {tuple(buf.shape)} labels equal {same:.6f}, "
               f"two launches bit-equal {bits}",
               abs_err, err, f"labels 0.9999; vs float64, ll within max(1e-5, 2 x "
               f"plain's), moments within max(1e-6, 2 x plain's) = {tol:.3e}",
               ok and err <= tol,
               lambda: gf.em_pass(buf, *inputs, moments=moments),
               lambda: gf.em_pass_plain(buf, *inputs, moments=moments),
               (bsz * npx * (d * size(dt) + 4), flops) if main else None)

    def mosaics(n, h=321, w=481):
        """(rgb (n, h, w, 3) uint8, ground truth (n, h, w)): the bench's
        5-region mosaics, seeds 100, 101, ..."""
        pairs = [synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i) for i in range(n)]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def size(dt):
        return torch.empty((), dtype=dt).element_size()

    # ---- phase 3: kernels against their plain versions ---------------------
    def compare_features(cfg, rgb, dt, tag, main_shape, pooled=True, bank_cfg=None):
        color = pl._color_transform(torch.from_numpy(rgb).to(dev), "lab")
        groups = bank_tensors(make_bank(bank_cfg or cfg.bank), dev)
        e, tw = fused.gabor_energies_fused(color, groups, dt, pooled=pooled)
        pe, pt = fused.gabor_energies_fused_plain(color, groups, dt, pooled=pooled)
        torch.cuda.synchronize()
        peak = pe.float().abs().max().item()
        abs_err = (e.float() - pe.float()).abs().max().item()
        if pooled:
            abs_err = max(abs_err, (tw.float() - pt.float()).abs().max().item())
        rel = abs_err / peak
        tol = 1e-4 if dt == torch.float32 else 2e-2
        b, h, w, c = color.shape
        # tap-loop FMAs of the separable modulated blur (rows over the conv
        # halo's width, then columns; real and imaginary parts) and of the
        # separable smoothing, per plane; with the twin, its pooled
        # smoothing (2r + 2 taps, down the rows over the halo's width, then
        # across)
        flops = sum(2 * b * g.n * c * (2 * (2 * g.p + 1) * (h * (w + 2 * g.p) + h * w)
                                       + 2 * (2 * g.r + 1) * h * w
                                       + (2 * (g.r + 1) * (h // 2) * (w + 2 * g.r + w // 2)
                                          if pooled else 0))
                    for g in groups)
        nbytes = color.numel() * 4 + e.numel() * size(dt) + (tw.numel() * size(dt)
                                                            if pooled else 0)
        ms = report("gabor_energies_fused", tag, abs_err, rel, f"{tol}*peak={tol * peak:.4g}",
                    rel <= tol,
                    lambda: fused.gabor_energies_fused(color, groups, dt, pooled=pooled),
                    lambda: fused.gabor_energies_fused_plain(color, groups, dt, pooled=pooled),
                    (nbytes, flops) if main_shape else None)
        b_ms, b_by = bound(nbytes, flops)
        print(f"phase 3: gabor_energies_fused [{tag}] radii (conv, smoothing) "
              f"{[(g.p, g.r) for g in groups]}: {flops / ms / 1e9:.2f} TFLOP/s achieved "
              f"({flops / 1e9:.1f} GFLOP), bound {b_ms:.4f} ms ({b_by}), "
              f"{100 * b_ms / ms:.1f} % of it ({card})", flush=True)
        del pe, pt
        return color, e, tw

    def chw_inputs(cfg, color, e, tw, dt):
        xc4 = kc.build_color4(color, dt)
        pc0 = ft._pool2x2_cm(xc4)
        affine = kc._affine_params(e, xc4, cfg.cluster, 1e-6, pooled=(tw, pc0))
        return xc4, pc0, affine

    def compare_lloyd(xe, xc4, affine, centers, dt, tag, main_shape, exact=False):
        """K2 with sums against its plain version (labels >= 0.9999 equal,
        sums within rtol of the plain sums' largest magnitude; ``exact``:
        labels and counts equal, sums within rtol 1e-4), labels only equal
        to the full pass's labels, two launches bit-equal; then the
        labels-only pass timed, each beside the bound, and K2's plan."""
        a, b = affine
        u = centers - b[:, None, :]
        wc = (a[:, None, :] * u).to(dt).float()
        offs = u.square().sum(dim=2)
        lk, sk, ck = kc.lloyd_chw_pass(xe, xc4, wc, offs)
        again = kc.lloyd_chw_pass(xe, xc4, wc, offs)
        lp, sp, cp = kc.lloyd_chw_pass_plain(xe, xc4, wc, offs)
        only = kc.lloyd_chw_pass(xe, xc4, wc, offs, assign_only=True)
        torch.cuda.synchronize()
        same = (lk == lp).float().mean().item()
        bits = all(torch.equal(x, y) for x, y in zip((lk, sk, ck), again))
        rtol = 1e-4 if dt == torch.float32 or exact else 1e-3
        scale = sp.abs().max().item()
        err = (sk - sp).abs().max().item()
        ok = (same >= 0.9999 and err <= rtol * scale and torch.equal(only, lk) and bits
              and (not exact or (torch.equal(lk, lp) and torch.equal(ck, cp))))
        bsz, e = xe.shape[:2]
        npix = xe.shape[2] * xe.shape[3]
        k, d = wc.shape[1], e + 3
        main = (bsz * npix * (d * size(dt) + 4), bsz * npix * (2 * k * d + d))
        ms = report("lloyd_chw_pass", f"{tag} labels equal {same:.6f}, two launches "
                    f"bit-equal {bits}", err, err, f"{rtol}*{scale:.4g}", ok,
                    lambda: kc.lloyd_chw_pass(xe, xc4, wc, offs),
                    lambda: kc.lloyd_chw_pass_plain(xe, xc4, wc, offs),
                    main if main_shape else None)
        ms_only = timed(lambda: kc.lloyd_chw_pass(xe, xc4, wc, offs, assign_only=True))[0]
        p, stages, ctas, tpc, rb = kc.lloyd_plan(bsz, npix, d, size(dt), n_sm)
        smem = kc._lloyd_smem(d, p, stages, size(dt), rb)
        fly = max(1, stages - 1) * rb * (p * size(dt) + 16)  # one CTA an SM
        b_ms = bound(*main)[0]
        print(f"phase 3: lloyd_chw_pass [{tag}] bound {b_ms:.4f} ms (bytes): with sums "
              f"{ms:.4f} ms, {100 * b_ms / ms:.1f} % of it; labels only {ms_only:.4f} ms, "
              f"{100 * b_ms / ms_only:.1f} % of it; plan {ctas} CTAs an image x {tpc} tiles of "
              f"{p} pixels, {stages} stages, rows staged "
              f"{'whole' if rb == d else f'in blocks of {rb}'}, {smem / 1024:.1f} KB a CTA "
              f"(one an SM), {fly / 1024:.0f} KB in flight an SM ({card})", flush=True)

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
        d = e + 3
        main = (bsz * h * w * (d * xe.element_size() + 8), bsz * h * w * 4 * d)
        report("maximin_chw_pass", f"{tag} same pixels {same}", abs_err, err,
               "1e-5 (rel)", same and err <= 1e-5,
               lambda: kc.maximin_chw_pass(xe, xc4, a2, probe, dk, False),
               lambda: kc.maximin_chw_pass_plain(xe, xc4, a2, probe, dp, False),
               main if main_shape else None)

    cfg1 = preset("config1").replace(batch_size=16, dtype="bfloat16")
    rgb16, gt16 = mosaics(16)
    tag = "config1 16x321x481 bf16"
    color, e, tw = compare_features(cfg1, rgb16, torch.bfloat16, tag, True)
    xc4, pc0, affine = chw_inputs(cfg1, color, e, tw, torch.bfloat16)
    pe2, pc2 = ft._pool2x2_cm(tw), ft._pool2x2_cm(pc0)
    d, m = e.shape[1] + 3, pe2.shape[2] * pe2.shape[3]
    xp = ft.assemble_xp_from_affine(pe2, pc2, affine[0], affine[1], torch.bfloat16)
    iters = cfg1.cluster.coarse_iters
    nb = xp.shape[0]

    def compare_coarse(xq, where, main=False):
        """K3 against its plain version (rtol and atol 2e-3) and against
        itself (two launches bit-equal); prints the design's floor, the
        k + 1 + iters reads of the buffer from device memory."""
        ck = kf.kmeans_coarse_centers_xp(xq, 5, d, m, iters)
        cp = kf.kmeans_coarse_centers_xp_plain(xq, 5, d, m, iters)
        again = kf.kmeans_coarse_centers_xp(xq, 5, d, m, iters)
        torch.cuda.synchronize()
        err = (ck - cp).abs().max().item()
        same = torch.equal(ck, again)
        b_q = xq.shape[0]
        active = kf._active_clusters(d, _kernels.storage_code(xq.dtype),
                                     torch.cuda.current_device())
        ctas = kf.coarse_plan(b_q, m, active)
        floor = (5 + 1 + iters) * xq.numel() * xq.element_size() / HBM_BYTES_PER_MS
        ms = report("kmeans_coarse_centers_xp",
                    f"{where} 4x4 grid {tuple(xq.shape)}, {ctas} CTAs an image (clusters of "
                    f"{kf.COARSE_CLUSTERS} held at once: {active}), two launches "
                    f"bit-equal {same}", err, err, "2e-3 (rtol and atol)",
                    same and torch.allclose(ck, cp, rtol=2e-3, atol=2e-3),
                    lambda: kf.kmeans_coarse_centers_xp(xq, 5, d, m, iters),
                    lambda: kf.kmeans_coarse_centers_xp_plain(xq, 5, d, m, iters),
                    (xq.numel() * xq.element_size(),
                     b_q * m * (5 * 3 * d + iters * (2 * 5 * d + d))) if main else None)
        print(f"phase 3: kmeans_coarse_centers_xp [{where}] design floor {floor:.4f} ms "
              f"({5 + 1 + iters} reads of {xq.numel() * xq.element_size() / 1e6:.2f} MB at "
              f"3.35 TB/s), {100 * floor / ms:.1f} % of it ({card})", flush=True)
        return ck

    ck = compare_coarse(xp, tag, main=True)
    compare_coarse(xp.float(), "config1 16x321x481 f32 buffer (config1's features in float32)")
    compare_coarse(xp[:1].contiguous(), "config1 batch 1 bf16")
    compare_lloyd(e, xc4, affine, ck, torch.bfloat16, f"{tag} full resolution", True)
    compare_lloyd(tw, pc0, affine, ck, torch.bfloat16, f"{tag} 2x2 twin", False)

    # K2 past the rows a whole tile stages (fault 10): one 321x481 frame of
    # E = 2,688 (bf16) and 1,400 (f32) energy rows, k = 5 blobs ~4 noise
    # radii apart with the blob means as centres (the affine a = 1, b = 0),
    # its tiles staged in blocks of rows
    for e_b, dt in ((2688, torch.bfloat16), (1400, torch.float32)):
        gen = torch.Generator(device=dev).manual_seed(e_b)
        d_b, n_b = e_b + 3, 321 * 481
        means = 4.0 * torch.randn((1, 5, d_b), generator=gen, device=dev)
        member = torch.randint(0, 5, (1, n_b), generator=gen, device=dev)
        xb = torch.gather(means, 1, member[:, :, None].expand(-1, -1, d_b))
        xb = (xb + torch.randn(xb.shape, generator=gen, device=dev)).transpose(1, 2)
        xb = xb.reshape(1, d_b, 321, 481)
        xe_b = xb[:, :e_b].to(dt).contiguous()
        xc_b = torch.cat([xb[:, e_b:], torch.ones((1, 1, 321, 481), device=dev)], dim=1).to(dt)
        del xb
        compare_lloyd(xe_b, xc_b, (torch.ones((1, d_b), device=dev),
                                   torch.zeros((1, d_b), device=dev)), means, dt,
                      f"1x321x481 E={e_b} {'bf16' if dt == torch.bfloat16 else 'f32'} blobs, "
                      "k=5, past the rows a whole tile stages", False, exact=True)
        del xe_b, xc_b

    # K7 on config1's standardised features laid out row-major, in bf16 (the
    # JSON line's shape) and f32: one pass from K3's centres against its
    # plain version, two launches bit-equal, beside its bound and its plan;
    # then the whole kmeans_fused in bf16 (K7's path)
    rows = ft.assemble_xp_from_affine(e, xc4, affine[0], affine[1], torch.bfloat16)
    rows = rows.transpose(1, 2).contiguous()  # (16, 154401, 243) bf16
    del color, e, tw, xc4, pc0, xp

    def compare_rows(xr, cr, k, tag, main_shape, exact):
        """K7 against its plain version (``exact``: labels and counts equal,
        else >= 0.9999 of the labels and the counts off by at most twice the
        labels that differ; sums within 1e-3 of their largest value), two
        launches bit-equal, beside its bound and its plan."""
        lk, sk, nk = kf.lloyd_pass(xr, cr, k)
        again = kf.lloyd_pass(xr, cr, k)
        lp, sp, np_ = kf.lloyd_pass_plain(xr, cr, k)
        torch.cuda.synchronize()
        ndiff = int((lk != lp).sum())
        scale = sp.abs().max().item()
        err = (sk - sp).abs().max().item()
        bits = all(torch.equal(u, v) for u, v in zip((lk, sk, nk), again))
        ok = bits and err <= 1e-3 * scale and (
            (ndiff == 0 and torch.equal(nk, np_)) if exact else
            (ndiff <= 1e-4 * lk.numel() and (nk - np_).abs().sum().item() <= 2 * ndiff))
        bsz, n, d = xr.shape
        main = (xr.numel() * xr.element_size() + bsz * n * 4, bsz * n * (2 * k * d + d))
        ms = report("lloyd_pass", f"{tag}, {ndiff} labels differ, two launches bit-equal "
                    f"{bits}", err, err,
                    f"labels {'equal' if exact else '0.9999'}, sums 1e-3*{scale:.4g}", ok,
                    lambda: kf.lloyd_pass(xr, cr, k), lambda: kf.lloyd_pass_plain(xr, cr, k),
                    main if main_shape else None)
        ctas, tpc, p, stages, vb = kf.lloyd_rows_plan(bsz, n, d, xr.element_size(), n_sm)
        b_ms, b_by = bound(*main)
        print(f"phase 3: lloyd_pass [{tag}] {ms:.4f} ms against its bound {b_ms:.4f} ms "
              f"({b_by}), {100 * b_ms / ms:.1f} % of it; plan {ctas} CTAs an image x {tpc} "
              f"tiles of {p} pixels, {stages} stages, values staged "
              f"{'whole' if vb == d else f'in blocks of {vb}'}, "
              f"{kf._rows_smem(d, p, stages, xr.element_size(), vb) / 1024:.1f} KB a CTA "
              f"({card})", flush=True)

    tag7 = f"config1 standardised features {tuple(rows.shape)} bf16, k=5"
    compare_rows(rows, ck, 5, f"{tag7}, one pass from K3's centres", True, False)
    rows32 = rows.float()
    compare_rows(rows32, ck, 5, f"config1 standardised features {tuple(rows.shape)} f32, k=5, "
                 "one pass from K3's centres", False, False)
    del rows32
    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l7, _ = kf.kmeans_fused(rows, 5, 25, torch.bfloat16)
    torch.cuda.synchronize()
    t7 = (time.perf_counter() - t0) * 1e3
    k7_launches = kf.lloyd_pass.launches
    check(k7_launches > 0, "lloyd_pass was never launched on the kmeans_fused path")
    saved_pass = kf.lloyd_pass
    kf.lloyd_pass = kf.lloyd_pass_plain
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r7, _ = kf.kmeans_fused(rows, 5, 25, torch.bfloat16)
        torch.cuda.synchronize()
        t7p = (time.perf_counter() - t0) * 1e3
    finally:
        kf.lloyd_pass = saved_pass
    same7 = (l7 == r7).float().mean(dim=1).min().item()
    print(f"phase 3: kmeans_fused [{tag7}, n_iter 25] K7's path (counts set to 0 before it, "
          f"read after): {k7_launches} lloyd_pass launches, {t7:.2f} ms host to host; "
          f"through the plain pass {t7p:.2f} ms; labels equal per image min {same7:.6f} "
          f"(floor 0.99) ({card})", flush=True)
    check(same7 >= 0.99, "kmeans_fused through K7 disagrees with its plain pass")
    del rows, l7, r7

    # K7 past 512 feature rows: k = 8 blobs ~4 noise radii apart in 1,000
    # rows, the centres their means moved by 0.1 noise
    gen = torch.Generator(device=dev).manual_seed(7)
    means = 4.0 * torch.randn((2, 8, 1000), generator=gen, device=dev)
    member = torch.randint(0, 8, (2, 20000), generator=gen, device=dev)
    wide = (torch.gather(means, 1, member[:, :, None].expand(-1, -1, 1000))
            + torch.randn((2, 20000, 1000), generator=gen, device=dev))
    cw = means + 0.1 * torch.randn(means.shape, generator=gen, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        compare_rows(wide.to(dt), cw, 8, f"(2, 20000, 1000) "
                     f"{'bf16' if dt == torch.bfloat16 else 'f32'}, k=8, past 512 rows", False,
                     True)
    del wide

    cfg0 = preset("config0").replace(batch_size=1)
    rgb1, gt1 = mosaics(1)
    for dt in (torch.float32, torch.bfloat16):
        tag0 = f"config0 1x321x481 {'f32' if dt == torch.float32 else 'bf16'}"
        color, e, tw = compare_features(cfg0, rgb1, dt, tag0, False)
        xc4, pc0, affine = chw_inputs(cfg0, color, e, tw, dt)
        compare_maximin(e, xc4, affine, tag0, dt == torch.float32)
        c0 = kc._maximin_init_chw(e, xc4, affine[0], affine[1], cfg0.cluster.k)
        compare_lloyd(e, xc4, affine, c0, dt, tag0, False)
    del color, e, tw, xc4, pc0

    cfg2 = preset("config2")  # batch 8
    c2 = cfg2.cluster
    rgb8, gt8 = mosaics(cfg2.batch_size)
    for dt in (torch.bfloat16, torch.float32):
        main2 = dt == torch.bfloat16  # the production dtype is the JSON line's
        tag2 = f"config2 8x321x481 {'bf16' if main2 else 'f32'}"
        color, e, _ = compare_features(cfg2, rgb8, dt, f"{tag2} no twin", False,
                                       pooled=False)
        c4 = kc.build_color4(color, torch.float32)
        a, b_aff = kc._affine_params(e, c4, c2, 1e-6)
        x = ft.assemble_xp_from_affine(e, c4, a, b_aff, dt)
        _, _, lv = gmm_fit_levels(321, 481, c2.gmm_fit_pool)
        pe, pc = e, kc.build_color4(color, dt)
        for _ in range(lv):
            pe, pc = ft._pool2x2_cm(pe), ft._pool2x2_cm(pc)
        fit = ft.assemble_xp_from_affine(pe, pc, a, b_aff, dt)
        del color, c4, e, pe, pc
        bsz, d, m = fit.shape
        n = x.shape[2]
        k = c2.k
        gtag = f"{tag2} fit grid {tuple(fit.shape)}"

        # K6: five maximin steps from the mean, as the GMM init seeds
        probe = fit.float().sum(dim=2) / m
        dk = torch.zeros((bsz, m), device=dev)
        dp = torch.zeros((bsz, m), device=dev)
        abs_err, err, same, seeds = 0.0, 0.0, True, []
        for step in range(k):
            pk = kf.maximin_t_pass(fit, probe, dk, step < 2)
            pp = kf.maximin_t_pass_plain(fit, probe, dp, step < 2)
            torch.cuda.synchronize()
            same = same and torch.equal(pk, pp)
            diff = (dk - dp).abs().max().item()
            abs_err = max(abs_err, diff)
            # the expanded form cancels near the probe (distance ~ 0), so
            # the error is taken against the largest distance
            err = max(err, diff / dp.abs().max().item())
            probe = pk
            seeds.append(pk)
        # two launches from the same running minima, bit-equal; one device
        # kernel a call (counted in a profile of one call)
        d_a, d_b = dk.clone(), dk.clone()
        p_a = kf.maximin_t_pass(fit, probe, d_a, False)
        p_b = kf.maximin_t_pass(fit, probe, d_b, False)
        torch.cuda.synchronize()
        bits6 = torch.equal(p_a, p_b) and torch.equal(d_a, d_b)
        k6_kernels = kernels_in_one_call(lambda: kf.maximin_t_pass(fit, probe, d_a, False))
        ms6 = report("maximin_t_pass", f"{gtag} same pixels {same}", abs_err, err,
                     "1e-5 (of the largest distance)",
                     same and err <= 1e-5 and bits6,
                     lambda: kf.maximin_t_pass(fit, probe, dk, False),
                     lambda: kf.maximin_t_pass_plain(fit, probe, dp, False),
                     (bsz * m * (d * size(dt) + 8), bsz * m * 4 * d) if main2 else None)
        b6, _ = bound(bsz * m * (d * size(dt) + 8), bsz * m * 4 * d)
        empty_ms = timed(lambda: torch.cuda._sleep(0))[0]
        print(f"phase 3: maximin_t_pass [{gtag}] {kf.maximin_t_plan(bsz, m, n_sm)} CTAs an "
              f"image; device kernels in one call {len(k6_kernels)} ({k6_kernels}); two "
              f"launches bit-equal {bits6}; {ms6:.4f} ms against its bytes bound {b6:.4f} and "
              f"one empty launch {empty_ms:.4f} (torch.cuda._sleep(0), timed alike) ({card})",
              flush=True)
        check(len(k6_kernels) == 1, f"maximin_t_pass ran {len(k6_kernels)} kernels in one call")

        # K6 past the 10,240 rows it once held in shared memory: five steps
        # on a (2, 12024, 9600) normal buffer against the plain version
        xw = torch.randn((2, 12024, m), generator=torch.Generator(device=dev).manual_seed(12),
                         device=dev).to(dt)
        pw_k = pw_p = xw.float().mean(dim=2)
        dwk, dwp = torch.zeros((2, m), device=dev), torch.zeros((2, m), device=dev)
        same_w, err_w = True, 0.0
        for step in range(k):
            pw_k = kf.maximin_t_pass(xw, pw_k, dwk, step < 2)
            pw_p = kf.maximin_t_pass_plain(xw, pw_p, dwp, step < 2)
            torch.cuda.synchronize()
            same_w = same_w and torch.equal(pw_k, pw_p)
            err_w = max(err_w, (dwk - dwp).abs().max().item() / dwp.abs().max().item())
        ms_w = report("maximin_t_pass", f"(2, 12024, {m}) {'bf16' if main2 else 'f32'}, same pixels "
                      f"{same_w}", err_w, err_w, "1e-5 (of the largest distance)",
                      same_w and err_w <= 1e-5,
                      lambda: kf.maximin_t_pass(xw, pw_k, dwk, False),
                      lambda: kf.maximin_t_pass_plain(xw, pw_p, dwp, False))
        bw, _ = bound(2 * m * (12024 * size(dt) + 8), 2 * m * 4 * 12024)
        print(f"phase 3: maximin_t_pass [(2, 12024, {m})] {ms_w:.4f} ms against its bytes "
              f"bound {bw:.4f} ({card})", flush=True)
        del xw, dwk, dwp

        # K5: a Lloyd pass from those seeds, one launch a call (counted in a
        # profile of one call), two launches bit-equal
        centers = torch.stack(seeds, dim=1)
        lk, sk, nk = kf.lloyd_t_pass(fit, centers)
        lp, sp, np_ = kf.lloyd_t_pass_plain(fit, centers)
        only = kf.lloyd_t_pass(fit, centers, assign_only=True)
        again = kf.lloyd_t_pass(fit, centers)
        torch.cuda.synchronize()
        bits = all(torch.equal(a, g) for a, g in zip(again, (lk, sk, nk)))
        k5_kernels = kernels_in_one_call(lambda: kf.lloyd_t_pass(fit, centers))
        print(f"phase 3: lloyd_t_pass [{gtag}] {kf.lloyd_t_plan(bsz, m, n_sm)} CTAs an image; device "
              f"kernels in one call {len(k5_kernels)} ({k5_kernels}); two launches "
              f"bit-equal {bits}", flush=True)
        check(len(k5_kernels) == 1, f"lloyd_t_pass ran {len(k5_kernels)} kernels in one call")
        same = (lk == lp).float().mean().item()
        rtol = 1e-4 if dt == torch.float32 else 1e-3
        scale = sp.abs().max().item()
        err = (sk - sp).abs().max().item()
        report("lloyd_t_pass", f"{gtag} labels equal {same:.6f}", err, err,
               f"{rtol}*{scale:.4g}",
               same >= 0.9999 and err <= rtol * scale and torch.equal(nk, np_)
               and torch.equal(only, lk) and bits,
               lambda: kf.lloyd_t_pass(fit, centers),
               lambda: kf.lloyd_t_pass_plain(fit, centers),
               (bsz * m * (d * size(dt) + 4), bsz * m * (2 * k * d + d)) if main2 else None)

        # K9 and K8 on the parameters of that hard split, as the EM loop's
        # first iteration takes them
        params = gf._moments_to_params(*gf._init_moments(fit, lk, k), m, c2.gmm_reg_covar)
        covs = params[2].reshape(bsz * k, d, d).contiguous()
        nmat = covs.shape[0]
        if main2:
            # well-conditioned matrices (cond < 40) of the same count and
            # order: entry by entry within 5e-4 of cuSOLVER, as the tests hold
            rng = np.random.default_rng(39)
            g = rng.normal(size=(nmat, d, 2 * d))
            wc = torch.from_numpy((g @ g.transpose(0, 2, 1) / (2 * d) + 1e-3 * np.eye(d))
                                  .astype(np.float32)).to(dev)
            (pw, dw), (pr, dr) = chol.precision_chol(wc), chol.precision_chol_plain(wc)
            rel = ((pw - pr).abs() / (pr.abs() + 1e-3)).max().item()
            drel = ((dw - dr).abs() / dr).max().item()
            print(f"phase 3: precision_chol [well-conditioned M={nmat} d={d}] against "
                  f"cuSOLVER: max rel {rel:.3e} (bound 5e-4), diag {drel:.3e} (bound 1e-5)",
                  flush=True)
            check(rel < 5e-4 and drel <= 1e-5,
                  "precision_chol disagrees with cuSOLVER on well-conditioned matrices")
        ptk, dgk = chol.precision_chol(covs)
        ptp, dgp = chol.precision_chol_plain(covs)
        torch.cuda.synchronize()
        # The EM's covariances are ill-conditioned (small clusters: near
        # rank-deficient plus reg_covar * I), so two float32 inverses differ
        # entry by entry by up to cond * eps: the forward error is a reading.
        # The gate is the backward error, which does not grow with cond.
        (bk, gk), (bp, gp) = chol_errors(covs, ptk, dgk), chol_errors(covs, ptp, dgp)
        c64 = covs.double()
        pt64 = torch.linalg.solve_triangular(
            torch.linalg.cholesky(c64),
            torch.eye(d, dtype=torch.float64, device=dev).expand_as(c64), upper=False)

        def fwd(pt):
            return (torch.linalg.matrix_norm(pt.double() - pt64)
                    / torch.linalg.matrix_norm(pt64)).max().item()

        cond = torch.linalg.cond(c64)
        noise = torch.randn(ptk.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        perturbed = torch.tril(ptk * (1 + 1e-5 * noise))
        catches = not (chol_ok(covs, perturbed, dgk)
                       or chol_ok(covs, torch.zeros_like(ptk), dgk))
        print(f"phase 3: precision_chol [{tag2}] cond {cond.min().item():.3e}.."
              f"{cond.max().item():.3e}; backward error kernel {bk.max().item():.3e}, "
              f"cuSOLVER {bp.max().item():.3e}, P^T perturbed by 1e-5 "
              f"{chol_errors(covs, perturbed, dgk)[0].max().item():.3e}; diag error "
              f"kernel {gk.max().item():.3e}, cuSOLVER {gp.max().item():.3e}; forward "
              f"error against float64 (normwise, a reading) kernel {fwd(ptk):.3e}, "
              f"cuSOLVER {fwd(ptp):.3e}", flush=True)
        check(catches, "the precision_chol gate passes a perturbed or zero P^T")
        report("precision_chol", f"{tag2} M={nmat} d={d}", (ptk - ptp).abs().max().item(),
               bk.max().item(), f"backward error {CHOL_BACKWARD_TOL:g}, diag error "
               f"{CHOL_DIAG_TOL:g}, upper triangle zero", chol_ok(covs, ptk, dgk),
               lambda: chol.precision_chol(covs), lambda: chol.precision_chol_plain(covs),
               (nmat * d * (2 * d + 1) * 4, nmat * d ** 3) if main2 else None)
        if main2:  # the plain version is the PyTorch (cuSOLVER) pair itself
            record["precision_chol"]["library_ms"] = record["precision_chol"]["plain_ms"]

        inputs = gf._params_to_kernel_inputs(*params)

        # K10 on the moments of the first EM pass (what the EM loop hands it
        # with the _FUSED_PREP switch on) and on well-conditioned moments
        reg = c2.gmm_reg_covar
        moments = gf.em_pass(fit, *inputs)[2:]
        if main2:
            rng = np.random.default_rng(10)
            xw = rng.normal(size=(bsz, k, 4 * d, d)) * rng.uniform(0.5, 2.0, (bsz, k, 1, d))
            rw = rng.uniform(0.2, 1.0, size=(bsz, k, 4 * d))
            well = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
                rw.sum(axis=2), np.einsum("bkn,bkni->bki", rw, xw),
                np.einsum("bkn,bkni,bknj->bkij", rw, xw, xw))]
            (pw, bw, cw), (pr, br, cr) = (chol.precision_chol_params(*well, m, reg),
                                          chol.precision_chol_params_plain(*well, m, reg))
            rel = ((pw - pr).abs() / (pr.abs() + 1e-3)).max().item()
            brel = ((bw - br).abs() / (br.abs() + br.abs().max())).max().item()
            cabs = (cw - cr).abs().max().item()
            print(f"phase 3: precision_chol_params [well-conditioned M={nmat} d={d}] against "
                  f"the plain chain: P^T max rel {rel:.3e} (bound 5e-4), bias {brel:.3e} "
                  f"(bound 2e-4), const max abs {cabs:.3e} (bound 1e-4)", flush=True)
            check(rel < 5e-4 and brel <= 2e-4 and cabs <= 1e-4,
                  "precision_chol_params disagrees with the plain chain on well-conditioned "
                  "moments")
        check_params(moments, m, reg, tag2 + " first EM pass's moments", f"{tag2} M={nmat}",
                     main2)
        del moments

        for buf, where, moments, main in ((fit, "fit grid", True, main2),
                                          (x, "full resolution", True, False),
                                          (x, "full resolution labels only", False, False)):
            check_em(buf, inputs, f"{tag2} {where}", moments, main)
        del x, fit, inputs
    torch.cuda.empty_cache()

    # K9 past config2's order: d = 39, 64, 65 and 128 (the reference's
    # limit), M = 40, on covariances shaped as the EM's (clusters of fewer
    # points than rows, plus reg_covar I: cond ~1e3-1e6) under the backward
    # error gate, and on well-conditioned ones within 5e-4 of cuSOLVER; two
    # launches bit-equal; d = 129 raises, as the reference's K9
    def em_covariances(m, d, seed):
        rng = np.random.default_rng(seed)
        covs = []
        for i in range(m):
            pts = rng.normal(size=(max(1, d // 2 + i % 7), d)) * rng.uniform(0.2, 3.0, size=d)
            pts -= pts.mean(axis=0)
            covs.append(pts.T @ pts / len(pts) + 1e-4 * np.eye(d))
        return torch.from_numpy(np.stack(covs).astype(np.float32)).to(dev)

    for d9 in (39, 64, 65, 128):
        covs9 = em_covariances(40, d9, 100 + d9)
        g = np.random.default_rng(d9).normal(size=(40, d9, 2 * d9))
        wc9 = torch.from_numpy((g @ g.transpose(0, 2, 1) / (2 * d9) + 1e-3 * np.eye(d9))
                               .astype(np.float32)).to(dev)
        (pw, _), (pr, _) = chol.precision_chol(wc9), chol.precision_chol_plain(wc9)
        pt9, dg9 = chol.precision_chol(covs9)
        again9 = chol.precision_chol(covs9)
        torch.cuda.synchronize()
        rel = ((pw - pr).abs() / (pr.abs() + 1e-3)).max().item()
        (bk9, gk9), (bp9, _) = (chol_errors(covs9, pt9, dg9),
                                chol_errors(covs9, *chol.precision_chol_plain(covs9)))
        bits = torch.equal(pt9, again9[0]) and torch.equal(dg9, again9[1])
        cond = torch.linalg.cond(covs9.double())
        ms9 = timed(lambda: chol.precision_chol(covs9))[0]
        ms9p = timed(lambda: chol.precision_chol_plain(covs9))[0]
        b9 = bound(40 * d9 * (2 * d9 + 1) * 4, 40 * d9 ** 3)
        print(f"phase 3: precision_chol [EM-shaped M=40 d={d9}] cond {cond.min().item():.3e}.."
              f"{cond.max().item():.3e}; backward error kernel {bk9.max().item():.3e}, cuSOLVER "
              f"{bp9.max().item():.3e} (bound {CHOL_BACKWARD_TOL:g}), diag error "
              f"{gk9.max().item():.3e} (bound {CHOL_DIAG_TOL:g}), upper triangle zero, two "
              f"launches bit-equal {bits}; well-conditioned against cuSOLVER max rel {rel:.3e} "
              f"(bound 5e-4); kernel {ms9:.4f} ms, cuSOLVER {ms9p:.4f} ms, bound {b9[0]:.5f} ms "
              f"({b9[1]}) ({card})", flush=True)
        check(chol_ok(covs9, pt9, dg9) and rel < 5e-4 and bits,
              f"precision_chol fails its gate at d = {d9}")
    try:
        chol.precision_chol(torch.eye(129, device=dev).expand(2, 129, 129).contiguous())
    except ValueError as exc:
        print(f"phase 3: precision_chol [d=129] raises, as the reference's: {exc}", flush=True)
    else:
        fail("precision_chol took d = 129, past the reference's limit")

    # K8 past the 40 rows its first kernel holds in registers: D = 51 (a
    # 16-kernel bank) and D = 123 on buffers of config2's fit grid (8 x 9,600
    # pixels, three blobs), in both dtypes, with moments and labels only,
    # from a hard split's parameters (K9 at d = D); K10 at d = 123 on the
    # moments of the D = 123 pass
    rng = np.random.default_rng(51)
    for dw in (51, 123):
        means = rng.normal(scale=2.0, size=(8, 3, dw))
        xw = (np.take_along_axis(means, rng.integers(0, 3, size=(8, 9600))[:, :, None], 1)
              + rng.normal(size=(8, 9600, dw)))
        x32 = torch.from_numpy(np.swapaxes(xw, 1, 2).astype(np.float32)).to(dev)
        hard = torch.from_numpy(rng.integers(0, c2.k, size=(8, 9600))).to(dev)
        inputs = gf._params_to_kernel_inputs(*gf._moments_to_params(
            *gf._init_moments(x32, hard, c2.k), 9600, c2.gmm_reg_covar))
        for dt in (torch.bfloat16, torch.float32):
            for moments in (True, False):
                check_em(x32.to(dt), inputs, f"D={dw} fit grid "
                         f"{'bf16' if dt == torch.bfloat16 else 'f32'} "
                         f"{'with moments' if moments else 'labels only'}", moments, False)
        if dw == 123:
            check_params(gf.em_pass(x32, *inputs)[2:], 9600, c2.gmm_reg_covar,
                         "D=123 pass's moments", "8x5 matrices", False)
        del x32, inputs
    torch.cuda.empty_cache()

    cfg3 = preset("config3")  # batch 8
    g3 = cfg3.graph
    tag3 = "config3 8x321x481"
    # K1 at config3 (the graph stage's bf16 call, no twin; f32 batches take
    # the modulated route there), and at any radius: config0's bank widened
    # past the radii K1's tiles were once sized for (conv 16, smoothing 25)
    # and a bank at twice them or more (conv 32, smoothing 50), batch 2
    compare_features(cfg3, rgb8, torch.bfloat16, f"{tag3} bf16 no twin", False, pooled=False)
    wide_banks = (("conv radius 16", dataclasses.replace(cfg0.bank, max_ksize=33)),
                  ("smoothing radius 25", dataclasses.replace(cfg0.bank, smooth_truncate=3.1)),
                  ("radii 32 and 50", BankConfig(scales=(2.0, 11.0), orientations=2,
                                                 max_ksize=65, smoothing=1.5)))
    for what, bank_cfg in wide_banks:
        for dt in (torch.bfloat16, torch.float32):
            compare_features(cfg0, rgb8[:2], dt, f"2x321x481 {what} "
                             f"{'bf16' if dt == torch.bfloat16 else 'f32'}", False,
                             bank_cfg=bank_cfg)
    torch.cuda.empty_cache()
    lab3 = pl._color_transform(torch.from_numpy(rgb8).to(dev), "lab")
    bsz, h3, w3, _ = lab3.shape
    n3 = h3 * w3
    gh3, gw3, _ = sl.grid_shape(h3, w3, g3.n_superpixels)
    s3 = gh3 * gw3

    # K11, the least work: in each of the n_iter + 1 assignments, a score per
    # candidate (5 products and 4 sums for the dot, a product and a
    # difference, a compare) and |cs|^2 per centroid (2 spatial weights, 5
    # products, 4 sums); in each update 6 sums per pixel. Labels equal to
    # slic_plain's on every pixel and two launches bit-equal, at config3,
    # at batch 1 and on a frame of one grid row
    def run_slic(fn, lab=None, n_sp=None):
        return fn(lab3 if lab is None else lab, n_sp or g3.n_superpixels, g3.slic_compactness,
                  g3.slic_iters)

    spk, spk2, spp = run_slic(sf.slic_w3), run_slic(sf.slic_w3), run_slic(sl.slic_plain)
    torch.cuda.synchronize()
    ndiff, twice = int((spk != spp).sum()), torch.equal(spk, spk2)
    n_cand = int(sl._candidates(h3, w3, gh3, gw3, dev)[1].sum()) * bsz
    flops = ((g3.slic_iters + 1) * (n_cand * 12 + bsz * s3 * 11)
             + g3.slic_iters * bsz * n3 * 6)
    report("slic_w3", f"{tag3} S={s3}, {g3.slic_iters} iterations, {ndiff} pixels differ, two "
           f"launches bit-equal {twice}; the thread-a-pixel design it replaced read "
           f"{K11_BEFORE_MS} ms here",
           float((spk - spp).abs().max()), ndiff, "labels equal on every pixel, two launches "
           "bit-equal", ndiff == 0 and twice,
           lambda: run_slic(sf.slic_w3), lambda: run_slic(sl.slic_plain),
           (lab3.numel() * 4 + spk.numel() * 4, flops))
    lab_row = pl._color_transform(torch.from_numpy(mosaics(2, 20, 301)[0]).to(dev), "lab")
    for tagx, labx, n_spx in ((f"config3 1x{h3}x{w3} (batch 1)", lab3[:1], None),
                              ("2x20x301 (one grid row: gh = 1)", lab_row, 30)):
        got, got2, ref = (run_slic(sf.slic_w3, labx, n_spx), run_slic(sf.slic_w3, labx, n_spx),
                          run_slic(sl.slic_plain, labx, n_spx))
        torch.cuda.synchronize()
        ndx, twx = int((got != ref).sum()), torch.equal(got, got2)
        print(f"phase 3: slic_w3 [{tagx}] {ndx} pixels differ from slic_plain, two launches "
              f"bit-equal {twx}, {timed(lambda: run_slic(sf.slic_w3, labx, n_spx))[0]:.4f} ms "
              f"({card})", flush=True)
        check(ndx == 0 and twx, f"slic_w3 is not bit-equal to slic_plain at {tagx}")
    # one pass (labels and partials) and one update bit-equal to their plain
    # versions at centroids three plain iterations off the grid, each timed
    # beside its bound (the pass: the Lab read and the labels written, or
    # its candidate scores; the update: the partials read, the centroids
    # read and written)
    plan3 = sf.slic_w3_plan(h3, w3, g3.n_superpixels)
    sw3 = sl.slic_geometry(h3, w3, g3.n_superpixels, g3.slic_compactness)[2]
    cent3 = sl.slic_init_centroids(lab3, gh3, gw3)
    for _ in range(3):
        cent3 = sf.slic_w3_update_plain(cent3, sf.slic_w3_pass_plain(lab3, cent3, plan3, sw3)[1],
                                        plan3)
    lk3, pk3 = sf.slic_w3_pass(lab3, cent3, g3.n_superpixels, sw3)
    lp3, pp3 = sf.slic_w3_pass_plain(lab3, cent3, plan3, sw3)
    up_ok = torch.equal(sf.slic_w3_update(cent3.clone(), pk3, h3, w3, g3.n_superpixels),
                        sf.slic_w3_update_plain(cent3, pp3, plan3))
    torch.cuda.synchronize()
    pass_ok = torch.equal(lk3, lp3) and torch.equal(pk3, pp3)
    pass_b = bound(lab3.numel() * 4 + lk3.numel() * 4, n_cand * 12)
    upd_b = bound(pk3.numel() * 8 + cent3.numel() * 8, 0)
    t_pass = timed(lambda: sf.slic_w3_pass(lab3, cent3, g3.n_superpixels, sw3))[0]
    t_only = timed(lambda: sf.slic_w3_pass(lab3, cent3, g3.n_superpixels, sw3,
                                           partials=False))[0]
    t_update = timed(lambda: sf.slic_w3_update(cent3.clone(), pk3, h3, w3, g3.n_superpixels))[0]
    print(f"phase 3: slic_w3 [{tag3}] plan: tiles of {plan3['ty']}x{plan3['tx']} cells, "
          f"{plan3['nty']}x{plan3['ntx']} a frame, {plan3['cells']} hoisted cells a tile; one "
          f"pass: labels and partials bit-equal to the plain pass {pass_ok}, update bit-equal "
          f"{up_ok}; with partials {t_pass:.4f} ms, labels only {t_only:.4f} ms, bound "
          f"{pass_b[0]:.4f} ms ({pass_b[1]}); one update {t_update:.4f} ms (a centroid clone "
          f"included), bound {upd_b[0]:.5f} ms ({upd_b[1]}) ({card})", flush=True)
    check(pass_ok and up_ok, "K11's pass or update is not bit-equal to its plain version")
    del spk2, lab_row, lk3, pk3, lp3, pp3, cent3
    # a frame whose band plan misses a band's candidate rows (config3's
    # S = 900 on 1288x481): slic_batch, with the counts set to 0 just before
    # it and read just after, runs K11 alone, labels equal to slic_plain's
    f12 = (1288, 481, 900)
    check(sf.slic_route(*f12) == "w3" and not sf.band_plan_ok(*f12),
          "1288x481 at S = 900 does not route to K11")
    lab12 = pl._color_transform(torch.from_numpy(mosaics(8, *f12[:2])[0]).to(dev), "lab")
    for wrapper in counters.values():
        wrapper.launches = 0
    sp12 = sf.slic_batch(lab12, f12[2], g3.slic_compactness, g3.slic_iters)
    torch.cuda.synchronize()
    f12_counts = {name: counters[name].launches for name in ("slic_w3", "slic_band_pass",
                                                              "slic_band_update", "slic_w5")}
    ndiff = int((sp12 != sl.slic_plain(lab12, f12[2], g3.slic_compactness,
                                       g3.slic_iters)).sum())
    check(f12_counts["slic_w3"] == 1 and sum(f12_counts.values()) == 1 and ndiff == 0,
          "slic_batch at 8x1288x481, S = 900, did not run as K11 alone, bit-equal to slic_plain")
    f12_launches = f12_counts["slic_w3"]
    print(f"phase 3: slic_batch [8x1288x481 S=900, a band plan that misses candidate rows] "
          f"launches {f12_counts} (counts set to 0 before it, read after), {ndiff} pixels "
          f"differ from slic_plain; "
          f"{timed(lambda: sf.slic_batch(lab12, f12[2], g3.slic_compactness, g3.slic_iters))[0]:.4f}"
          f" ms (a reading) ({card})", flush=True)
    del lab12, sp12

    # K14 on K11's output (the main path's input), on a fragmented map, on
    # the spiral maze (a corridor ~h * w / 2 long, the kept block in a
    # corner: the longest adoption distance, h + w - 6) and on a map with no
    # surviving component (min_size 5 for both mazes); with what the pass
    # meets there (the plain union-find's hook rounds, the Jacobi loop's
    # steps, the largest adoption distance, the absorbed share)
    rng = np.random.default_rng(14)
    base = rng.integers(0, s3, ((h3 + 7) // 8, (w3 + 7) // 8))
    frag = np.kron(base, np.ones((8, 8), int))[:h3, :w3]
    frag = np.where(rng.random((h3, w3)) < 0.25, rng.integers(0, s3, (h3, w3)), frag)
    frag = torch.from_numpy(np.stack([frag] * bsz).astype(np.int32)).to(dev)

    def maze(kept, h, w):
        return torch.from_numpy(np.stack([connectivity_maze(h, w, kept)] * bsz)).to(dev)

    def compare_connectivity(src, n_sp, min_size, where, main):
        h, w = src.shape[1:]
        ck = cn.enforce_connectivity_fused(src, n_sp, min_size)
        cp = sl.enforce_connectivity_plain(src, n_sp, min_size)
        torch.cuda.synchronize()
        ndiff = int((ck != cp).sum())
        r = sl.connectivity_readings(src, n_sp, min_size)
        report("enforce_connectivity_fused", f"{where}, min_size "
               f"{sl.connectivity_defaults(h, w, n_sp, min_size, None)[0]}, {ndiff} pixels "
               f"differ; union-find rounds {r['union_find_rounds']}, adoption steps "
               f"{r['adoption_steps']}, largest distance {r['max_distance']} (h + w = "
               f"{h + w}), absorbed {r['absorbed_share']:.4f}, kept per image "
               f"{r['kept_per_image']}", float((ck - cp).abs().max()), ndiff,
               "bit-equal (0 pixels)", ndiff == 0,
               lambda: cn.enforce_connectivity_fused(src, n_sp, min_size),
               lambda: sl.enforce_connectivity_plain(src, n_sp, min_size),
               (2 * src.numel() * 4, 0) if main else None)
        return ck

    sp3 = compare_connectivity(spk, s3, None, f"{tag3} on K11's output", True).reshape(bsz, n3)
    compare_connectivity(frag, s3, None, f"{tag3} on a fragmented random map", False)
    compare_connectivity(maze("corner", h3, w3), 16, 5, f"{tag3} spiral maze, corner kept",
                         False)
    compare_connectivity(maze("none", h3, w3), 16, 5, f"{tag3} no surviving component",
                         False)

    # K15: region ids of each superpixel broadcast to the pixels
    table = torch.from_numpy(rng.integers(0, g3.n_regions, (bsz, s3)).astype(np.int32)).to(dev)
    lk, lp = lookup.table_lookup(sp3, table), lookup.table_lookup_plain(sp3, table)
    torch.cuda.synchronize()
    ndiff = int((lk != lp).sum())
    report("table_lookup", f"{tag3} idx {tuple(sp3.shape)} table {tuple(table.shape)}, "
           f"{ndiff} pixels differ", float((lk - lp).abs().max()), ndiff,
           "bit-equal (0 pixels)", ndiff == 0, lambda: lookup.table_lookup(sp3, table),
           lambda: lookup.table_lookup_plain(sp3, table),
           (2 * sp3.numel() * 4 + table.numel() * 4, 0))
    sp3_64 = sp3.long()
    record["table_lookup"]["library_ms"] = timed(lambda: torch.gather(table, 1, sp3_64))[0]
    # K15 past its old 12,288-entry cap: S = 50,000, uniform random indices
    # over config3's pixels (odd N, so rows 1.. are not 16-byte aligned)
    s_big = 50000
    idx_big = torch.from_numpy(rng.integers(0, s_big, tuple(sp3.shape)).astype(np.int32)).to(dev)
    table_big = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (bsz, s_big))
                                 .astype(np.int32)).to(dev)
    lk, lp = lookup.table_lookup(idx_big, table_big), lookup.table_lookup_plain(idx_big, table_big)
    torch.cuda.synchronize()
    ndiff = int((lk != lp).sum())
    report("table_lookup", f"{tag3} idx {tuple(idx_big.shape)} uniform random, table "
           f"{tuple(table_big.shape)}, {ndiff} pixels differ", float((lk - lp).abs().max()),
           ndiff, "bit-equal (0 pixels)", ndiff == 0,
           lambda: lookup.table_lookup(idx_big, table_big),
           lambda: lookup.table_lookup_plain(idx_big, table_big))
    del lab3, spk, spp, frag, sp3, sp3_64, lk, lp, idx_big, table_big

    # K13 at config4's pooled grid, the main path's SLIC; K12 at 8x321x481
    # with 400 superpixels (a frame under the whole-image gate, where
    # plan="w5" selects it); K11, and K13 at K12's frame, as readings
    pairs4 = [f.result() for f in pending4]
    workers.shutdown()
    rgb4, gt4 = np.stack([p[0] for p in pairs4]), np.stack([p[1] for p in pairs4])
    del pairs4
    g4 = cfg4.graph
    tag4 = "config4 8x2160x3840"
    color4 = pl._color_transform(torch.from_numpy(rgb4).to(dev), "lab")
    lab4 = color4
    for _ in range(g4.pool):
        lab4 = tiled.pool2x2_mean(lab4, 1)

    def compare_banded(name, fn, lab, n_sp, tag, readings, equal_to=()):
        """``fn`` (K13's loop or K12) against the plain banded loop: labels
        equal on every pixel, and two calls bit-equal; the calls in
        ``equal_to`` bit-equal to it too. The least work is K11's (see
        run_slic)."""
        args = (lab, n_sp, g4.slic_compactness, g4.slic_iters)
        got, again, ref = fn(*args), fn(*args), sf.slic_banded_plain(*args)
        torch.cuda.synchronize()
        ndiff = int((got != ref).sum())
        twice = torch.equal(got, again)
        bsz, h, w, _ = lab.shape
        gh, gw, _ = sl.grid_shape(h, w, n_sp)
        n_cand = int(sl._candidates(h, w, gh, gw, dev)[1].sum()) * bsz
        flops = ((g4.slic_iters + 1) * (n_cand * 12 + bsz * gh * gw * 11)
                 + g4.slic_iters * bsz * h * w * 6)
        report(name, f"{tag} S={gh * gw}, {g4.slic_iters} iterations, {ndiff} pixels "
               f"differ, two calls bit-equal {twice}", float((got - ref).abs().max()), ndiff,
               "labels equal on every pixel", ndiff == 0 and twice, lambda: fn(*args),
               lambda: sf.slic_banded_plain(*args), (lab.numel() * 4 + got.numel() * 4, flops))
        for other, ofn in equal_to:
            ndiff = int((ofn(*args) != got).sum())
            print(f"phase 3: {other} [{tag} S={gh * gw}] {ndiff} pixels differ from "
                  f"{name}'s labels ({card})", flush=True)
            check(ndiff == 0, f"{other} is not bit-equal to {name} at {tag}")
        for other, ofn in readings:
            same = (ofn(*args) == got).float().mean(dim=(1, 2)).min().item()
            other_ms = timed(lambda: ofn(*args))[0]
            print(f"phase 3: {other} [{tag} S={gh * gw}] (a reading) {other_ms:.3f} ms, labels "
                  f"equal to {name}'s per image min {same:.6f} ({card})", flush=True)
        return got

    check(sf.slic_route(*lab4.shape[1:3], g4.n_superpixels) == "banded",
          "config4's pooled grid does not take the banded SLIC")
    h4, w4 = lab4.shape[1:3]
    tag4p = f"config4 pooled 8x{h4}x{w4}"
    sp4 = compare_banded("slic_band_pass", sf.slic_banded, lab4, g4.n_superpixels,
                         f"{tag4p}, banded loop, 11 pass launches, against the plain "
                         "loop (the parent's, unchanged)",
                         [("slic_w3 (K11)", sf.slic_w3)])
    # K13's pass (labels and partials) and update bit-equal to their plain
    # versions at centroids three plain iterations off the grid; one pass
    # with partials, one labels only and one update beside the pass's
    # bound, and one pass at several column-piece widths (the frame's width
    # is one piece per band) as readings
    bp4 = sf._band_plan(h4, w4, g4.n_superpixels)
    sw4 = sl.slic_geometry(h4, w4, g4.n_superpixels, g4.slic_compactness)[2]
    cent4 = sl.slic_init_centroids(lab4, bp4["gh"], bp4["gw"])
    for _ in range(3):
        cent4 = sf.slic_band_update_plain(cent4, sf.slic_band_pass_plain(lab4, cent4, bp4,
                                                                         sw4)[1], bp4)
    lk4, pk4 = sf.slic_band_pass(lab4, cent4, bp4, sw4)
    lp4, pp4 = sf.slic_band_pass_plain(lab4, cent4, bp4, sw4)
    up_ok = torch.equal(sf.slic_band_update(cent4.clone(), pk4, bp4, h4),
                        sf.slic_band_update_plain(cent4, pp4, bp4))
    torch.cuda.synchronize()
    pass_ok = torch.equal(lk4, lp4) and torch.equal(pk4, pp4)
    n_cand4 = int(sl._candidates(h4, w4, bp4["gh"], bp4["gw"], dev)[1].sum()) * lab4.shape[0]
    pass_b = bound(lab4.numel() * 4 + lk4.numel() * 4, n_cand4 * 12)[0]
    t_pass = timed(lambda: sf.slic_band_pass(lab4, cent4, bp4, sw4))[0]
    t_only = timed(lambda: sf.slic_band_pass(lab4, cent4, bp4, sw4, partials=False))[0]
    t_update = timed(lambda: sf.slic_band_update(cent4.clone(), pk4, bp4, h4))[0]
    by_cols = {c: round(timed(lambda: sf.slic_band_pass(lab4, cent4, bp4, sw4, cols=c))[0], 4)
               for c in (w4, 256, sf._BAND_COLS, 64)}
    print(f"phase 3: slic_band_pass [{tag4p}] one pass: labels and partials bit-equal to the "
          f"plain pass {pass_ok}, update bit-equal {up_ok}; with partials {t_pass:.4f} ms, "
          f"labels only {t_only:.4f} ms, bound {pass_b:.4f} ms ({100 * pass_b / t_pass:.1f} % "
          f"of it with partials); one update {t_update:.4f} ms (a centroid clone included); "
          f"with partials by column width {by_cols} ms (readings) ({card})", flush=True)
    check(pass_ok and up_ok, "K13's pass or update is not bit-equal to its plain version")
    del lk4, pk4, lp4, pp4, cent4

    # K14 and K15 on K13's output, at config4's shapes: 3.4x config3's
    # pixels a frame, with config4's min_size and a table of its S rows
    gh4, gw4, _ = sl.grid_shape(h4, w4, g4.n_superpixels)
    s4 = gh4 * gw4
    ck = compare_connectivity(sp4, s4, None, f"{tag4p} on K13's output, S={s4}", False)
    compare_connectivity(maze("corner", h4, w4), 16, 5, f"{tag4p} spiral maze, corner kept",
                         False)
    idx4 = ck.reshape(ck.shape[0], h4 * w4)
    table4 = torch.from_numpy(rng.integers(0, g4.n_regions, (ck.shape[0], s4))
                              .astype(np.int32)).to(dev)
    lk, lp = lookup.table_lookup(idx4, table4), lookup.table_lookup_plain(idx4, table4)
    torch.cuda.synchronize()
    ndiff = int((lk != lp).sum())
    report("table_lookup", f"{tag4p} idx {tuple(idx4.shape)} table {tuple(table4.shape)}, "
           f"{ndiff} pixels differ", float((lk - lp).abs().max()), ndiff,
           "bit-equal (0 pixels)", ndiff == 0, lambda: lookup.table_lookup(idx4, table4),
           lambda: lookup.table_lookup_plain(idx4, table4))
    del sp4, ck, idx4, table4, lk, lp

    # K16-K18 on the graph stage's own inputs: the standardised features and
    # the connected superpixels of config3 and of config4's pooled grid; at
    # config3 also past the old 3,632 cap, S = 8,192, on a raster block map
    # (narrow chunk ranges) and on uniform random labels in [-1, S] (the
    # widest ranges, labels outside [0, S) in every chunk)
    def within_one_ulp(got, ref):
        ulp = torch.nextafter(ref.abs(), torch.full_like(ref, float("inf"))) - ref.abs()
        return bool(((got - ref).abs() <= ulp).all())

    def compare_moments(name, kern_fn, plain_fn, dt, tag, main):
        (sk_, ck_), (sk2, ck2), (sp_, cp_) = kern_fn(), kern_fn(), plain_fn()
        torch.cuda.synchronize()
        ndiff = int((sk_ != sp_).sum()) + int((ck_ != cp_).sum())
        same = torch.equal(sk_, sk2) and torch.equal(ck_, ck2)
        ok = same and torch.equal(ck_, cp_) and (ndiff == 0 if dt == torch.bfloat16
                                                 else within_one_ulp(sk_, sp_))
        report(name, f"{tag}, {ndiff} values differ, two launches "
               f"{'bit-equal' if same else 'DIFFER'}", (sk_ - sp_).abs().max().item(), ndiff,
               "bf16 every value equal, f32 within one ulp, counts equal, two launches "
               "bit-equal", ok, kern_fn, plain_fn, main)

    def moments_cases(spm, feats, rows_m, n_sp, dt, tagm, main):
        """The three entry points on one input: K17 on the channel-major
        features in ``dt``, K16 and K18 on the rows in bf16; and the kernel's
        chunk ranges (a reading of the partials it writes)."""
        dname = "bf16" if dt == torch.bfloat16 else "f32"
        compare_moments("superpixel_moments_fused_t",
                        lambda: gm.superpixel_moments_fused_t(spm, feats, n_sp, dtype=dt),
                        lambda: gm.superpixel_moments_plain(spm, feats, n_sp, True), dt,
                        f"{tagm}, channel-major in {dname} (the graph stage's call)", main)
        for name in ("superpixel_moments_fused", "superpixel_moments_fused_nhwc"):
            fn = getattr(gm, name)
            compare_moments(name, lambda: fn(spm, rows_m, n_sp),
                            lambda: gm.superpixel_moments_plain(
                                spm, rows_m.to(torch.bfloat16), n_sp),
                            torch.bfloat16, f"{tagm}, row-major in bf16", main)
        bsz, dm, nm = feats.shape
        chunk, n_chunks = gm.chunk_plan(bsz, nm, n_sp, dm)
        rg = gm.chunk_ranges(spm, n_sp, chunk).long()
        width = (rg[..., 1] - rg[..., 0] + 1).clamp(min=0).float()
        moved = 2 * width.sum().item() * (dm + 1) * 8  # written once, read once
        print(f"phase 3: superpixel moments [{tagm}] chunks of {chunk} pixels, {n_chunks} an "
              f"image ({bsz * n_chunks} blocks): label range per chunk mean "
              f"{width.mean().item():.1f}, max {int(width.max().item())}, "
              f"{int((width > gm.WINDOW).sum().item())} chunks over the {gm.WINDOW}-label "
              f"window; float64 partials {moved / 1e6:.1f} MB written and read against "
              f"{feats.numel() * size(dt) / 1e6:.1f} MB of features (buffer "
              f"{bsz * n_chunks * n_sp * (dm + 1) * 8 / 1e6:.1f} MB)", flush=True)

    for cfg_m, rgb_m, where in ((cfg3, rgb8, tag3), (cfg4, rgb4, tag4p)):
        for dt in (torch.bfloat16, torch.float32):
            dname = "bf16" if dt == torch.bfloat16 else "f32"
            feats, spm, n_sp = pl._graph_front(
                torch.from_numpy(rgb_m).to(dev),
                cfg_m.replace(dtype="bfloat16" if dt == torch.bfloat16 else "float32"),
                make_bank(cfg_m.bank))
            rows_m = feats.transpose(1, 2).contiguous()
            bsz, dm, nm = feats.shape
            main = (feats.numel() * size(dt) + spm.numel() * 4 + bsz * n_sp * (dm + 1) * 4,
                    bsz * nm * (dm + 1)) if cfg_m is cfg3 and dt == torch.bfloat16 else None
            tagm = f"{where} {dname} graph features {tuple(feats.shape)}"
            moments_cases(spm, feats, rows_m, n_sp, dt, f"{tagm}, S={n_sp}", main)
            if main:  # one index_add_ of the same values as float32 rows
                flat = (spm.long() + n_sp * torch.arange(bsz, device=dev)[:, None]).reshape(-1)
                src = rows_m.float().reshape(-1, dm)
                lib, lib_single = timed(lambda: torch.zeros((bsz * n_sp, dm), device=dev)
                                        .index_add_(0, flat, src))
                for name in ("superpixel_moments_fused", "superpixel_moments_fused_t",
                             "superpixel_moments_fused_nhwc"):
                    record[name]["library_ms"] = lib
                print(f"phase 3: superpixel moments [{tagm}] library call, one float32 "
                      f"index_add_ of the sums: {lib:.4f} ms (single launch "
                      f"{lib_single:.4f}; {timing_note(lib_single)}) ({card})", flush=True)
                del flat, src
            if cfg_m is cfg3:
                s_big = 8192
                gy = np.arange(h3)[:, None] * 64 // h3
                gx = np.arange(w3)[None, :] * 128 // w3
                raster = np.broadcast_to((gy * 128 + gx).reshape(1, -1), (bsz, nm))
                uniform = rng.integers(-1, s_big + 1, (bsz, nm))
                for lab_np, kind in ((raster, "raster 64x128 block map"),
                                     (uniform, "uniform random labels in [-1, S]")):
                    lab_big = torch.from_numpy(lab_np.astype(np.int32)).to(dev)
                    moments_cases(lab_big, feats, rows_m, s_big, dt,
                                  f"{tagm}, S={s_big}, {kind}", None)
                del lab_big
            del feats, spm, rows_m
    torch.cuda.empty_cache()
    lab5 = pl._color_transform(torch.from_numpy(rgb8).to(dev), "lab")

    def w5_plan_line(lab, n_sp, tag):
        """K12's plan at this batch and frame, on a line of its own."""
        bsz, h, w, _ = lab.shape
        plan = sf.slic_w5_plan(h, w, n_sp, bsz, sf.w5_active(h, w, n_sp, dev.index or 0))
        print(f"phase 3: slic_w5 [{tag}] plan: a thread-block cluster of {plan['ctas']} CTAs "
              f"an image, {plan['groups']} group(s) of 256 threads a CTA, pieces "
              f"{plan['cw']} columns wide, {plan['kmax']} pieces a CTA at most, partials in "
              f"{'shared' if plan['parts_in_smem'] else 'global'} memory, {plan['smem']} B of "
              f"shared memory a CTA, {plan['active']} clusters held at once, "
              f"{plan['waves']} wave(s) ({card})", flush=True)

    check(sf.slic_route(321, 481, 400, "w5") == "w5", "8x321x481 at 400 superpixels is not w5")
    w5_plan_line(lab5, 400, "8x321x481 S=384")
    compare_banded("slic_w5", sf.slic_w5, lab5, 400, "8x321x481, one cluster launch",
                   [("slic_w3 (K11)", sf.slic_w3), ("slic_banded (K13)", sf.slic_banded)],
                   equal_to=[("slic_banded (K13)", sf.slic_banded)])
    # K12 at the extremes of the range slic_route(h, w, S, "w5") admits: the
    # most superpixels (1052x16, S = 12,000: 12,432), the most bands
    # (1422x16, S = 12,000: 474, the partials in the global scratch) and the
    # most pixels (1422x127, S = 10: 180,594, a width not a multiple of 4)
    for h5, w5, n5 in ((1052, 16, 12000), (1422, 16, 12000), (1422, 127, 10)):
        check(sf.slic_route(h5, w5, n5, "w5") == "w5", f"{h5}x{w5} at {n5} is not w5")
        labx = pl._color_transform(torch.from_numpy(mosaics(8, h5, w5)[0]).to(dev), "lab")
        tagx = f"8x{h5}x{w5} S={n5}"
        w5_plan_line(labx, n5, tagx)
        argsx = (labx, n5, g4.slic_compactness, g4.slic_iters)
        got, again = sf.slic_w5(*argsx), sf.slic_w5(*argsx)
        ndiff = int((got != sf.slic_banded_plain(*argsx)).sum())
        twice = torch.equal(got, again)
        ndiff13 = int((got != sf.slic_banded(*argsx)).sum())
        print(f"phase 3: slic_w5 [{tagx}, the range's extreme] {ndiff} pixels differ from the "
              f"plain banded loop, {ndiff13} from K13's loop, two calls bit-equal {twice}; "
              f"{timed(lambda: sf.slic_w5(*argsx))[0]:.4f} ms ({card})", flush=True)
        check(ndiff == 0 and ndiff13 == 0 and twice,
              f"K12 is not bit-equal to the plain banded loop at {tagx}")
        del labx, got, again
    # K12's path: slic_batch(plan="w5"), the reference's entry point to it,
    # with the counts set to 0 just before and read just after
    for wrapper in counters.values():
        wrapper.launches = 0
    sp5 = sf.slic_batch(lab5, 400, g4.slic_compactness, g4.slic_iters, plan="w5")
    torch.cuda.synchronize()
    k12_counts = {name: wrapper.launches for name, wrapper in counters.items()}
    slic_counts = {n: k12_counts[n] for n in ("slic_w5", "slic_w3", "slic_band_pass",
                                               "slic_band_update")}
    print(f"phase 3: slic_batch(plan='w5') [8x321x481] K12's path (counts set to 0 before it, "
          f"read after): launches {slic_counts} ({card})", flush=True)
    check(k12_counts["slic_w5"] == 1 and sum(k12_counts.values()) == 1
          and tuple(sp5.shape) == tuple(lab5.shape[:3]),
          "slic_batch(plan='w5') did not run as one K12 launch")
    k12_launches = k12_counts["slic_w5"]
    del lab4, lab5, sp5

    # tiled K1 at config4: against K1 on the whole frames plus pooling (a
    # reading of what the tiling costs), and against the plain tiled path on
    # one frame (the plain K1 at batch 8 of 4K takes seconds a call)
    groups4 = bank_tensors(make_bank(cfg4.bank), dev)
    halo4 = cfg4.bank.max_halo

    def tiled_k1(color, dt):
        return tiled.gabor_energies_tiled(color, groups4, dt, cfg4.tile_hw, halo4, g4.pool)

    def untiled_k1(color, dt):
        e, _ = fused.gabor_energies_fused(color, groups4, dt, pooled=False)
        for _ in range(g4.pool):
            e = tiled.pool2x2_mean(e, 2)
        return e

    def tiled_plain(color, dt):
        saved = tiled.gabor_energies_fused
        tiled.gabor_energies_fused = fused.gabor_energies_fused_plain
        try:
            return tiled_k1(color, dt)
        finally:
            tiled.gabor_energies_fused = saved

    _, _, ys4, xs4 = tiled.tile_offsets(*cfg4.image_hw, cfg4.tile_hw)
    n_win = len(ys4) * len(xs4)
    et, eu = tiled_k1(color4, torch.bfloat16), untiled_k1(color4, torch.bfloat16)
    torch.cuda.synchronize()
    peak = eu.float().abs().max().item()
    rel = (et.float() - eu.float()).abs().max().item() / peak
    del et, eu
    t_tiled = cuda_ms(lambda: tiled_k1(color4, torch.bfloat16))
    t_whole = cuda_ms(lambda: untiled_k1(color4, torch.bfloat16))
    print(f"phase 3: gabor_energies_fused [{tag4} bf16, {n_win} windows, pool {g4.pool}] "
          f"tiled against untiled plus pooling (a reading of the tiling's cost): err "
          f"{rel:.3e} of the peak (K1's bound 2e-2), tiled {t_tiled:.3f} ms, untiled "
          f"{t_whole:.3f} ms ({card})", flush=True)
    check(rel <= 2e-2, "tiled K1 disagrees with untiled K1 at config4")
    torch.cuda.empty_cache()
    for dt in (torch.bfloat16, torch.float32):
        c1 = color4[:1]
        ek, ep = tiled_k1(c1, dt), tiled_plain(c1, dt)
        torch.cuda.synchronize()
        peak = ep.float().abs().max().item()
        abs_err = (ek.float() - ep.float()).abs().max().item()
        tol, dname = (1e-4, "f32") if dt == torch.float32 else (2e-2, "bf16")
        report("gabor_energies_fused", f"config4 1x2160x3840 {dname} tiled, {n_win} "
               f"windows, pool {g4.pool}, against the plain tiled path",
               abs_err, abs_err / peak, f"{tol}*peak={tol * peak:.4g}", abs_err <= tol * peak,
               lambda: tiled_k1(c1, dt), lambda: tiled_plain(c1, dt))
    del color4, ek, ep
    torch.cuda.empty_cache()

    # the modulated route, plain torch and float32 energies, which the
    # reference's graph stage takes at batch 1 and in float32: the energies
    # of the config3 and config4 float32 batches (a reading, not a kernel),
    # beside K1's route for the same frames in bf16
    for cfg_m, rgb_m, where, reps in ((cfg3, rgb8, tag3, 5), (cfg4, rgb4, tag4, 2)):
        x_m = torch.from_numpy(rgb_m).to(dev)
        bank_m = make_bank(cfg_m.bank)
        pool_m = cfg_m.graph.pool
        mcfg = cfg_m.replace(dtype="float32", feature_impl="modulated")
        kcfg = cfg_m.replace(dtype="bfloat16")
        t_mod = cuda_ms(lambda: pl.compute_energies(x_m, mcfg, bank_m, pool_m), reps=reps)
        t_k1 = cuda_ms(lambda: pl.compute_energies(x_m, kcfg, bank_m, pool_m), reps=reps)
        print(f"phase 3: modulated route [{where} f32, pool {pool_m}] energies "
              f"(colour transform included) {t_mod:.3f} ms, K1's route in bf16 {t_k1:.3f} ms "
              f"(readings, median of {reps}) ({card})", flush=True)
        del x_m
    torch.cuda.empty_cache()

    # ---- phase 4: end to end ----------------------------------------------
    def moments_t_plain(idx, feats_t, n_sp, dtype=torch.bfloat16):
        return gm.superpixel_moments_plain(idx, feats_t.to(dtype), n_sp, True)

    @contextlib.contextmanager
    def fused_prep(on):
        """models/gmm_fused.py's _FUSED_PREP switch set to ``on``."""
        saved = gf._FUSED_PREP
        gf._FUSED_PREP = on
        try:
            yield
        finally:
            gf._FUSED_PREP = saved

    def coarse_plain(xq, k, d, m, iters):
        """The warm start's all-plain route: K3's plain version, or past K3's
        rows the blocked route, whose K6 and K5 plain_kernels swaps for
        their plain versions."""
        if kf.coarse_route(d) == "k3":
            return kf.kmeans_coarse_centers_xp_plain(xq, k, d, m, iters)
        return kf.kmeans_coarse_centers_xp(xq, k, d, m, iters)

    def slic_batch_plain(lab, n_superpixels, ruler=10.0, n_iter=10, impl="auto"):
        """The graph stage's SLIC call on K11's plain version (every route
        gives its labels)."""
        return sl.slic_plain(lab, n_superpixels, ruler, n_iter)

    @contextlib.contextmanager
    def plain_kernels(keep=()):
        """Route the pipeline through the plain versions (on the card), but
        for the wrappers named in ``keep``."""
        swaps = [(pl, "gabor_energies_fused", fused.gabor_energies_fused_plain),
                 (tiled, "gabor_energies_fused", fused.gabor_energies_fused_plain),
                 (pl, "kmeans_coarse_centers_xp", coarse_plain),
                 (kc, "lloyd_chw_pass", kc.lloyd_chw_pass_plain),
                 (kc, "maximin_chw_pass", kc.maximin_chw_pass_plain),
                 (kf, "lloyd_t_pass", kf.lloyd_t_pass_plain),
                 (kf, "maximin_t_pass", kf.maximin_t_pass_plain),
                 (gf, "em_pass", gf.em_pass_plain),
                 (chol, "precision_chol", chol.precision_chol_plain),
                 (gf, "precision_chol_params", chol.precision_chol_params_plain),
                 (gr, "slic_batch", slic_batch_plain),
                 (gr, "enforce_connectivity_fused", sl.enforce_connectivity_plain),
                 (gr, "table_lookup", lookup.table_lookup_plain),
                 (gr, "superpixel_moments_fused_t", moments_t_plain)]
        swaps = [(mod, name, fn) for mod, name, fn in swaps if name not in keep]
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            yield
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)

    def aligned_agreement(pred: np.ndarray, ref: np.ndarray) -> float:
        """Share of pixels where ``pred``, its ids permuted to match ``ref``
        best (Hungarian, as utils.labels.align_labels), equals ``ref``; the
        contingency from one bincount, which keeps 4K frames quick."""
        from scipy.optimize import linear_sum_assignment

        p, r = pred.reshape(-1).astype(np.int64), ref.reshape(-1).astype(np.int64)
        k = int(max(p.max(), r.max())) + 1
        cont = np.bincount(p * k + r, minlength=k * k).reshape(k, k)
        row, col = linear_sum_assignment(-cont)
        return float(cont[row, col].sum() / p.size)

    def affinity_readings(cfg, rgb):
        """The graph stage's affinity on the card, as ``affinity_matrix``
        builds it from the pipeline's own features and superpixels: per
        image the live superpixels, the median of d2 over the entries the
        median reads (every S x S entry, dead ids included, for S <= 512),
        s2, whether W is 0 between every two live superpixels, and the live
        ids whose W_ii is 1 (d2_ii rounded to exactly 0). Readings: at
        config4 they show why its cut is not determined (ROADMAP "Not
        faults")."""
        g = cfg.graph
        feats, sp, n_sp = pl._graph_front(torch.from_numpy(rgb).to(dev), cfg,
                                          make_bank(cfg.bank))
        means, counts = gr.superpixel_means(feats, sp, n_sp)
        sq = (means * means).sum(dim=2)
        d2 = torch.clamp(sq[:, :, None] - 2.0 * (means @ means.transpose(1, 2))
                         + sq[:, None, :], min=0.0)
        d2m = d2[:, ::4, ::4] if n_sp > 512 else d2
        med = gr._median(d2m.reshape(d2.shape[0], -1))
        s2 = torch.clamp(med, min=1e-12) * g.affinity_sigma_scale
        w = gr.affinity_matrix(means, g.affinity_sigma, counts, g.affinity_sigma_scale)
        live = counts > 0
        pairs = live[:, :, None] & live[:, None, :] & ~torch.eye(n_sp, dtype=torch.bool,
                                                                 device=dev)
        zero = [not bool(w[i][pairs[i]].any()) for i in range(w.shape[0])]
        ones = ((torch.diagonal(w, dim1=1, dim2=2) == 1) & live).sum(dim=1)
        return (n_sp, live.sum(dim=1).tolist(), med.tolist(), s2.tolist(), zero,
                ones.tolist())

    # (config, images, ground truth, label, kernels that must launch,
    # kernels that must not, the _FUSED_PREP switch)
    k1to4 = ["gabor_energies_fused", "lloyd_chw_pass"]
    runs = [(cfg1, rgb16, gt16, "config1 batch 16 bf16", k1to4 + ["kmeans_coarse_centers_xp"],
             [], False),
            (cfg0, rgb1, gt1, "config0 batch 1 f32", k1to4 + ["maximin_chw_pass"], [], False)]
    # config1 with a 160-kernel bank (its bank with two more frequencies):
    # E = 480 energy rows, past the 400 K3 takes, so the warm start takes
    # the blocked route (K6, K5; fault 11), batch 2 in both dtypes
    bank160 = dataclasses.replace(cfg1.bank, frequencies=(0.05, 0.10, 0.20, 0.30))
    check(bank160.n_kernels == 160, "the 160-kernel bank has another size")
    for dtype in ("bfloat16", "float32"):
        runs.append((cfg1.replace(batch_size=2, dtype=dtype, bank=bank160), rgb16[:2], gt16[:2],
                     f"config1 batch 2 {'bf16' if dtype == 'bfloat16' else 'f32'} 160-kernel "
                     "bank (E = 480)", k1to4 + ["maximin_t_pass", "lloyd_t_pass"],
                     ["kmeans_coarse_centers_xp"], False))
    gmm_path = ["gabor_energies_fused", "maximin_t_pass", "lloyd_t_pass", "em_pass"]
    moments_off = ["superpixel_moments_fused", "superpixel_moments_fused_nhwc"]
    graph_path = ["gabor_energies_fused", "slic_w3", "enforce_connectivity_fused",
                  "superpixel_moments_fused_t", "table_lookup"]
    banded_path = ["gabor_energies_fused", "slic_band_pass", "slic_band_update",
                   "enforce_connectivity_fused", "superpixel_moments_fused_t", "table_lookup"]
    for prep in (False, True):
        for dtype in ("bfloat16", "float32"):
            runs.append((cfg2.replace(dtype=dtype), rgb8, gt8,
                         f"config2 batch 8 {'bf16' if dtype == 'bfloat16' else 'f32'}"
                         + (" _FUSED_PREP on" if prep else ""),
                         gmm_path + ["precision_chol_params" if prep else "precision_chol"],
                         ["precision_chol" if prep else "precision_chol_params"], prep))
    # config2 with a 16-kernel bank (4 scales x 4 orientations): D = 51
    # feature rows, past the 40 of K8's first kernel (its wide kernel, K9 at
    # d = 51)
    bank16 = dataclasses.replace(cfg2.bank, scales=(2.0, 3.0, 4.0, 8.0))
    check(bank16.n_kernels == 16, "the 16-kernel bank has another size")
    for dtype in ("bfloat16", "float32"):
        runs.append((cfg2.replace(dtype=dtype, bank=bank16), rgb8, gt8,
                     f"config2 batch 8 {'bf16' if dtype == 'bfloat16' else 'f32'} 16-kernel "
                     "bank (D = 51)", gmm_path + ["precision_chol"], ["precision_chol_params"],
                     False))
    # the graph stage's energies: K1 for bf16 batches, the reference's
    # modulated route (no K1) in float32
    for dtype in ("bfloat16", "float32"):
        bf = dtype == "bfloat16"
        runs.append((cfg3.replace(dtype=dtype), rgb8, gt8,
                     f"config3 batch 8 {'bf16' if bf else 'f32'}",
                     graph_path if bf else graph_path[1:],
                     moments_off + ([] if bf else graph_path[:1]), False))
    for dtype in ("bfloat16", "float32"):
        bf = dtype == "bfloat16"
        runs.append((cfg4.replace(dtype=dtype), rgb4, gt4,
                     f"config4 batch 8 of 2160x3840 {'bf16' if bf else 'f32'}",
                     banded_path if bf else banded_path[1:],
                     ["slic_w3"] + moments_off + ([] if bf else banded_path[:1]), False))
    totals = {name: 0 for name in counters}
    totals["lloyd_pass"] += k7_launches  # K7's path ran in phase 3
    totals["slic_w5"] += k12_launches  # and K12's
    totals["slic_w3"] += f12_launches  # and K11's on the missed-band frame
    outputs = []
    for cfg, rgb, gt, label, path, absent, prep in runs:
        def run():
            with fused_prep(prep):
                labels, _ = pl.segment_batch(rgb, cfg, with_features=False, device="cuda")
            return labels.cpu()

        for wrapper in counters.values():
            wrapper.launches = 0
        modulated.gabor_energies_mod.calls = 0
        t0 = time.perf_counter()
        first = run()
        warm = time.perf_counter() - t0
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            times.append(time.perf_counter() - t0)
        counts = {name: wrapper.launches for name, wrapper in counters.items()}
        mod_calls = modulated.gabor_energies_mod.calls
        ms = statistics.median(times) * 1e3
        mp = rgb.shape[0] * rgb.shape[1] * rgb.shape[2] / 1e6 / (ms / 1e3)
        check(torch.equal(out, first), f"{label}: labels differ between runs")
        outputs.append((cfg, rgb, gt, label, out, prep, ms))
        print(f"phase 4: {label}: {ms:.2f} ms/batch (median of 5, first call "
              f"{warm:.2f} s), {mp:.2f} MP/s, host uint8 in -> host int32 labels "
              f"out, {card}", flush=True)
        print(f"phase 4: {label}: launches in its 6 calls "
              f"{ {name: counts[name] for name in path + absent} }, modulated route calls "
              f"{mod_calls}", flush=True)
        mod_route = cfg.graph.enabled and cfg.dtype == "float32"
        check((mod_calls > 0) == mod_route,
              f"{label}: the modulated route ran {mod_calls} times, expected "
              f"{'some' if mod_route else 'none'}")
        for name in path:
            check(counts[name] > 0, f"{name} was never launched on the {label} path")
            totals[name] += counts[name]
        for name in absent:
            check(counts[name] == 0, f"{name} was launched on the {label} path")
        if cfg.graph.enabled and cfg.graph.pool:
            n_sp, live, med, s2, zero, ones = affinity_readings(cfg, rgb)
            print(f"phase 4: {label}: the affinity (readings, after the counts were read): "
                  f"live superpixels per image {live} of {n_sp}, "
                  f"median of d2 {med}, s2 {s2}, W zero between every two live superpixels "
                  f"{zero}, live ids with W_ii = 1 {ones} ({card})", flush=True)

    # the host-side min-cut route, with tests/test_pipeline_configs.py's pins
    # on its fixture (two 96x128 mosaics of 4 regions, seeds 20 and 21)
    cfg_mc = cfg3.replace(batch_size=2, graph=GraphConfig(
        enabled=True, n_superpixels=64, cut="mincut", mincut_k=15.0, mincut_min_size=2))
    rgb_mc = np.stack([synthetic_mosaic(h=96, w=128, n_regions=4, seed=20 + i)[0]
                       for i in range(2)])
    for wrapper in counters.values():
        wrapper.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_mc = pl.segment_images(rgb_mc, cfg_mc, device="cuda").cpu()
    mc_ms = (time.perf_counter() - t0) * 1e3
    counts = {name: wrapper.launches for name, wrapper in counters.items()}
    mc_path = ["gabor_energies_fused", "slic_w3", "enforce_connectivity_fused"]
    with plain_kernels(keep=("gabor_energies_fused",)):
        ref_mc = pl.segment_images(rgb_mc, cfg_mc, device="cuda").cpu().numpy()
    each = [aligned_agreement(out_mc[i].numpy(), ref_mc[i]) for i in range(2)]
    print(f"phase 4: config3 min-cut batch 2 of 96x128 f32 (segment_images): "
          f"{mc_ms:.2f} ms (first call), launches "
          f"{ {name: counts[name] for name in mc_path} }, regions per image "
          f"{[len(np.unique(o)) for o in out_mc.numpy()]}, against the plain graph stage "
          f"on K1's energies "
          f"{[round(v, 6) for v in each]} (floor 0.999), {card}", flush=True)
    check(out_mc.dtype == torch.int32 and tuple(out_mc.shape) == rgb_mc.shape[:3]
          and int(out_mc.min()) >= 0 and min(each) >= 0.999, "config3 min-cut: bad labels")
    for name in mc_path:
        check(counts[name] > 0, f"{name} was never launched on the config3 min-cut path")
        totals[name] += counts[name]

    switch_off = {(cfg.cluster.method, cfg.dtype, cfg.bank): (o, t)
                  for cfg, _, _, _, o, prep, t in outputs if not cfg.graph.enabled and not prep}
    for cfg, rgb, gt, label, out, prep, ms in outputs:
        check(out.dtype == torch.int32 and tuple(out.shape) == rgb.shape[:3],
              f"{label}: labels {out.dtype} {tuple(out.shape)}")
        n_labels = cfg.graph.n_regions if cfg.graph.enabled else cfg.cluster.k
        check(int(out.min()) >= 0 and int(out.max()) < n_labels,
              f"{label}: labels outside [0, {n_labels})")
        floor = 0.99 if cfg.dtype == "bfloat16" else 0.999
        if prep:
            # the gate: the switch on against the switch off, both through
            # the kernels; the times both ways are a reading
            ref, ms_off = switch_off[(cfg.cluster.method, cfg.dtype, cfg.bank)]
            each = [aligned_agreement(out[i].numpy(), ref[i].numpy()) for i in range(len(ref))]
            print(f"phase 4: {label}: against _FUSED_PREP off, min aligned agreement "
                  f"{min(each):.6f} (floor {floor}; per image {[round(v, 6) for v in each]}); "
                  f"{ms:.2f} ms/batch on, {ms_off:.2f} off (a reading), {card}", flush=True)
            check(min(each) >= floor, f"{label}: disagrees with _FUSED_PREP off")
            continue

        def agreement(keep=()):
            with plain_kernels(keep):
                ref, _ = pl.segment_batch(rgb, cfg, with_features=False, device="cuda")
            ref = ref.cpu().numpy()
            return [aligned_agreement(out[i].numpy(), ref[i]) for i in range(len(ref))]

        note = GRAPH_NOTE if cfg.graph.enabled else ""
        each = agreement()
        print(f"phase 4: {label}: kernel path vs all-plain path on the card, "
              f"min aligned agreement {min(each):.6f} (floor {floor}{note}; per image "
              f"{[round(v, 6) for v in each]})", flush=True)
        if cfg.graph.enabled:
            # the gate: both paths from the same energies (K1's in bf16, the
            # modulated route's in f32), so the comparison holds K11 or K13,
            # K14, K15 and the plain n-cut around them
            each = agreement(keep=("gabor_energies_fused",))
            print(f"phase 4: {label}: kernel path vs the plain graph stage on the same "
                  f"energies, min aligned agreement {min(each):.6f} (floor {floor}; per "
                  f"image {[round(v, 6) for v in each]})", flush=True)
        check(min(each) >= floor, f"{label}: kernel path disagrees with the plain path")
        pri = [rand_index_np(out[i].numpy(), gt[i]) for i in range(len(gt))]
        print(f"phase 4: {label}: Rand index against the mosaics' ground truth, "
              f"mean {statistics.mean(pri):.4f}, min {min(pri):.4f} (a reading; "
              f"the gate is the agreement above)", flush=True)

    # a reading: config2's bf16 labels against its f32 labels on the same
    # mosaics (the reference's own measure of a stable image; its CPU run
    # reads 0.986535 on seed 107, a borderline image)
    by_label = {label: out for _, _, _, label, out, _, _ in outputs}
    lo, hi = by_label["config2 batch 8 bf16"], by_label["config2 batch 8 f32"]
    each = [aligned_agreement(lo[i].numpy(), hi[i].numpy()) for i in range(len(hi))]
    print(f"phase 4: config2 batch 8: bf16 labels vs f32 labels on the card, min aligned "
          f"agreement {min(each):.6f} (per image, seeds 100-{99 + len(each)}: "
          f"{[round(v, 6) for v in each]}; under 0.99: seeds "
          f"{[100 + i for i, v in enumerate(each) if v < 0.99]}; a reading), {card}",
          flush=True)

    # ---- phase 5: where the time goes -------------------------------------
    os.makedirs(out_dir, exist_ok=True)
    for cfg, rgb, label, prep in (
            (cfg1, rgb16, "config1 batch 16 bf16", False),
            (cfg2.replace(dtype="bfloat16"), rgb8, "config2 batch 8 bf16", False),
            (cfg2.replace(dtype="bfloat16"), rgb8, "config2 batch 8 bf16 _FUSED_PREP on", True),
            (cfg3.replace(dtype="bfloat16"), rgb8, "config3 batch 8 bf16", False),
            (cfg3, rgb8, "config3 batch 8 f32", False),
            (cfg4.replace(dtype="bfloat16"), rgb4, "config4 batch 8 bf16", False)):
        with fused_prep(prep):
            pl.segment_batch(rgb, cfg, with_features=False, device="cuda")
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                pl.segment_batch(rgb, cfg, with_features=False, device="cuda")[0].cpu()
                wall = (time.perf_counter() - t0) * 1e3
        events = prof.key_averages()
        device_ms = sum(ev.self_device_time_total for ev in events  # kernels only
                        if ev.device_type == DeviceType.CUDA
                        and not getattr(ev, "is_user_annotation", False)) / 1e3
        table = events.table(sort_by="self_cuda_time_total", row_limit=15)
        name = "_".join(label.split()[:4][::3]) + ("_prep" if prep else "")  # config3_bf16
        with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
            f.write(f"{label} ({card})\n{events.table(sort_by='self_cuda_time_total')}")
        print(f"phase 5: one {label} call under torch.profiler ({card}): device time "
              f"{device_ms:.2f} ms of {wall:.2f} ms host to host, idle share "
              f"{1 - device_ms / wall:.3f}")
        print(table, flush=True)

    # ---- phase 6: the evaluation surface ----------------------------------
    import io

    from gabor_color_image_segmentation_tpu_torch import cli
    from gabor_color_image_segmentation_tpu_torch import eval as ev
    from gabor_color_image_segmentation_tpu_torch.metrics import boundary as mb
    from gabor_color_image_segmentation_tpu_torch.metrics import pri as mpri
    from gabor_color_image_segmentation_tpu_torch.metrics import region as mreg

    t6 = time.perf_counter()
    split = ev.load_split("test", limit=8)
    check(len(split) == 8 and all(rgb.shape == (321, 481, 3) and len(gts) == 3
                                  for _, rgb, gts in split),
          "load_split('test', limit=8) did not give eight 321x481 images with 3 ground truths")
    tol6 = mb.default_tolerance(321, 481)
    cells6 = (("config1 bf16 batch 8", cfg1.replace(batch_size=8),
               ["gabor_energies_fused", "kmeans_coarse_centers_xp", "lloyd_chw_pass"]),
              ("config0 f32 batch 1", cfg0,
               ["gabor_energies_fused", "maximin_chw_pass", "lloyd_chw_pass"]))
    # the rows' host metrics, recomputed from segment_images' labels for the
    # same batches in worker processes after each evaluation (the optimal
    # matcher, scipy's maximum_bipartite_matching, takes ~100 s on one
    # ground truth of one of these images at config0, in the loop and again
    # here; checking beside the loop took no less on the card and slowed the
    # loop's reading)
    checkers = ProcessPoolExecutor(max_workers=len(split),
                                   mp_context=multiprocessing.get_context("spawn"))
    evals = []
    for label, cfg, path in cells6:
        rows_path = os.path.join(out_dir, f"eval_{label.split()[0]}.jsonl")
        if os.path.exists(rows_path):
            os.remove(rows_path)
        for wrapper in counters.values():
            wrapper.launches = 0
        summary = ev.evaluate(split, cfg, out_path=rows_path, device="cuda")
        counts = {name: counters[name].launches for name in path}
        with open(rows_path) as f:
            rows = [json.loads(line) for line in f]
        check(summary["n_failed"] == 0 and summary["n_images"] == len(rows) == len(split),
              f"phase 6 {label}: {summary['n_failed']} of {summary['n_images']} images failed")
        for name in path:
            check(counts[name] > 0, f"{name} was never launched on the {label} evaluation")
            totals[name] += counts[name]
        labels = np.concatenate([
            pl.segment_images(np.stack([c[1] for c in chunk]), cfg, device="cuda").cpu().numpy()
            for chunk in ev._batches(split, cfg.batch_size)])
        futures = [checkers.submit(host_metrics, labels[i], split[i][2])
                   for i in range(len(split))]
        # the tensor metrics on the card against the host ones, on these labels
        errs = {"rand_index": 0.0, "voi": 0.0, "covering": 0.0, "f_boundary (dilated)": 0.0}
        for lab_i, (_, _, gts) in zip(labels, split):
            lab_d = torch.from_numpy(lab_i).to(dev)
            for g in gts:
                g_d = torch.from_numpy(g).to(dev)
                n_p, n_g = cfg.cluster.k, int(g.max()) + 1
                for key, fn, ref in (("rand_index", mpri.rand_index_torch, mpri.rand_index_np),
                                     ("voi", mreg.voi_torch, mreg.voi_np),
                                     ("covering", mreg.covering_torch, mreg.covering_np)):
                    errs[key] = max(errs[key], abs(fn(lab_d, g_d, n_p, n_g).item()
                                                   - ref(lab_i, g)))
                got = mb.fboundary_torch(lab_d, g_d, tol6).tolist()
                want = mb.fboundary_dilated_np(lab_i, g, tol6)
                errs["f_boundary (dilated)"] = max(errs["f_boundary (dilated)"],
                                                   *(abs(a - b) for a, b in zip(got, want)))
        print(f"phase 6: {label} metrics on the card against the host ones, max abs "
              f"difference { {k: float(f'{v:.3e}') for k, v in errs.items()} } (bounds "
              f"1e-12, dilated F 0) ({card})", flush=True)
        check(max(errs["rand_index"], errs["voi"], errs["covering"]) <= 1e-12
              and errs["f_boundary (dilated)"] == 0,
              f"phase 6 {label}: the card's tensor metrics disagree with the host ones")
        evals.append((label, summary, rows, labels, futures, counts))
    for label, summary, rows, labels, futures, counts in evals:
        for row, fut, (image_id, _, _), lab_i in zip(rows, futures, split, labels):
            want = fut.result()
            want.update(id=image_id, n_regions=int(len(np.unique(lab_i))))
            check(row == want, f"phase 6 {label}: row {image_id} {row} is not the host "
                  f"metrics of segment_images' labels {want}")
        print(f"phase 6: {label} eval.evaluate over load_split('test', limit=8) on the card: "
              f"n_failed {summary['n_failed']}, every row equal to the host metrics of "
              f"segment_images' labels; launches {counts}; readings: mean PRI "
              f"{summary['mean_pri']:.4f}, mean boundary F {summary['mean_f_boundary']:.4f}, "
              f"mean VoI {summary['mean_voi']:.4f}, mean covering "
              f"{summary['mean_covering']:.4f}, the loop's {summary['mp_per_s']:.3f} MP/s "
              f"(host metrics included, {summary['wall_s']:.2f} s) ({card})", flush=True)
    checkers.shutdown()
    outs = []
    for argv in (["info", "--preset", "config1"], ["run", "--preset", "config0", "--device",
                                                   "cuda"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        outs.append(json.loads(buf.getvalue()))
    info, run = outs
    check(info["preset"] == "config1" and info["n_kernels"] == 80
          and info["feature_dim"] == 243, f"cli info: {info}")
    check(run["shape"] == [321, 481] and 1 <= run["n_regions"] <= 5
          and run["preset"] == "config0", f"cli run: {run}")
    print(f"phase 6: cli info --preset config1: {info['n_kernels']} kernels, feature_dim "
          f"{info['feature_dim']}; cli run --preset config0 --device cuda: {run}; phase 6 "
          f"took {time.perf_counter() - t6:.1f} s ({card})", flush=True)

    # ---- phase 7: the with-features path ----------------------------------
    t7 = time.perf_counter()
    torch.cuda.empty_cache()

    def zero_counts():
        for wrapper in counters.values():
            wrapper.launches = 0

    def feature_err(got, ref):
        """The reference's feature measure: max |got - ref| / max |ref|."""
        g, r = got.float(), ref.float()
        return ((g - r).abs().max() / r.abs().max()).item()

    def with_features_cell(cfg, rgb, label, path, absent, fbound, reps=5, keep=None,
                           plain=True, labels_gate=True):
        """``segment_batch(rgb, cfg)`` (with features) on the card: the first
        call and ``reps`` timed calls (host uint8 in, labels on the host, the
        features left on the card) with the counts set to 0 just before and
        read just after, every kernel of ``path`` launched and none of
        ``absent``; against the all-plain path on the card (with ``keep``,
        also against the plain versions but for ``keep``, the gate then),
        labels after alignment and the features by the reference's measure
        (``fbound`` of the largest |feature|); with ``labels_gate`` False the
        labels' agreement is a reading and the features alone the gate.
        Returns (labels, features, ms)."""
        def run():
            labels, feats = pl.segment_batch(rgb, cfg, device="cuda")
            return labels.cpu(), feats

        zero_counts()
        t0 = time.perf_counter()
        out, feats = run()
        warm = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again, _ = run()
            times.append(time.perf_counter() - t0)
        calls = reps + 1
        counts = {name: counters[name].launches for name in path + absent}
        check(torch.equal(out, again), f"phase 7 {label}: labels differ between runs")
        ms = statistics.median(times) * 1e3
        print(f"phase 7: {label}: {ms:.2f} ms/batch (median of {reps}, first call {warm:.2f} "
              f"s), host uint8 in -> host int32 labels out, features (B, H, W, D) "
              f"{tuple(feats.shape)} {feats.dtype} left on the card; launches a call "
              f"{ {n: round(c / calls, 2) for n, c in counts.items()} } ({card})", flush=True)
        for name in path:
            check(counts[name] > 0, f"{name} was never launched on the phase 7 {label} path")
            totals[name] += counts[name]
        for name in absent:
            check(counts[name] == 0, f"{name} was launched on the phase 7 {label} path")
        check(torch.isfinite(feats.float()).all().item(), f"phase 7 {label}: features not finite")
        n_labels = cfg.graph.n_regions if cfg.graph.enabled else cfg.cluster.k
        check(out.dtype == torch.int32 and tuple(out.shape) == rgb.shape[:3]
              and int(out.min()) >= 0 and int(out.max()) < n_labels,
              f"phase 7 {label}: labels {out.dtype} {tuple(out.shape)} outside [0, {n_labels})")
        if not plain:
            return out, feats, ms
        floor = 0.99 if cfg.dtype == "bfloat16" else 0.999
        gates = [((), "the all-plain path")] + ([(keep, f"the plain path but {keep}")]
                                               if keep else [])
        for kept, what in gates:
            with plain_kernels(kept):
                ref_l, ref_f = pl.segment_batch(rgb, cfg, device="cuda")
            each = [aligned_agreement(out[i].numpy(), ref_l[i].cpu().numpy())
                    for i in range(len(out))]
            ferr = feature_err(feats, ref_f)
            gate = kept == (keep or ())
            lgate = gate and labels_gate
            print(f"phase 7: {label}: kernel path vs {what} on the card, min aligned "
                  f"agreement {min(each):.6f} (floor {floor}{'' if lgate else ', a reading'}; "
                  f"per image {[round(v, 6) for v in each]}), features max |d| / max |ref| "
                  f"{ferr:.3e} (bound {fbound}{'' if gate else ', a reading'}), bit-equal "
                  f"{torch.equal(feats, ref_f)} ({card})", flush=True)
            if gate:
                check((min(each) >= floor or not labels_gate) and ferr <= fbound,
                      f"phase 7 {label}: the kernel path disagrees with {what}")
            del ref_f
        return out, feats, ms

    with_feat_kmeans = ["gabor_energies_fused", "maximin_t_pass", "lloyd_t_pass"]
    chw_kernels = ["lloyd_chw_pass", "maximin_chw_pass", "kmeans_coarse_centers_xp"]
    # config1 batch 16 bf16, full width (D = 243): K1, then the transposed
    # solver's multigrid branch (K6 seeds and K5 passes on the 4x4-pooled
    # buffer, K5 on the 2x2 one and at full resolution)
    lab1, feats1, _ = with_features_cell(cfg1, rgb16, "config1 batch 16 bf16 with features",
                                         with_feat_kmeans, chw_kernels + ["em_pass"], 2e-2)
    del feats1
    only1 = pl.segment_batch(rgb16, cfg1, with_features=False, device="cuda")[0].cpu()
    each = [aligned_agreement(lab1[i].numpy(), only1[i].numpy()) for i in range(16)]
    print(f"phase 7: config1 batch 16 bf16: with-features labels vs the labels-only path's "
          f"(K1 twin, K3, K2: another assembly and solver), min aligned agreement "
          f"{min(each):.6f}, mean {statistics.mean(each):.6f} (a reading) ({card})", flush=True)
    # config2 batch 8 bf16: gmm_fused_t on the flat features (K6, K5, K9, K8)
    cfg2b = cfg2.replace(dtype="bfloat16")
    lab2, feats2, _ = with_features_cell(
        cfg2b, rgb8, "config2 batch 8 bf16 with features",
        with_feat_kmeans + ["precision_chol", "em_pass"], chw_kernels, 2e-2)
    del feats2
    only2 = pl.segment_batch(rgb8, cfg2b, with_features=False, device="cuda")[0].cpu()
    each = [aligned_agreement(lab2[i].numpy(), only2[i].numpy()) for i in range(8)]
    print(f"phase 7: config2 batch 8 bf16: with-features labels vs the labels-only path's, "
          f"min aligned agreement {min(each):.6f}, mean {statistics.mean(each):.6f} (a "
          f"reading) ({card})", flush=True)
    torch.cuda.empty_cache()
    # config0 on one 4K frame in f32, windowed: K1 on 25 windows, then
    # kmeans_fused_t at N = 8,294,400, D = 39
    cfg0k = cfg0.replace(tile_hw=(432, 768))
    with_features_cell(cfg0k, rgb4[:1], "config0 1x2160x3840 f32 tile (432, 768) with features",
                       with_feat_kmeans, chw_kernels, 1e-4, reps=2)
    torch.cuda.empty_cache()
    # K5 and K6 on the largest buffer the route hands them: (1, 243,
    # 8,294,400) bf16, D * N = 2.02e9 elements. Five regions of the pixels
    # lie 3 apart on their own rows, five pixels planted 50 ... 30 out on
    # rows 200 ... 204: the seeds are the planted pixels by wide margins
    n4k = 2160 * 3840
    xb = torch.randn((1, 243, n4k), device=dev, dtype=torch.bfloat16,
                     generator=torch.Generator(device=dev).manual_seed(17))
    xb.mul_(0.1)
    bounds = [r * n4k // 5 for r in range(6)]
    for r in range(5):
        xb[:, 40 * r, bounds[r]:bounds[r + 1]] += 3.0
    planted = [j * n4k // 5 + 12345 for j in range(5)]
    for j, p_j in enumerate(planted):
        xb[:, 200 + j, p_j] = 50.0 - 5.0 * j
    probe_k = probe_p = xb.mean(dim=2, dtype=torch.float32)
    dk7 = torch.zeros((1, n4k), device=dev)
    dp7 = torch.zeros((1, n4k), device=dev)
    seeds7, same7, err7 = [], True, 0.0
    for step in range(5):
        probe_k = kf.maximin_t_pass(xb, probe_k, dk7, step < 2)
        probe_p = kf.maximin_t_pass_plain(xb, probe_p, dp7, step < 2)
        torch.cuda.synchronize()
        same7 = same7 and torch.equal(probe_k, probe_p)
        err7 = max(err7, ((dk7 - dp7).abs().max() / dp7.abs().max()).item())
        seeds7.append(probe_k)
    ms6 = cuda_ms(lambda: kf.maximin_t_pass(xb, probe_k, dk7, False))
    ms6p = cuda_ms(lambda: kf.maximin_t_pass_plain(xb, probe_p, dp7, False), reps=3)
    seed_rows = torch.stack(seeds7, dim=1)[0, :, 200:205]
    want_rows = torch.tensor([[50.0 - 5.0 * j if i == j else 0.0 for i in range(5)]
                              for j in range(5)], device=dev)
    print(f"phase 7: maximin_t_pass [(1, 243, {n4k}) bf16, D * N = {243 * n4k:.3e}] five "
          f"steps: same pixels as the plain version {same7}, the planted pixels in order "
          f"{bool(((seed_rows - want_rows).abs() < 1.0).all())}, running minima within "
          f"{err7:.3e} of the largest distance (bound 1e-5); kernel {ms6:.4f} ms, plain "
          f"{ms6p:.4f} ms, bytes bound {bound(n4k * (243 * 2 + 8), 0)[0]:.4f} ms ({card})",
          flush=True)
    check(same7 and err7 <= 1e-5 and bool(((seed_rows - want_rows).abs() < 1.0).all()),
          "phase 7: maximin_t_pass disagrees with its plain version at (1, 243, 8294400)")
    centers7 = torch.zeros((1, 5, 243), device=dev)
    for r in range(5):
        centers7[0, r, 40 * r] = 3.0
    lk7, sk7, nk7 = kf.lloyd_t_pass(xb, centers7)
    lp7, sp7, np7 = kf.lloyd_t_pass_plain(xb, centers7)
    again7 = kf.lloyd_t_pass(xb, centers7)
    torch.cuda.synchronize()
    bits7 = all(torch.equal(a, g) for a, g in zip(again7, (lk7, sk7, nk7)))
    eq7 = (lk7 == lp7).float().mean().item()
    serr7 = ((sk7 - sp7).abs().max() / sp7.abs().max()).item()
    ms5 = cuda_ms(lambda: kf.lloyd_t_pass(xb, centers7))
    ms5p = cuda_ms(lambda: kf.lloyd_t_pass_plain(xb, centers7), reps=3)
    print(f"phase 7: lloyd_t_pass [(1, 243, {n4k}) bf16] labels equal {eq7:.6f} (floor "
          f"0.9999), counts equal {torch.equal(nk7, np7)}, sums within {serr7:.3e} of their "
          f"largest (bound 1e-3), two launches bit-equal {bits7}; kernel {ms5:.4f} ms, plain "
          f"{ms5p:.4f} ms, bytes bound {bound(n4k * (243 * 2 + 4), 0)[0]:.4f} ms ({card})",
          flush=True)
    check(eq7 >= 0.9999 and torch.equal(nk7, np7) and serr7 <= 1e-3 and bits7,
          "phase 7: lloyd_t_pass disagrees with its plain version at (1, 243, 8294400)")
    del xb, dk7, dp7, lk7, lp7, again7
    torch.cuda.empty_cache()
    # config3 batch 8 bf16 with the coherence cue weights: the gate hands
    # both paths K1's energies (GRAPH_NOTE), the all-plain path a reading
    cfg3c = cfg3.replace(dtype="bfloat16", cluster=dataclasses.replace(
        cfg3.cluster, cue_weight="coherence", coherence_pow=4.0))
    with_features_cell(cfg3c, rgb8, "config3 batch 8 bf16 coherence with features",
                       graph_path, ["slic_band_pass", "lloyd_t_pass"], 2e-2,
                       keep=("gabor_energies_fused",))
    # config4 with features at its published geometry, batch 2 of 2160x3840
    # bf16 (K1 on 25 windows a frame, K13, K14, K17, K15): its labels
    # bit-equal to the labels-only path's, its pooled (2, 540, 960, 39)
    # features against the all-plain path; the labels against the all-plain
    # path are a reading (config4's cut is not determined by its features,
    # GRAPH_NOTE)
    cfg4f = cfg4.replace(batch_size=2, dtype="bfloat16")
    lab4f, feats4f, _ = with_features_cell(
        cfg4f, rgb4[:2], "config4 batch 2 of 2160x3840 bf16 with features", banded_path,
        ["slic_w3"] + moments_off, 2e-2, reps=3, labels_gate=False)
    check(tuple(feats4f.shape) == (2, 540, 960, 39) and feats4f.dtype == torch.bfloat16,
          f"phase 7 config4: features {tuple(feats4f.shape)} {feats4f.dtype}")
    only4 = pl.segment_batch(rgb4[:2], cfg4f, with_features=False, device="cuda")[0].cpu()
    same4 = torch.equal(lab4f, only4)
    print(f"phase 7: config4 batch 2 of 2160x3840 bf16: with-features labels bit-equal to the "
          f"labels-only path's {same4} (the gate) ({card})", flush=True)
    check(same4, "phase 7 config4: the with-features labels differ from the labels-only path's")
    del feats4f, lab4f, only4
    torch.cuda.empty_cache()
    # config1 with k = 10: the plain solver (kmeans_multigrid) on the card
    cfg1k = cfg1.replace(cluster=dataclasses.replace(cfg1.cluster, k=10))
    with_features_cell(cfg1k, rgb16, "config1 batch 16 bf16 k=10 with features (the plain "
                       "solver, a reading)", ["gabor_energies_fused"],
                       ["maximin_t_pass", "lloyd_t_pass"] + chw_kernels, 2e-2, plain=False)
    torch.cuda.empty_cache()
    print(f"phase 7 took {time.perf_counter() - t7:.1f} s ({card})", flush=True)

    # ---- phase 8: parallel/ on meshes of repeated cuda:0 shards -----------
    t8 = time.perf_counter()
    from gabor_color_image_segmentation_tpu_torch.parallel import tiled_graph as tg8
    from gabor_color_image_segmentation_tpu_torch.parallel import tiling as tl8
    from gabor_color_image_segmentation_tpu_torch.parallel.mesh import Mesh
    from gabor_color_image_segmentation_tpu_torch.parallel.sharding import (
        make_mesh,
        segment_batch_sharded,
    )

    def phase8_counts(path, absent, label, calls=1):
        """Read the counts of the run just made: every kernel of ``path``
        launched, none of ``absent``; all of them added to the totals."""
        counts = {name: wrapper.launches for name, wrapper in counters.items()}
        for name in path:
            check(counts[name] > 0, f"{name} was never launched on the phase 8 {label} path")
        for name in absent:
            check(counts[name] == 0, f"{name} was launched on the phase 8 {label} path")
        for name in totals:
            totals[name] += counts[name]
        return {name: round(counts[name] / calls, 2) for name in path}

    # (a) the data-parallel leg: each shard runs segment_batch on its images;
    # its labels must be segment_batch's run shard by shard, bit for bit
    mesh8 = make_mesh(8, devices=[dev] * 8)
    cfg3b = cfg3.replace(dtype="bfloat16")
    dp_runs = [(cfg1, rgb16, "config1 batch 16 bf16", {
                   False: (["gabor_energies_fused", "kmeans_coarse_centers_xp",
                            "lloyd_chw_pass"], ["lloyd_t_pass"]),
                   True: (["gabor_energies_fused", "maximin_t_pass", "lloyd_t_pass"],
                          ["lloyd_chw_pass"])}),
               (cfg3b, rgb8, "config3 batch 8 bf16", {
                   wf: (["slic_w3", "enforce_connectivity_fused", "superpixel_moments_fused_t",
                         "table_lookup"], ["gabor_energies_fused"]) for wf in (False, True)})]
    for cfg, rgb, label, paths in dp_runs:
        for wf in (False, True):
            tagd = f"{label} over 8 batch shards, {'with' if wf else 'without'} features"
            zero_counts()
            modulated.gabor_energies_mod.calls = 0
            mesh8.reset_counts()
            t0 = time.perf_counter()
            lab_s, feat_s = segment_batch_sharded(rgb, cfg, None, mesh8, wf)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            mod_calls = modulated.gabor_energies_mod.calls
            per = phase8_counts(*paths[wf], tagd)
            colls = dict(mesh8.collectives)
            bl = rgb.shape[0] // 8
            ref = [pl.segment_batch(rgb[i * bl:(i + 1) * bl], cfg, with_features=wf,
                                    device=dev) for i in range(8)]
            same_l = torch.equal(lab_s, torch.cat([r[0] for r in ref]))
            same_f = (not wf) or torch.equal(feat_s, torch.cat([r[1] for r in ref]))
            whole = pl.segment_batch(rgb, cfg, with_features=wf, device=dev)[0].cpu()
            each = [aligned_agreement(lab_s[i].cpu().numpy(), whole[i].numpy())
                    for i in range(rgb.shape[0])]
            print(f"phase 8: segment_batch_sharded [{tagd}]: labels{' and features' if wf else ''}"
                  f" bit-equal to segment_batch shard by shard {same_l and same_f}, collectives "
                  f"{colls}, launches {per}, modulated route calls {mod_calls}; against the "
                  f"whole-batch call min aligned agreement {min(each):.6f} (a reading: the "
                  f"local batch of {bl} picks the routes); {ms:.1f} ms (first call, a reading) "
                  f"({card})", flush=True)
            check(same_l and same_f, f"phase 8 {tagd}: labels differ from segment_batch "
                  "shard by shard")
            check(not any(colls.values()), f"phase 8 {tagd}: the DP leg called collectives")
            check(int(lab_s.min()) >= 0 and tuple(lab_s.shape) == rgb.shape[:3],
                  f"phase 8 {tagd}: labels outside the expected shape or range")
            del ref, lab_s, feat_s
    torch.cuda.empty_cache()

    # (b) segment_tiled: the real config1 bank on one 320x480 frame over 8
    # space shards (40-row strips > the 24-row halo), the modulated route,
    # against the port's untiled segment_image
    cfg1t = preset("config1").replace(feature_impl="modulated")
    rgb_t, _ = synthetic_mosaic(h=320, w=480, n_regions=5, seed=77)
    space8 = Mesh([dev] * 8, ("space",))
    zero_counts()
    space8.reset_counts()
    t0 = time.perf_counter()
    tiled_l = tl8.segment_tiled(rgb_t, cfg1t, None, space8)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    per = phase8_counts(["lloyd_t_pass"], ["gabor_energies_fused", "maximin_t_pass"],
                        "segment_tiled config1")
    colls = dict(space8.collectives)
    zero_counts()
    t0 = time.perf_counter()
    again = tl8.segment_tiled(rgb_t, cfg1t, None, space8)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    phase8_counts(["lloyd_t_pass"], [], "segment_tiled config1")
    zero_counts()
    untiled = pl.segment_image(rgb_t, cfg1t, device=dev)[0].cpu().numpy()
    agree_t = aligned_agreement(tiled_l.cpu().numpy(), untiled)
    print(f"phase 8: segment_tiled [config1 bank, 1x320x480 over 8 space shards, 40-row "
          f"strips, modulated route]: aligned agreement with the untiled segment_image "
          f"{agree_t:.6f} (floor 0.999), two calls equal {torch.equal(tiled_l, again)}, K5 "
          f"launches a call {per['lloyd_t_pass']} (8 shards x 20 passes), collectives a "
          f"call {colls}; {ms:.1f} ms a call (first {warm:.2f} s, a reading) ({card})",
          flush=True)
    check(agree_t >= 0.999 and torch.equal(tiled_l, again),
          "phase 8: segment_tiled disagrees with the untiled segment_image")
    check(per["lloyd_t_pass"] == 8 * 20, "phase 8: segment_tiled ran K5 another number of times")
    # K5 on one shard's strip, at the tiled path's shape, against its plain version
    feats_t = tl8._strip_features(list(torch.from_numpy(rgb_t).to(dev).chunk(8)), cfg1t,
                                  make_bank(cfg1t.bank), space8, "space")
    x5 = feats_t[3].reshape(1, feats_t[3].shape[0], -1)
    c5 = x5[:, :, ::3841].transpose(1, 2).contiguous()
    got5, ref5 = kf.lloyd_t_pass(x5, c5), kf.lloyd_t_pass_plain(x5, c5)
    torch.cuda.synchronize()
    eq5 = (got5[0] == ref5[0]).float().mean().item()
    serr5 = ((got5[1] - ref5[1]).abs().max() / ref5[1].abs().max()).item()
    print(f"phase 8: lloyd_t_pass [one strip {tuple(x5.shape)} f32, k = {c5.shape[1]}] labels "
          f"equal {eq5:.6f} (floor 0.9999), counts equal {torch.equal(got5[2], ref5[2])}, sums "
          f"within {serr5:.3e} of their largest (bound 1e-4) ({card})", flush=True)
    check(eq5 >= 0.9999 and torch.equal(got5[2], ref5[2]) and serr5 <= 1e-4,
          "phase 8: lloyd_t_pass disagrees with its plain version on a strip")
    del feats_t, x5, got5, ref5
    torch.cuda.empty_cache()

    # (c) segment_tiled_batch: config4 as published, 2 frames of 2160x3840
    # on a (2, 4) batch x space mesh (540-row strips: pool 2 keeps blocks
    # strip-local), against the port's untiled config4 path, both on the
    # modulated route
    cfg4m = cfg4.replace(feature_impl="modulated", batch_size=2)
    mesh24 = Mesh(np.asarray([dev] * 8, dtype=object).reshape(2, 4), ("batch", "space"))
    graph8 = ["superpixel_moments_fused_t", "table_lookup"]
    zero_counts()
    mesh24.reset_counts()
    t0 = time.perf_counter()
    tiled4 = tl8.segment_tiled_batch(rgb4[:2], cfg4m, None, mesh24)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    per = phase8_counts(graph8, ["gabor_energies_fused", "slic_band_pass", "slic_w3",
                                 "enforce_connectivity_fused"], "segment_tiled_batch config4")
    colls, syncs = dict(mesh24.collectives), mesh24.host_syncs
    zero_counts()
    t0 = time.perf_counter()
    again4 = tl8.segment_tiled_batch(rgb4[:2], cfg4m, None, mesh24)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    phase8_counts(graph8, [], "segment_tiled_batch config4")
    zero_counts()
    untiled4 = pl.segment_batch(rgb4[:2], cfg4m, with_features=False, device=dev)[0].cpu()
    each4 = [aligned_agreement(tiled4[i].cpu().numpy(), untiled4[i].numpy()) for i in range(2)]
    print(f"phase 8: segment_tiled_batch [config4 2x2160x3840 on a (2, 4) batch x space mesh, "
          f"540-row strips, pool 2, modulated route]: aligned agreement with the untiled "
          f"config4 path per image {[round(v, 6) for v in each4]}, two calls equal "
          f"{torch.equal(tiled4, again4)}, K17 / K15 launches a call {per} (2 frames x 4 "
          f"shards), collectives a call {colls}, host syncs of the fixpoint loops a call "
          f"{syncs}; {ms:.1f} ms a call (first {warm:.2f} s, a reading) ({card})", flush=True)
    check(torch.equal(tiled4, again4), "phase 8: segment_tiled_batch differs between calls")
    check(per["superpixel_moments_fused_t"] == 8 and per["table_lookup"] == 8,
          "phase 8: segment_tiled_batch ran K17 / K15 another number of times")
    check(tuple(tiled4.shape) == (2, *rgb4.shape[1:3]) and int(tiled4.min()) >= 0
          and int(tiled4.max()) < cfg4m.graph.n_regions,
          "phase 8: segment_tiled_batch labels outside the expected shape or range")
    # the sharded connectivity against K14 on the same sharded SLIC labels,
    # and the sharded SLIC against K13 on the whole pooled frame; K17 and
    # K15 on one shard's strip against their plain versions
    sub = mesh24.along("space", batch=0)
    feats_g, labs_g = tl8._strip_graph_inputs(list(torch.from_numpy(rgb4[0]).to(dev).chunk(4)),
                                              cfg4m, make_bank(cfg4m.bank), sub, "space")
    g4m = cfg4m.graph
    hp, wp = rgb4.shape[1] >> g4m.pool, rgb4.shape[2] >> g4m.pool
    sp_s = tg8.slic_sharded(labs_g, hp, wp, g4m.n_superpixels, g4m.slic_compactness,
                            g4m.slic_iters, sub, "space")
    gh8, gw8, _ = sl.grid_shape(hp, wp, g4m.n_superpixels)
    conn_s = torch.cat(tg8.enforce_connectivity_sharded(sp_s, gh8 * gw8, hp, sub, "space"))
    conn_k = cn.enforce_connectivity_fused(torch.cat(sp_s)[None], gh8 * gw8)[0]
    sp_k = sf.slic_batch(torch.cat(labs_g)[None], g4m.n_superpixels, g4m.slic_compactness,
                         g4m.slic_iters)[0]
    # the untiled config4 path's graph inputs on the same frame: its
    # superpixels (K13, K14) and pooled features beside the sharded ones
    feats_u, sp_u, _ = pl._graph_front(torch.from_numpy(rgb4[:1]).to(dev), cfg4m,
                                       make_bank(cfg4m.bank))
    feats_s = torch.cat(feats_g, dim=1).reshape(feats_u.shape[1], -1)
    ferr8 = ((feats_s - feats_u[0]).abs().max() / feats_u[0].abs().max()).item()
    torch.cuda.synchronize()
    conn_same = torch.equal(conn_s, conn_k)
    slic_eq = (torch.cat(sp_s) == sp_k).float().mean().item()
    sp_same = torch.equal(conn_s.reshape(-1), sp_u[0])
    kept8 = int(conn_s.max()) + 1
    sp1, f1 = conn_s[hp // 4:hp // 2].reshape(1, -1), feats_g[1].reshape(1, feats_g[1].shape[0], -1)
    m_k = gm.superpixel_moments_fused_t(sp1, f1, gh8 * gw8, dtype=f1.dtype)
    m_p = gm.superpixel_moments_plain(sp1, f1, gh8 * gw8, True)
    table8 = torch.arange(gh8 * gw8, dtype=torch.int32, device=dev).flip(0)[None] % 5
    l_k, l_p = lookup.table_lookup(sp1, table8), lookup.table_lookup_plain(sp1, table8)
    torch.cuda.synchronize()
    mom_same = torch.equal(m_k[1], m_p[1]) and bool(
        ((m_k[0] - m_p[0]).abs() <= 1.2e-7 * m_p[0].abs()).all())
    print(f"phase 8: config4 frame 0 on 4 space shards: enforce_connectivity_sharded bit-equal "
          f"to K14 on the same sharded SLIC labels {conn_same}; slic_sharded vs K13 on the "
          f"whole pooled frame, labels equal {slic_eq:.6f} (a reading); the connected "
          f"superpixels equal the untiled path's {sp_same}, {kept8} of {gh8 * gw8} kept; the "
          f"pooled features within {ferr8:.3e} of the untiled path's largest (a reading: its "
          f"432x768 windows take window-local plane waves, the strips global rows, and its "
          f"moments are one image's one-pass ones, the strips' psum'd two-pass); superpixel "
          f"moments "
          f"[one strip {tuple(f1.shape)} f32, S = {gh8 * gw8}] within one ulp of the plain "
          f"version, counts equal {mom_same}; table_lookup [{tuple(sp1.shape)}] bit-equal "
          f"{torch.equal(l_k, l_p)} ({card})", flush=True)
    check(conn_same, "phase 8: the sharded connectivity differs from K14")
    check(mom_same and torch.equal(l_k, l_p),
          "phase 8: K17 / K15 disagree with their plain versions on a strip")
    del feats_g, labs_g, tiled4, again4, untiled4, feats_u, feats_s
    torch.cuda.empty_cache()
    print(f"phase 8 took {time.perf_counter() - t8:.1f} s ({card})", flush=True)

    # ---- phase 9: the reference's entry points on the kernels -------------
    t9 = time.perf_counter()
    torch.cuda.empty_cache()

    def phase9_counts(path, label):
        """The counts of the run just made: every kernel of ``path``
        launched; all of them added to the totals."""
        counts = {name: wrapper.launches for name, wrapper in counters.items()}
        for name in path:
            check(counts[name] > 0, f"{name} was never launched on the phase 9 {label} path")
        for name in totals:
            totals[name] += counts[name]
        return {name: counts[name] for name in path}

    phase4 = {label: out for _, _, _, label, out, _, _ in outputs}
    # (a) graph_segment_batch, the graph stage the pipeline now calls, on
    # the features and Lab of phase 4's bf16 graph cells: labels bit-equal
    # to phase 4's, and phase 4's bit-equal to the stage composed by hand
    # (_graph_front, ncut_regions, K15, the unpooling)
    feats3 = lab3 = None
    for cfg, rgb, label, path in (
            (cfg3.replace(dtype="bfloat16"), rgb8, "config3 batch 8 bf16", graph_path[1:]),
            (cfg4.replace(dtype="bfloat16"), rgb4, "config4 batch 8 of 2160x3840 bf16",
             banded_path[1:])):
        g = cfg.graph
        x = torch.from_numpy(rgb).to(dev)
        bank9 = make_bank(cfg.bank)
        feats9, lab9 = pl._graph_features(x, cfg, bank9)
        zero_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = gr.graph_segment_batch(feats9, lab9, cfg)
        torch.cuda.synchronize()
        gsb_ms = (time.perf_counter() - t0) * 1e3
        counts = phase9_counts(path, f"graph_segment_batch {label}")
        got = pl._unpool(got, g.pool).cpu()
        f_old, sp_old, n_old = pl._graph_front(x, cfg, bank9)
        regions = gr.ncut_regions(f_old, sp_old, n_old, g.n_regions, g.affinity_sigma,
                                  gr.resolve_eig_method(g, cfg.dtype, dev),
                                  g.affinity_sigma_scale)
        old = pl._unpool(lookup.table_lookup(sp_old, regions).reshape(
            rgb.shape[0], rgb.shape[1] >> g.pool, rgb.shape[2] >> g.pool), g.pool).cpu()
        same_new, same_old = torch.equal(got, phase4[label]), torch.equal(old, phase4[label])
        print(f"phase 9: graph_segment_batch [{label}, features {tuple(feats9.shape)} "
              f"{feats9.dtype}]: labels bit-equal to phase 4's segment_batch {same_new}, "
              f"phase 4's bit-equal to the stage composed by hand {same_old}; launches "
              f"{counts}; {gsb_ms:.2f} ms (one call, host to host, a reading) ({card})",
              flush=True)
        check(same_new and same_old, f"phase 9 {label}: graph_segment_batch's labels differ")
        if feats3 is None:
            feats3, lab3, cfg9 = feats9, lab9, cfg
        del x, feats9, lab9, f_old, sp_old
    # (b) ncut_segment on image 0 is graph_segment_batch's batch of one
    g = cfg9.graph
    eig9 = gr.resolve_eig_method(g, cfg9.dtype, dev)
    one = gr.ncut_segment(feats3[0], lab3[0], g.n_superpixels, g.n_regions, g.slic_compactness,
                          g.slic_iters, g.affinity_sigma, eig9, g.affinity_sigma_scale)
    batch1 = gr.graph_segment_batch(feats3[:1], lab3[:1], cfg9)[0]
    same_ncut = torch.equal(one, batch1)
    # (c) slic on one 321x481 frame against slic_batch on the batch of 8;
    # (d) enforce_connectivity_device against K14 and its plain version;
    # (e) slic_batch(impl="fused") on config3's frame and on a frame the
    # reference's slic_fused_eligible refuses (a grid too wide for a window)
    zero_counts()
    sp_one = sl.slic(lab3[0], g.n_superpixels, g.slic_compactness, g.slic_iters)
    slic_launches = sf.slic_w3.launches
    sp_all = sf.slic_batch(lab3, g.n_superpixels, g.slic_compactness, g.slic_iters)
    same_slic = torch.equal(sp_one, sp_all[0])
    gh9, gw9, _ = sl.grid_shape(*sp_one.shape, g.n_superpixels)
    conn = sl.enforce_connectivity_device(sp_all, gh9 * gw9)
    same_conn = (torch.equal(conn, cn.enforce_connectivity_fused(sp_all, gh9 * gw9))
                 and torch.equal(conn, sl.enforce_connectivity_plain(sp_all, gh9 * gw9)))
    fused_same = torch.equal(sf.slic_batch(lab3, g.n_superpixels, g.slic_compactness,
                                           g.slic_iters, "fused"), sp_all)
    try:
        sf.slic_batch(torch.zeros((1, 30, 440, 3), device=dev), 132, impl="fused")
        refused = None
    except ValueError as exc:
        refused = str(exc)
    print(f"phase 9: ncut_segment(features[0], lab[0]) [config3 bf16] bit-equal to "
          f"graph_segment_batch on the batch of one {same_ncut} (eig {eig9}); slic on one "
          f"{tuple(sp_one.shape)} frame bit-equal to slic_batch(...)[0] on the batch of 8 "
          f"{same_slic} (K11 launches {slic_launches}); enforce_connectivity_device "
          f"bit-equal to K14 and its plain version {same_conn}; slic_batch(impl='fused') "
          f"runs config3's frame bit-equal to impl='auto' {fused_same} and refuses 30x440 "
          f"with S = 132, as slic_fused_eligible: {refused!r} ({card})", flush=True)
    check(same_ncut and same_slic and same_conn and fused_same and slic_launches == 1
          and refused is not None and "ineligible" in refused,
          "phase 9: the graph and SLIC entry points disagree with the batched path")
    del feats3, lab3, one, batch1, sp_one, sp_all, conn
    torch.cuda.empty_cache()

    # (f) kmeans_fused_chw's own multigrid (coarse_iters 15, refine_iters 1)
    # on config1's energies: K4 and K2 on the 2x2 twin (K1's own twin in
    # bf16, pooled here in f32), then K2 at full resolution
    color9 = pl._color_transform(torch.from_numpy(rgb16).to(dev), "lab")
    groups9 = bank_tensors(make_bank(cfg1.bank), dev)
    k9 = cfg1.cluster.k
    for dt, floor, twin_given in ((torch.bfloat16, 0.99, True), (torch.float32, 0.999, False)):
        tag9 = f"config1 16x321x481 {'bf16' if dt == torch.bfloat16 else 'f32'}"
        e9, tw9 = fused.gabor_energies_fused(color9, groups9, dt, pooled=True)
        xc9 = kc.build_color4(color9, dt)
        pc9 = ft._pool2x2_cm(xc9)
        aff9 = kc._affine_params(e9, xc9, cfg1.cluster, 1e-6, pooled=(tw9, pc9))
        kw9 = dict(coarse_iters=15, refine_iters=1,
                   pooled=(tw9, pc9) if twin_given else None)
        zero_counts()
        lab_k, _ = kc.kmeans_fused_chw(e9, xc9, aff9, k9, **kw9)
        counts = phase9_counts(["maximin_chw_pass", "lloyd_chw_pass"], f"kmeans_fused_chw {tag9}")
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            again, _ = kc.kmeans_fused_chw(e9, xc9, aff9, k9, **kw9)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        with plain_kernels():
            lab_p, _ = kc.kmeans_fused_chw(e9, xc9, aff9, k9, **kw9)
        lab_k, lab_p = lab_k.cpu().numpy(), lab_p.cpu().numpy()
        each = [aligned_agreement(lab_k[i], lab_p[i]) for i in range(len(lab_k))]
        print(f"phase 9: kmeans_fused_chw [{tag9}, coarse_iters 15, refine_iters 1, twin "
              f"{'K1s' if twin_given else 'pooled inside'}]: against its plain version min "
              f"aligned agreement {min(each):.6f} (floor {floor}), launches {counts}, two calls "
              f"equal {np.array_equal(again.cpu().numpy(), lab_k)}; "
              f"{statistics.median(times):.2f} ms a call (median of 3, host to host) "
              f"({card})", flush=True)
        check(min(each) >= floor and np.array_equal(again.cpu().numpy(), lab_k),
              f"phase 9: kmeans_fused_chw's multigrid disagrees with its plain version ({tag9})")
        del e9, tw9, xc9, pc9, again
    del color9
    torch.cuda.empty_cache()

    # (g) evaluate(debug_nans=True): every operation's and kernel's
    # floating-point outputs checked for NaN; the rows equal the mode off's
    split9 = ev.load_split("test", limit=2)
    for cfg, label, path in (
            (cfg1, "config1 bf16", ["gabor_energies_fused", "kmeans_coarse_centers_xp",
                                    "lloyd_chw_pass"]),
            (cfg3.replace(dtype="bfloat16"), "config3 bf16", graph_path)):
        rows9, secs9 = {}, {}
        for on in (False, True):
            path9 = os.path.join(out_dir, f"eval_debug_nans_{label.split()[0]}_"
                                 f"{'on' if on else 'off'}.jsonl")
            if os.path.exists(path9):
                os.remove(path9)
            zero_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev.evaluate(split9, cfg, out_path=path9, debug_nans=on, device="cuda")
            secs9[on] = time.perf_counter() - t0
            counts9 = phase9_counts(path, f"{label} evaluate(debug_nans={on})")
            with open(path9) as f:
                rows9[on] = [json.loads(line) for line in f]
        print(f"phase 9: evaluate(debug_nans=True) over load_split('test', limit=2) [{label}]: "
              f"no FloatingPointError, rows equal to the mode off's "
              f"{rows9[True] == rows9[False]}, launches {counts9}; {secs9[True]:.2f} s with "
              f"the mode, {secs9[False]:.2f} s without (host metrics included, readings) "
              f"({card})", flush=True)
        check(rows9[True] == rows9[False] and len(rows9[True]) == 2,
              f"phase 9: evaluate(debug_nans=True) gave other rows ({label})")
    print(f"phase 9 took {time.perf_counter() - t9:.1f} s ({card})", flush=True)

    # ---- phase 10: the benchmark core, device-resident MP/s ---------------
    t10 = time.perf_counter()
    torch.cuda.empty_cache()
    from gabor_color_image_segmentation_tpu_torch import benchmark as bm
    from gabor_color_image_segmentation_tpu_torch import cli

    # build_batch's mosaics are the ones made above (the same seeds and
    # generator): config4's eight 4K frames took seconds each on the host
    made = {arr.shape: arr for arr in (rgb1, rgb8, rgb16, rgb4)}
    real_build, real_loop = bm.build_batch, bm._timed_loop

    def build_batch(cfg, n_images):
        key = (n_images, *cfg.image_hw, 3)
        return made[key] if key in made else real_build(cfg, n_images)

    loops = []

    def timed_loop(*args, **kwargs):
        """benchmark._timed_loop with its launches counted: the counts set
        to 0 just before each loop and read just after."""
        zero_counts()
        modulated.gabor_energies_mod.calls = 0
        seconds, checksum = real_loop(*args, **kwargs)
        loops.append((seconds, checksum,
                      {name: wrapper.launches for name, wrapper in counters.items()},
                      modulated.gabor_energies_mod.calls))
        return seconds, checksum

    bm.build_batch, bm._timed_loop = build_batch, timed_loop
    bench_paths = {
        "config0": ["gabor_energies_fused", "maximin_chw_pass", "lloyd_chw_pass"],
        "config1": ["gabor_energies_fused", "kmeans_coarse_centers_xp", "lloyd_chw_pass"],
        "config2": gmm_path + ["precision_chol"],
        "config3": graph_path,
        "config4": banded_path,
    }
    bench_keys = {"metric", "value", "unit", "vs_baseline"}
    try:
        for name, path in bench_paths.items():
            iters = 2 if name == "config4" else 5
            loops.clear()
            out = bm.run_benchmark(name, iters=iters, dtype="bfloat16")
            check(len(loops) == 2, f"phase 10 {name}: run_benchmark ran {len(loops)} loops")
            (_, warm_sum, _, _), (secs, timed_sum, counts, mod_calls) = loops
            pcfg = preset(name)
            h, w = pcfg.image_hw
            mp_s = pcfg.batch_size * h * w / 1e6 / (secs / iters)
            print(f"phase 10: run_benchmark('{name}', batch {pcfg.batch_size}, bf16, iters "
                  f"{iters}): {out['value']} {out['unit']}, vs_baseline {out['vs_baseline']} "
                  f"(the JAX package's CPU golden table), {secs / iters * 1e3:.2f} ms a call "
                  f"in the timed loop; checksum {timed_sum}, the untimed loop's {warm_sum}; "
                  f"launches in the timed loop {({k: counts[k] for k in path})}, modulated "
                  f"route calls {mod_calls}; {json.dumps(out)} ({card})", flush=True)
            check(set(out) == bench_keys, f"phase 10 {name}: keys {sorted(out)}")
            check(math.isfinite(out["value"]) and out["value"] > 0,
                  f"phase 10 {name}: MP/s {out['value']}")
            check(abs(out["value"] - round(mp_s, 3)) < 1e-9,
                  f"phase 10 {name}: the value is not the timed loop's MP/s")
            check(out["unit"] == "MP/s/GPU" and out["vs_baseline"] == round(
                mp_s / bm.CPU_BASELINE_MP_S[name], 1),
                f"phase 10 {name}: unit {out['unit']} or vs_baseline {out['vs_baseline']}")
            check(timed_sum == warm_sum,
                  f"phase 10 {name}: the timed loop's checksum differs from the untimed one's")
            check(mod_calls == 0, f"phase 10 {name}: the modulated route ran in bf16")
            for k in path:
                check(counts[k] > 0, f"{k} was never launched in the phase 10 {name} loop")
            for k in totals:
                totals[k] += counts[k]
        buf = io.StringIO()
        loops.clear()
        with contextlib.redirect_stdout(buf):
            cli.main(["bench", "--preset", "config1", "--iters", "5"])
        lines = buf.getvalue().strip().splitlines()
        print(f"phase 10: cli bench --preset config1 --iters 5 on the card printed "
              f"{len(lines)} line(s): {lines[-1] if lines else ''} ({card})", flush=True)
        check(len(lines) == 1 and set(json.loads(lines[0])) == bench_keys
              and json.loads(lines[0])["unit"] == "MP/s/GPU",
              "phase 10: cli bench did not print one JSON line with the four keys")
    finally:
        bm.build_batch, bm._timed_loop = real_build, real_loop
    print(f"phase 10 took {time.perf_counter() - t10:.1f} s ({card})", flush=True)


    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda",
         "source": f"gabor_color_image_segmentation_tpu_torch/csrc/{src}",
         "replaces": f"gabor_color_image_segmentation_tpu/{where}",
         "launches": totals[name], **record[name]}
        for name, (_, src, where) in kernels.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
