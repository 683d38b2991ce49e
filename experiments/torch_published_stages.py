#!/usr/bin/env python3
"""The port against the JAX package at the presets' published 321x481
frame, stage by stage, on the CPU (the JAX package's Pallas kernels in
interpret mode). Prints the figures that located where config2 in bf16 parted
from the reference (K1's rounding points) and the ones
ROADMAP's "Not faults" quotes for config1 and config3.

    JAX_PLATFORMS=cpu python3 experiments/torch_published_stages.py config2 [--seeds 100,...]
    JAX_PLATFORMS=cpu python3 experiments/torch_published_stages.py config1
    JAX_PLATFORMS=cpu python3 experiments/torch_published_stages.py config3

``--port DIR`` imports the port from another checkout (a parent's, say).

config2 (bf16, seed 100 first): K1's energies equal to the reference's
(share of values); the k-means init (K6, K5) on the pooled fit buffer
against the reference's, on the port's buffer and on the reference's; the
fit buffer's affine from the storage-dtype colour (the reference's) in
place of the float32 colour's; then the labels of every seed in both
dtypes against the reference's, and the reference's bf16 against its f32.
config1 (seed 102, bf16): the reference's transposed path against its
NHWC with-features path, the port's labels-only path against the
transposed one. config3 (seed 100, f32): the reference's ``segment_batch``
against its own stages run one after another, its SLIC against the port's
on the same Lab, and the port's SLIC with float32 moment sums in pixel
order against its float64 sums.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
if "--port" in sys.argv:  # the port's checkout goes first on the path
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--port") + 1]).resolve()))
sys.path.insert(1 if "--port" in sys.argv else 0, str(ROOT))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gabor_color_image_segmentation_tpu.config import preset as jax_preset  # noqa: E402
from gabor_color_image_segmentation_tpu.models import pipeline as jpl  # noqa: E402
from gabor_color_image_segmentation_tpu.ops.bank import make_bank  # noqa: E402
from gabor_color_image_segmentation_tpu.utils.labels import align_labels  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.config import preset  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic  # noqa: E402
from gabor_color_image_segmentation_tpu_torch.models import pipeline as tpl  # noqa: E402


def mosaics(seeds):
    return np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=s)[0] for s in seeds])


def agree(a, b):
    return [round(float((align_labels(a[i], b[i]) == b[i]).mean()), 6) for i in range(len(b))]


def f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.float().numpy()


def config2(seeds):
    from gabor_color_image_segmentation_tpu.models.gmm import gmm_fit_levels
    from gabor_color_image_segmentation_tpu.models.kmeans_chw import _affine_params, build_color4
    from gabor_color_image_segmentation_tpu.models.kmeans_pallas import (
        kmeans_fused_t_xt,
        xt_geometry,
    )
    from gabor_color_image_segmentation_tpu.ops.features import (
        _pool2x2_cm,
        assemble_xp_from_affine,
    )
    from gabor_color_image_segmentation_tpu.ops.fused_pallas import gabor_energies_fused
    from gabor_color_image_segmentation_tpu_torch.models.kmeans_fused import (
        kmeans_fused_t_xt as port_kmeans,
    )

    rgb = mosaics(seeds[:1])
    jcfg = jax_preset("config2").replace(batch_size=1, dtype="bfloat16")
    cfg = preset("config2").replace(batch_size=1, dtype="bfloat16")
    bank = make_bank(jcfg.bank)
    h, w = rgb.shape[1:3]
    color = jpl._color_transform(jnp.asarray(rgb), jcfg.color_space)
    energies = gabor_energies_fused(color, bank, jnp.bfloat16, channel_major=True)
    d = energies.shape[1] + 3
    hp, wp, lv = gmm_fit_levels(h, w, jcfg.cluster.gmm_fit_pool)
    m = hp * wp
    c4 = build_color4(color, jnp.bfloat16)
    a, b = _affine_params(energies, c4, jcfg.cluster, 1e-6)
    pe, pc = energies, c4
    for _ in range(lv):
        pe, pc = _pool2x2_cm(pe), _pool2x2_cm(pc)
    dp, _, _ = xt_geometry(h * w, d, jnp.bfloat16)
    _, mp_pad, _ = xt_geometry(m, d, jnp.bfloat16)
    ref_fit = assemble_xp_from_affine(pe, pc, a, b, dp, mp_pad, jnp.bfloat16)
    ref_init = np.asarray(kmeans_fused_t_xt(ref_fit, 5, d, m, 10)[0])[0, :m]

    port_x, port_e, port_color, (pa, pb) = tpl._normalised_buffer(torch.from_numpy(rgb), cfg,
                                                                  bank)
    print(f"config2 seed {seeds[0]} bf16: K1 energies equal to the reference's on "
          f"{(f32(port_e) == f32(energies)).mean():.6f} of the values", flush=True)

    def port_fit(affine):
        qe, qc = port_e, tpl.build_color4(port_color, port_e.dtype)
        for _ in range(lv):
            qe, qc = tpl._pool2x2_cm(qe), tpl._pool2x2_cm(qc)
        return tpl.assemble_xp_from_affine(qe, qc, *affine, port_e.dtype)

    def init_agreement(fit):
        got = port_kmeans(fit, 5, 10)[0].numpy()[0]
        return round(float((align_labels(got, ref_init) == ref_init).mean()), 6)

    ref_fit_t = torch.from_numpy(f32(ref_fit)[:, :d, :m]).to(torch.bfloat16).contiguous()
    storage_affine = tpl._affine_params(port_e, tpl.build_color4(port_color, port_e.dtype),
                                        cfg.cluster, 1e-6)
    print(f"config2 seed {seeds[0]} bf16: k-means init on the pooled fit buffer against the "
          f"reference's: the port's buffer {init_agreement(port_fit((pa, pb)))}, the "
          f"reference's buffer {init_agreement(ref_fit_t)}, the port's with the "
          f"storage-dtype colour's affine {init_agreement(port_fit(storage_affine))}",
          flush=True)

    rgb = mosaics(seeds)
    ref = {}
    for dt in ("bfloat16", "float32"):
        jc = jax_preset("config2").replace(batch_size=len(seeds), dtype=dt)
        ref[dt] = np.asarray(jpl._segment_batch_transposed(rgb, jc, make_bank(jc.bank)))
        got = tpl.segment_batch(rgb, preset("config2").replace(batch_size=len(seeds), dtype=dt),
                                with_features=False, device="cpu")[0].numpy()
        print(f"config2 {dt} seeds {seeds}: port against the reference {agree(got, ref[dt])}",
              flush=True)
    print(f"config2 seeds {seeds}: the reference's bf16 against its f32 "
          f"{agree(ref['bfloat16'], ref['float32'])}", flush=True)


def config1(seeds):
    rgb = mosaics(seeds)
    jc = jax_preset("config1").replace(batch_size=len(seeds), dtype="bfloat16")
    bank = make_bank(jc.bank)
    transposed = np.asarray(jpl._segment_batch_transposed(rgb, jc, bank))
    nhwc = np.asarray(jpl.segment_batch(rgb, jc, bank, True)[0])
    got = tpl.segment_batch(rgb, preset("config1").replace(batch_size=len(seeds),
                                                           dtype="bfloat16"),
                            with_features=False, device="cpu")[0].numpy()
    print(f"config1 bf16 seeds {seeds}: the reference's NHWC path against its transposed "
          f"path {agree(nhwc, transposed)}; the port's labels-only path against the "
          f"transposed path {agree(got, transposed)}", flush=True)


def config3(seeds):
    from gabor_color_image_segmentation_tpu.models import graph as jg
    from gabor_color_image_segmentation_tpu.models.slic import (
        enforce_connectivity_device,
        grid_shape,
    )
    from gabor_color_image_segmentation_tpu.models.slic_pallas import slic_batch
    from gabor_color_image_segmentation_tpu.ops.features import assemble_features
    from gabor_color_image_segmentation_tpu_torch.models import slic as tsl
    from gabor_color_image_segmentation_tpu_torch.models.slic_fused import (
        slic_batch as port_slic,
    )

    rgb = mosaics(seeds)
    cfg = jax_preset("config3").replace(batch_size=len(seeds), dtype="float32")
    g = cfg.graph
    bank = make_bank(cfg.bank)
    whole = np.asarray(jpl.segment_batch(rgb, cfg, bank, False)[0])
    energies, color = jax.jit(jpl.compute_energies, static_argnums=(1, 2, 3))(
        rgb, cfg.replace(feature_impl="modulated"), bank, 0)
    feats = assemble_features(energies, color, cfg.cluster)
    gh, gw, _ = grid_shape(321, 481, g.n_superpixels)
    slic_impl, eig_method = jg.resolve_graph_impls(g, "float32")
    raw = slic_batch(color, g.n_superpixels, g.slic_compactness, g.slic_iters, slic_impl)
    sp = enforce_connectivity_device(raw, gh * gw)
    regions = np.asarray(jax.vmap(lambda f, s: jg.ncut_regions(
        f, s, gh * gw, g.n_regions, g.affinity_sigma, eig_method, g.affinity_sigma_scale))(
        feats, sp))
    sp = np.asarray(sp)
    staged = np.stack([regions[i][sp[i]] for i in range(len(seeds))])
    print(f"config3 f32 seeds {seeds}: the reference's segment_batch against its stages run "
          f"one after another {agree(staged, whole)}", flush=True)
    lab = torch.from_numpy(np.asarray(color, np.float32))
    got = port_slic(lab, g.n_superpixels, g.slic_compactness, g.slic_iters).numpy()
    raw = np.asarray(raw)
    print(f"config3 seeds {seeds}: SLIC ids equal, port against the reference on its Lab "
          f"{[round(float((got[i] == raw[i]).mean()), 6) for i in range(len(seeds))]}",
          flush=True)
    real = tsl.slic_moments

    def float32_sums(rows, labels, n_sp):
        _, counts = real(rows, labels, n_sp)
        b = rows.shape[0]
        flat = (labels + torch.arange(b)[:, None] * n_sp).reshape(-1)
        sums = torch.zeros((b * n_sp, 5)).index_add_(0, flat, rows.reshape(-1, 5).float())
        return sums.reshape(b, n_sp, 5), counts

    tsl.slic_moments = float32_sums
    try:
        f32_sums = tsl.slic_plain(lab, g.n_superpixels, g.slic_compactness, g.slic_iters)
    finally:
        tsl.slic_moments = real
    print(f"config3 seeds {seeds}: the port's SLIC with float32 moment sums in pixel order "
          f"against its float64 sums "
          f"{[round(float((f32_sums[i].numpy() == got[i]).mean()), 6) for i in range(len(seeds))]}",
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("preset", choices=["config1", "config2", "config3"])
    parser.add_argument("--port", default=None, help="a checkout to import the port from")
    parser.add_argument("--seeds", default=None,
                        help="comma-separated mosaic seeds (default: config2 100-107, "
                             "config1 102, config3 100)")
    args = parser.parse_args()
    default = {"config2": "100,101,102,103,104,105,106,107", "config1": "102",
               "config3": "100"}[args.preset]
    seeds = [int(s) for s in (args.seeds or default).split(",")]
    torch.set_num_threads(4)
    print(f"the port from {Path(tpl.__file__).resolve().parents[2]}", flush=True)
    {"config1": config1, "config2": config2, "config3": config3}[args.preset](seeds)


if __name__ == "__main__":
    main()
