#!/usr/bin/env python3
"""The port against the JAX package at the presets' published frames
(321x481; config4's 2160x3840), stage by stage, on the CPU (the JAX
package's Pallas kernels in interpret mode). Prints the figures that
located where config2 in bf16 parted from the reference (K1's rounding
points) and the ones ROADMAP's "Not faults" quotes for config1, config3
and config4.

    JAX_PLATFORMS=cpu python3 experiments/torch_published_stages.py config2 [--seeds 100,...]
    JAX_PLATFORMS=cpu python3 experiments/torch_published_stages.py config1
    JAX_PLATFORMS=cpu python3 experiments/torch_published_stages.py config3
    JAX_PLATFORMS=cpu python3 experiments/torch_published_stages.py config4 [--no-end-to-end]

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

config4 (seeds 100 and 101, both dtypes, whole 2160x3840 frames, one at
a time; ~25 min and ~13 GB at the peak on 8 cores, most of it the
reference's K1 in interpret mode and its float32 segment_batch) holds
each stage on the reference's inputs to it, on the route the port's
graph stage takes (bf16: K1 against the reference's Pallas kernel, run
eagerly as its own tests run it; float32: the modulated route; the exact
"xla" SLIC; "eigh" and "subspace" on both sides): 1. the tiled energies
pooled per window (25 windows of 432x768 and a 39-pixel halo); 2. the
pooled colour (the pooling bit-equal, the colour transform within 1e-4)
and the assembled features, from the reference's energies and from the
port's own; 3. SLIC on the reference's pooled Lab (and the reference's
banded bf16x3 kernel against its exact SLIC, a reading); 4. connectivity
on the reference's SLIC labels; 5. the superpixel means and counts and
the affinity matrix (median of d2, s2, empty ids, W among live pairs and
on its diagonal); 6. the smallest n_regions + 1 eigenvalues of L_sym on
each side and how many lie under GAP; 7. the n-cut's labels (both
eigensolvers; held to the label bar only after a gap of GAP, else a
reading), the lookup and the 4x unpooling, and the reference's own
labels under the same rounding (eigh against subspace, one image alone
against the batch of two, jit against eager).
Then, unless ``--no-end-to-end``, both packages' ``segment_batch``: float32
one frame at a time, bfloat16 the frames as one batch (the reference's
composed with its K1 run eagerly, ``_reference_bf16``), each beside the
reference's labels from its stages run one by one. ``--cache DIR`` keeps
the reference's stage-1 outputs between runs.
"""

from __future__ import annotations

import argparse
import sys
from functools import partial
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


# an eigengap of L_sym under GAP does not fix the n-cut's eigenvectors: the
# eigenvalues of a float32 L_sym of S = 405 nodes carry errors up to about
# S * eps = 5e-5
GAP = 1e-4


def _share(a, b):
    return round(float((np.asarray(a) == np.asarray(b)).mean()), 6)


def _rel(a, b):
    """max |a - b| over the peak of |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _cached(cache, key, fn):
    """fn() -> tuple of arrays, kept as DIR/key.npz when ``cache`` is set."""
    path = Path(cache) / f"{key}.npz" if cache else None
    if path is not None and path.exists():
        z = np.load(path)
        return tuple(z[f"a{i}"] for i in range(len(z.files)))
    out = tuple(np.asarray(a) for a in fn())
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **{f"a{i}": a for i, a in enumerate(out)})
    return out


def _d2_ref(m):
    """The reference's d2 (graph.py:affinity_matrix), eager."""
    sq = jnp.sum(m * m, axis=1)
    d2 = sq[:, None] - 2.0 * jnp.dot(m, m.T, preferred_element_type=jnp.float32,
                                     precision=jax.lax.Precision.HIGHEST) + sq
    return np.asarray(jnp.maximum(d2, 0.0))


def _d2_port(m):
    """The port's d2 (models/graph.py::affinity_matrix)."""
    sq = (m * m).sum(dim=1)
    return torch.clamp(sq[:, None] - 2.0 * (m @ m.T) + sq[None, :], min=0.0).numpy()


def _l_sym_ref(w):
    deg = jnp.sum(w, axis=1)
    di = 1.0 / jnp.sqrt(jnp.maximum(deg, 1e-12))
    return np.asarray(jnp.eye(w.shape[0]) - di[:, None] * w * di[None, :])


def _l_sym_port(w):
    di = 1.0 / torch.sqrt(torch.clamp(w.sum(dim=1), min=1e-12))
    return (torch.eye(w.shape[0]) - di[:, None] * w * di[None, :]).numpy()


def _w_figures(w, d2, live):
    """(largest W among live pairs off the diagonal, smallest and largest
    diagonal W among live ids, live ids whose diagonal W is 1, the largest
    live diagonal d2)."""
    wl, dl = w[np.ix_(live, live)], d2[np.ix_(live, live)]
    off = ~np.eye(int(live.sum()), dtype=bool)
    diag = np.diag(wl)
    return (float(wl[off].max()), float(diag.min()), float(diag.max()), int((diag == 1).sum()),
            float(np.diag(dl).max()))


def _reference_bf16(rgb, jc, bank):
    """The reference's segment_batch in bf16 with the graph stage, on the
    route the port's takes: its K1 (feature_impl="pallas", off the TPU its
    "auto" is the modulated route) run eagerly over the windows, the
    pooling, assembly and ``graph_segment_batch`` jitted, the 4x unpooling.
    Under one jit the interpret-mode K1 held more than 23 GB for one 4K
    frame on the CPU, and XLA drops some of its bf16 rounding points."""
    from gabor_color_image_segmentation_tpu.models.graph import graph_segment_batch
    from gabor_color_image_segmentation_tpu.ops.features import assemble_features

    p = jc.graph.pool
    energies, color = jpl.compute_energies(jnp.asarray(rgb), jc.replace(feature_impl="pallas"),
                                           bank, p)

    @partial(jax.jit, static_argnums=2)
    def rest(energies, color, cfg):
        for _ in range(p):
            color = jpl._pool2x2_nhwc(color)
        return graph_segment_batch(assemble_features(energies, color, cfg.cluster), color, cfg)

    labels = np.asarray(rest(energies, color, jc))
    return np.repeat(np.repeat(labels, 1 << p, axis=1), 1 << p, axis=2)


def config4(seeds, end_to_end=True, cache=None):
    import time

    from gabor_color_image_segmentation_tpu.models import graph as jg
    from gabor_color_image_segmentation_tpu.models.slic import (
        enforce_connectivity_device,
        grid_shape,
    )
    from gabor_color_image_segmentation_tpu.models.slic_pallas import slic_batch
    from gabor_color_image_segmentation_tpu.ops.features import assemble_features
    from gabor_color_image_segmentation_tpu.ops.lookup import table_lookup as jax_lookup
    from gabor_color_image_segmentation_tpu_torch.models import graph as tg
    from gabor_color_image_segmentation_tpu_torch.models.connectivity import (
        enforce_connectivity_fused,
    )
    from gabor_color_image_segmentation_tpu_torch.models.slic_fused import (
        slic_batch as port_slic,
    )
    from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank as port_bank
    from gabor_color_image_segmentation_tpu_torch.ops.features import (
        assemble_features as port_assemble,
    )
    from gabor_color_image_segmentation_tpu_torch.ops.lookup import table_lookup
    from gabor_color_image_segmentation_tpu_torch.ops.tiled import pool2x2_mean

    h, w = preset("config4").image_hw
    g = preset("config4").graph
    hp, wp = h >> g.pool, w >> g.pool
    gh, gw, _ = grid_shape(hp, wp, g.n_superpixels)
    n_sp = gh * gw
    energies_jit = jax.jit(jpl.compute_energies, static_argnums=(1, 2, 3))
    print(f"config4: {h}x{w} frames, tile_hw {preset('config4').tile_hw}, pool {g.pool} -> "
          f"{hp}x{wp}, S = {g.n_superpixels} on a {gh}x{gw} = {n_sp}-cell grid, "
          f"{g.n_regions} regions, sigma_scale {g.affinity_sigma_scale}", flush=True)
    frames = {s: synthetic_mosaic(h=h, w=w, n_regions=5, seed=s)[0][None] for s in seeds}
    superpixels, kept = {}, {}
    for seed in seeds:
        rgb = frames[seed]
        for dt in ("float32", "bfloat16"):
            tag = f"config4 seed {seed} {dt}"
            impl = "pallas" if dt == "bfloat16" else "modulated"
            jc = jax_preset("config4").replace(batch_size=1, dtype=dt, feature_impl=impl)
            bank = make_bank(jc.bank)
            t = time.time()

            def ref_energies():
                # bf16: the reference's K1 run eagerly, as its own tests run it
                # (under jit XLA drops some of its bf16 rounding points)
                fn = jpl.compute_energies if dt == "bfloat16" else energies_jit
                e, color = fn(jnp.asarray(rgb), jc, bank, g.pool)
                pc = color
                for _ in range(g.pool):
                    pc = jpl._pool2x2_nhwc(pc)
                return f32(e), pc, color

            ref_e, ref_pc, ref_color = _cached(cache, f"c4_{seed}_{dt}_v2", ref_energies)
            t_ref = time.time() - t
            cfg = preset("config4").replace(batch_size=1, dtype=dt, feature_impl=impl)
            t = time.time()
            port_e, color = tpl.compute_energies(torch.from_numpy(rgb), cfg,
                                                 port_bank(cfg.bank), g.pool)
            t_port = time.time() - t
            pe = port_e.float().permute(0, 2, 3, 1).numpy()
            bound = 2e-2 if dt == "bfloat16" else 1e-4
            print(f"{tag} stage 1, tiled energies pooled per window ({impl}): max |d| "
                  f"{_rel(pe, ref_e):.3e} of the peak (bar {bound:g}), equal on "
                  f"{_share(pe, ref_e):.6f} of the values; the reference {t_ref:.1f} s, "
                  f"the port {t_port:.1f} s", flush=True)
            pc = color
            for _ in range(g.pool):
                pc = pool2x2_mean(pc, 1)
            ref_tdt = torch.from_numpy(ref_e.copy()).to(port_e.dtype)
            ref_f = assemble_features(jnp.asarray(ref_e, jnp.bfloat16 if dt == "bfloat16"
                                                  else jnp.float32), jnp.asarray(ref_pc),
                                      jc.cluster)
            ref_f32 = f32(ref_f)
            got_f = port_assemble(ref_tdt.permute(0, 3, 1, 2), torch.from_numpy(ref_pc),
                                  cfg.cluster)
            own_f = port_assemble(port_e, pc, cfg.cluster)
            ref_pooled = torch.from_numpy(np.asarray(ref_color))
            for _ in range(g.pool):
                ref_pooled = pool2x2_mean(ref_pooled, 1)
            print(f"{tag} stage 2: the port's pooling of the reference's Lab bit-equal "
                  f"{np.array_equal(ref_pooled.numpy(), ref_pc)}; the pooled Lab max |d| "
                  f"{float(np.abs(pc.numpy() - ref_pc).max()):.3e} (bar 1e-4), equal on "
                  f"{_share(pc.numpy(), ref_pc):.6f}; features on the reference's energies max |d| "
                  f"{_rel(f32(got_f), ref_f32):.3e} of the peak, on the port's own "
                  f"{_rel(f32(own_f), ref_f32):.3e}", flush=True)
            if seed not in superpixels:
                t = time.time()
                raw = np.asarray(slic_batch(jnp.asarray(ref_pc), g.n_superpixels,
                                            g.slic_compactness, g.slic_iters, "xla"))
                t_ref = time.time() - t
                t = time.time()
                got = port_slic(torch.from_numpy(ref_pc), g.n_superpixels, g.slic_compactness,
                                g.slic_iters).numpy()
                t_port = time.time() - t
                banded = np.asarray(slic_batch(jnp.asarray(ref_pc), g.n_superpixels,
                                               g.slic_compactness, g.slic_iters, "fused"))
                sp = np.asarray(enforce_connectivity_device(jnp.asarray(raw), n_sp))
                got_sp = enforce_connectivity_fused(torch.from_numpy(raw.copy()), n_sp).numpy()
                print(f"config4 seed {seed} stage 3, SLIC on the reference's pooled Lab: ids "
                      f"equal on {_share(got, raw):.6f} (bar 0.99; the reference {t_ref:.1f} s,"
                      f" the port {t_port:.1f} s); reading: the reference's banded bf16x3 "
                      f"kernel against its exact SLIC {_share(banded, raw):.6f}, against the "
                      f"port's {_share(banded, got):.6f}", flush=True)
                print(f"config4 seed {seed} stage 4, connectivity on the reference's SLIC "
                      f"labels: bit-equal {np.array_equal(got_sp, sp)}; "
                      f"{len(np.unique(sp))} of {n_sp} ids survive", flush=True)
                superpixels[seed] = sp
            sp = superpixels[seed]
            flat_sp = sp[0].reshape(-1)
            d = ref_f32.shape[-1]
            ref_fj = jnp.asarray(ref_f)[0]
            m, cnt = jg.superpixel_means(ref_fj.reshape(-1, d), jnp.asarray(flat_sp), n_sp)
            m, cnt = np.asarray(m), np.asarray(cnt)
            feats_t = torch.from_numpy(f32(ref_f)[0].reshape(-1, d).T.copy())[None]
            feats_t = feats_t.to(torch.bfloat16) if dt == "bfloat16" else feats_t
            sp_t = torch.from_numpy(flat_sp[None].astype(np.int32))
            pm, pcnt = tg.superpixel_means(feats_t, sp_t, n_sp)
            pm, pcnt = pm[0], pcnt[0]
            live = cnt > 0
            ref_w = np.asarray(jg.affinity_matrix(jnp.asarray(m), None, jnp.asarray(cnt),
                                                  g.affinity_sigma_scale))
            port_w = tg.affinity_matrix(torch.from_numpy(m)[None], None,
                                        torch.from_numpy(cnt)[None], g.affinity_sigma_scale)[0]
            rd2, pd2 = _d2_ref(jnp.asarray(m)), _d2_port(torch.from_numpy(m))
            off = ~np.eye(n_sp, dtype=bool)
            med = {"reference": float(np.median(rd2)), "port": float(tg._median(
                torch.from_numpy(pd2).reshape(1, -1))[0])}
            live_pairs = rd2[np.ix_(live, live)][~np.eye(int(live.sum()), dtype=bool)]
            print(f"{tag} stage 5: counts bit-equal {np.array_equal(pcnt.numpy(), cnt)}, means "
                  f"max |d| {_rel(pm.numpy(), m):.3e} of the peak; {int(live.sum())} live ids, "
                  f"{1 - live.mean():.6f} of the {n_sp} empty, the largest covers "
                  f"{int(cnt.max())} of {hp * wp} pixels; d2 off the diagonal max |d| "
                  f"{_rel(pd2[off], rd2[off]):.3e} of the peak; median d2 reference "
                  f"{med['reference']!r} port {med['port']!r} (over live pairs only "
                  f"{float(np.median(live_pairs)):.6f});"
                  f" s2 = {max(med['reference'], 1e-12) * g.affinity_sigma_scale!r}", flush=True)
            for name, wm, d2m in (("reference", ref_w, rd2), ("port", port_w.numpy(), pd2)):
                top, dmin, dmax, ones, d2max = _w_figures(wm, d2m, live)
                print(f"{tag} stage 5, {name}'s W: largest among live pairs {top!r}, diagonal "
                      f"min {dmin!r} max {dmax!r}, {ones} of {int(live.sum())} live ids with "
                      f"W_ii = 1 (diagonal d2 exactly 0; the largest live diagonal d2 "
                      f"{d2max:.3e}, |f|^2 up to {float((m * m).sum(1).max()):.3e})", flush=True)
            ref_l = _l_sym_ref(jnp.asarray(ref_w))
            port_l = _l_sym_port(port_w)
            k = g.n_regions
            ev = {name: np.linalg.eigvalsh(((lm + lm.T) / 2).astype(np.float64))
                  for name, lm in (("reference", ref_l), ("port", port_l))}
            print(f"{tag} stage 6: L_sym off its diagonal max |entry| reference "
                  f"{float(np.abs(ref_l[off]).max())!r} port {float(np.abs(port_l[off]).max())!r}"
                  f"; smallest {k + 1} eigenvalues reference "
                  f"{[float(v) for v in ev['reference'][:k + 1]]} port "
                  f"{[float(v) for v in ev['port'][:k + 1]]}; eigenvalues under {GAP:g} "
                  f"(zero at float32) reference {int((ev['reference'] < GAP).sum())} port "
                  f"{int((ev['port'] < GAP).sum())}; gap after the {k}th: reference "
                  f"{float(ev['reference'][k] - ev['reference'][k - 1]):.3e} port "
                  f"{float(ev['port'][k] - ev['port'][k - 1]):.3e}", flush=True)
            gap = min(ev[name][k] - ev[name][k - 1] for name in ev) > GAP
            bar = 0.999 if dt == "float32" else 0.99
            status = (f"held to the bar {bar}" if gap
                      else f"a reading: no gap of {GAP:g} after the {k}th eigenvalue")
            regions = {}
            for em in ("eigh", "subspace"):
                r = np.asarray(jg.ncut_regions(ref_fj, jnp.asarray(sp[0]), n_sp, k, None, em,
                                               g.affinity_sigma_scale))
                p = tg.ncut_regions(feats_t, sp_t, n_sp, k, None, em,
                                    g.affinity_sigma_scale)
                regions[em] = (r, p)
                ra, pa = r[sp[0]], p[0].numpy()[sp[0]]
                print(f"{tag} stage 7, n-cut labels ({em}), port against the reference per "
                      f"pooled pixel {float((align_labels(pa, ra) == ra).mean()):.6f} "
                      f"({status})", flush=True)
            re, rs = regions["eigh"][0], regions["subspace"][0]
            ref_px = np.asarray(jax_lookup(jnp.asarray(flat_sp[None]), jnp.asarray(re[None])))
            port_px = table_lookup(sp_t, torch.from_numpy(re[None].astype(np.int32)))
            ref_up = np.repeat(np.repeat(ref_px.reshape(1, hp, wp), 4, 1), 4, 2)
            port_up = tpl._unpool(port_px.reshape(1, hp, wp), g.pool).numpy()
            print(f"{tag} stage 7: lookup bit-equal {np.array_equal(port_px.numpy(), ref_px)}, "
                  f"4x unpooling bit-equal {np.array_equal(port_up, ref_up)}; the reference's "
                  f"own eigh against its subspace "
                  f"{float((align_labels(rs[sp[0]], re[sp[0]]) == re[sp[0]]).mean()):.6f}",
                  flush=True)
            kept[(seed, dt)] = (ref_f, sp, ref_up[0])
    for dt in ("float32", "bfloat16"):
        if len(seeds) < 2:
            break
        fs = jnp.concatenate([kept[(s, dt)][0] for s in seeds])
        sps = jnp.asarray(np.concatenate([superpixels[s][:, :, :] for s in seeds]))

        def one(f, s):
            return jg.ncut_regions(f, s, n_sp, g.n_regions, None, "eigh",
                                   g.affinity_sigma_scale)

        def diag_ones(f, s):
            m, c = jg.superpixel_means(f.reshape(-1, f.shape[-1]), s.reshape(-1), n_sp)
            wm = jg.affinity_matrix(m, None, c, g.affinity_sigma_scale)
            return jnp.sum((jnp.diag(wm) == 1) & (c > 0))

        batched = np.asarray(jax.vmap(one)(fs, sps))
        jitted = np.asarray(jax.jit(one)(fs[0], sps[0]))
        ones_b = np.asarray(jax.vmap(diag_ones)(fs, sps)).tolist()
        ones_1 = [int(diag_ones(fs[i], sps[i])) for i in range(len(seeds))]
        ones_j = [int(jax.jit(diag_ones)(fs[i], sps[i])) for i in range(len(seeds))]
        for i, seed in enumerate(seeds):
            s0 = np.asarray(sps[i])
            alone = np.asarray(one(fs[i], sps[i]))[s0]
            got = {"in the batch of two": batched[i][s0]}
            if i == 0:
                got["under jit"] = jitted[s0]
            print(f"config4 seed {seed} {dt}, the reference's own n-cut (eigh) on the same "
                  f"features: alone against " + ", ".join(
                      f"{name} {float((align_labels(v, alone) == alone).mean()):.6f}"
                      for name, v in got.items())
                  + f"; live ids with W_ii = 1 alone {ones_1[i]}, in the batch {ones_b[i]}, "
                  f"under jit {ones_j[i]}", flush=True)
    if not end_to_end:
        return
    # bf16 as one batch of two or more frames: the port's K1 route (at batch 1
    # its graph stage takes the modulated route, as the reference's)
    bf16_groups = [list(seeds)] if len(seeds) > 1 else []
    for dt, groups in (("float32", [[s] for s in seeds]), ("bfloat16", bf16_groups)):
        for grp in groups:
            rgb = np.concatenate([frames[s] for s in grp])
            jc = jax_preset("config4").replace(batch_size=len(grp), dtype=dt)
            t = time.time()
            if dt == "float32":
                ref = np.asarray(jpl.segment_batch(rgb, jc, make_bank(jc.bank), False)[0])
            else:
                ref = _reference_bf16(rgb, jc, make_bank(jc.bank))
            t_ref = time.time() - t
            t = time.time()
            got = tpl.segment_batch(rgb, preset("config4").replace(batch_size=len(grp),
                                                                   dtype=dt),
                                    with_features=False, device="cpu")[0].numpy()
            t_port = time.time() - t
            staged = np.stack([kept[(s, dt)][2] for s in grp])
            what = "segment_batch" if dt == "float32" else "segment_batch, composed"
            print(f"config4 {dt} seeds {grp} end to end (batch {len(grp)}): the port's "
                  f"segment_batch against the reference's {what} {agree(got, ref)}; the "
                  f"reference's "
                  f"segment_batch against its stages run one by one {agree(staged, ref)}; "
                  f"the reference {t_ref:.1f} s, the port {t_port:.1f} s", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("preset", choices=["config1", "config2", "config3", "config4"])
    parser.add_argument("--port", default=None, help="a checkout to import the port from")
    parser.add_argument("--seeds", default=None,
                        help="comma-separated mosaic seeds (default: config2 100-107, "
                             "config1 102, config3 100, config4 100,101)")
    parser.add_argument("--no-end-to-end", action="store_true",
                        help="config4: skip both packages' segment_batch")
    parser.add_argument("--cache", default=None,
                        help="config4: a directory that keeps the reference's stage-1 outputs")
    args = parser.parse_args()
    default = {"config2": "100,101,102,103,104,105,106,107", "config1": "102",
               "config3": "100", "config4": "100,101"}[args.preset]
    seeds = [int(s) for s in (args.seeds or default).split(",")]
    torch.set_num_threads(4)
    print(f"the port from {Path(tpl.__file__).resolve().parents[2]}", flush=True)
    if args.preset == "config4":
        config4(seeds, not args.no_end_to_end, args.cache)
    else:
        {"config1": config1, "config2": config2, "config3": config3}[args.preset](seeds)


if __name__ == "__main__":
    main()
