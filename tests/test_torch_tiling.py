"""PyTorch port, spatial tiling (parallel/tiling.py) on a single-controller
mesh of repeated CPU devices, against the JAX package's parallel/tiling.py
on the conftest's fake CPU devices (64x96 frames on 2 devices and the
2-kernel toy bank, the sizes of tests/test_tiling.py:133-144).

- ``_strip_energies`` (the two-level halo exchange) against the JAX
  package's under ``shard_map`` (within 5e-6 of the peak, the reference's
  own tiled-vs-untiled bound: its jit moves the last bits) and against the
  port's untiled modulated route (within 1e-6 of the peak).
- ``kmeans_sharded`` against the JAX package's on the same features, with
  and without the multigrid schedule, at k = 8 (each shard's pass is K5,
  here its plain version) and k = 9 (the one-hot route past K5's K_MAX),
  the route checked at both sides of the limit.
- ``segment_tiled`` against the JAX package's (>= 0.999 after alignment)
  and against the port's untiled ``segment_image`` at 256x96 over 8
  shards (>= 0.9999); ``segment_tiled_batch`` on a (4, 2) mesh equal to
  ``segment_tiled`` per image.
- Every refusal (halo >= strip rows, strip rows % 2^coarse_levels,
  coherence strip rows % 8, the graph pool, H % shards) raises where the
  reference's does."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from gabor_color_image_segmentation_tpu.config import BankConfig as JaxBankConfig
from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.parallel import tiling as jax_tiling
from gabor_color_image_segmentation_tpu.parallel.sharding import _shard_map_unchecked
from gabor_color_image_segmentation_tpu_torch.config import BankConfig, preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models.pipeline import (
    _color_transform,
    segment_image,
)
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank
from gabor_color_image_segmentation_tpu_torch.ops.modulated import gabor_energies_mod
from gabor_color_image_segmentation_tpu_torch.parallel import tiling
from gabor_color_image_segmentation_tpu_torch.parallel.mesh import Mesh
from gabor_color_image_segmentation_tpu_torch.utils.labels import align_labels

torch.set_num_threads(2)

TOY = dict(scales=(2.0, 3.0), orientations=3, frequencies=None)


def _cfg(jax_side=False, **cluster):
    base = (jax_preset if jax_side else preset)("config0").replace(
        feature_impl="modulated",
        bank=(JaxBankConfig if jax_side else BankConfig)(**TOY))
    return base.replace(cluster=dataclasses.replace(base.cluster, **cluster)) if cluster else base


def _jax_mesh(n, shape=None, names=("space",)):
    devs = np.asarray(jax.devices()[:n])
    return JaxMesh(devs.reshape(shape) if shape else devs, names)


def _jax_rows(fn, mesh, in_spec, out_spec):
    return jax.jit(_shard_map_unchecked(fn, mesh, in_spec, out_spec))


def _agree(pred, ref):
    return float((align_labels(pred, ref) == ref).mean())


@pytest.fixture(scope="module")
def frame():
    return synthetic_mosaic(h=64, w=96, n_regions=3, seed=9)[0]


def test_strip_energies_match_jax(frame):
    cfg, jcfg = _cfg(), _cfg(True)
    bank, jbank = make_bank(cfg.bank), jax_make_bank(jcfg.bank)
    mesh = Mesh(["cpu"] * 2, ("space",))
    strips = list(torch.from_numpy(frame).chunk(2))
    got, _ = tiling._strip_energies(strips, cfg, bank, mesh, "space")
    got = torch.cat(got).numpy()
    fn = _jax_rows(lambda s: jax_tiling._strip_energies(s, jcfg, jbank, "space")[0],
                   _jax_mesh(2), P("space", None, None), P("space", None, None))
    ref = np.asarray(fn(jnp.asarray(frame)))
    peak = np.abs(ref).max()
    assert got.shape == ref.shape == (64, 96, 18)
    assert np.abs(got - ref).max() <= 5e-6 * peak
    untiled = gabor_energies_mod(_color_transform(torch.from_numpy(frame)[None], "lab"),
                                 bank)[0].numpy()
    assert np.abs(got - untiled).max() <= 1e-6 * peak
    assert mesh.collectives["ppermute"] == 4


def _features(frame, n):
    cfg = _cfg()
    mesh = Mesh(["cpu"] * n, ("space",))
    feats = tiling._strip_features(list(torch.from_numpy(frame).chunk(n)), cfg,
                                   make_bank(cfg.bank), mesh, "space")
    return torch.cat(feats, dim=1)  # (D, H, W)


@pytest.mark.parametrize("k,multigrid", [(8, True), (9, True), (5, False)])
def test_kmeans_sharded_match_jax(frame, monkeypatch, k, multigrid):
    """The port's distributed Lloyd against the JAX package's on the same
    (64, 96, D) features split over 2 shards; K5's plain version for k <=
    8, the one-hot route past it."""
    feats = _features(frame, 2)
    d, h, w = feats.shape
    sched = dict(hw_local=(h // 2, w), coarse_iters=15, refine_iters=1, coarse_levels=2,
                 mid_iters=3) if multigrid else dict(init_stride=2)
    calls = []
    real = tiling.lloyd_t_pass
    monkeypatch.setattr(tiling, "lloyd_t_pass", lambda *a: calls.append(1) or real(*a))
    mesh = Mesh(["cpu"] * 2, ("space",))
    strips = [f.reshape(1, d, -1) for f in feats.chunk(2, dim=1)]
    labels, centers = tiling.kmeans_sharded(strips, k, 10, mesh, "space", **sched)
    assert bool(calls) == (k <= 8)
    got = torch.cat(labels).reshape(h, w).numpy()
    assert all(torch.equal(c, centers[0]) for c in centers)

    def local(x):
        rows = x.shape[0]
        lab, cen = jax_tiling.kmeans_sharded(x.reshape(rows * w, d), k, 10, "space", **sched)
        return lab.reshape(rows, w), cen[None]

    fn = _jax_rows(local, _jax_mesh(2), P("space", None, None), (P("space", None), P("space")))
    ref_l, ref_c = fn(jnp.asarray(feats.permute(1, 2, 0).numpy()))
    ref_l, ref_c = np.asarray(ref_l), np.asarray(ref_c)[0]
    assert (got == ref_l).mean() >= 0.999
    np.testing.assert_allclose(centers[0].numpy(), ref_c, rtol=1e-3, atol=1e-3)


def test_segment_tiled_matches_jax(frame):
    mesh = Mesh(["cpu"] * 2, ("space",))
    got = tiling.segment_tiled(frame, _cfg(), None, mesh).numpy()
    jcfg = _cfg(True)
    ref = np.asarray(jax_tiling.segment_tiled(frame, jcfg, jax_make_bank(jcfg.bank),
                                              _jax_mesh(2)))
    assert got.dtype == np.int32 and got.shape == (64, 96)
    assert _agree(got, ref) >= 0.999


def test_segment_tiled_matches_untiled_8_shards():
    rgb = synthetic_mosaic(h=256, w=96, n_regions=4, seed=5)[0]
    cfg = _cfg()
    mesh = Mesh(["cpu"] * 8, ("space",))
    got = tiling.segment_tiled(rgb, cfg, None, mesh).numpy()
    ref = segment_image(rgb, cfg, device="cpu")[0].numpy()
    assert _agree(got, ref) >= 0.9999
    assert mesh.collectives["ppermute"] == 4 and mesh.collectives["all_gather"] == 10
    assert mesh.host_syncs == 0


def test_segment_tiled_batch_4x2():
    cfg = _cfg()
    imgs = np.stack([synthetic_mosaic(h=96, w=64, n_regions=3, seed=30 + i)[0]
                     for i in range(4)])
    mesh = Mesh(np.asarray(["cpu"] * 8, dtype=object).reshape(4, 2), ("batch", "space"))
    got = tiling.segment_tiled_batch(imgs, cfg, None, mesh)
    assert got.shape == (4, 96, 64) and got.dtype == torch.int32
    exact = 0
    for i in range(4):
        one = tiling.segment_tiled(imgs[i], cfg, None, Mesh(["cpu"] * 2, ("space",)))
        assert torch.equal(got[i], one)
        ref = segment_image(imgs[i], cfg, device="cpu")[0].numpy()
        exact += _agree(got[i].numpy(), ref) > 0.999
    assert exact >= 3


REFUSALS = {
    # 64 rows over 8: 8-row strips under the toy bank's 9-row halo
    "halo": (64, 8, {}, {}, "halo"),
    # 72 rows over 4: 18-row strips, not divisible by 2^2
    "multigrid": (72, 4, dict(cue_weight="static", coarse_iters=3, coarse_levels=2), {},
                  "multigrid"),
    # 18-row strips with the coherence cue weights
    "coherence": (72, 4, {}, {}, "coherence"),
    # 18-row strips of a pool-2 graph stage
    "graph_pool": (72, 4, {}, dict(enabled=True, n_superpixels=48, n_regions=4, pool=2),
                   "graph.pool"),
    "rows": (70, 4, {}, {}, "divide"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_refusals_match_reference(name):
    h, n, cluster, graph, match = REFUSALS[name]
    rgb = synthetic_mosaic(h=h, w=96, n_regions=3, seed=1)[0]
    cfg, jcfg = _cfg(**cluster), _cfg(True, **cluster)
    if graph:
        cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, **graph))
        jcfg = jcfg.replace(graph=dataclasses.replace(jcfg.graph, **graph))
    with pytest.raises(ValueError, match=match):
        tiling.segment_tiled(rgb, cfg, None, Mesh(["cpu"] * n, ("space",)))
    with pytest.raises((ValueError, AssertionError)):
        jax_tiling.segment_tiled(rgb, jcfg, jax_make_bank(jcfg.bank), _jax_mesh(n))
