"""PyTorch port, the distributed cut chain (parallel/tiled_graph.py) on a
single-controller mesh of repeated CPU devices, against the JAX package's
parallel/tiled_graph.py on the conftest's fake CPU devices and against the
port's single-chip passes.

- ``slic_sharded`` against the JAX package's ``slic_sharded`` (>= 0.999,
  the reference's own bar for its sharded SLIC) and against the port's
  ``slic_plain`` on the whole image (every pixel: float64 moments psum'd in
  shard order, rounded once).
- ``enforce_connectivity_sharded`` bit-equal to the port's single-chip
  ``enforce_connectivity_plain`` and to the JAX package's sharded and
  single-chip passes, on SLIC labels, fragmented random maps, a spiral
  maze (adoption distances past a strip) and one-row strips.
- The cut chain: ``segment_tiled`` with the graph stage against the JAX
  package's at 64x96 on 2 devices, and at the reference's config4-
  representative geometry (384x256 over 8 shards, pool 2, 96
  superpixels; tests/test_tiling.py:475) against the port's untiled
  ``segment_image`` (>= 0.999); ``segment_tiled_batch`` with the graph
  stage on a (2, 2) mesh equal to ``segment_tiled`` per image."""

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
from gabor_color_image_segmentation_tpu.models import slic as jax_slic
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.parallel import tiled_graph as jax_tg
from gabor_color_image_segmentation_tpu.parallel import tiling as jax_tiling
from gabor_color_image_segmentation_tpu.parallel.sharding import _shard_map_unchecked
from gabor_color_image_segmentation_tpu_torch.config import BankConfig, preset
from gabor_color_image_segmentation_tpu_torch.data import connectivity_maze, synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import slic as sl
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_image
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu_torch.parallel import tiled_graph as tg
from gabor_color_image_segmentation_tpu_torch.parallel import tiling
from gabor_color_image_segmentation_tpu_torch.parallel.mesh import Mesh
from gabor_color_image_segmentation_tpu_torch.utils.labels import align_labels

torch.set_num_threads(2)

TOY = dict(scales=(2.0, 3.0), orientations=3, frequencies=None)


def _mesh(n):
    return Mesh(["cpu"] * n, ("space",))


def _jax_rows(fn, n, in_spec, out_spec):
    mesh = JaxMesh(np.asarray(jax.devices()[:n]), ("space",))
    return jax.jit(_shard_map_unchecked(fn, mesh, in_spec, out_spec))


def _lab(h, w, seed):
    rgb = synthetic_mosaic(h=h, w=w, n_regions=4, seed=seed)[0]
    return rgb_to_lab(torch.from_numpy(rgb).to(torch.float32) / 255.0)


def _agree(pred, ref):
    return float((align_labels(pred, ref) == ref).mean())


def test_slic_sharded_matches_jax_and_plain():
    lab = _lab(64, 96, 7)
    mesh = _mesh(2)
    got = torch.cat(tg.slic_sharded(list(lab.chunk(2)), 64, 96, 48, 10.0, 10, mesh, "space"))
    fn = _jax_rows(lambda x: jax_tg.slic_sharded(x, 64, 96, 48, 10.0, 10, "space"), 2,
                   P("space", None, None), P("space", None))
    ref = np.asarray(fn(jnp.asarray(lab.numpy())))
    assert got.dtype == torch.int32
    assert (got.numpy() == ref).mean() >= 0.999
    plain = sl.slic_plain(lab[None], 48, 10.0, 10)[0]
    assert torch.equal(got, plain)
    # one (S, 3) psum of the seed colours, then an (S, 5) and an (S,) psum
    # an iteration
    assert mesh.collectives["psum"] == 1 + 2 * 10


def _fragmented(h, w, n_sp, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, n_sp, ((h + 7) // 8, (w + 7) // 8))
    lab = np.kron(base, np.ones((8, 8), int))[:h, :w]
    return np.where(rng.random((h, w)) < 0.25, rng.integers(0, n_sp, (h, w)),
                    lab).astype(np.int32)


def _slic_map(h, w, n_sp):
    return sl.slic_plain(_lab(h, w, 3)[None], n_sp, 10.0, 5)[0].numpy()


# (label map, S, shards, compare with the JAX package's sharded pass)
CASES = {
    "slic_2": (lambda: _slic_map(64, 96, 48), 48, 2, True),
    "slic_8": (lambda: _slic_map(64, 96, 48), 48, 8, False),
    "fragmented_4": (lambda: _fragmented(64, 96, 40), 40, 4, True),
    "maze_4": (lambda: connectivity_maze(48, 40, "corner"), 30, 4, False),
    "one_row_strips": (lambda: _fragmented(8, 50, 12, 3), 12, 8, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_connectivity_sharded_bit_equal(name):
    make, n_sp, n, with_jax = CASES[name]
    lab = make()
    h = lab.shape[0]
    mesh = _mesh(n)
    got = torch.cat(tg.enforce_connectivity_sharded(list(torch.from_numpy(lab).chunk(n)),
                                                    n_sp, h, mesh, "space"))
    single = sl.enforce_connectivity_plain(torch.from_numpy(lab)[None], n_sp)[0]
    assert got.dtype == torch.int32 and torch.equal(got, single)
    jax_single = np.asarray(jax_slic.enforce_connectivity_device(jnp.asarray(lab)[None],
                                                                 n_sp))[0]
    assert (got.numpy() == jax_single).all()
    assert mesh.host_syncs >= 2
    if with_jax:
        fn = _jax_rows(lambda s: jax_tg.enforce_connectivity_sharded(s, n_sp, h, "space"), n,
                       P("space", None), P("space", None))
        assert (got.numpy() == np.asarray(fn(jnp.asarray(lab)))).all()


def _graph_cfg(jax_side=False, **graph):
    base = (jax_preset if jax_side else preset)("config0").replace(
        feature_impl="modulated", bank=(JaxBankConfig if jax_side else BankConfig)(**TOY))
    return base.replace(graph=dataclasses.replace(base.graph, enabled=True, **graph))


def test_tiled_graph_matches_jax():
    rgb = synthetic_mosaic(h=64, w=96, n_regions=3, seed=9)[0]
    g = dict(n_superpixels=48, n_regions=3, pool=1)
    got = tiling.segment_tiled(rgb, _graph_cfg(**g), None, _mesh(2)).numpy()
    jcfg = _graph_cfg(True, **g)
    mesh = JaxMesh(np.asarray(jax.devices()[:2]), ("space",))
    ref = np.asarray(jax_tiling.segment_tiled(rgb, jcfg, jax_make_bank(jcfg.bank), mesh))
    assert _agree(got, ref) >= 0.999


def test_cut_chain_config4_geometry_matches_untiled():
    """config4's bank and cut chain at 384x256 over 8 shards: 48-row strips
    keep pool 2's blocks strip-local; the pooled SLIC grid spans the strips
    and components cross every seam."""
    cfg = preset("config4").replace(feature_impl="modulated", image_hw=(384, 256))
    cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, n_superpixels=96, n_regions=5,
                                                pool=2))
    rgb = synthetic_mosaic(h=384, w=256, n_regions=5, seed=78)[0]
    mesh = _mesh(8)
    got = tiling.segment_tiled(rgb, cfg, None, mesh).numpy()
    ref = segment_image(rgb, cfg, device="cpu")[0].numpy()
    assert got.shape == (384, 256)
    assert _agree(got, ref) >= 0.999
    assert mesh.host_syncs > 0 and mesh.collectives["all_gather"] == 0


def test_tiled_graph_batch_2x2():
    cfg = _graph_cfg(n_superpixels=48, n_regions=3, pool=1)
    imgs = np.stack([synthetic_mosaic(h=64, w=64, n_regions=3, seed=40 + i)[0]
                     for i in range(2)])
    mesh = Mesh(np.asarray(["cpu"] * 4, dtype=object).reshape(2, 2), ("batch", "space"))
    got = tiling.segment_tiled_batch(imgs, cfg, None, mesh)
    for i in range(2):
        assert torch.equal(got[i], tiling.segment_tiled(imgs[i], cfg, None, _mesh(2)))
