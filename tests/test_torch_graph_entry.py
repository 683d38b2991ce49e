"""PyTorch port, the graph stage's entry points (models/graph.py:
resolve_graph_impls, ncut_from_superpixels, ncut_segment,
graph_segment_batch) against the JAX package's on the same numpy inputs.

Inputs: 64x96 mosaics (4 regions), their float32 Lab (the port's
rgb_to_lab, handed to both packages) and features drawn around a mean per
ground-truth region (39 wide, or the Lab scaled to [-1, 1] as the JAX
package's own n-cut tests take it). Region labels are compared after
alignment, >= 0.999 of the pixels in float32 (the n-cut turns ulp-level
differences of the superpixel means into whole superpixels changing region
only where an eigengap is tiny; these mosaics have clear cuts). The
pipeline's n-cut, through graph_segment_batch, is held bit for bit
against the stage composed by hand (pipeline._graph_front, ncut_regions,
table_lookup, the unpooling) at config3 and config4 in both dtypes."""

import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu import config as jconfig
from gabor_color_image_segmentation_tpu.models import graph as jgraph
from gabor_color_image_segmentation_tpu.models import slic as jslic
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import GraphConfig, preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import graph as tgraph
from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu_torch.ops.lookup import table_lookup

torch.set_num_threads(2)

H, W, N_SP, D = 64, 96, 64, 39


@pytest.fixture(scope="module")
def images():
    """(lab (2, H, W, 3) float32, features (2, H, W, D) float32)."""
    rng = np.random.default_rng(5)
    labs, feats = [], []
    for i in range(2):
        rgb, gt = synthetic_mosaic(h=H, w=W, n_regions=4, seed=40 + i)
        labs.append(rgb_to_lab(torch.from_numpy(rgb)).numpy())
        means = rng.normal(scale=2.0, size=(int(gt.max()) + 1, D))
        feats.append(means[gt] + 0.5 * rng.normal(size=(H, W, D)))
    return np.stack(labs).astype(np.float32), np.stack(feats).astype(np.float32)


def _agreement(got, ref) -> float:
    got, ref = np.asarray(got).reshape(-1), np.asarray(ref).reshape(-1)
    return float((align_labels(got, ref) == ref).mean())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resolve_graph_impls(dtype):
    """The reference's mapping over every setting (tests/test_graph.py's
    dtype-aware resolution), and "auto" resolved by device."""
    for slic_impl, eig in itertools.product(("auto", "fused", "xla"),
                                           ("auto", "eigh", "subspace")):
        g = GraphConfig(enabled=True, slic_impl=slic_impl, eig_method=eig)
        jg = jconfig.GraphConfig(enabled=True, slic_impl=slic_impl, eig_method=eig)
        got = tgraph.resolve_graph_impls(g, dtype)
        assert got == jgraph.resolve_graph_impls(jg, dtype)
        for dev, auto in (("cpu", "eigh"), ("cuda", "subspace")):
            want = auto if got[1] == "auto" else got[1]
            assert tgraph.resolve_eig_method(g, dtype, torch.device(dev)) == want


def test_ncut_from_superpixels_matches_jax(images):
    lab, feats = images
    gh, gw, _ = jslic.grid_shape(H, W, N_SP)
    for i in range(2):
        sp = np.array(jslic.enforce_connectivity_device(
            jslic.slic(lab[i], N_SP, 10.0, 5)[None], gh * gw)[0])
        ref = np.asarray(jgraph.ncut_from_superpixels(jnp.asarray(feats[i]), jnp.asarray(sp),
                                                      gh * gw, 4, None, "eigh"))
        got = tgraph.ncut_from_superpixels(torch.from_numpy(feats[i]), torch.from_numpy(sp),
                                           gh * gw, 4, None, "eigh")
        assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
        assert _agreement(got.numpy(), ref) >= 0.999


@pytest.mark.parametrize("features", ["drawn", "lab"])
def test_ncut_segment_matches_jax(images, features):
    lab, feats = images
    for i in range(2):
        f = feats[i] if features == "drawn" else lab[i] / np.abs(lab[i]).max()
        ref = np.asarray(jgraph.ncut_segment(jnp.asarray(f), jnp.asarray(lab[i]), N_SP, 4))
        got = tgraph.ncut_segment(torch.from_numpy(f), torch.from_numpy(lab[i]), N_SP, 4)
        assert got.dtype == torch.int32 and tuple(got.shape) == (H, W)
        assert _agreement(got.numpy(), ref) >= 0.999


@pytest.mark.parametrize("name", ["config3", "config4"])
def test_graph_segment_batch_matches_jax(images, name):
    lab, feats = images
    graph = dict(n_superpixels=N_SP, n_regions=4)
    tcfg = preset(name)
    jcfg = jconfig.preset(name)
    tcfg = tcfg.replace(batch_size=2, graph=dataclasses.replace(tcfg.graph, **graph))
    jcfg = jcfg.replace(batch_size=2, graph=dataclasses.replace(jcfg.graph, **graph))
    assert tcfg.dtype == jcfg.dtype == "float32"
    ref = np.asarray(jgraph.graph_segment_batch(jnp.asarray(feats), jnp.asarray(lab), jcfg))
    got = tgraph.graph_segment_batch(torch.from_numpy(feats), torch.from_numpy(lab), tcfg)
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, H, W)
    for i in range(2):
        assert _agreement(got[i].numpy(), ref[i]) >= 0.999
    # one image of the batch is ncut_segment on it, bit for bit
    g = tcfg.graph
    one = tgraph.ncut_segment(torch.from_numpy(feats[0]), torch.from_numpy(lab[0]), N_SP, 4,
                              g.slic_compactness, g.slic_iters, g.affinity_sigma, "eigh",
                              g.affinity_sigma_scale)
    assert torch.equal(one, tgraph.graph_segment_batch(
        torch.from_numpy(feats[:1]), torch.from_numpy(lab[:1]), tcfg)[0])


def test_graph_segment_batch_refuses_the_mincut(images):
    lab, feats = images
    cfg = preset("config3").replace(graph=GraphConfig(enabled=True, cut="mincut"))
    with pytest.raises(ValueError, match="host-side"):
        tgraph.graph_segment_batch(torch.from_numpy(feats), torch.from_numpy(lab), cfg)


@pytest.mark.parametrize("name,dtype", [(n, d) for n in ("config3", "config4")
                                        for d in ("float32", "bfloat16")])
def test_segment_batch_ncut_unchanged(name, dtype):
    """segment_batch's n-cut labels and features equal, bit for bit, the
    stage composed by hand from _graph_front, ncut_regions and K15."""
    rgb = np.stack([synthetic_mosaic(h=64, w=96, n_regions=4, seed=i)[0] for i in range(2)])
    cfg = preset(name).replace(batch_size=2, dtype=dtype)
    if name == "config4":
        cfg = cfg.replace(tile_hw=(32, 48),
                          graph=dataclasses.replace(cfg.graph, n_superpixels=24))
    else:
        cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, n_superpixels=48))
    labels, feats = pipeline.segment_batch(rgb, cfg, device="cpu")
    g = cfg.graph
    x = torch.from_numpy(rgb)
    f, sp, n_sp = pipeline._graph_front(x, cfg, make_bank(cfg.bank))
    regions = tgraph.ncut_regions(f, sp, n_sp, g.n_regions, g.affinity_sigma,
                                  tgraph.resolve_eig_method(g, cfg.dtype, x.device),
                                  g.affinity_sigma_scale)
    hp, wp = 64 >> g.pool, 96 >> g.pool
    ref = pipeline._unpool(table_lookup(sp, regions).reshape(2, hp, wp), g.pool)
    assert torch.equal(labels, ref)
    assert torch.equal(feats, f.reshape(2, -1, hp, wp).permute(0, 2, 3, 1))
