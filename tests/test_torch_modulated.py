"""PyTorch port, the modulated feature route (ops/modulated.py) and the
graph stage's energy dispatch (queue 3 fault 4).

- ``gabor_energies_mod`` and ``modulated_group_magnitudes`` against the JAX
  package's at 32x40, batch 2, on a two-scale bank (radii 6 and 12, so the
  JAX reference compiles in seconds): within 1e-5 of the peak in float32
  and 1e-3 of the peak in bfloat16. The rounding points are the same
  (input and taps cast to the dtype, each product in the dtype, float32
  accumulation in tap order), so only the last bits of cos, sin and the
  summation order can differ.
- config3 at batch 1 in bfloat16 against the JAX package's ``segment_batch``
  on one 96x128 mosaic where the reference's bf16 batch-1 labels differ
  from its f32 ones, because its graph stage takes the modulated route
  there with bf16 products: the port takes that route too (a spy on the
  energies functions) and agrees. (K1's route, which the port ran at batch
  1 before, parted from it there while K1 rounded only its stored values;
  since K1 follows the reference's rounding points both routes give these
  labels, so the spy holds the route.)
- The dispatch itself: batch 1 or float32 take the modulated route, bf16
  batches and the min-cut route K1, ``feature_impl="modulated"`` always
  the modulated route, config4's tiled path window by window."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import BankConfig as JaxBankConfig
from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models.pipeline import (
    segment_batch as jax_segment_batch,
)
from gabor_color_image_segmentation_tpu.ops import modulated as jax_mod
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu.utils.labels import align_labels
from gabor_color_image_segmentation_tpu_torch.config import BankConfig, GraphConfig, preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gabor_color_image_segmentation_tpu_torch.models.pipeline import (
    segment_batch,
    segment_images,
)
from gabor_color_image_segmentation_tpu_torch.ops import modulated
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

torch.set_num_threads(2)

BANK = dict(scales=(2.0, 4.0), orientations=3)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 1e-3)}


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(5)
    return rng.uniform(0.0, 100.0, (2, 32, 40, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_energies_match_jax(image, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    ref = np.asarray(jax_mod.gabor_energies_mod(jnp.asarray(image),
                                                jax_make_bank(JaxBankConfig(**BANK)), jdt))
    got = modulated.gabor_energies_mod(torch.from_numpy(image), make_bank(BankConfig(**BANK)),
                                       tdt)
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 32, 40, 18)
    peak = np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= tol * peak


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_group_magnitudes_match_jax(image, dtype):
    tdt, jdt, tol = DTYPES[dtype]
    jbank, tbank = jax_make_bank(JaxBankConfig(**BANK)), make_bank(BankConfig(**BANK))
    for jg, tg in zip(jbank.groups, tbank.groups):
        ref = np.asarray(jax_mod.modulated_group_magnitudes(jnp.asarray(image), jg, jbank, jdt))
        got = modulated.modulated_group_magnitudes(torch.from_numpy(image), tg, tbank, tdt)
        assert tuple(got.shape) == ref.shape
        assert np.abs(got.numpy() - ref).max() <= tol * np.abs(ref).max()


def _pinned(cfg, dtype, batch=1):
    """tests/test_torch_pipeline_config3.py's pins for the 96x128 toy frame."""
    return cfg.replace(batch_size=batch, dtype=dtype, graph=dataclasses.replace(
        cfg.graph, n_superpixels=64, n_regions=4, slic_compactness=10.0,
        affinity_sigma_scale=1.0))


def _agreement(a, b):
    return float((align_labels(a, b) == b).mean())


def test_config3_batch1_bf16_follows_the_reference_route(routes):
    rgb = synthetic_mosaic(h=96, w=128, n_regions=4, seed=221)[0][None]
    ref = {}
    for dt in ("bfloat16", "float32"):
        cfg = _pinned(jax_preset("config3"), dt)
        ref[dt] = np.asarray(jax_segment_batch(rgb, cfg, jax_make_bank(cfg.bank), False)[0])[0]
    # the reference's bf16 route moves its labels on this image
    assert _agreement(ref["bfloat16"], ref["float32"]) < 0.99
    cfg = _pinned(preset("config3"), "bfloat16")
    labels, _ = segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert routes == ["gabor_energies_mod"]
    got = labels.numpy()[0]
    assert got.min() >= 0 and got.max() < cfg.graph.n_regions
    assert _agreement(got, ref["bfloat16"]) >= 0.99


@pytest.fixture
def routes(monkeypatch):
    """The energies functions each pipeline call reached, in order."""
    calls = []
    for name in ("gabor_energies_fused", "gabor_energies_mod"):
        real = getattr(pipeline, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(pipeline, name, spy)
    return calls


@pytest.mark.parametrize("case", [("bfloat16", 1, "gabor_energies_mod"),
                                  ("float32", 1, "gabor_energies_mod"),
                                  ("float32", 2, "gabor_energies_mod"),
                                  ("bfloat16", 2, "gabor_energies_fused")])
def test_graph_dispatch(routes, case):
    dtype, batch, route = case
    rgb = np.stack([synthetic_mosaic(h=32, w=48, n_regions=3, seed=i)[0] for i in range(batch)])
    cfg = _pinned(preset("config3"), dtype, batch).replace(
        graph=dataclasses.replace(_pinned(preset("config3"), dtype).graph, n_superpixels=16,
                                  n_regions=3))
    feats, _, _ = pipeline._graph_front(torch.from_numpy(rgb), cfg, make_bank(cfg.bank))
    assert routes == [route]
    # the features keep the energies' dtype: bf16 only from K1 in bf16 mode
    want = torch.bfloat16 if route == "gabor_energies_fused" else torch.float32
    assert feats.dtype == want
    routes.clear()
    # the min-cut route keeps the reference's feature_impl: K1 for "auto"
    mincut = cfg.replace(graph=GraphConfig(enabled=True, n_superpixels=16, cut="mincut",
                                           mincut_k=15.0, mincut_min_size=2))
    segment_images(rgb, mincut, device="cpu")
    assert routes == ["gabor_energies_fused"]


def test_explicit_modulated_and_tiled_dispatch(routes):
    rgb = np.stack([synthetic_mosaic(h=64, w=96, n_regions=3, seed=i)[0] for i in range(2)])
    cfg = _pinned(preset("config3"), "bfloat16", 2).replace(feature_impl="modulated")
    segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert routes == ["gabor_energies_mod"]
    routes.clear()
    # config4's tiled path at float32: the modulated route once per window
    cfg4 = preset("config4").replace(batch_size=2, dtype="float32", tile_hw=(32, 48),
                                     graph=dataclasses.replace(preset("config4").graph,
                                                               n_superpixels=16))
    energies, _ = pipeline.compute_energies(torch.from_numpy(rgb),
                                            cfg4.replace(feature_impl="modulated"),
                                            make_bank(cfg4.bank), cfg4.graph.pool)
    assert routes == ["gabor_energies_mod"] * 4
    assert energies.dtype == torch.float32 and tuple(energies.shape[2:]) == (16, 24)
    routes.clear()
    pipeline._graph_front(torch.from_numpy(rgb), cfg4, make_bank(cfg4.bank))
    assert routes == ["gabor_energies_mod"] * 4


def test_pixel_clustering_keeps_k1(routes):
    """config1's pixel clustering is not the graph stage: K1 at batch 1 too;
    feature_impl="modulated" takes the reference's NHWC path on the
    modulated energies, labels agreeing with the JAX package's (>= 0.999).
    64x64: a frame inside the reference's pixel range of the clustering."""
    rgb = synthetic_mosaic(h=64, w=64, n_regions=3, seed=1)[0][None]
    cfg = preset("config1").replace(batch_size=1, dtype="float32")
    segment_batch(rgb, cfg, with_features=False, device="cpu")
    assert routes == ["gabor_energies_fused"]
    routes.clear()
    mod = cfg.replace(feature_impl="modulated")
    labels, _ = segment_batch(rgb, mod, with_features=False, device="cpu")
    assert routes == ["gabor_energies_mod"]
    jcfg = jax_preset("config1").replace(batch_size=1, dtype="float32",
                                         feature_impl="modulated")
    ref = np.asarray(jax_segment_batch(rgb, jcfg, jax_make_bank(jcfg.bank), False)[0])
    assert _agreement(labels.numpy()[0], ref[0]) >= 0.999
