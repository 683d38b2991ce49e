"""PyTorch port at config4's published geometry, stage 1 in float32: the
tiled energies of the modulated route (the reference's graph route in
float32, ``_graph_features``' choice) pooled per window, on the real
432x768 windows with the 39-pixel halo and pool 2, over a block of 3x3
windows (the top-left 1296x2304 of the bench's 2160x3840 mosaic, seed
100), batch 1, against the JAX package's ``compute_energies`` (jitted, as
its ``segment_batch`` runs it) on the CPU. Bar: max |d| <= 1e-4 of the
peak (K1's float32 bound; the two read ~1.1e-5).

The bfloat16 case (K1) and the block's helpers are in
test_torch_published_config4_energies.py, seed 101 in
test_torch_published_config4_energies_f32_101.py: one seed a file
(~60 s alone: the port's modulated route on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_published_config4_energies import block, port_energies

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models import pipeline as jax_pipeline
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu_torch.config import preset

torch.set_num_threads(2)

BOUND = 1e-4


def check_modulated(seed, monkeypatch):
    """The port's tiled modulated energies on seed's block within BOUND of
    the reference's, window by window."""
    rgb = block(seed)
    jcfg = jax_preset("config4").replace(batch_size=1, dtype="float32",
                                         feature_impl="modulated")
    ref, _ = jax.jit(jax_pipeline.compute_energies, static_argnums=(1, 2, 3))(
        jnp.asarray(rgb), jcfg, jax_make_bank(jcfg.bank), jcfg.graph.pool)
    ref = np.asarray(ref)
    cfg = preset("config4").replace(batch_size=1, dtype="float32", feature_impl="modulated")
    got, windows = port_energies(rgb, cfg, monkeypatch)
    assert len(windows) == 9 and got.shape == ref.shape
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    assert err <= BOUND, err


def test_tiled_modulated_matches_jax(monkeypatch):
    check_modulated(100, monkeypatch)
