"""PyTorch port at config4's published geometry, stage 1 in bfloat16: the
tiled energies pooled per window, on the real 432x768 windows with the
config4 bank's 39-pixel halo and pool 2, over a block of 3x3 windows
(the top-left 1296x2304 of the bench's 2160x3840 mosaic, seed 100:
corner, edge and interior windows; seed 101 in
test_torch_published_config4_energies_101.py), batch 1, against the JAX
package's ``compute_energies`` on the CPU.

``feature_impl="pallas"`` is forced on both sides: K1's plain version
window by window against the reference's Pallas kernel in interpret mode,
run eagerly as the JAX package's own tests run it (under jit XLA drops some
of the kernel's bf16 rounding points, and the two then agree on ~0.990 of
the values in place of ~0.992). Bars (ROADMAP "Not faults": tiled energies
are held to K1's bounds): max |d| <= 2e-2 of the peak, and equal on >= 0.99
of the values (K1's rounding points, tests/test_torch_k1_rounding.py).

test_torch_published_config4_energies_f32.py and ..._f32_101.py hold
float32 (the modulated route) with this file's ``block`` and
``port_energies``; experiments/torch_published_stages.py config4 the whole
frames. One seed a file: ~45 s alone, most of it the reference's kernel in
interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu.models import pipeline as jax_pipeline
from gabor_color_image_segmentation_tpu.ops.bank import make_bank as jax_make_bank
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank
from gabor_color_image_segmentation_tpu_torch.ops.tiled import tile_offsets

torch.set_num_threads(2)

BLOCK = (1296, 2304)  # 3 x 3 windows of config4's tile_hw
BOUND, EQUAL_FLOOR = 2e-2, 0.99


def block(seed):
    h, w = preset("config4").image_hw
    rgb = synthetic_mosaic(h=h, w=w, n_regions=5, seed=seed)[0]
    return np.ascontiguousarray(rgb[None, :BLOCK[0], :BLOCK[1]])


def port_energies(rgb, cfg, monkeypatch):
    """The port's compute_energies on ``rgb`` -> ((1, h, w, E) float32
    energies, the windows it ran)."""
    windows = []
    real = pipeline._ENERGIES[cfg.feature_impl]

    def spy(win, bank, dtype):
        windows.append(tuple(win.shape[1:3]))
        return real(win, bank, dtype)

    monkeypatch.setitem(pipeline._ENERGIES, cfg.feature_impl, spy)
    energies, _ = pipeline.compute_energies(torch.from_numpy(rgb), cfg, make_bank(cfg.bank),
                                            cfg.graph.pool)
    return energies.float().permute(0, 2, 3, 1).numpy(), windows


def test_block_is_three_by_three_windows():
    cfg = preset("config4")
    th, tw, ys, xs = tile_offsets(*BLOCK, cfg.tile_hw)
    assert (th, tw, ys, xs) == (432, 768, [0, 432, 864], [0, 768, 1536])
    assert make_bank(cfg.bank).config.max_halo == 39


def check_k1(seed, monkeypatch):
    """K1's plain version window by window on seed's block against the
    reference's Pallas K1, within BOUND of the peak and equal on
    EQUAL_FLOOR of the values."""
    rgb = block(seed)
    jcfg = jax_preset("config4").replace(batch_size=1, dtype="bfloat16", feature_impl="pallas")
    ref, _ = jax_pipeline.compute_energies(jnp.asarray(rgb), jcfg, jax_make_bank(jcfg.bank),
                                           jcfg.graph.pool)
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    cfg = preset("config4").replace(batch_size=1, dtype="bfloat16", feature_impl="pallas")
    got, windows = port_energies(rgb, cfg, monkeypatch)
    # halos of 39 on the sides that are not the block's border
    assert sorted(set(windows)) == [(471, 807), (471, 846), (510, 807), (510, 846)]
    assert len(windows) == 9
    assert got.shape == ref.shape == (1, BLOCK[0] >> 2, BLOCK[1] >> 2, 36)
    err = float(np.abs(got - ref).max() / np.abs(ref).max())
    equal = float((got == ref).mean())
    assert err <= BOUND and equal >= EQUAL_FLOOR, (err, equal)


def test_tiled_k1_matches_jax(monkeypatch):
    check_k1(100, monkeypatch)
