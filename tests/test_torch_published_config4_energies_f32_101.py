"""PyTorch port at config4's published geometry, stage 1 in float32 on
seed 101's block: test_torch_published_config4_energies_f32.py's check
(the modulated route on 3x3 of the 432x768 windows against the JAX
package's), a file of its own so --dist loadfile runs the two seeds on
two workers (~60 s alone)."""

from test_torch_published_config4_energies_f32 import check_modulated


def test_tiled_modulated_matches_jax_seed_101(monkeypatch):
    check_modulated(101, monkeypatch)
