"""PyTorch port at config4's published geometry, stage 1 in bfloat16 on
seed 101's block: test_torch_published_config4_energies.py's check (K1's
plain version on 3x3 of the 432x768 windows against the JAX package's
Pallas K1, eagerly), a file of its own so --dist loadfile runs the two
seeds on two workers (~45 s alone)."""

from test_torch_published_config4_energies import check_k1


def test_tiled_k1_matches_jax_seed_101(monkeypatch):
    check_k1(101, monkeypatch)
