"""Feature stage of the port: colour transform, Gabor bank, fused energies
(kernel K1), the standardisation-affine helpers and the per-image table
lookup (kernel K15)."""
