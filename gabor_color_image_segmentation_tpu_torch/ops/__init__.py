"""Feature stage of the port: colour transform, Gabor bank, fused energies
(kernel K1) and the standardisation-affine helpers."""
