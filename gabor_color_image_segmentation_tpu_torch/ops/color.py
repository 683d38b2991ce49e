"""RGB -> CIELab (counterpart of the JAX package's ops/color.py).

sRGB (D65) -> linear RGB -> XYZ -> CIELab, as ``cv2.cvtColor(img,
COLOR_RGB2LAB)`` on float32 input (L in [0, 100]). The 3x3 sRGB->XYZ
product is written as explicit per-channel multiply-adds, not a matmul: a
reduced-precision matmul (TPU DEFAULT precision there, TF32 here) would
round the operands and cost ~5e-3 relative error on a/b.
"""

from __future__ import annotations

import torch

# sRGB -> XYZ (D65) matrix, IEC 61966-2-1.
_RGB2XYZ = (
    (0.4124564, 0.3575761, 0.1804375),
    (0.2126729, 0.7151522, 0.0721750),
    (0.0193339, 0.1191920, 0.9503041),
)
_WHITE = (0.95047, 1.0, 1.08883)  # D65 reference white
_DELTA = 6.0 / 29.0


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Inverse sRGB gamma. Input in [0, 1]."""
    return torch.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def _lab_f(t: torch.Tensor) -> torch.Tensor:
    # the cube root branch only ever sees t > delta^3 > 0; the clamp keeps
    # the unused branch free of NaNs
    return torch.where(
        t > _DELTA**3,
        t.clamp(min=_DELTA**3) ** (1.0 / 3.0),
        t / (3.0 * _DELTA**2) + 4.0 / 29.0,
    )


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """(..., 3) sRGB in [0, 1] (or uint8, scaled by 1/255) -> (..., 3)
    float32 CIELab."""
    if rgb.dtype == torch.uint8:
        rgb = rgb.to(torch.float32) / 255.0
    lin = srgb_to_linear(rgb.to(torch.float32))
    r, g, b_ = lin[..., 0], lin[..., 1], lin[..., 2]
    m = _RGB2XYZ
    f = [
        _lab_f((m[i][0] * r + m[i][1] * g + m[i][2] * b_) / _WHITE[i])
        for i in range(3)
    ]
    fx, fy, fz = f
    return torch.stack(
        [116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)], dim=-1
    )
