"""Spatial tiling of the feature stage and the pipeline's exact 2x2 pooling
(counterpart of the JAX package's ops/tiled.py::gabor_energies_tiled and
models/pipeline.py::_pool2x2_nhwc).

Large frames (config4's 4K) run the energies window by window: each
window is a tile of ``tile_hw`` plus a halo of the bank's ``max_halo`` on
every side that is not a true image border (clamped, never reflected: the
energies reflect the magnitude map at a true border, which a reflected
input would change), the last window of a ragged axis shifted inward. The
energies function (K1 with no twin by default, or the caller's, as the
reference's ``energies_fn``: the pipeline passes the modulated route
there) runs on the window, the tile's interior is kept, pooled ``pool``
times and written into one (B, E, H >> pool, W >> pool) tensor, so the
full-resolution energies of the frame never exist.

K1 centres each input on its own per-channel mean, so a window's energies
differ from the whole frame's in their last bits, as they do in the
reference (tests/test_tiling.py); the tiled result is held to K1's bounds,
not to bit-equality.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from gabor_color_image_segmentation_tpu_torch.ops.bank import GroupTensors
from gabor_color_image_segmentation_tpu_torch.ops.fused import gabor_energies_fused


def pool2x2_mean(x: torch.Tensor, spatial_dim: int) -> torch.Tensor:
    """Exact 2x2 block means ((x00 + x01) + (x10 + x11)) * 0.25 in float32,
    cast back to x's dtype, over axes ``spatial_dim`` (rows) and
    ``spatial_dim + 1`` (columns): 1 for (B, H, W, C), 2 for (B, C, H, W).
    An odd last row or column is dropped. Bit-equal to the reference's
    _pool2x2_nhwc in both storage dtypes (it pools the stored values)."""
    h2, w2 = x.shape[spatial_dim] // 2, x.shape[spatial_dim + 1] // 2

    def part(dy: int, dx: int) -> torch.Tensor:
        idx = [slice(None)] * x.dim()
        idx[spatial_dim] = slice(dy, 2 * h2, 2)
        idx[spatial_dim + 1] = slice(dx, 2 * w2, 2)
        return x[tuple(idx)].to(torch.float32)

    s = (part(0, 0) + part(0, 1)) + (part(1, 0) + part(1, 1))
    return (0.25 * s).to(x.dtype)


def tile_offsets(h: int, w: int, tile_hw: Tuple[int, int]):
    """(th, tw, row offsets, column offsets) of the windows' interiors: a
    grid of ``tile_hw`` tiles, the last of a ragged axis shifted inward."""
    th, tw = min(tile_hw[0], h), min(tile_hw[1], w)
    ys = sorted({min(i * th, h - th) for i in range(-(-h // th))})
    xs = sorted({min(j * tw, w - tw) for j in range(-(-w // tw))})
    return th, tw, ys, xs


def gabor_energies_tiled(
    color: torch.Tensor, groups: Sequence[GroupTensors], dtype: torch.dtype,
    tile_hw: Tuple[int, int], halo: int, pool: int = 0,
    energies_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, E, H >> pool, W >> pool) energies, tile
    by tile, ``energies_fn`` once per window: (B, h, w, C) -> (B, E, h, w),
    in whatever dtype it returns; None is K1 on ``groups`` in ``dtype``.
    ``halo``: the bank's ``max_halo`` (conv radius + smoothing radius).
    Raises ValueError when a tile or an offset is not a multiple of 2^pool
    (a 2^pool block would straddle two tiles)."""
    b, h, w, _ = color.shape
    th, tw, ys, xs = tile_offsets(h, w, tile_hw)
    f = 1 << pool
    if pool and any(v % f for v in [th, tw, h, w, *ys, *xs]):
        raise ValueError(
            f"tiled pooling needs tile/image geometry divisible by {f}, got "
            f"tile {th}x{tw} over {h}x{w} at offsets {ys}x{xs}"
        )
    if energies_fn is None:
        def energies_fn(win):
            return gabor_energies_fused(win, groups, dtype, pooled=False)[0]
    out = None
    for y0 in ys:
        for x0 in xs:
            y_lo, y_hi = max(0, y0 - halo), min(h, y0 + th + halo)
            x_lo, x_hi = max(0, x0 - halo), min(w, x0 + tw + halo)
            win = energies_fn(color[:, y_lo:y_hi, x_lo:x_hi])
            part = win[:, :, y0 - y_lo:y0 - y_lo + th, x0 - x_lo:x0 - x_lo + tw]
            for _ in range(pool):
                part = pool2x2_mean(part, 2)
            if out is None:
                out = torch.empty((b, part.shape[1], h // f, w // f), dtype=part.dtype,
                                  device=color.device)
            out[:, :, y0 // f:(y0 + th) // f, x0 // f:(x0 + tw) // f] = part
    return out
