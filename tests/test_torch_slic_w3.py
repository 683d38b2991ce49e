"""PyTorch port, K11's host-side plan and the plain versions of its pass and
update (models/slic_fused.py), on the CPU; no JAX: ``slic_plain``, which the
pass-and-update loop must reproduce bit for bit, is held against the JAX
package's w3 kernel in test_torch_slic.py.

- ``slic_w3_plan``: the tiles of grid cells a pass block takes cover every
  pixel once, each pixel's float32 cell lies in its tile, and its clipped
  3 x 3 candidate cells lie in the tile's hoisted set (the tile's cells
  +- 1), which fits the kernel's 128 cells; at config3's frame, at other
  superpixel counts, and on frames with one grid row or column or smaller
  than a tile.
- The plain pass's partials, added per superpixel over the tiles that
  hoist it, equal ``slic_plain``'s update moments bit for bit (the float64
  sums of the Lab of uint8 images are exact), and n_iter plain passes and
  updates give ``slic_plain``'s labels bit for bit."""

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import slic as sl
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab

torch.set_num_threads(2)

# (h, w, n_superpixels): config3's frame at its 925 superpixels and at
# others; one grid row (gh = 1), one grid column, gh = 2, frames smaller
# than a tile, more cells than pixel rows
PLAN_GEOMETRIES = [(321, 481, 925), (321, 481, 100), (321, 481, 400), (321, 481, 2000),
                   (20, 301, 30), (301, 20, 30), (40, 77, 20), (9, 13, 4), (5, 7, 60),
                   (161, 77, 60), (540, 960, 405), (1, 1, 1)]


@pytest.mark.parametrize("geometry", PLAN_GEOMETRIES)
def test_slic_w3_plan_holds_every_candidate(geometry):
    h, w, n_sp = geometry
    plan = sf.slic_w3_plan(h, w, n_sp)
    gh, gw, ty, tx = plan["gh"], plan["gw"], plan["ty"], plan["tx"]
    assert (gh, gw) == sl.grid_shape(h, w, n_sp)[:2]
    assert 1 <= ty <= gh and 1 <= tx <= gw
    assert plan["cells"] == (ty + 2) * (tx + 2) <= 128
    assert (plan["nty"], plan["ntx"]) == (-(-gh // ty), -(-gw // tx))
    assert plan["parts_shape"] == (plan["nty"], plan["ntx"], plan["cells"], 6)
    for n, g, t, nt, bounds in ((h, gh, ty, plan["nty"], plan["rows"]),
                                (w, gw, tx, plan["ntx"], plan["cols"])):
        assert len(bounds) == nt + 1 and bounds[0] == 0 and bounds[-1] == n
        assert all(a <= b for a, b in zip(bounds, bounds[1:]))
        cells = sl.cell_index(n, g, "cpu").numpy()
        tile = np.searchsorted(np.asarray(bounds), np.arange(n), side="right") - 1
        # each pixel's cell lies in its tile, and its candidates (the cell
        # +- 1, clipped to the grid) in the tile's hoisted cells
        assert np.all(tile * t <= cells) and np.all(cells < (tile + 1) * t)
        lo, hi = np.maximum(cells - 1, 0), np.minimum(cells + 1, g - 1)
        assert np.all(tile * t - 1 <= lo) and np.all(hi <= tile * t + t)


def test_slic_w3_plan_at_config3():
    plan = sf.slic_w3_plan(321, 481, 925)
    assert (plan["gh"], plan["gw"], plan["ty"], plan["tx"]) == (25, 37, 2, 4)
    assert (plan["nty"], plan["ntx"], plan["cells"]) == (13, 10, 24)
    assert plan["rows"][:3] == (0, 26, 52) and plan["cols"][:3] == (0, 52, 104)


def _lab(h, w, b):
    rgb = np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0]
                    for i in range(b)])
    return rgb_to_lab(torch.from_numpy(rgb))


# (h, w, n_superpixels, ruler, batch): config3's frame at batch 1, a small
# frame at batch 2, one grid row, one grid column, a frame under one tile
PARTIAL_GEOMETRIES = [(321, 481, 925, 5.0, 1), (64, 96, 60, 10.0, 2), (20, 301, 30, 10.0, 2),
                      (301, 20, 30, 10.0, 1), (9, 13, 4, 10.0, 2)]


@pytest.mark.parametrize("geometry", PARTIAL_GEOMETRIES)
def test_slic_w3_partials_sum_to_slic_moments(geometry):
    h, w, n_sp, ruler, b = geometry
    lab = _lab(h, w, b)
    plan = sf.slic_w3_plan(h, w, n_sp)
    _, _, sw = sl.slic_geometry(h, w, n_sp, ruler)
    rows = sl._pixel_rows(lab)
    cent = sl.slic_init_centroids(lab, plan["gh"], plan["gw"])
    for _ in range(3):
        labels, parts = sf.slic_w3_pass_plain(lab, cent, plan, sw)
        sums, counts = sl.slic_moments(rows, labels.reshape(b, -1).long(),
                                       plan["gh"] * plan["gw"])
        g = sf.slic_w3_moments(parts, plan)
        assert torch.equal(g[..., :5], sums)
        assert torch.equal(g[..., 5], counts.to(torch.float64))
        cent = sf.slic_w3_update_plain(cent, parts, plan)
        assert torch.equal(cent, sl.slic_update(cent, sums, counts))


@pytest.mark.parametrize("geometry", PARTIAL_GEOMETRIES)
def test_slic_w3_plain_loop_equals_slic_plain(geometry):
    """n_iter plain passes with partials and updates and a last assignment,
    as the kernel's C loop runs them, give slic_plain's labels bit for bit;
    the wrappers take the plain versions for CPU tensors."""
    h, w, n_sp, ruler, b = geometry
    lab = _lab(h, w, b)
    _, _, sw = sl.slic_geometry(h, w, n_sp, ruler)
    plan = sf.slic_w3_plan(h, w, n_sp)
    cent = sl.slic_init_centroids(lab, plan["gh"], plan["gw"])
    for _ in range(10):
        _, parts = sf.slic_w3_pass(lab, cent, n_sp, sw)
        cent = sf.slic_w3_update(cent, parts, h, w, n_sp)
    labels, none = sf.slic_w3_pass(lab, cent, n_sp, sw, partials=False)
    assert none is None
    assert torch.equal(labels, sl.slic_plain(lab, n_sp, ruler, 10))
    assert torch.equal(labels, sf.slic_w3(lab, n_sp, ruler, 10))
