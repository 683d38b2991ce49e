"""PyTorch port, K14's algorithm on the CPU: ``enforce_connectivity_bfs_plain``
(the city-block distance to the kept pixels, a pointer to the first nearer
neighbour up, left, right, down, pointer jumping) bit-equal to
``enforce_connectivity_plain`` (the reference's Jacobi adoption loop), on
fragmented random maps, spiral mazes, a map with no surviving component,
1-row and 1-column images and maps whose survivors s_max cuts.

Why no map passes the loop's h + w cap with a kept pixel in it: every unset
pixel can be set, so the adoption spreads over the whole 4-connected grid
and reaches a pixel at its city-block distance to the nearest kept pixel,
at most h + w - 2. The spiral mazes make a corridor many times h + w long;
the adoption crosses its walls. Only an image that keeps nothing reaches
the cap, and there every pixel ends at 0 (both forms)."""

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.data import connectivity_maze
from gabor_color_image_segmentation_tpu_torch.data.synthetic import spiral_path
from gabor_color_image_segmentation_tpu_torch.models import slic as sl

torch.set_num_threads(2)


def _fragmented(h, w, n_sp, seed=7):
    """tests/test_torch_cuda.py's recipe: 8 x 8 blocks of random labels, a
    quarter of the pixels relabelled at random, the map and its mirror."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, n_sp, ((h + 7) // 8, (w + 7) // 8))
    lab = np.kron(base, np.ones((8, 8), int))[:h, :w]
    lab = np.where(rng.random((h, w)) < 0.25, rng.integers(0, n_sp, (h, w)), lab)
    return torch.from_numpy(np.stack([lab, lab[:, ::-1]]).astype(np.int32))


def _maze(h, w, kept):
    lab = connectivity_maze(h, w, kept)
    return torch.from_numpy(np.stack([lab, lab[::-1, ::-1]]).copy())


def _both(lab, n_sp, min_size=None, s_max=None):
    ref = sl.enforce_connectivity_plain(lab, n_sp, min_size, s_max)
    got = sl.enforce_connectivity_bfs_plain(lab, n_sp, min_size, s_max)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref)
    return got


@pytest.mark.parametrize("case", [(48, 64, 12, 16, None), (33, 47, 20, 4, 7),
                                  (64, 96, 40, 30, None), (57, 31, 8, 50, None),
                                  (96, 128, 64, None, None)])
@pytest.mark.parametrize("seed", [7, 11])
def test_bfs_equals_jacobi_on_fragmented_maps(case, seed):
    h, w, n_sp, min_size, s_max = case
    _both(_fragmented(h, w, n_sp, seed), n_sp, min_size, s_max)


@pytest.mark.parametrize("kept", ["centre", "corner", "walls"])
@pytest.mark.parametrize("hw", [(41, 37), (64, 64)])
def test_bfs_equals_jacobi_on_spiral_mazes(kept, hw):
    h, w = hw
    lab = _maze(h, w, kept)
    assert spiral_path(h, w).sum() > 2 * (h + w)  # the corridor passes the cap
    _both(lab, 16, 5)
    r = sl.connectivity_readings(lab, 16, 5)
    # the adoption does not follow the corridor: its longest distance stays
    # under the cap, and the loop runs exactly that many steps
    assert 0 < r["max_distance"] <= h + w - 2
    assert r["adoption_steps"] == r["max_distance"]
    if kept == "corner":
        assert r["max_distance"] == h + w - 6


def test_no_surviving_component_ends_at_zero():
    lab = _maze(41, 37, "none")
    assert int(_both(lab, 16, 5).abs().sum()) == 0
    r = sl.connectivity_readings(lab, 16, 5)
    assert r["adoption_steps"] == 41 + 37 and r["kept_per_image"] == (0, 0)
    # a min_size above every component's size absorbs the fragmented map too
    assert int(_both(_fragmented(40, 40, 4), 4, 40 * 40 + 1).abs().sum()) == 0


@pytest.mark.parametrize("hw", [(1, 50), (1, 1), (29, 1), (1, 200)])
def test_one_row_and_one_column_images(hw):
    h, w = hw
    for n_sp, min_size in ((5, 2), (3, 4), (1, 1)):
        _both(_fragmented(h, w, n_sp), n_sp, min_size)


@pytest.mark.parametrize("s_max", [0, 1, 3, 7])
def test_s_max_cuts_survivors(s_max):
    lab = _fragmented(64, 96, 40)
    got = _both(lab, 40, 30, s_max)
    assert int(got.max()) < max(s_max, 1)
    # without the cap more components survive than s_max keeps
    assert int(sl.enforce_connectivity_plain(lab, 40, 30).max()) + 1 > s_max


def _bfs_relaxation(kept):
    """An independent reference: Bellman-Ford relaxation over the 4-connected
    grid to its fixpoint."""
    dist = torch.where(kept, 0, sl.DIST_INF).to(torch.int64)
    while True:
        nxt = dist
        for dy, dx in ((-1, 0), (0, -1), (0, 1), (1, 0)):
            nxt = torch.minimum(nxt, sl._shifted(dist, dy, dx, sl.DIST_INF) + 1)
        nxt = torch.where(kept, 0, nxt.clamp(max=sl.DIST_INF))
        if torch.equal(nxt, dist):
            return dist
        dist = nxt


@pytest.mark.parametrize("case", ["fragmented", "maze", "none", "row", "column"])
def test_city_block_distance_is_the_bfs_distance(case):
    lab = {"fragmented": lambda: _fragmented(48, 64, 12),
           "maze": lambda: _maze(41, 37, "corner"),
           "none": lambda: _maze(19, 23, "none"),
           "row": lambda: _fragmented(1, 70, 5),
           "column": lambda: _fragmented(70, 1, 5)}[case]()
    h, w = lab.shape[1:]
    n_sp = 12 if case == "fragmented" else 5
    min_size, s_max = sl.connectivity_defaults(h, w, n_sp, 5 if case != "fragmented" else None,
                                               None)
    seeds = sl._seeds(lab, sl.connected_components(lab), min_size, s_max)
    kept = seeds >= 0
    assert torch.equal(sl.city_block_distance(kept), _bfs_relaxation(kept))
