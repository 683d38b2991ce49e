"""PyTorch port, K12's cluster plan (``slic_fused.w5_layout`` and
``slic_w5_plan``): which CTA of an image's thread-block cluster owns which
(band, column piece) piece, which grid rows its candidate table holds,
where it finds the partials of every superpixel it updates, and how much
shared memory it takes, at K12's frame and at the extremes of the range
``slic_route(h, w, S, "w5")`` admits (S = 12,000 on 1052x16 and 1422x16,
1422x127 with S = 10, a width that is not a multiple of 4).

The update is replayed in numpy from the plan alone, as the kernel reads
it (each piece's partials as its own window, gathered in (band, piece)
order from the owning CTA), and must give K13's plain update bit for bit.
No JAX: the kernel's plain version is the banded loop, held against the
JAX package in tests/test_torch_slic_banded.py."""

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import slic as tslic
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab

torch.set_num_threads(2)

# K12's frame; the range's extremes; a frame whose width is not a multiple
# of 4 (scalar loads) and one piece a band; a frame of two pieces
FRAMES = [(321, 481, 400), (1052, 16, 12000), (1422, 16, 12000), (1422, 127, 10),
          (161, 77, 60), (37, 53, 10)]
# co-resident clusters of 1, 2, 4, 8, 16 CTAs as an H100 reports them for a
# CTA an SM (K3's counts, PERF.md), and for two an SM (CTAs of 1 or 2
# groups; 4 groups, 1,024 threads, take one an SM)
ONE_AN_SM, TWO_AN_SM = (132, 66, 30, 15, 7), (264, 132, 62, 30, 14)
ACTIVE = {"one_an_sm": {(c, g, cw): n for c, n in zip(sf.W5_CLUSTERS, ONE_AN_SM)
                        for g in sf.W5_GROUPS for cw in sf.W5_COLS},
          "two_an_sm": {(c, g, cw): (n2 if g < 4 else n1)
                        for c, n1, n2 in zip(sf.W5_CLUSTERS, ONE_AN_SM, TWO_AN_SM)
                        for g in sf.W5_GROUPS for cw in sf.W5_COLS}}
SMEM_BLOCK = 227 * 1024  # what one CTA may take on an H100


def _pieces_holding(lay, gy, gx):
    """Every piece whose window holds superpixel (gy, gx), by brute force."""
    out = []
    for q in range(lay["pieces"]):
        t, cp = divmod(q, lay["n_col_pieces"])
        lo, hi = lay["cols"][cp]
        if lay["rb"][t] <= gy < lay["rb"][t] + lay["w_rows"] and lo <= gx <= hi:
            out.append(q)
    return out


@pytest.mark.parametrize("frame", FRAMES)
def test_w5_frames_are_in_the_range(frame):
    assert sf.slic_route(*frame, plan="w5") == "w5"
    lay = sf.w5_layout(*frame, 16, 1)
    assert lay["rb"] == tuple(int(v) for v in sf._band_plan(*frame)["rb"])


@pytest.mark.parametrize("cw", sf.W5_COLS)
@pytest.mark.parametrize("groups", sf.W5_GROUPS)
@pytest.mark.parametrize("ctas", sf.W5_CLUSTERS)
@pytest.mark.parametrize("frame", FRAMES)
def test_every_piece_owned_once_in_order(frame, ctas, groups, cw):
    """Each CTA owns a run of pieces; the runs follow each other in (band,
    piece) order and cover every piece exactly once; the piece pixels add
    up to the frame; a CTA's costliest group is the one whose share of the
    run (every groups-th piece) costs most."""
    lay = sf.w5_layout(*frame, ctas, groups, cw)
    first = lay["first"]
    assert first[0] == 0 and first[-1] == lay["pieces"] == lay["n_bands"] * lay["n_col_pieces"]
    assert all(a <= b for a, b in zip(first, first[1:]))
    owner = np.concatenate([np.full(n, r) for r, n in enumerate(lay["owned"])])
    assert owner.shape == (lay["pieces"],) and (np.diff(owner) >= 0).all()
    assert max(lay["owned"]) - min(lay["owned"]) <= 1 and lay["kmax"] == max(lay["owned"])
    assert sum(lay["pixels"]) == frame[0] * frame[1]
    for r in range(ctas):
        run = list(range(lay["first"][r], lay["first"][r + 1]))
        shares = [run[g::groups] for g in range(groups)]
        assert sorted(q for sh in shares for q in sh) == run
        assert lay["work"][r] <= lay["pixels"][r] + sf._W5_PIECE_PIXELS * len(run)
        assert lay["work"][r] >= (lay["pixels"][r] + sf._W5_PIECE_PIXELS * len(run)) / groups


@pytest.mark.parametrize("ctas", sf.W5_CLUSTERS)
@pytest.mark.parametrize("frame", FRAMES)
def test_every_superpixel_found_among_the_owners(frame, ctas):
    """Every candidate of a CTA's pieces lies in its table; for every
    superpixel of its table the plan's bands and column pieces are exactly
    the pieces whose window holds it, each owned by one CTA of the image and
    holding it at a local index inside that piece's window."""
    lay = sf.w5_layout(*frame, ctas, 1)
    gw, wr, ncp = lay["gw"], lay["w_rows"], lay["n_col_pieces"]
    first = lay["first"]
    for r in range(ctas):
        ty0, ty1 = lay["rows"][r]
        assert ty1 - ty0 <= lay["tmax"]
        for q in range(first[r], first[r + 1]):
            t, cp = divmod(q, ncp)
            lo, hi = lay["cols"][cp]
            assert ty0 <= lay["rb"][t] and lay["rb"][t] + wr <= ty1
            assert wr * (hi - lo + 1) <= lay["nmax"]
        for gy in range(ty0, ty1):
            t_lo, t_hi = lay["bands"][gy]
            for gx in range(gw):
                found = []
                for t in range(t_lo, t_hi + 1):
                    for cp in range(ncp):
                        lo, hi = lay["cols"][cp]
                        if not lo <= gx <= hi:
                            continue
                        q = t * ncp + cp
                        owner = int(np.searchsorted(first, q, side="right")) - 1
                        assert first[owner] <= q < first[owner + 1]
                        j = (gy - lay["rb"][t]) * (hi - lo + 1) + gx - lo
                        assert 0 <= j < wr * (hi - lo + 1)
                        found.append(q)
                assert found == _pieces_holding(lay, gy, gx)


@pytest.mark.parametrize("active", sorted(ACTIVE))
@pytest.mark.parametrize("b", [1, 8, 20])
@pytest.mark.parametrize("frame", FRAMES)
def test_plan_fits_shared_memory(frame, b, active):
    """The chosen cluster fits one CTA's 227 KB with its table, the band
    pass's scratch and (where the plan keeps them there) its partials in
    two buffers; no table holds a whole image's candidates at the range's
    extremes; the waves cover the batch."""
    plan = sf.slic_w5_plan(*frame, b, ACTIVE[active])
    assert plan["smem"] <= SMEM_BLOCK - 1024
    assert (plan["ctas"], plan["groups"], plan["cw"]) in sf.W5_SHAPES
    assert plan["ctas"] <= plan["pieces"]
    assert plan["waves"] * plan["active"] >= b > (plan["waves"] - 1) * plan["active"]
    base = (32 * plan["tmax"] * plan["gw"] + plan["groups"] * sf._pass_smem(plan["nmax"])
            + 4 * len(plan["table"]))
    assert len(plan["table"]) == (3 * plan["ctas"] + 1 + 2 * plan["gh"] + plan["n_bands"]
                                  + 2 * plan["n_col_pieces"])
    parts = 8 * 12 * plan["kmax"] * plan["nmax"]
    assert plan["smem"] == base + (parts if plan["parts_in_smem"] else 0)
    assert plan["parts_in_smem"] == (base + parts <= SMEM_BLOCK - 1024)
    if frame[2] >= 12000:
        assert plan["tmax"] < plan["gh"]


def test_plan_picks_by_waves_and_work():
    """At K12's frame and batch 8, clusters of 16 CTAs of 2 groups on pieces
    64 columns wide win when the card holds 14 such clusters at once (one
    wave, six pieces a CTA shared by two groups); with 7 at once (one CTA
    an SM) 8 CTAs of 4 groups win (one wave). At batch 1 the 4 groups of 16
    CTAs pass the image's 44 pieces of 128 columns in one round. Tall,
    narrow frames keep their partials in the global scratch where shared
    memory cannot hold them. Shapes the card cannot hold are never chosen."""
    def shape(b, active):
        plan = sf.slic_w5_plan(321, 481, 400, b, active)
        return plan["ctas"], plan["groups"], plan["cw"]

    assert shape(8, ACTIVE["two_an_sm"]) == (16, 2, 64)
    assert shape(8, ACTIVE["one_an_sm"]) == (8, 4, 128)
    assert shape(1, ACTIVE["two_an_sm"]) == (16, 4, 128)
    assert shape(8, {(8, 1, 128): 1}) == (8, 1, 128)
    assert not sf.w5_layout(1422, 16, 12000, 8, 1)["parts_in_smem"]
    assert sf.w5_layout(321, 481, 400, 16, 2)["parts_in_smem"]
    with pytest.raises(ValueError, match="no K12 cluster"):
        sf.slic_w5_plan(321, 481, 400, 8, {})


def _update_from_plan(cent, parts, lay):
    """K12's update replayed from the plan: every CTA's table rows, each
    superpixel's partials gathered from the owners' piece windows in (band,
    piece) order and added in float64, then K13's centroid step. Returns
    (B, S, 5) centroids, asserting that all CTAs holding a superpixel agree."""
    b = cent.shape[0]
    gw, wr, ncp = lay["gw"], lay["w_rows"], lay["n_col_pieces"]
    # each piece's partials as its own window, as the kernel stores them
    window = {}
    for q in range(lay["pieces"]):
        t, cp = divmod(q, ncp)
        lo, hi = lay["cols"][cp]
        cells = parts[:, t, cp].reshape(b, wr, gw, 6)[:, :, lo:hi + 1]
        window[q] = cells.reshape(b, -1, 6)
    out = cent.clone()
    seen = {}
    for r in range(lay["ctas"]):
        ty0, ty1 = lay["rows"][r]
        for gy in range(ty0, ty1):
            t_lo, t_hi = lay["bands"][gy]
            for gx in range(gw):
                acc = torch.zeros((b, 6), dtype=torch.float64)
                for t in range(t_lo, t_hi + 1):
                    for cp in range(ncp):
                        lo, hi = lay["cols"][cp]
                        if lo <= gx <= hi:
                            j = (gy - lay["rb"][t]) * (hi - lo + 1) + gx - lo
                            acc += window[t * ncp + cp][:, j]
                s = gy * gw + gx
                if s in seen:
                    assert torch.equal(seen[s], acc)
                seen[s] = acc
    for s, acc in seen.items():
        upd = tslic.slic_update(cent[:, s:s + 1], acc[:, None, :5], acc[:, None, 5])
        out[:, s] = upd[:, 0]
    return out


@pytest.mark.parametrize("cw", sf.W5_COLS)
@pytest.mark.parametrize("ctas", [1, 4, 16])
@pytest.mark.parametrize("frame", [(96, 128, 64), (161, 77, 60), (200, 301, 150)])
def test_update_from_plan_is_k13s(frame, ctas, cw):
    """The update the kernel runs, replayed from the plan on K13's plain
    partials two iterations in, gives K13's plain update bit for bit; every
    superpixel of the grid is held by some CTA's table."""
    h, w, n_sp = frame
    rgb = np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0] for i in range(2)])
    lab = rgb_to_lab(torch.from_numpy(rgb))
    bp = sf._band_plan(h, w, n_sp)
    lay = sf.w5_layout(h, w, n_sp, ctas, 1, cw)
    _, _, sw = tslic.slic_geometry(h, w, n_sp, 10.0)
    cent = tslic.slic_init_centroids(lab, bp["gh"], bp["gw"])
    for _ in range(2):
        parts = sf.slic_band_pass_plain(lab, cent, bp, sw, cols=cw)[1]
        want = sf.slic_band_update_plain(cent, parts, bp)
        got = _update_from_plan(cent, parts, lay)
        assert torch.equal(got, want)
        cent = want
    held = set()
    for ty0, ty1 in lay["rows"]:
        held.update(range(ty0 * lay["gw"], ty1 * lay["gw"]))
    assert held == set(range(lay["gh"] * lay["gw"]))


def test_w5_cpu_path_is_the_plain_loop():
    """On the CPU slic_w5 is the plain banded loop, at n_iter 0 and 1 too."""
    rgb = synthetic_mosaic(h=64, w=96, n_regions=4, seed=3)[0][None]
    lab = rgb_to_lab(torch.from_numpy(rgb))
    for n_iter in (0, 1, 10):
        ref = tslic.slic_plain(lab, 30, 10.0, n_iter)
        assert torch.equal(sf.slic_w5(lab, 30, 10.0, n_iter), ref)
        assert torch.equal(sf.slic_banded_plain(lab, 30, 10.0, n_iter), ref)
