"""PyTorch port on the card: each Hopper kernel against its plain PyTorch
version on the same CUDA tensors, at small and ragged shapes (tile edges,
odd sizes), and the pipeline's kernel path against its all-plain path.

Marked ``cuda``: the tests skip without an NVIDIA card (decided inside the
``device`` fixture, never at import). Run them on a card with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest`` (the
file imports only the port, so the card's machine needs no JAX).
Tolerances as in chip_smoke.py."""

import dataclasses
import math

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.config import BankConfig, preset
from gabor_color_image_segmentation_tpu_torch.data import connectivity_maze, synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import chol
from gabor_color_image_segmentation_tpu_torch.models import connectivity as cn
from gabor_color_image_segmentation_tpu_torch.models import gmm_fused as gf
from gabor_color_image_segmentation_tpu_torch.models import graph as gr
from gabor_color_image_segmentation_tpu_torch.models import graph_fused as gm
from gabor_color_image_segmentation_tpu_torch.models import kmeans_chw as kc
from gabor_color_image_segmentation_tpu_torch.models import kmeans_fused as kf
from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gabor_color_image_segmentation_tpu_torch.models import slic as sl
from gabor_color_image_segmentation_tpu_torch.models import slic_fused as sf
from gabor_color_image_segmentation_tpu_torch.models.pipeline import segment_batch
from gabor_color_image_segmentation_tpu_torch.ops import fused, lookup, tiled
from gabor_color_image_segmentation_tpu_torch.ops import standardise as sd
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank
from gabor_color_image_segmentation_tpu_torch.ops.color import rgb_to_lab
from gabor_color_image_segmentation_tpu_torch.ops.precision import set_policy
from gabor_color_image_segmentation_tpu_torch.utils.labels import align_labels

pytestmark = pytest.mark.cuda

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    set_policy()
    return torch.device("cuda")


# K1's banks: a small one; the config0 bank widened past the radii K1's
# tiles were once sized for (conv radius 16, smoothing radius 25, as
# tests/test_torch_refusals.py's WIDE_BANKS); one at twice them or more
# (conv radius 32, smoothing radius 50: the bf16 bands past the blocks a
# warp keeps in registers); and radii of 300, where every tile reflects
# many times and both bf16 kernels stage their tiles in column strips
K1_BANKS = {
    "small": BankConfig(scales=(2.0, 4.0, 8.0), orientations=3, frequencies=(0.12,)),
    "conv_radius_16": dataclasses.replace(preset("config0").bank, max_ksize=33),
    "smooth_radius_25": dataclasses.replace(preset("config0").bank, smooth_truncate=3.1),
    "radii_32_50": BankConfig(scales=(2.0, 11.0), orientations=2, max_ksize=65,
                              smoothing=1.5),
    "radii_300": BankConfig(scales=(2.0, 100.0), orientations=1, frequencies=(0.12,),
                            max_ksize=601, smoothing=1.0),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", [(37, 53), (64, 96)])
@pytest.mark.parametrize("bank_name", sorted(K1_BANKS))
def test_gabor_energies_kernel(device, dtype, hw, bank_name):
    dt = DTYPES[dtype]
    groups = bank_tensors(make_bank(K1_BANKS[bank_name]), device)
    img = torch.randn((2, *hw, 3), generator=torch.Generator().manual_seed(0)).to(device)
    out, twin = fused.gabor_energies_fused(img, groups, dt)
    ref, ref_twin = fused.gabor_energies_fused_plain(img, groups, dt)
    torch.cuda.synchronize()
    peak = ref.float().abs().max()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max() <= tol * peak
    assert (twin.float() - ref_twin.float()).abs().max() <= tol * peak


@pytest.mark.parametrize("hw", [(37, 53), (64, 96)])
@pytest.mark.parametrize("bank_name", sorted(K1_BANKS))
def test_gabor_energies_kernel_rounds_as_plain(device, hw, bank_name):
    """bf16: the kernel rounds where its plain version does (the reference's
    rounding points, folded border taps, the pooled-smoothing twin), so all
    but a few stored values are equal, where rounding only at the store
    leaves most of them a bit apart."""
    groups = bank_tensors(make_bank(K1_BANKS[bank_name]), device)
    img = torch.randn((2, *hw, 3), generator=torch.Generator().manual_seed(1)).to(device)
    out, twin = fused.gabor_energies_fused(img, groups, torch.bfloat16)
    ref, ref_twin = fused.gabor_energies_fused_plain(img, groups, torch.bfloat16)
    torch.cuda.synchronize()
    assert (out == ref).float().mean().item() >= 0.99
    assert (twin == ref_twin).float().mean().item() >= 0.99


# config1's bank (conv radii 5-15, smoothing radii 5-24), the benchmark's: at
# its 321x481 frame, and at 37x53, where every tile lies on an edge and both
# sides are odd. bf16 takes the tensor-core route (tc_groups counts its five
# groups), float32 the FMA tap loops.
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", [(37, 53), (321, 481)])
def test_gabor_energies_kernel_config1(device, dtype, hw):
    dt = DTYPES[dtype]
    groups = bank_tensors(make_bank(preset("config1").bank), device)
    img = torch.randn((2, *hw, 3), generator=torch.Generator().manual_seed(2)).to(device)
    before = fused.gabor_energies_fused.tc_groups
    out, twin = fused.gabor_energies_fused(img, groups, dt)
    assert fused.gabor_energies_fused.tc_groups - before == (5 if dt == torch.bfloat16 else 0)
    ref, ref_twin = fused.gabor_energies_fused_plain(img, groups, dt)
    torch.cuda.synchronize()
    peak = ref.float().abs().max()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert (out.float() - ref.float()).abs().max() <= tol * peak
    assert (twin.float() - ref_twin.float()).abs().max() <= tol * peak
    if dt == torch.bfloat16:
        assert (out == ref).float().mean().item() >= 0.99
        assert (twin == ref_twin).float().mean().item() >= 0.99


def _rows(device, dt, b=2, e=7, h=29, w=41, seed=0):
    rng = np.random.default_rng(seed)
    xe = torch.from_numpy(np.abs(rng.normal(size=(b, e, h, w))).astype(np.float32))
    color = torch.from_numpy(rng.uniform(0, 100, size=(b, h, w, 3)).astype(np.float32))
    return xe.to(device, dt), kc.build_color4(color.to(device), dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lloyd_kernel(device, dtype):
    dt = DTYPES[dtype]
    xe, xc4 = _rows(device, dt)
    b, e = xe.shape[:2]
    g = torch.Generator().manual_seed(1)
    wc = (torch.randn((b, 5, e + 3), generator=g) * 0.1).to(device).to(dt).float()
    offs = torch.rand((b, 5), generator=g).to(device)
    labels, sums, counts = kc.lloyd_chw_pass(xe, xc4, wc, offs)
    rl, rs, rc = kc.lloyd_chw_pass_plain(xe, xc4, wc, offs)
    torch.cuda.synchronize()
    assert (labels == rl).float().mean() >= 0.9999
    assert torch.equal(counts, rc)
    assert torch.allclose(sums, rs, rtol=1e-4, atol=1e-4 * rs.abs().max().item())
    assert torch.equal(kc.lloyd_chw_pass(xe, xc4, wc, offs, assign_only=True), labels)


# K2's plan at its edges: (B, E, H, W, k). N not a multiple of the tile, N
# under one tile, batch 1 and 16, k = 1 and 8, config1's 243 rows, 603 rows
# (16-pixel tiles, five M-tiles a warp) and rows whose pointer is not
# 16-byte aligned (an energy view one plane into a larger buffer)
K2_CASES = {
    "ragged": (2, 20, 37, 53, 5),
    "under_tile": (2, 7, 5, 9, 3),
    "b1_config0": (1, 36, 321, 481, 5),
    "b16": (16, 40, 33, 47, 5),
    "k1": (2, 12, 40, 61, 1),
    "k8": (2, 12, 40, 61, 8),
    "d243": (2, 240, 41, 61, 5),
    "d603": (1, 600, 19, 23, 5),
    "offset": (1, 9, 31, 43, 4),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", list(K2_CASES))
def test_lloyd_kernel_plan_edges(device, dtype, case):
    """K2 against its plain version at the plan's edges, labels only equal
    to the full pass's labels, and two launches bit-equal."""
    dt = DTYPES[dtype]
    b, e, h, w, k = K2_CASES[case]
    if case == "offset":
        xe, xc4 = _rows(device, dt, b=b, e=e + 1, h=h, w=w, seed=3)
        xe = xe[:, 1:]  # contiguous, one odd plane past the allocation's start
        assert xe.is_contiguous() and xe.data_ptr() % 16
    else:
        xe, xc4 = _rows(device, dt, b=b, e=e, h=h, w=w, seed=len(case))
    g = torch.Generator().manual_seed(k)
    wc = (torch.randn((b, k, e + 3), generator=g) * 0.1).to(device).to(dt).float()
    offs = torch.rand((b, k), generator=g).to(device)
    labels, sums, counts = kc.lloyd_chw_pass(xe, xc4, wc, offs)
    again = kc.lloyd_chw_pass(xe, xc4, wc, offs)
    rl, rs, rc = kc.lloyd_chw_pass_plain(xe, xc4, wc, offs)
    torch.cuda.synchronize()
    assert (labels == rl).float().mean() >= 0.9999
    assert torch.equal(counts, rc)
    rtol = 1e-4 if dt == torch.float32 else 1e-3
    assert (sums - rs).abs().max() <= rtol * rs.abs().max()
    assert all(torch.equal(x, y) for x, y in zip((labels, sums, counts), again))
    assert torch.equal(kc.lloyd_chw_pass(xe, xc4, wc, offs, assign_only=True), labels)


def _chw_blobs(device, dt, b, e, h, w, k, seed):
    """Raw rows xe (B, E, H, W) and xc4 (B, 4, H, W) of k blobs ~4 noise
    radii apart, with the blob means as K2 takes centres (the affine a = 1,
    b = 0: wc the means rounded to dt, offs their squared norms): each
    pixel's own centre is nearer than any other by ~16 (E + 3), so no
    summation order moves a label."""
    rng = np.random.default_rng(seed)
    d, n = e + 3, h * w
    means = rng.normal(scale=4.0, size=(b, k, d))
    lab = rng.integers(0, k, size=(b, n))
    x = np.take_along_axis(means, lab[:, :, None], 1) + rng.normal(size=(b, n, d))
    x = np.ascontiguousarray(np.swapaxes(x, 1, 2), np.float32).reshape(b, d, h, w)
    xe = torch.from_numpy(np.ascontiguousarray(x[:, :e])).to(device, dt)
    xc4 = torch.cat([torch.from_numpy(np.ascontiguousarray(x[:, e:])),
                     torch.ones((b, 1, h, w))], dim=1).to(device, dt)
    wc = torch.from_numpy(means.astype(np.float32)).to(device).to(dt).float()
    return xe, xc4, wc, wc.square().sum(dim=2)


# K2 past the rows a whole tile stages (fault 10): its tiles staged in
# blocks of rows; W = 481 with N ragged against the 128-pixel tiles
K2_BLOCKED = [(1700, "bfloat16"), (2688, "bfloat16"), (1400, "float32")]


@pytest.mark.parametrize("e, dtype", K2_BLOCKED)
def test_lloyd_kernel_rows_in_blocks(device, e, dtype):
    """K2 at E + 3 rows staged in blocks: labels and counts equal to its
    plain version's, sums within rtol 1e-4 of their largest value, labels
    only equal to the full pass's labels, two launches bit-equal."""
    dt = DTYPES[dtype]
    assert kc.lloyd_plan(2, 5 * 481, e + 3, dt.itemsize, 132)[4] < e + 3
    xe, xc4, wc, offs = _chw_blobs(device, dt, 2, e, 5, 481, 5, seed=e)
    labels, sums, counts = kc.lloyd_chw_pass(xe, xc4, wc, offs)
    again = kc.lloyd_chw_pass(xe, xc4, wc, offs)
    rl, rs, rc = kc.lloyd_chw_pass_plain(xe, xc4, wc, offs)
    torch.cuda.synchronize()
    assert torch.equal(labels, rl) and torch.equal(counts, rc)
    assert (sums - rs).abs().max() <= 1e-4 * rs.abs().max()
    assert all(torch.equal(x, y) for x, y in zip((labels, sums, counts), again))
    assert torch.equal(kc.lloyd_chw_pass(xe, xc4, wc, offs, assign_only=True), labels)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_maximin_kernel(device, dtype):
    dt = DTYPES[dtype]
    xe, xc4 = _rows(device, dt, seed=2)
    b, e, h, w = xe.shape
    a2 = torch.rand((b, e + 3), generator=torch.Generator().manual_seed(3)).to(device)
    probe = xe.float().mean(dim=(2, 3))
    probe = torch.cat([probe, xc4[:, :3].float().mean(dim=(2, 3))], dim=1)
    dk = torch.zeros((b, h, w), device=device)
    dp = torch.zeros((b, h, w), device=device)
    for step in range(4):
        pk = kc.maximin_chw_pass(xe, xc4, a2, probe, dk, step < 2)
        pp = kc.maximin_chw_pass_plain(xe, xc4, a2, probe, dp, step < 2)
        torch.cuda.synchronize()
        assert torch.equal(pk, pp), step
        assert torch.allclose(dk, dp, rtol=1e-5, atol=1e-5)
        probe = pk


def _separated(device, dt, b, d, n, k, seed):
    """A (B, d, n) buffer of k blobs whose means lie ~4 noise radii apart:
    no pixel sits within rounding of a boundary between two clusters, so
    two summation orders (the kernel's, cuBLAS's in the plain version) give
    the same labels. Where k-means splits a blob (more clusters than
    blobs), float32 centres that differ in their last bits send a pixel
    near the split to the other cluster, and the centres part by ~1e-2."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=4.0, size=(b, k, d))
    lab = rng.integers(0, k, size=(b, n))
    x = np.take_along_axis(means, lab[:, :, None], 1) + rng.normal(size=(b, n, d))
    return torch.from_numpy(np.swapaxes(x, 1, 2).astype(np.float32)).to(device, dt)


# K3's cases: (batch, d, rows, m, cols, k, CTAs per image forced or None)
COARSE_CASES = {
    "rows": None,  # the (3, 20 + 3, 30 * 44) buffer of _rows, k = 5
    "batch1": (1, 23, 23, 1320, 1320, 5, None),  # 16 CTAs
    "batch17_queued": (17, 23, 23, 1320, 1320, 5, 8),  # 136 CTAs, more than fit at once
    "m_below_ctas": (1, 23, 23, 5, 5, 3, None),  # 16 CTAs, 11 of them empty
    "ragged_unaligned": (2, 39, 41, 3001, 3004, 5, None),  # rows, columns past d, m
    "k1": (2, 23, 23, 1320, 1320, 1, None),
    "k8": (2, 23, 23, 1320, 1320, 8, None),
    "d243": (2, 243, 243, 2400, 2400, 5, None),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", list(COARSE_CASES))
def test_coarse_centers_kernel(device, dtype, case, monkeypatch):
    dt = DTYPES[dtype]
    if COARSE_CASES[case] is None:
        xe, xc4 = _rows(device, dt, b=3, e=20, h=30, w=44, seed=4)
        b, e, h, w = xe.shape
        xp = torch.cat([xe.reshape(b, e, -1), xc4[:, :3].reshape(b, 3, -1)], dim=1)
        k, d, m = 5, e + 3, h * w
    else:
        b, d, rows, m, cols, k, ctas = COARSE_CASES[case]
        xp = _separated(device, dt, b, rows, cols, k, seed=d + m + k)
        if ctas is not None:
            monkeypatch.setattr(kf, "coarse_plan", lambda *_: ctas)
    out = kf.kmeans_coarse_centers_xp(xp, k, d, m, 8)
    ref = kf.kmeans_coarse_centers_xp_plain(xp, k, d, m, 8)
    again = kf.kmeans_coarse_centers_xp(xp, k, d, m, 8)
    torch.cuda.synchronize()
    assert torch.allclose(out, ref, rtol=2e-3, atol=2e-3)
    assert torch.equal(out, again)  # two launches give the same bits


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_coarse_centers_blocked_route(device, dtype, monkeypatch):
    """Past K3's 400 rows (fault 11) the warm start takes K6 and K5 on the
    card, K3 not: d = 483 rows of a padded (2, 488, 2400) buffer, against
    the same route through K6's and K5's plain versions (rtol and atol
    2e-3), two calls bit-equal."""
    dt = DTYPES[dtype]
    d, m, k = 483, 2400, 5
    xp = _separated(device, dt, 2, 488, m, k, seed=d)
    for fn in (kf.kmeans_coarse_centers_xp, kf.maximin_t_pass, kf.lloyd_t_pass):
        fn.launches = 0
    out = kf.kmeans_coarse_centers_xp(xp, k, d, m, 8)
    again = kf.kmeans_coarse_centers_xp(xp, k, d, m, 8)
    assert kf.kmeans_coarse_centers_xp.launches == 0
    assert kf.maximin_t_pass.launches == 2 * k and kf.lloyd_t_pass.launches == 2 * 8
    monkeypatch.setattr(kf, "maximin_t_pass", kf.maximin_t_pass_plain)
    monkeypatch.setattr(kf, "lloyd_t_pass", kf.lloyd_t_pass_plain)
    ref = kf.kmeans_coarse_centers_xp(xp, k, d, m, 8)
    torch.cuda.synchronize()
    assert out.shape == (2, k, d) and torch.equal(out, again)
    assert torch.allclose(out, ref, rtol=2e-3, atol=2e-3)


def _buffer(device, dt, b=2, d=39, n=3001, seed=5):
    """A (B, D, N) normalised buffer of three well-separated blobs."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=2.0, size=(b, 3, d))
    lab = rng.integers(0, 3, size=(b, n))
    x = np.take_along_axis(means, lab[:, :, None], 1) + rng.normal(size=(b, n, d))
    return torch.from_numpy(np.swapaxes(x, 1, 2).astype(np.float32)).to(device, dt)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lloyd_t_kernel(device, dtype):
    x = _buffer(device, DTYPES[dtype])
    c = x[:, :, :5].float().transpose(1, 2).contiguous() + 0.1
    labels, sums, counts = kf.lloyd_t_pass(x, c)
    rl, rs, rc = kf.lloyd_t_pass_plain(x, c)
    torch.cuda.synchronize()
    assert (labels == rl).float().mean() >= 0.9999
    assert torch.equal(counts, rc)
    assert torch.allclose(sums, rs, rtol=1e-4, atol=1e-4 * rs.abs().max().item())
    assert torch.equal(kf.lloyd_t_pass(x, c, assign_only=True), labels)


# K5's sums against the plain version, relative to their largest value
LLOYD_T_RTOL = {"float32": 1e-4, "bfloat16": 1e-3}


def _lloyd_t_case(device, dtype, n, k, seed, d=39):
    """K5 once, again and assign-only against its plain version on a
    (2, d, n) buffer of three blobs from k random centres; returns the
    checks' results."""
    x = _buffer(device, DTYPES[dtype], d=d, n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    c = torch.from_numpy(rng.normal(scale=2.0, size=(2, k, d)).astype(np.float32)).to(device)
    labels, sums, counts = kf.lloyd_t_pass(x, c)
    again = kf.lloyd_t_pass(x, c)
    only = kf.lloyd_t_pass(x, c, assign_only=True)
    rl, rs, rc = kf.lloyd_t_pass_plain(x, c)
    torch.cuda.synchronize()
    err = (sums - rs).abs().max().item()
    return {"labels": (labels == rl).float().mean().item() >= 0.9999,
            "counts": torch.equal(counts, rc),
            "sums": err <= LLOYD_T_RTOL[dtype] * max(rs.abs().max().item(), 1e-30),
            "assign only": torch.equal(only, labels),
            "two launches": all(torch.equal(a, g) for a, g in zip(again, (labels, sums, counts)))}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [1, 5, 8])
@pytest.mark.parametrize("n", [1, 255, 257, 4096, 4097, 9600, 154401])
def test_lloyd_t_kernel_shapes(device, dtype, n, k):
    """One launch a call at any N >= 1 (odd N leaves bf16 rows 2-byte
    aligned): labels, counts and sums as the plain version, two launches
    bit-equal."""
    got = _lloyd_t_case(device, dtype, n, k, seed=n % 89 + k)
    assert all(got.values()), got


# (D, k, N): past 512 rows K5 stages a tile's rows in blocks; k * D = 12,024
# is the widest the kernel once held in shared memory at k = 1 and k = 8
WIDE_ROWS = [(513, 5, 4097), (1000, 8, 257), (1503, 8, 4097), (12024, 1, 1001)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d,k,n", WIDE_ROWS)
def test_lloyd_t_kernel_wide_rows(device, dtype, d, k, n):
    """Any D: a tile's rows in blocks of at most 512, scored then summed
    block by block, as the plain version, two launches bit-equal."""
    got = _lloyd_t_case(device, dtype, n, k, seed=d % 97 + k, d=d)
    assert all(got.values()), got


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cpi", [1, 3, 16, 64, 132])
def test_lloyd_t_kernel_ctas(device, dtype, cpi, monkeypatch):
    """Any number of CTAs an image, whatever the plan picks on this card:
    the last CTA of each image adds the partials."""
    monkeypatch.setattr(kf, "lloyd_t_plan", lambda *_: cpi)
    got = _lloyd_t_case(device, dtype, 4097, 5, seed=cpi)
    assert all(got.values()), got


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_maximin_t_kernel(device, dtype):
    x = _buffer(device, DTYPES[dtype], seed=6)
    b, _, n = x.shape
    probe = x.float().mean(dim=2)
    dk = torch.zeros((b, n), device=device)
    dp = torch.zeros((b, n), device=device)
    for step in range(5):
        pk = kf.maximin_t_pass(x, probe, dk, step < 2)
        pp = kf.maximin_t_pass_plain(x, probe, dp, step < 2)
        torch.cuda.synchronize()
        assert torch.equal(pk, pp), step
        assert torch.allclose(dk, dp, rtol=1e-5, atol=1e-4)
        probe = pk


def _maximin_t_case(device, dtype, n, d, seed, steps=4):
    """K6's seeding steps on a (2, d, n) buffer of three blobs, from the
    mean, against its plain version; each step launched a second time on a
    copy of the running minima. Returns the checks' results: the same
    pixels, the minima within 1e-5 of the largest distance (or of the
    largest ||x||^2 where that is larger: at N = 1 every distance is the
    expanded form's cancellation) and two launches bit-equal."""
    x = _buffer(device, DTYPES[dtype], d=d, n=n, seed=seed)
    b = x.shape[0]
    scale = x.float().square().sum(dim=1).max().item()
    probe = x.float().mean(dim=2)
    dk = torch.zeros((b, n), device=device)
    dp = torch.zeros((b, n), device=device)
    got = {"same pixels": True, "dmin": True, "two launches": True}
    for step in range(steps):
        d2 = dk.clone()
        pk = kf.maximin_t_pass(x, probe, dk, step < 2)
        again = kf.maximin_t_pass(x, probe, d2, step < 2)
        pp = kf.maximin_t_pass_plain(x, probe, dp, step < 2)
        torch.cuda.synchronize()
        got["same pixels"] &= torch.equal(pk, pp)
        tol = 1e-5 * max(dp.abs().max().item(), scale)
        got["dmin"] &= (dk - dp).abs().max().item() <= tol
        got["two launches"] &= torch.equal(pk, again) and torch.equal(dk, d2)
        probe = pk
    return got


# (N, D): one pixel, N at and around 256-pixel CTA ranges, config2's fit
# grid and full resolution; past the 10,240 rows the kernel once held in
# shared memory (its probe), to 12,024
MAXIMIN_T_SHAPES = [(1, 39), (255, 39), (257, 39), (9600, 39), (154401, 39),
                    (257, 10241), (9600, 10241), (1, 12024), (4097, 12024)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("n,d", MAXIMIN_T_SHAPES)
def test_maximin_t_kernel_shapes(device, dtype, n, d):
    """One launch a call at any N >= 1 and any D (odd N leaves bf16 rows
    2-byte aligned): the plain version's pixels, two launches bit-equal."""
    got = _maximin_t_case(device, dtype, n, d, seed=n % 89 + d % 7)
    assert all(got.values()), got


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cpi", [1, 3, 16, 64, 132])
def test_maximin_t_kernel_ctas(device, dtype, cpi, monkeypatch):
    """Any number of CTAs an image, whatever the plan picks on this card:
    the last CTA of each image picks among the CTAs' pairs."""
    monkeypatch.setattr(kf, "maximin_t_plan", lambda *_: cpi)
    got = _maximin_t_case(device, dtype, 4097, 39, seed=cpi)
    assert all(got.values()), got


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("cpi", [1, 16, 132])
def test_maximin_t_kernel_ties(device, dtype, cpi, monkeypatch):
    """Equal maxima at several pixels, in one CTA and across CTAs: the first
    index wins. With a zero probe d2 is the sum of squares, so a column and
    its negation tie bit for bit, and the column tells the winner."""
    monkeypatch.setattr(kf, "maximin_t_plan", lambda *_: cpi)
    rng = np.random.default_rng(11)
    n, d = 9600, 39
    x = rng.normal(size=(2, d, n)).astype(np.float32)
    v = rng.normal(scale=3.0, size=d).astype(np.float32)
    first = {0: 3000, 1: 7001}  # per image -v there, +v at the later ties
    for b, i in first.items():
        for j, sign in [(i, -1.0), (i + 1, 1.0), (i + 500, 1.0), (n - 1, 1.0)]:
            x[b, :, j] = sign * v
    x = torch.from_numpy(x).to(device, DTYPES[dtype])
    probe = torch.zeros((2, d), device=device)
    dk = torch.zeros((2, n), device=device)
    got = kf.maximin_t_pass(x, probe, dk, True)
    ref = kf.maximin_t_pass_plain(x, probe, torch.zeros_like(dk), True)
    torch.cuda.synchronize()
    want = torch.stack([x[b, :, i].float() for b, i in first.items()])
    assert torch.equal(got, want) and torch.equal(ref, want)


def _em_inputs(x, k=5, seed=7):
    """GMM parameters from a hard split of the buffer, as the EM loop makes
    them."""
    b, d, n = x.shape
    labels = torch.from_numpy(np.random.default_rng(seed).integers(0, k, size=(b, n)))
    params = gf._moments_to_params(*gf._init_moments(x, labels.to(x.device), k), n, 1e-4)
    return gf._params_to_kernel_inputs(*params)


# K8's cases: (batch, D, N, k)
EM_CASES = {
    "b2_d39_k5": (2, 39, 3001, 5),
    "k1": (2, 39, 3001, 1),
    "k8": (2, 39, 3001, 8),
    "d3": (2, 3, 3001, 5),
    "d40": (2, 40, 3001, 5),
    "b1_n1": (1, 39, 1, 5),
    "b1_n257": (1, 39, 257, 5),
    "b1_n200003": (1, 39, 200003, 5),  # ragged: 313 chunks of 640, two a block
    # the wide kernel (D > 40): a 16-kernel bank's 51 rows, and 123 rows
    # (the k = 8 triangles no longer fit in shared memory; ~2,000 tiles)
    "d41": (2, 41, 3001, 5),
    "d51": (2, 51, 3001, 5),
    "d51_n200003": (1, 51, 200003, 5),
    "d123": (2, 123, 3001, 5),
    "d123_k8": (2, 123, 1001, 8),
    "d128": (1, 128, 700, 3),
    # config2's own shapes, where a block walks many chunks: the fit grid at
    # batch 50 (8 chunks a block) and full resolution at batch 8 (16), and
    # the wide kernel at full resolution (38 chunks of 256 a block)
    "b50_n9600": (50, 39, 9600, 5),
    "b8_n154401": (8, 39, 154401, 5),
    "d51_b8_n154401": (8, 51, 154401, 5),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", list(EM_CASES))
def test_em_pass_kernel(device, dtype, case):
    b, d, n, k = EM_CASES[case]
    x = _buffer(device, DTYPES[dtype], b=b, d=d, n=n, seed=8)
    pt, bias, const = _em_inputs(x, k=k)
    got = gf.em_pass(x, pt, bias, const)
    ref = gf.em_pass_plain(x, pt, bias, const)
    again = gf.em_pass(x, pt, bias, const)
    only = gf.em_pass(x, pt, bias, const, moments=False)
    only_again = gf.em_pass(x, pt, bias, const, moments=False)
    torch.cuda.synchronize()
    lk, llk, ck, sk, xk = got
    lp, llp, cp, sp, xp = ref
    assert (lk == lp).float().mean() >= 0.9999
    if n <= 3001:
        assert torch.allclose(llk, llp, rtol=1e-5)
        for g, r in ((ck, cp), (sk, sp), (xk, xp)):
            assert torch.allclose(g, r, rtol=1e-4, atol=1e-4 * r.abs().max().item())
    # both against the plain version in float64, the moments' error scaled
    # by each component's summed magnitude; the moments within 1e-6 or twice
    # the plain pass's distance (float64 sums rounded once), whichever is
    # larger
    r64 = gf.em_pass_plain(x, *(t.double() for t in (pt, bias, const)))
    scale = torch.maximum(r64[2], torch.diagonal(r64[4], dim1=2, dim2=3).amax(dim=2))
    scale = scale.clamp(min=1e-30)

    def err64(out):
        e_ll = ((out[1].double() - r64[1]).abs() / r64[1].abs()).max().item()
        e_m = max(((g.double() - r).abs().reshape(b, k, -1).amax(dim=2) / scale).max().item()
                  for g, r in zip(out[2:], r64[2:]))
        return e_ll, e_m

    (ll_k, m_k), (ll_p, m_p) = err64(got), err64(ref)
    assert ll_k <= max(1e-5, 2.0 * ll_p)
    assert m_k <= max(1e-6, 2.0 * m_p), (m_k, m_p)
    assert torch.equal(only, lk)
    assert torch.equal(xk, xk.transpose(2, 3))  # one packed entry per pair
    for g, a in zip(got, again):  # two launches give the same bits
        assert torch.equal(g, a)
    assert torch.equal(only, only_again)


def test_em_pass_kernel_refuses_d_above_128(device):
    x = _buffer(device, torch.float32, b=1, d=129, n=100)
    pt, bias, const = _em_inputs(x.cpu(), k=2)
    with pytest.raises(ValueError, match="128"):
        gf.em_pass(x, pt.to(device), bias.to(device), const.to(device))


@pytest.mark.parametrize("d", [3, 39, 64, 65, 128])
def test_precision_chol_kernel(device, d):
    # 2d samples keep the condition number near 34 at every d, so float32
    # rounding (cond * eps) stays far below the bound
    rng = np.random.default_rng(d)
    a = rng.normal(size=(10, d, 2 * d))
    cov = torch.from_numpy((a @ a.transpose(0, 2, 1) / (2 * d) + 1e-3 * np.eye(d))
                           .astype(np.float32)).to(device)
    pt, diag = chol.precision_chol(cov)
    ref_pt, ref_diag = chol.precision_chol_plain(cov)
    torch.cuda.synchronize()
    rel = (pt - ref_pt).abs() / (ref_pt.abs() + 1e-3)
    assert rel.max().item() < 5e-4
    assert torch.allclose(diag, ref_diag, rtol=1e-5)
    assert torch.count_nonzero(torch.triu(pt, 1)) == 0


CHOL_BACKWARD_TOL, CHOL_DIAG_TOL = 2e-5, 1e-6  # chip_smoke.py's K9 gate


def _chol_errors(covs, pt, diag):
    """Per matrix: (||L L^T - C||_F / ||C||_F with L the float64 inverse of
    P^T, max_i |diag_i P^T_ii - 1|), as chip_smoke.py's gate."""
    c64, x = covs.double(), pt.double()
    eye = torch.eye(c64.shape[-1], dtype=torch.float64, device=c64.device).expand_as(c64)
    lt = torch.linalg.solve_triangular(x, eye, upper=False)
    back = torch.linalg.matrix_norm(lt @ lt.transpose(1, 2) - c64) / torch.linalg.matrix_norm(c64)
    return back, (diag.double() * torch.diagonal(x, dim1=1, dim2=2) - 1).abs().amax(dim=1)


@pytest.mark.parametrize("d", [1, 39, 64, 65, 128])
def test_precision_chol_kernel_ill_conditioned(device, d):
    """K9 on covariances shaped as the EM's: clusters of fewer points than
    rows plus reg_covar I (cond ~1e3-1e6), held by the backward error, the
    diag error and a zero upper triangle; two launches bit-equal."""
    rng = np.random.default_rng(100 + d)
    m = 40
    covs = []
    for i in range(m):
        pts = rng.normal(size=(max(1, d // 2 + i % 7), d)) * rng.uniform(0.2, 3.0, size=d)
        pts -= pts.mean(axis=0)
        covs.append(pts.T @ pts / len(pts) + 1e-4 * np.eye(d))
    covs = torch.from_numpy(np.stack(covs).astype(np.float32)).to(device)
    pt, diag = chol.precision_chol(covs)
    again = chol.precision_chol(covs)
    torch.cuda.synchronize()
    back, dg = _chol_errors(covs, pt, diag)
    assert torch.isfinite(back).all() and back.max().item() <= CHOL_BACKWARD_TOL
    assert dg.max().item() <= CHOL_DIAG_TOL
    assert torch.count_nonzero(torch.triu(pt, 1)) == 0
    assert torch.equal(pt, again[0]) and torch.equal(diag, again[1])


def test_precision_chol_kernel_refuses_d_above_128(device):
    covs = torch.eye(129, device=device)[None].repeat(2, 1, 1)
    with pytest.raises(ValueError, match="128"):
        chol.precision_chol(covs)


def _lab(device, h, w, b=2):
    rgb = np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0]
                    for i in range(b)])
    return rgb_to_lab(torch.from_numpy(rgb).to(device))


@pytest.mark.parametrize("geometry", [(96, 128, 64, 10.0), (64, 96, 800, 5.0),
                                      (37, 53, 12, 10.0), (321, 481, 900, 5.0)])
def test_slic_kernel(device, geometry):
    h, w, n_sp, ruler = geometry
    lab = _lab(device, h, w)
    got = sf.slic_batch(lab, n_sp, ruler, 10)
    ref = sl.slic_plain(lab, n_sp, ruler, 10)
    torch.cuda.synchronize()
    gh, gw, _ = sl.grid_shape(h, w, n_sp)
    assert got.dtype == torch.int32 and int(got.max()) < gh * gw
    assert (got == ref).float().mean(dim=(1, 2)).min() >= 0.999


def test_slic_batch_missed_band_frame_runs_k11(device):
    """config3's S = 900 on a 1288x481 frame, whose band plan misses a
    band's candidate rows: slic_batch runs K11 alone, 0 pixels differ from
    slic_plain."""
    assert sf.slic_route(1288, 481, 900) == "w3"
    lab = _lab(device, 1288, 481)
    counts = (sf.slic_w3.launches, sf.slic_band_pass.launches, sf.slic_w5.launches)
    got = sf.slic_batch(lab, 900, 5.0, 10)
    ref = sl.slic_plain(lab, 900, 5.0, 10)
    torch.cuda.synchronize()
    assert (sf.slic_w3.launches - counts[0], sf.slic_band_pass.launches - counts[1],
            sf.slic_w5.launches - counts[2]) == (1, 0, 0)
    assert int((got != ref).sum()) == 0


# K11's geometries: config3's frame and batch; a frame with one grid row
# (gh < 3) and one with one grid column; a frame smaller than one tile;
# ragged tiles on odd sizes; and tiles of one cell (big cells)
W3_GEOMETRIES = {"config3": (321, 481, 925, 5.0, 8), "one_grid_row": (20, 301, 30, 10.0, 2),
                 "one_grid_column": (301, 20, 30, 10.0, 2), "under_a_tile": (9, 13, 4, 10.0, 3),
                 "odd": (161, 77, 60, 10.0, 2), "one_cell_tiles": (321, 481, 40, 10.0, 1)}


@pytest.mark.parametrize("case", list(W3_GEOMETRIES))
def test_slic_w3_kernel_bit_equal(device, case):
    """K11 bit-equal to slic_plain (0 pixels differ), two launches
    bit-equal, and one pass (labels and partials) and one update bit-equal
    to their plain versions at centroids moved off the grid."""
    h, w, n_sp, ruler, b = W3_GEOMETRIES[case]
    lab = _lab(device, h, w, b)
    got = sf.slic_w3(lab, n_sp, ruler, 10)
    again = sf.slic_w3(lab, n_sp, ruler, 10)
    ref = sl.slic_plain(lab, n_sp, ruler, 10)
    torch.cuda.synchronize()
    assert torch.equal(got, ref) and torch.equal(got, again)
    plan = sf.slic_w3_plan(h, w, n_sp)
    _, _, sw = sl.slic_geometry(h, w, n_sp, ruler)
    cent = sl.slic_init_centroids(lab, plan["gh"], plan["gw"])
    for _ in range(3):
        cent = sf.slic_w3_update_plain(cent, sf.slic_w3_pass_plain(lab, cent, plan, sw)[1],
                                       plan)
    lk, pk = sf.slic_w3_pass(lab, cent, n_sp, sw)
    lp, pp = sf.slic_w3_pass_plain(lab, cent, plan, sw)
    only, none = sf.slic_w3_pass(lab, cent, n_sp, sw, partials=False)
    up = sf.slic_w3_update(cent.clone(), pk, h, w, n_sp)
    torch.cuda.synchronize()
    assert none is None and torch.equal(only, lk)
    assert torch.equal(lk, lp) and torch.equal(pk, pp)
    assert torch.equal(up, sf.slic_w3_update_plain(cent, pp, plan))


@pytest.mark.parametrize("geometry", [(96, 128, 64), (37, 53, 10), (64, 96, 30),
                                      (540, 960, 400)])
def test_slic_band_pass_kernel(device, geometry):
    """K13's pass and update bit-equal to their plain versions (labels and
    float64 partials: on the Lab of uint8 images the sums are exact, so the
    plain version's atomics give the same bits), with the default column
    pieces and with 32-column ones (ragged at 53 and 960 - 32k columns),
    and the banded loop."""
    h, w, n_sp = geometry
    lab = _lab(device, h, w)
    bp = sf.slic_plan(h, w, n_sp)
    _, _, sw = sl.slic_geometry(h, w, n_sp, 10.0)
    cent = sl.slic_init_centroids(lab, bp["gh"], bp["gw"])
    for _ in range(3):  # move the centroids off the grid first
        _, parts = sf.slic_band_pass_plain(lab, cent, bp, sw)
        cent = sf.slic_band_update_plain(cent, parts, bp)
    for cols in (sf._BAND_COLS, 32):
        lk, pk = sf.slic_band_pass(lab, cent, bp, sw, cols=cols)
        lp, pp = sf.slic_band_pass_plain(lab, cent, bp, sw, cols=cols)
        only, none = sf.slic_band_pass(lab, cent, bp, sw, partials=False, cols=cols)
        torch.cuda.synchronize()
        assert none is None and torch.equal(only, lk)
        assert torch.equal(lk, lp) and torch.equal(pk, pp)
        assert torch.equal(sf.slic_band_update(cent.clone(), pk, bp, h),
                           sf.slic_band_update_plain(cent, pp, bp))
    got = sf.slic_banded(lab, n_sp, 10.0, 10)
    assert torch.equal(got, sf.slic_banded_plain(lab, n_sp, 10.0, 10))
    assert (got == sl.slic_plain(lab, n_sp, 10.0, 10)).float().mean(dim=(1, 2)).min() >= 0.999


@pytest.mark.parametrize("geometry", [(40, 77, 20), (33, 129, 24), (150, 203, 100),
                                      (161, 77, 60), (200, 301, 150)])
def test_slic_band_pass_kernel_odd_widths(device, geometry):
    """K13 at widths under one column piece and at odd widths (scalar Lab
    loads), and with 30-column pieces (ragged, not a multiple of 4): pass
    and update bit-equal to their plain versions, two banded loops
    bit-equal to each other, to the plain loop and to K12's."""
    h, w, n_sp = geometry
    lab = _lab(device, h, w)
    bp = sf._band_plan(h, w, n_sp)
    _, _, sw = sl.slic_geometry(h, w, n_sp, 10.0)
    cent = sl.slic_init_centroids(lab, bp["gh"], bp["gw"])
    for _ in range(2):
        _, parts = sf.slic_band_pass_plain(lab, cent, bp, sw)
        cent = sf.slic_band_update_plain(cent, parts, bp)
    for cols in (sf._BAND_COLS, 30):
        lk, pk = sf.slic_band_pass(lab, cent, bp, sw, cols=cols)
        lp, pp = sf.slic_band_pass_plain(lab, cent, bp, sw, cols=cols)
        torch.cuda.synchronize()
        assert torch.equal(lk, lp) and torch.equal(pk, pp)
        assert torch.equal(sf.slic_band_update(cent.clone(), pk, bp, h),
                           sf.slic_band_update_plain(cent, pp, bp))
    got = sf.slic_banded(lab, n_sp, 10.0, 10)
    assert torch.equal(got, sf.slic_banded(lab, n_sp, 10.0, 10))
    assert torch.equal(got, sf.slic_banded_plain(lab, n_sp, 10.0, 10))
    assert torch.equal(got, sf.slic_w5(lab, n_sp, 10.0, 10))


# K12's cases: (h, w, superpixels, batch, iterations). Small frames; K12's
# own frame; the extremes of the range slic_route(h, w, S, "w5") admits
# (S = 12,000 on 1052x16 and 1422x16: 351 and 474 bands, partials in the
# global scratch; 1422x127 with S = 10: 180,594 pixels, a width not a
# multiple of 4); 20 images, more than the card holds clusters at once;
# one image; 0 and 1 iterations
W5_CASES = {"96x128": (96, 128, 64, 2, 10), "37x53": (37, 53, 10, 2, 10),
            "k12_frame": (321, 481, 400, 2, 10), "extreme_s": (1052, 16, 12000, 2, 10),
            "extreme_bands": (1422, 16, 12000, 2, 10), "extreme_pixels": (1422, 127, 10, 2, 10),
            "batch_20": (321, 481, 400, 20, 10), "batch_1": (321, 481, 400, 1, 10),
            "no_iteration": (321, 481, 400, 2, 0), "one_iteration": (321, 481, 400, 2, 1)}


@pytest.mark.parametrize("case", list(W5_CASES))
def test_slic_w5_kernel(device, case):
    """K12's one launch bit-equal to the plain banded loop and to K13's, two
    calls bit-equal, one launch a call."""
    h, w, n_sp, b, n_iter = W5_CASES[case]
    lab = _lab(device, h, w, b)
    before = sf.slic_w5.launches
    got = sf.slic_w5(lab, n_sp, 10.0, n_iter)
    again = sf.slic_w5(lab, n_sp, 10.0, n_iter)
    torch.cuda.synchronize()
    assert sf.slic_w5.launches == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, sf.slic_banded_plain(lab, n_sp, 10.0, n_iter))
    assert torch.equal(got, sf.slic_banded(lab, n_sp, 10.0, n_iter))
    assert torch.equal(sf.slic_batch(lab, n_sp, 10.0, n_iter, plan="w5"), got)


@pytest.mark.parametrize("case", ["k12_frame", "extreme_bands", "extreme_pixels"])
def test_slic_w5_every_shape(device, case):
    """Every cluster shape the card holds (CTAs an image, groups, piece
    width; partials in shared or global memory) gives the plain loop's
    labels."""
    h, w, n_sp, b, n_iter = W5_CASES[case]
    lab = _lab(device, h, w, b).contiguous()
    ref = sf.slic_banded_plain(lab, n_sp, 10.0, n_iter)
    active = sf.w5_active(h, w, n_sp, device.index or 0)
    gh, gw, sw = sl.slic_geometry(h, w, n_sp, 10.0)
    cent = sl.slic_init_centroids(lab, gh, gw)
    shapes = [shape for shape in sf.W5_SHAPES if active[shape] > 0]
    assert shapes
    for shape in shapes:
        plan = sf.slic_w5_plan(h, w, n_sp, b, {shape: active[shape]})
        labels = torch.empty_like(ref)
        sf.w5_launch(lab, cent, labels, plan, n_iter, sw)
        torch.cuda.synchronize()
        assert torch.equal(labels, ref), shape


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tiled_energies_kernel(device, dtype, monkeypatch):
    """Tiled K1 (pool 2) against the same windows through the plain K1."""
    dt = DTYPES[dtype]
    bank = make_bank(preset("config4").bank)
    groups = bank_tensors(bank, device)
    lab = _lab(device, 96, 128)
    got = tiled.gabor_energies_tiled(lab, groups, dt, (48, 64), bank.config.max_halo, 2)
    monkeypatch.setattr(tiled, "gabor_energies_fused", fused.gabor_energies_fused_plain)
    ref = tiled.gabor_energies_tiled(lab, groups, dt, (48, 64), bank.config.max_halo, 2)
    torch.cuda.synchronize()
    tol = 1e-4 if dt == torch.float32 else 2e-2
    assert (got.float() - ref.float()).abs().max() <= tol * ref.float().abs().max()


def _fragmented(device, h, w, n_sp, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, n_sp, ((h + 7) // 8, (w + 7) // 8))
    lab = np.kron(base, np.ones((8, 8), int))[:h, :w]
    lab = np.where(rng.random((h, w)) < 0.25, rng.integers(0, n_sp, (h, w)), lab)
    return torch.from_numpy(np.stack([lab, lab[:, ::-1]]).astype(np.int32)).to(device)


@pytest.mark.parametrize("case", [(48, 64, 12, 16, None), (33, 47, 20, 4, 7),
                                  (1, 50, 5, 2, None), (29, 1, 5, 2, None),
                                  (321, 481, 925, 41, None), (540, 960, 405, 320, None)])
def test_connectivity_kernel(device, case):
    """(321, 481, 925) and (540, 960, 405) are config3's and config4's SLIC
    grids with their default min_size."""
    h, w, n_sp, min_size, s_max = case
    lab = _fragmented(device, h, w, n_sp)
    got = cn.enforce_connectivity_fused(lab, n_sp, min_size, s_max)
    ref = sl.enforce_connectivity_plain(lab, n_sp, min_size, s_max)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)


def test_connectivity_kernel_on_slic_output(device):
    lab = _lab(device, 321, 481)
    sp = sf.slic_batch(lab, 900, 5.0, 10)
    assert torch.equal(cn.enforce_connectivity_fused(sp, 925),
                       sl.enforce_connectivity_plain(sp, 925))


@pytest.mark.parametrize("kept", ["centre", "corner", "walls", "none"])
@pytest.mark.parametrize("hw", [(41, 37), (97, 130)])
def test_connectivity_kernel_on_mazes(device, kept, hw):
    """The spiral mazes of data.connectivity_maze (a corridor many times h +
    w long, every pixel but the kept part a one-pixel fragment) and the map
    with no surviving component, min_size 5."""
    lab = connectivity_maze(*hw, kept)
    lab = torch.from_numpy(np.stack([lab, lab[::-1, ::-1]]).copy()).to(device)
    got = cn.enforce_connectivity_fused(lab, 16, 5)
    ref = sl.enforce_connectivity_plain(lab, 16, 5)
    torch.cuda.synchronize()
    assert torch.equal(got, ref)
    if kept == "none":
        assert int(got.abs().sum()) == 0


@pytest.mark.parametrize("shape", [(2, 5000, 37), (3, 1001, 925), (1, 7, 1),
                                   (8, 154401, 925), (8, 518400, 405)])
def test_lookup_kernel(device, shape):
    b, n, s = shape
    g = torch.Generator().manual_seed(n)
    idx = torch.randint(0, s, (b, n), generator=g, dtype=torch.int32).to(device)
    table = torch.randint(-2**31, 2**31 - 1, (b, s), generator=g,
                          dtype=torch.int32).to(device)
    got = lookup.table_lookup(idx, table)
    torch.cuda.synchronize()
    assert torch.equal(got, lookup.table_lookup_plain(idx, table))


@pytest.mark.parametrize("n", [150001, 40000 * 3 + 1])
def test_lookup_kernel_large_table(device, n):
    """K15 past its old 12,288-entry cap: S = 50,000, uniform random
    indices, N odd so that rows 1.. of idx start off a 16-byte boundary."""
    b, s = 3, 50000
    rng = np.random.default_rng(n)
    idx = torch.from_numpy(rng.integers(0, s, (b, n)).astype(np.int32)).to(device)
    table = torch.from_numpy(rng.integers(-2**31, 2**31 - 1, (b, s)).astype(np.int32)).to(device)
    assert idx[1].data_ptr() % 16 != 0
    got = lookup.table_lookup(idx, table)
    torch.cuda.synchronize()
    assert torch.equal(got, lookup.table_lookup_plain(idx, table))


def _within_one_ulp(got, ref):
    """float32 values equal up to one unit in the last place of ``ref``."""
    ulp = torch.nextafter(ref.abs(), torch.full_like(ref, float("inf"))) - ref.abs()
    return bool(((got - ref).abs() <= ulp).all())


MOMENTS = {"fused": (gm.superpixel_moments_fused, False),
           "fused_t": (gm.superpixel_moments_fused_t, True),
           "fused_nhwc": (gm.superpixel_moments_fused_nhwc, False)}


@pytest.mark.parametrize("name", sorted(MOMENTS))
@pytest.mark.parametrize("shape", [(2, 61, 97, 39, 925), (3, 17, 33, 5, 40),
                                   (2, 540, 960, 39, 405)])
def test_superpixel_moments_kernel(device, name, shape):
    """K16-K18 against their plain version: every value equal with bfloat16
    features (float64 sums of them are exact); K17 with float32 features
    within one ulp. Labels hold superpixel blocks of 8x8 pixels, a quarter
    of them noise, and some -1 and S (no bucket). (540, 960, 405) is
    config4's pooled grid."""
    fn, channel_major = MOMENTS[name]
    b, h, w, d, n_sp = shape
    rng = np.random.default_rng(h)
    lab = _fragmented("cpu", h, w, n_sp, seed=w).reshape(2, -1)[np.arange(b) % 2].numpy()
    lab = np.where(rng.random(lab.shape) < 0.01, rng.choice([-1, n_sp], lab.shape), lab)
    idx = torch.from_numpy(lab.astype(np.int32)).to(device)
    f = torch.from_numpy(rng.normal(size=(b, h * w, d)).astype(np.float32)).to(device)
    if channel_major:
        f = f.transpose(1, 2).contiguous()
    for dt in ([torch.bfloat16, torch.float32] if channel_major else [torch.bfloat16]):
        kw = {"dtype": dt} if channel_major else {}
        sums, counts = fn(idx, f, n_sp, **kw)
        rs, rc = gm.superpixel_moments_plain(idx, f.to(dt), n_sp, channel_major)
        torch.cuda.synchronize()
        assert torch.equal(counts, rc)
        assert torch.equal(sums, rs) if dt == torch.bfloat16 else _within_one_ulp(sums, rs)


@pytest.mark.parametrize("name", sorted(MOMENTS))
@pytest.mark.parametrize("n_sp", [4096, 16384])
@pytest.mark.parametrize("labels", ["raster", "random"])
def test_superpixel_moments_kernel_large_s(device, name, n_sp, labels):
    """K16-K18 past the old 3,632 cap on 2 x 39 x 40,000 (200 x 200):
    "raster" numbers square blocks in raster order (a chunk of rows holds
    a narrow label range, wider than one window at these S), "random" draws
    each pixel's label uniformly from [-1, S] (every chunk's range is the
    whole of S, and -1 and S add to no bucket). bf16 every value equal,
    f32 (K17) within one ulp, counts equal, two launches bit-equal."""
    fn, channel_major = MOMENTS[name]
    b, h, w, d = 2, 200, 200, 39
    rng = np.random.default_rng(n_sp + len(labels))
    if labels == "raster":
        g = int(round(n_sp ** 0.5))
        lab = (np.arange(h)[:, None] * g // h) * g + np.arange(w)[None, :] * g // w
        lab = np.broadcast_to(lab.reshape(1, -1), (b, h * w))
    else:
        lab = rng.integers(-1, n_sp + 1, (b, h * w))
    idx = torch.from_numpy(lab.astype(np.int32)).to(device)
    f = torch.from_numpy(rng.normal(size=(b, h * w, d)).astype(np.float32)).to(device)
    if channel_major:
        f = f.transpose(1, 2).contiguous()
    for dt in ([torch.bfloat16, torch.float32] if channel_major else [torch.bfloat16]):
        kw = {"dtype": dt} if channel_major else {}
        sums, counts = fn(idx, f, n_sp, **kw)
        again = fn(idx, f, n_sp, **kw)
        rs, rc = gm.superpixel_moments_plain(idx, f.to(dt), n_sp, channel_major)
        torch.cuda.synchronize()
        assert torch.equal(sums, again[0]) and torch.equal(counts, again[1])
        assert torch.equal(counts, rc)
        assert torch.equal(sums, rs) if dt == torch.bfloat16 else _within_one_ulp(sums, rs)


@pytest.mark.parametrize("d", [3, 39, 64, 123, 127])
def test_precision_chol_params_kernel(device, d):
    """K10 on moments of well-conditioned data (cond of the covariance near
    the K9 test's): P^T within 5e-4 relative of the plain version, bias and
    const within float32 rounding of different sum orders."""
    rng = np.random.default_rng(d)
    b, k, n = 2, 5, 4 * d
    x = rng.normal(size=(b, k, n, d)) * rng.uniform(0.5, 2.0, size=(b, k, 1, d)) + 0.3
    r = rng.uniform(0.2, 1.0, size=(b, k, n, 1))
    moments = [torch.from_numpy(a.astype(np.float32)).to(device)
               for a in ((r[..., 0]).sum(axis=2), (r * x).sum(axis=2),
                         np.einsum("bknc,bkni,bknj->bkij", r, x, x))]
    pt, bias, const = chol.precision_chol_params(*moments, 3000, 1e-4)
    rp, rb, rc = chol.precision_chol_params_plain(*moments, 3000, 1e-4)
    torch.cuda.synchronize()
    assert ((pt - rp).abs() / (rp.abs() + 1e-3)).max().item() < 5e-4
    assert torch.count_nonzero(torch.triu(pt, 1)) == 0
    assert torch.allclose(bias, rb, rtol=2e-4, atol=2e-4 * rb.abs().max().item())
    assert torch.allclose(const, rc, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("d", [3, 39, 64, 123, 127])
def test_precision_chol_params_kernel_bits(device, d):
    """Two K10 launches give the same bits, and K10 forms C bit-equal to
    _moments_to_params' C: K10 and K9 share the factorisation, so K10's P^T
    equals K9's on that C bit for bit."""
    rng = np.random.default_rng(d + 1)
    b, k, n = 2, 5, 4 * d
    x = rng.normal(size=(b, k, n, d)) * rng.uniform(0.5, 2.0, size=(b, k, 1, d)) + 0.3
    r = rng.uniform(0.2, 1.0, size=(b, k, n, 1))
    moments = [torch.from_numpy(a.astype(np.float32)).to(device)
               for a in ((r[..., 0]).sum(axis=2), (r * x).sum(axis=2),
                         np.einsum("bknc,bkni,bknj->bkij", r, x, x))]
    got = chol.precision_chol_params(*moments, 3000, 1e-4)
    again = chol.precision_chol_params(*moments, 3000, 1e-4)
    _, _, cov = chol._moments_to_params(*moments, 3000, 1e-4)
    pt9, _ = chol.precision_chol(cov.reshape(b * k, d, d))
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    assert torch.equal(got[0], pt9.reshape(b, k, d, d))


def test_precision_chol_params_kernel_refuses_d_above_127(device):
    b, k, d = 1, 2, 128
    counts = torch.full((b, k), 10.0, device=device)
    sums = torch.zeros((b, k, d), device=device)
    scatter = torch.eye(d, device=device).expand(b, k, d, d).contiguous()
    with pytest.raises(ValueError, match="127"):
        chol.precision_chol_params(counts, sums, scatter, 100, 1e-4)


def _wide_rows(device, dt, b, n, d, k, seed):
    """(B, n, d) rows of k blobs ~4 noise radii apart and, as centres, the
    blob means moved by 0.1 noise: each pixel's own centre is nearer than
    any other by ~16 d, so no summation order moves a label at any width."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=4.0, size=(b, k, d))
    lab = rng.integers(0, k, size=(b, n))
    x = np.take_along_axis(means, lab[:, :, None], 1) + rng.normal(size=(b, n, d))
    c = means + 0.1 * rng.normal(size=means.shape)
    return (torch.from_numpy(x.astype(np.float32)).to(device, dt),
            torch.from_numpy(c.astype(np.float32)).to(device))


# (B, N, D, k): past 512 rows (N ragged against the tiles) at k = 1, 5, 8;
# D = 2048 and 4096 stage a tile's values in blocks
LLOYD_WIDE_SHAPES = [(2, n, d, k) for d, n in [(513, 3001), (1000, 1001), (2048, 777),
                                                (4096, 257)] for k in (1, 5, 8)]
# on _buffer's blobs with noisy pixels as centres; the other shapes on
# _wide_rows: at config1's N = 154,401 those centres leave pixels within
# float32 rounding of a tie (score margins 1e-4 of scores up to ~2e3)
LLOYD_NOISY_SHAPES = [(2, 5000, 243, 5), (3, 1001, 37, 8), (1, 7, 1, 1)]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", LLOYD_NOISY_SHAPES + LLOYD_WIDE_SHAPES
                         + [(2, 154401, 243, 5)])
def test_lloyd_pass_kernel(device, dtype, shape):
    """K7 against its plain version: labels and counts equal, sums within
    rtol 1e-4 of their largest value, two launches bit-equal. The small
    shapes on the blobs of _buffer with centres at noisy pixels, the others
    on _wide_rows (the blob means as centres: no pixel near a tie)."""
    b, n, d, k = shape
    if shape in LLOYD_NOISY_SHAPES:
        x = _buffer(device, DTYPES[dtype], b=b, d=d, n=n, seed=9).transpose(1, 2).contiguous()
        c = x[:, :k].float() + 0.1
    else:
        x, c = _wide_rows(device, DTYPES[dtype], b, n, d, k, seed=d + k)
    labels, sums, counts = kf.lloyd_pass(x, c, k)
    again = kf.lloyd_pass(x, c, k)
    rl, rs, rc = kf.lloyd_pass_plain(x, c, k)
    torch.cuda.synchronize()
    if not torch.equal(labels, rl):  # the score margin of the pixels that differ
        xf, cr = x.float(), c.to(x.dtype).float()
        sc = c.square().sum(dim=2)[:, None, :] - 2.0 * torch.bmm(xf, cr.transpose(1, 2))
        top = sc.sort(dim=2).values
        gap = (top[:, :, 1] - top[:, :, 0])[labels != rl]
        pytest.fail(f"{int((labels != rl).sum())} labels differ, score margins {gap[:8]} "
                    f"against scores up to {sc.abs().max().item():.4g}")
    assert torch.equal(counts, rc)
    assert torch.allclose(sums, rs, rtol=1e-4, atol=1e-4 * rs.abs().max().item())
    assert all(torch.equal(u, v) for u, v in zip((labels, sums, counts), again))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kmeans_fused_kernel(device, dtype, monkeypatch):
    """K7's solver against the same solver through K7's plain version."""
    dt = DTYPES[dtype]
    x = _buffer(device, torch.float32, b=3, d=24, n=4000, seed=10).transpose(1, 2)
    kf.lloyd_pass.launches = 0
    labels, centers = kf.kmeans_fused(x, 4, 20, dt)
    assert kf.lloyd_pass.launches > 0
    monkeypatch.setattr(kf, "lloyd_pass", kf.lloyd_pass_plain)
    ref, ref_c = kf.kmeans_fused(x, 4, 20, dt)
    assert (labels == ref).float().mean(dim=1).min().item() >= 0.999
    assert torch.allclose(centers, ref_c, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_gmm_fused_prep_kernel(device, dtype, monkeypatch):
    """With _FUSED_PREP on, every K8 pass takes its inputs from K10 (15 EM
    iterations and the labels pass) and K9 never runs; the labels agree with
    the switch off."""
    x = _buffer(device, DTYPES[dtype], d=12, n=6000, seed=11)
    off = gf.gmm_fused_t_xt(x, 4, 15, 1e-4, 10, 1e-3)
    monkeypatch.setattr(gf, "_FUSED_PREP", True)
    for fn in (chol.precision_chol, chol.precision_chol_params, gf.em_pass):
        fn.launches = 0
    on = gf.gmm_fused_t_xt(x, 4, 15, 1e-4, 10, 1e-3)
    assert chol.precision_chol_params.launches == gf.em_pass.launches == 16
    assert chol.precision_chol.launches == 0
    for i in range(x.shape[0]):
        got, ref = on[i].cpu().numpy(), off[i].cpu().numpy()
        assert (align_labels(got, ref) == ref).mean() >= 0.999


def _slic_batch_plain(lab, n_superpixels, ruler=10.0, n_iter=10, impl="auto", plan="auto"):
    """slic_batch's plain version on the graph stage's call (K11's)."""
    return sl.slic_plain(lab, n_superpixels, ruler, n_iter)


@pytest.mark.parametrize("name", ["config0", "config1", "config2", "config3", "config4"])
def test_pipeline_kernels_match_plain_path(device, name, monkeypatch):
    # config2 at 160x224 fits its GMM on the 2x2-pooled grid (one level);
    # config3's preset at 64x96 has S > 512 superpixels; config4 runs 2 x 2
    # windows, and its 48x64 pooled grid takes the banded SLIC (K13) with
    # the whole-image gate at 0
    h, w = {"config2": (160, 224), "config3": (64, 96),
            "config4": (192, 256)}.get(name, (96, 128))
    rgb = np.stack([synthetic_mosaic(h=h, w=w, n_regions=5, seed=100 + i)[0]
                    for i in range(2)])
    cfg = preset(name).replace(batch_size=2)
    if name == "config4":
        cfg = cfg.replace(tile_hw=(96, 128),
                          graph=dataclasses.replace(cfg.graph, n_superpixels=48))
        monkeypatch.setattr(sf, "_SLIC_FUSE_BYTES", 0)
        assert sf.slic_route(48, 64, 48) == "banded"
    gpu, _ = segment_batch(rgb, cfg, with_features=False)
    assert gpu.device.type == "cuda"
    if name == "config4":
        # the cut is not determined on image 1 (14 live superpixels, all
        # isolated: PERF.md §7), so K1's last-bit differences from its plain
        # version move its labels; the graph stage's kernels are held with
        # both paths on K1's energies
        for attr, plain in (("slic_batch", _slic_batch_plain),
                            ("enforce_connectivity_fused", sl.enforce_connectivity_plain),
                            ("table_lookup", lookup.table_lookup_plain)):
            monkeypatch.setattr(gr, attr, plain)
        ref, _ = segment_batch(rgb, cfg, with_features=False)
    else:
        ref, _ = segment_batch(rgb, cfg, with_features=False, device="cpu")
    gpu, ref = gpu.cpu().numpy(), ref.cpu().numpy()
    for i in range(2):
        assert (align_labels(gpu[i], ref[i]) == ref[i]).mean() >= 0.999


# ---------------------------------------------------------------------------
# parallel/: the tiled k-means (K5 per shard) and the tiled graph (K17 and
# K15 per shard) on a mesh of repeated cuda:0 shards
# ---------------------------------------------------------------------------


def _cuda_mesh(device, n):
    from gabor_color_image_segmentation_tpu_torch.parallel.mesh import Mesh

    return Mesh([device] * n, ("space",))


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("n", [2, 8])
def test_tiled_kmeans_k5_per_shard(device, monkeypatch, k, n):
    """kmeans_sharded with K5 on each shard against the same schedule with
    K5's plain one-hot pass, both on the card: labels equal on >= 99.99 %,
    centres within 1e-4; K5 launched once a shard a pass."""
    from gabor_color_image_segmentation_tpu_torch.parallel import tiling

    gen = torch.Generator().manual_seed(k + n)
    d, h, w = 39, 64, 96
    blobs = torch.randn((k, d), generator=gen) * 4.0
    which = torch.randint(0, k, (h * w,), generator=gen)
    x = (blobs[which] + torch.randn((h * w, d), generator=gen)).T.reshape(d, h, w)
    strips = [s.reshape(1, d, -1).contiguous().to(device) for s in x.chunk(n, dim=1)]
    sched = dict(hw_local=(h // n, w), coarse_iters=5, refine_iters=2, coarse_levels=2,
                 mid_iters=1)
    kf.lloyd_t_pass.launches = 0
    lab, cen = tiling.kmeans_sharded(strips, k, 10, _cuda_mesh(device, n), "space", **sched)
    passes = 5 + 1 + 2 + 1
    assert kf.lloyd_t_pass.launches == passes * n
    monkeypatch.setattr(tiling, "lloyd_t_pass", kf.lloyd_t_pass_plain)
    ref_l, ref_c = tiling.kmeans_sharded(strips, k, 10, _cuda_mesh(device, n), "space", **sched)
    torch.cuda.synchronize()
    got, ref = torch.cat(lab), torch.cat(ref_l)
    assert (got == ref).float().mean().item() >= 0.9999
    torch.testing.assert_close(cen[0], ref_c[0], rtol=1e-4, atol=1e-4)


def test_tiled_graph_k17_k15_per_shard(device, monkeypatch):
    """graph_cut_strip on the card with K17 and K15 on each shard against
    the same chain with their plain versions: every label equal, the
    sharded connectivity bit-equal to K14 on the gathered SLIC labels."""
    from gabor_color_image_segmentation_tpu_torch.parallel import tiled_graph as tg

    n, h, w = 4, 96, 128
    cfg = preset("config3").replace(graph=dataclasses.replace(
        preset("config3").graph, n_superpixels=96, n_regions=5))
    rgb = synthetic_mosaic(h=h, w=w, n_regions=5, seed=4)[0]
    lab = rgb_to_lab(torch.from_numpy(rgb).to(device).to(torch.float32) / 255.0)
    feats = torch.randn((8, h, w), generator=torch.Generator().manual_seed(1)).to(device)
    feats += lab.permute(2, 0, 1).repeat(3, 1, 1)[:8] * 0.05
    mesh = _cuda_mesh(device, n)
    labs, fs = list(lab.chunk(n)), list(feats.chunk(n, dim=1))
    gm.superpixel_moments_fused_t.launches = 0
    lookup.table_lookup.launches = 0
    got = torch.cat(tg.graph_cut_strip(fs, labs, cfg, h, mesh, "space"))
    assert gm.superpixel_moments_fused_t.launches == n and lookup.table_lookup.launches == n
    sp = tg.slic_sharded(labs, h, w, 96, cfg.graph.slic_compactness, cfg.graph.slic_iters,
                         mesh, "space")
    gh, gw, _ = sl.grid_shape(h, w, 96)
    conn = torch.cat(tg.enforce_connectivity_sharded(sp, gh * gw, h, mesh, "space"))
    assert torch.equal(conn, cn.enforce_connectivity_fused(torch.cat(sp)[None], gh * gw)[0])
    monkeypatch.setattr(tg, "superpixel_moments_fused_t",
                        lambda i, f, s, dtype: gm.superpixel_moments_plain(i, f.to(dtype), s,
                                                                           True))
    monkeypatch.setattr(tg, "table_lookup", lookup.table_lookup_plain)
    ref = torch.cat(tg.graph_cut_strip(fs, labs, cfg, h, mesh, "space"))
    assert torch.equal(got, ref)


# ---------------------------------------------------------------------------
# The reference's entry points: the graph stage, SLIC, kmeans_fused_chw's
# own multigrid and evaluate(debug_nans=True), on the kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_graph_segment_batch_kernels(device, dtype):
    """graph_segment_batch on the card launches K11, K14, K17 and K15 and
    gives segment_batch's labels; ncut_segment on image 0 is its batch of
    one; the same stage on the plain versions agrees."""
    rgb = np.stack([synthetic_mosaic(h=64, w=96, n_regions=4, seed=i)[0] for i in range(2)])
    cfg = preset("config3").replace(batch_size=2, dtype=dtype)
    cfg = cfg.replace(graph=dataclasses.replace(cfg.graph, n_superpixels=48, n_regions=4))
    labels, feats = segment_batch(rgb, cfg)
    x = torch.from_numpy(rgb).to(device)
    lab = pipeline._graph_features(x, cfg, make_bank(cfg.bank))[1]
    for wrapper in (sf.slic_w3, cn.enforce_connectivity_fused, gm.superpixel_moments_fused_t,
                    lookup.table_lookup):
        wrapper.launches = 0
    got = gr.graph_segment_batch(feats, lab, cfg)
    assert torch.equal(got, labels)
    for wrapper in (sf.slic_w3, cn.enforce_connectivity_fused, gm.superpixel_moments_fused_t,
                    lookup.table_lookup):
        assert wrapper.launches == 1, wrapper.__name__
    one = gr.graph_segment_batch(feats[:1], lab[:1], cfg)[0]
    g = cfg.graph
    single = gr.ncut_segment(feats[0], lab[0], g.n_superpixels, g.n_regions,
                             g.slic_compactness, g.slic_iters, g.affinity_sigma,
                             gr.resolve_eig_method(g, dtype, device), g.affinity_sigma_scale)
    assert torch.equal(single, one)
    plain = gr.ncut_segment(feats[0].cpu(), lab[0].cpu(), g.n_superpixels, g.n_regions,
                            g.slic_compactness, g.slic_iters, g.affinity_sigma,
                            gr.resolve_eig_method(g, dtype, device), g.affinity_sigma_scale)
    ref = plain.numpy()
    assert (align_labels(single.cpu().numpy(), ref) == ref).mean() >= 0.99


def test_slic_entry_points_kernels(device):
    rgb, _ = synthetic_mosaic(h=96, w=128, n_regions=4, seed=3)
    lab = rgb_to_lab(torch.from_numpy(rgb)).to(device)
    got = sl.slic(lab, 64, 10.0, 5)
    assert torch.equal(got, sf.slic_batch(lab[None], 64, 10.0, 5)[0])
    assert torch.equal(got.cpu(), sl.slic(lab.cpu(), 64, 10.0, 5))
    for impl in ("auto", "xla", "fused"):
        assert torch.equal(sf.slic_batch(lab[None], 64, 10.0, 5, impl)[0], got)
    assert torch.equal(sf.slic_fused(lab[None], 64, 10.0, 5)[0], got)
    with pytest.raises(ValueError, match="ineligible"):
        sf.slic_batch(torch.zeros((1, 30, 440, 3), device=device), 132, impl="fused")
    gh, gw, _ = sl.grid_shape(96, 128, 64)
    conn = sl.enforce_connectivity_device(got[None], gh * gw)
    assert torch.equal(conn, cn.enforce_connectivity_fused(got[None], gh * gw))
    assert torch.equal(conn.cpu(), sl.enforce_connectivity_plain(got[None].cpu(), gh * gw))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kmeans_fused_chw_multigrid_kernels(device, dtype, monkeypatch):
    """kmeans_fused_chw's own multigrid on the card (K4 and K2 on the twin,
    K2 at full resolution) against the same call on the plain versions."""
    xe, xc4, _, _ = _chw_blobs(device, DTYPES[dtype], 2, 12, 37, 45, 5, seed=5)
    affine = kc._affine_params(xe, xc4, preset("config1").cluster, 1e-6)
    kc.lloyd_chw_pass.launches = kc.maximin_chw_pass.launches = 0
    labels, centers = kc.kmeans_fused_chw(xe, xc4, affine, 5, coarse_iters=6, refine_iters=2)
    assert kc.lloyd_chw_pass.launches > 0 and kc.maximin_chw_pass.launches == 5
    monkeypatch.setattr(kc, "lloyd_chw_pass", kc.lloyd_chw_pass_plain)
    monkeypatch.setattr(kc, "maximin_chw_pass", kc.maximin_chw_pass_plain)
    ref, _ = kc.kmeans_fused_chw(xe, xc4, affine, 5, coarse_iters=6, refine_iters=2)
    floor = 0.999 if dtype == "float32" else 0.99
    for i in range(2):
        got, want = labels[i].cpu().numpy(), ref[i].cpu().numpy()
        assert (align_labels(got, want) == want).mean() >= floor


def test_evaluate_debug_nans_on_the_card(device, tmp_path):
    from gabor_color_image_segmentation_tpu_torch.data.synthetic import synthetic_dataset
    from gabor_color_image_segmentation_tpu_torch.eval import evaluate

    items = list(synthetic_dataset(2, h=96, w=128, seed=5))
    cfg = preset("config1").replace(batch_size=2, dtype="bfloat16")
    off, on = tmp_path / "off.jsonl", tmp_path / "on.jsonl"
    evaluate(items, cfg, out_path=str(off))
    evaluate(items, cfg, out_path=str(on), debug_nans=True)
    assert off.read_text() == on.read_text()


# ---------------------------------------------------------------------------
# the standardisation (csrc/standardise.cu): the pools and the normalised
# buffers bit-equal to their plain twins, the affine within 1e-6 of a
# float64 evaluation of its formulas, two launches bit-equal
# ---------------------------------------------------------------------------

# (batch, energy rows, H, W): config1's frame with its 240 rows, config2's
# batch of 50 with 36 rows, and odd small frames (15x17 has one 8x8 block
# a side: coherence weights of ones)
STD_SHAPES = {"config1": (16, 240, 321, 481), "config2": (50, 36, 321, 481),
              "7x9": (2, 5, 7, 9), "15x17": (2, 6, 15, 17), "64x96": (2, 9, 64, 96)}


def _std_inputs(device, dt, shape, seed, color_dt=None):
    """Energies (B, E, H, W) in dt (|normal|, as magnitudes are), colour rows
    (B, 4, H, W) in color_dt (default dt): L in [0, 100], a and b in [-60,
    60], a row of ones; made on the card."""
    b, e, h, w = shape
    g = torch.Generator(device).manual_seed(seed)
    xe = torch.randn((b, e, h, w), generator=g, device=device).abs_().to(dt)
    lab = torch.rand((b, 3, h, w), generator=g, device=device)
    lab = lab * torch.tensor([100.0, 120.0, 120.0], device=device)[:, None, None] \
        - torch.tensor([0.0, 60.0, 60.0], device=device)[:, None, None]
    xc4 = torch.cat([lab, torch.ones((b, 1, h, w), device=device)], dim=1)
    return xe, xc4.to(color_dt or dt).contiguous()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["config1_twin", "config1_xc4", "7x9", "15x17", "64x96"])
def test_std_pool_kernel(device, dtype, case):
    dt = DTYPES[dtype]
    if case.startswith("config1"):
        b, e, h, w = STD_SHAPES["config1"]
        shape = (b, e, h // 2, w // 2) if case == "config1_twin" else (b, 4, h, w)
    else:
        shape = STD_SHAPES[case]
    got = want = _std_inputs(device, dt, shape, seed=11)[0]
    for levels in (1, 2, 3):
        before = sd.pool2x2.launches
        got, want = sd.pool2x2(got), sd.pool2x2_plain(want)
        assert got.shape == want.shape
        assert torch.equal(got, want), (case, levels)
        assert sd.pool2x2.launches - before == (1 if got.numel() else 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["config1", "config1_twin", "config2", "7x9", "15x17",
                                  "64x96"])
def test_std_normalised_rows_kernel(device, dtype, case):
    """Given the same (a, b), the buffers equal the plain twin's bit for bit:
    config1's coarse buffer from the twin (one pool) and its full
    resolution, config2's buffer and fit grid (float32 colour) with 0-2
    pools and both at once, and small odd frames."""
    dt = DTYPES[dtype]
    name = case.split("_")[0]
    b, e, h, w = STD_SHAPES[name]
    if case == "config1_twin":
        h, w = h // 2, w // 2
    xe, xc4 = _std_inputs(device, dt, (b, e, h, w), seed=12,
                          color_dt=torch.float32 if name == "config2" else None)
    g = torch.Generator(device).manual_seed(3)
    a = torch.rand((b, e + 3), generator=g, device=device) + 0.1
    b_aff = torch.randn((b, e + 3), generator=g, device=device)
    pools = {"config1": [(0,)], "config1_twin": [(1,)],
             "config2": [(0,), (1,), (2,), (0, 1), (0, 2)]}.get(
        case, [(0,), (1,), (2,), (3,), (0, 1), (0, 2)])
    for p in pools:
        before = sd.normalised_rows.launches
        got = sd.normalised_rows(xe, xc4, a, b_aff, p)
        want = sd.normalised_rows_plain(xe, xc4, a, b_aff, p)
        assert sd.normalised_rows.launches - before <= 1
        for gg, ww in zip(got, want):
            assert gg.shape == ww.shape and gg.dtype == ww.dtype == dt
            assert torch.equal(gg, ww), (case, p)
    again = sd.normalised_rows(xe, xc4, a, b_aff, pools[-1])
    assert all(torch.equal(x, y) for x, y in
               zip(again, sd.normalised_rows(xe, xc4, a, b_aff, pools[-1])))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("pools", [(6,), (0, 6), (0, 7)])
def test_std_normalised_rows_past_max_pool(device, dtype, pools):
    """A fit grid deeper than one launch pools (gmm_fit_pool >= 6 on frames of
    16 MP or more): the raw rows pooled first, then the rest in the apply;
    bit-equal to the plain twin, every launch counted."""
    dt = DTYPES[dtype]
    xe, xc4 = _std_inputs(device, dt, (2, 9, 300, 520), seed=14, color_dt=torch.float32)
    g = torch.Generator(device).manual_seed(5)
    a = torch.rand((2, 12), generator=g, device=device) + 0.1
    b_aff = torch.randn((2, 12), generator=g, device=device)
    counts = (sd.pool2x2.launches, sd.normalised_rows.launches)
    got = sd.normalised_rows(xe, xc4, a, b_aff, pools)
    deep = pools[-1] - sd.MAX_POOL
    assert (sd.pool2x2.launches - counts[0], sd.normalised_rows.launches - counts[1]) == (
        2 * deep, len(pools))
    want = sd.normalised_rows_plain(xe, xc4, a, b_aff, pools)
    for gg, ww in zip(got, want):
        assert gg.shape == ww.shape and gg.dtype == ww.dtype == dt
        assert torch.equal(gg, ww), pools


def _affine64(xe, xc4, cfg, eps, pooled):
    """affine_params' formulas in float64 on the same (pooled) values:
    (a, b, the whole rows' mean and std)."""
    b, e, h, w = xe.shape

    def stats(qe, qc):
        v = torch.cat([qe.double().reshape(b, e, -1), qc[:, :3].double().reshape(b, 3, -1)], 1)
        m = v.mean(dim=2)
        return m, (v.square().mean(dim=2) - m * m).clamp(min=0).sqrt()

    scale = torch.cat([torch.ones(e), torch.full((3,), cfg.color_weight * math.sqrt(e / 3.0))])
    scale = scale.double().to(xe.device)[None].expand(b, -1)
    m = torch.zeros_like(scale)
    if cfg.normalize:
        m, s = stats(xe, xc4)
        a = scale / (s + eps)
        bb = -m * a
    else:
        a, bb = scale, torch.zeros_like(scale)
        s = None
    hb, wb = h // 8, w // 8
    if cfg.cue_weight == "coherence" and hb >= 2 and wb >= 2:
        qe, qc, lv = (pooled[0], pooled[1], 2) if pooled is not None else (xe, xc4, 3)
        qc = qc[:, :3]
        for _ in range(lv):
            qe, qc = sd.pool2x2_plain(qe), sd.pool2x2_plain(qc)
        qe, qc = qe[:, :, :hb, :wb], qc[:, :, :hb, :wb]
        _, sp = stats(qe, qc)
        if s is None:
            _, s = stats(xe[:, :, :8 * hb, :8 * wb], xc4[:, :, :8 * hb, :8 * wb])
        c = a * sp / (a * s + eps)
        wgt = c ** cfg.coherence_pow
        a, bb = a * wgt, bb * wgt
    return a, bb, m, s


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("case", ["config1", "config2", "normalize_off", "no_twin",
                                  "15x17", "7x9"])
def test_std_affine_params_kernel(device, dtype, case):
    """(a, b) within 1e-6 of the float64 evaluation: a relative to a, b
    relative to the scale of a standardised value, a (|m| + s). config1 at
    its frame with the twins, config2 at its batch of 50 with float32 colour
    (no coherence), coherence without normalisation (the 8x8-divisible
    crop's stds), coherence from the full-resolution rows (no twin), and
    frames under two 8x8 blocks a side (weights of ones). Two launches give
    the same bits; the launches are counted."""
    dt = DTYPES[dtype]
    cl1 = preset("config1").cluster
    cfg, shape, twin, color_dt = {
        "config1": (cl1, STD_SHAPES["config1"], True, None),
        "config2": (preset("config2").cluster, STD_SHAPES["config2"], False, torch.float32),
        "normalize_off": (dataclasses.replace(cl1, normalize=False), STD_SHAPES["64x96"],
                          True, None),
        "no_twin": (cl1, STD_SHAPES["64x96"], False, None),
        "15x17": (cl1, STD_SHAPES["15x17"], True, None),
        "7x9": (cl1, STD_SHAPES["7x9"], True, None),
    }[case]
    xe, xc4 = _std_inputs(device, dt, shape, seed=13, color_dt=color_dt)
    pooled = (sd.pool2x2_plain(xe), sd.pool2x2_plain(xc4)) if twin else None
    before = sd.affine_params.launches
    a, b_aff = sd.affine_params(xe, xc4, cfg, 1e-6, pooled)
    h, w = shape[2:]
    coh = cfg.cue_weight == "coherence" and h >= 16 and w >= 16
    assert sd.affine_params.launches - before == 1 + cfg.normalize + coh + (
        coh and not cfg.normalize)
    a2, b2 = sd.affine_params(xe, xc4, cfg, 1e-6, pooled)
    assert torch.equal(a, a2) and torch.equal(b_aff, b2)
    a64, b64, m64, s64 = _affine64(xe, xc4, cfg, 1e-6, pooled)
    assert ((a.double() - a64).abs() <= 1e-6 * a64.abs()).all()
    scale = a64.abs() * (m64.abs() + (s64 if s64 is not None else 0))
    assert ((b_aff.double() - b64).abs() <= 1e-6 * scale + 1e-30).all()
    if cfg.normalize:
        part = sd._moments(xe.contiguous(), xc4, 0, h, w).sum(dim=2)  # (B, R, 2)
        n = h * w
        m = part[..., 0] / n
        s = (part[..., 1] / n - m * m).clamp(min=0).sqrt()
        assert ((m - m64).abs() <= 1e-6 * (m64.abs() + s64)).all()
        assert ((s - s64).abs() <= 1e-6 * s64).all()
    plain_a, plain_b = sd.affine_params_plain(xe, xc4, cfg, 1e-6, pooled)
    assert ((a - plain_a).abs() <= 1e-4 * plain_a.abs()).all()


@pytest.mark.parametrize("name", ["config1", "config2"])
def test_std_pipeline_stage_against_plain(device, name, monkeypatch):
    """segment_batch at the published 321x481 frame (two images) with the
    standardisation's kernels against the same call with the plain twins
    on the card; the stage's launches counted."""
    rgb = np.stack([synthetic_mosaic(h=321, w=481, n_regions=5, seed=200 + i)[0]
                    for i in range(2)])
    cfg = preset(name).replace(batch_size=2, dtype="bfloat16")
    counts = [sd.pool2x2.launches, sd.affine_params.launches, sd.normalised_rows.launches]
    got, _ = segment_batch(rgb, cfg, with_features=False)
    counts = [f.launches - c for f, c in zip(
        (sd.pool2x2, sd.affine_params, sd.normalised_rows), counts)]
    assert counts == ([1, 3, 1] if name == "config1" else [0, 2, 1])
    for attr, plain in (("affine_params", sd.affine_params_plain),
                        ("normalised_rows", sd.normalised_rows_plain),
                        ("pool2x2", sd.pool2x2_plain)):
        monkeypatch.setattr(pipeline, attr, plain)
    want, _ = segment_batch(rgb, cfg, with_features=False)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    for i in range(2):
        assert (align_labels(got[i], want[i]) == want[i]).mean() >= 0.999
