"""PyTorch port: what K1's tensor-core route reads, on the CPU.

In bf16 mode K1 runs every 1-D pass as a banded product on the tensor
cores, its bands cut into 16 x 16 blocks on the host
(``fused.band_tables``). Assembled, those blocks are the matrices the plain
version multiplies by: the envelope's and the box sums' VALID bands
(``_band_matrix``), and the smoothing's and the twin's REFLECT_101-folded
matrices (``_smooth_matrix_np``), edge blocks included. The benchmark reads
K1's device time by the kernel names the source defines, so the trace
reader has to find every kernel the file defines."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu_torch.config import BankConfig, preset
from gabor_color_image_segmentation_tpu_torch.ops import fused
from gabor_color_image_segmentation_tpu_torch.ops.bank import bank_tensors, make_bank
from gpubench import trace

CSRC = Path(fused.__file__).resolve().parents[1] / "csrc"
BANKS = {
    "config1": preset("config1").bank,  # (p, r): (5, 5) ... (15, 24)
    "radii_32_50": BankConfig(scales=(2.0, 11.0), orientations=2, max_ksize=65,
                              smoothing=1.5),
}


def _groups(name):
    return bank_tensors(make_bank(BANKS[name]), "cpu")


def _assemble(blocks: np.ndarray, stride: int, n_out: int) -> np.ndarray:
    """The dense (n_out, padded width) band: block (m, k) at rows 16 m and
    padded columns stride * 16 m + 16 k."""
    nm, nk = blocks.shape[:2]
    dense = np.zeros((nm * 16, stride * 16 * nm + 16 * nk), np.float32)
    for m in range(nm):
        for k in range(nk):
            c0 = stride * 16 * m + 16 * k
            dense[16 * m:16 * m + 16, c0:c0 + 16] = blocks[m, k]
    return dense[:n_out]


def _source_kernel_names(text: str) -> list:
    """The name after each __global__ of a CUDA source, comments dropped:
    the last word before the parenthesis that opens the parameters."""
    text = re.sub(r"//[^\n]*", "", text)
    names = []
    for chunk in text.split("__global__")[1:]:
        head = chunk.lstrip()
        if head.startswith("void"):
            head = head[len("void"):].lstrip()
        if head.startswith("__launch_bounds__"):
            head = head[head.index(")") + 1:]
        names.append(head.split("(", 1)[0].split()[-1])
    return names


def test_trace_reader_finds_every_kernel_of_k1():
    path = CSRC / "gabor_energies.cu"
    names = _source_kernel_names(path.read_text())
    # the FMA route's two kernels and the tensor-core route's two
    assert len(names) == 4
    assert trace.kernel_names([path]) == set(names)
    pattern = trace.name_pattern(set(names))
    for demangled in ("(anonymous namespace)::tc::gabor_mag_kernel(float const*, "
                      "__nv_bfloat16*, int)",
                      "void (anonymous namespace)::smooth_kernel<float>(float const*, float*)"):
        assert pattern.search(demangled)


@pytest.mark.parametrize("bank_name", sorted(BANKS))
@pytest.mark.parametrize("ones", [False, True])
def test_envelope_blocks_are_the_band_matrix(bank_name, ones):
    for g in _groups(bank_name):
        blocks = fused._envelope_blocks_np(g.env_host, ones)
        assert blocks.shape == (1, (2 * g.p + 31) // 16, 16, 16)
        taps = torch.ones(2 * g.p + 1) if ones else fused._round_storage(
            torch.tensor(g.env_host, dtype=torch.float32), True)
        n_out = 48
        band = fused._band_matrix(taps, n_out).numpy()
        dense = _assemble(np.repeat(blocks, n_out // 16, axis=0), 1, n_out)
        assert np.array_equal(dense[:, :band.shape[1]], band)
        assert not dense[:, band.shape[1]:].any()


# axis lengths: one pixel (no twin), under one row block, odd, config1's frame
@pytest.mark.parametrize("n,pooled", [(1, False)] + [(n, pooled) for n in (2, 5, 37, 53, 321, 481)
                                                     for pooled in (False, True)])
@pytest.mark.parametrize("bank_name", sorted(BANKS))
def test_smooth_blocks_are_the_folded_matrix(bank_name, n, pooled):
    """Every row block, the folded ones at both edges included, laid on the
    REFLECT_101-padded axis and folded back onto the source pixels, gives
    the reference's matrix bit for bit (each source pixel has one nonzero
    tap a row on the padded axis, so the fold adds only zeros)."""
    for g in _groups(bank_name):
        # down the rows unshifted; across the columns from 8-aligned strips
        for shift in (0, fused.column_shift(g.r)):
            stride = 2 if pooled else 1
            blocks = fused._smooth_blocks_np(g.smooth_host, n, pooled, shift)
            ntap = 2 * g.r + 1 + (1 if pooled else 0)
            n_out = n // 2 if pooled else n
            assert blocks.shape == (-(-n_out // 16), (15 * stride + ntap + shift + 15) // 16,
                                    16, 16)
            want = fused._smooth_matrix_np(g.smooth_host, n, pooled, True)
            dense = _assemble(blocks, stride, n_out)
            src = fused._reflect_np(np.arange(dense.shape[1]) - g.r - shift, n)
            folded = np.zeros(want.shape, np.float64)
            for u in range(dense.shape[1]):
                folded[:, src[u]] += dense[:, u]
            assert np.array_equal(folded.astype(np.float32), want)


@pytest.mark.parametrize("pooled", [False, True])
def test_band_tables_hold_the_blocks_in_bf16(pooled):
    """The kernel's inputs: the blocks cast to bfloat16 exactly, the twin's
    only with a twin."""
    h, w = 37, 53
    for g in _groups("config1"):
        tables = fused.band_tables(g, h, w, pooled)
        shift = fused.column_shift(g.r)
        assert (g.r + shift) % 8 == 0 and 0 <= shift < 8
        want = [fused._envelope_blocks_np(g.env_host, False),
                fused._envelope_blocks_np(g.env_host, True),
                fused._smooth_blocks_np(g.smooth_host, h, False, 0),
                fused._smooth_blocks_np(g.smooth_host, w, False, shift)]
        want += ([fused._smooth_blocks_np(g.smooth_host, h, True, 0),
                  fused._smooth_blocks_np(g.smooth_host, w, True, shift)] if pooled
                 else [None, None])
        for got, ref in zip(tables, want):
            if ref is None:
                assert got is None
                continue
            assert got.dtype == torch.bfloat16 and got.is_contiguous()
            assert np.array_equal(got.float().numpy(), ref)


def test_cpu_calls_count_no_tensor_core_groups():
    groups = _groups("config1")
    img = torch.randn((1, 19, 23, 3), generator=torch.Generator().manual_seed(0))
    before = fused.gabor_energies_fused.tc_groups
    fused.gabor_energies_fused(img, groups, torch.bfloat16)
    assert fused.gabor_energies_fused.tc_groups == before
