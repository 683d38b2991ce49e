"""The trace reader on synthetic chrome traces: the union of overlapping
device intervals, the idle share, kernels found by their source's names,
copies, launches and the breakdown."""

from __future__ import annotations

import json

import pytest

from gpubench import trace
from gpubench.tests.conftest import REPO


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


K1 = "void (anonymous namespace)::gabor_mag_kernel<true>(float const*, float*, int)"
SM = "void (anonymous namespace)::smooth_kernel<__nv_bfloat16>(float const*, __nv_bfloat16*)"
TORCH = ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
         "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)")
SUM = "gcis::block_order_sum_kernel(float const*, float*, int, int)"


def _events():
    return [
        _ev("user_annotation", trace.WINDOW, 1000.0, 1000.0),
        _ev("user_annotation", trace.BATCH, 1000.0, 500.0),
        _ev("user_annotation", trace.BATCH, 1500.0, 500.0),
        _ev("cpu_op", "aten::add", 1100.0, 40.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 1105.0, 5.0),
        _ev("cuda_runtime", "cudaLaunchKernelExC", 1205.0, 5.0),
        _ev("cuda_runtime", "cudaMemcpyAsync", 1700.0, 150.0),
        _ev("cpu_op", "aten::copy_", 1690.0, 200.0),
        # 1100-1300 and 1250-1400 overlap: union 300 us
        _ev("kernel", K1, 1100.0, 200.0),
        _ev("kernel", TORCH, 1250.0, 150.0),
        _ev("kernel", SM, 1500.0, 100.0),
        _ev("kernel", SUM, 1600.0, 50.0),
        _ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 1020.0, 50.0),
        _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1720.0, 100.0),
        _ev("gpu_memset", "Memset (Device)", 1650.0, 10.0),
        # outside the window: ignored
        _ev("kernel", K1, 2500.0, 100.0),
        _ev("cuda_runtime", "cudaLaunchKernel", 2400.0, 5.0),
    ]


def test_union_of_overlapping_intervals_and_idle_share():
    tr = trace.Trace(_events())
    assert tr.window_s == pytest.approx(1e-3)
    # 1020-1070, 1100-1400, 1500-1660, 1720-1820
    assert tr.busy_s() == pytest.approx((50 + 300 + 160 + 100) / 1e6)
    assert trace.merge([(0, 2), (1, 3), (5, 6), (6, 7)]) == [[0, 3], [5, 7]]
    assert tr.batches == 2


def test_kernels_by_source_copies_and_launches():
    tr = trace.Trace(_events())
    k1 = trace.name_pattern({"gabor_mag_kernel", "smooth_kernel"})
    assert tr.kernel_seconds(k1) == (pytest.approx(300e-6), 2)
    ours = trace.name_pattern({"gabor_mag_kernel", "smooth_kernel", "block_order_sum_kernel"})
    assert tr.kernel_seconds(exclude=ours) == (pytest.approx(150e-6), 1)
    assert tr.kernel_seconds(trace.name_pattern({"block_order_sum_kernel"}))[1] == 1
    assert tr.copy_seconds() == (pytest.approx(150e-6), 2)
    assert tr.launches() == 2
    assert trace.name_pattern(set()) is None


def test_breakdown_names_device_ops_and_what_the_host_did_in_the_gaps():
    tr = trace.Trace(_events())
    ops = dict(tr.device_ops())
    assert ops["gabor_mag_kernel"] == pytest.approx(200e-6)
    assert ops["vectorized_elementwise_kernel"] == pytest.approx(150e-6)
    gaps = dict(tr.idle_gaps())
    # 1000-1020 and 1070-1100: host (nothing covers them); 1400-1500: host;
    # 1660-1720 under aten::copy_ (cudaMemcpyAsync starts at 1700, after
    # the gap's middle); 1820-2000: cudaMemcpyAsync runs to 1850 (middle
    # 1910: aten::copy_ to 1890, so host)
    assert sum(gaps.values()) == pytest.approx(1e-3 - tr.busy_s())
    assert gaps["aten::copy_"] == pytest.approx(60e-6)
    assert gaps["host"] == pytest.approx((20 + 30 + 100 + 180) / 1e6)


def test_short_names():
    assert trace.short_name(K1) == "gabor_mag_kernel"
    assert trace.short_name(SUM) == "block_order_sum_kernel"
    assert trace.short_name("(anonymous namespace)::partial_sum_kernel(float const*, int)") \
        == "partial_sum_kernel"
    assert trace.short_name(
        "std::enable_if<!(false), void>::type internal::gemvx::kernel<int, float>(int)") \
        == "kernel"
    assert trace.short_name("sm80_xmma_gemm_f32f32_cublas") == "sm80_xmma_gemm_f32f32_cublas"


def test_the_program_sources_define_the_kernels_the_metrics_map():
    csrc = REPO / "gabor_color_image_segmentation_tpu_torch" / "csrc"
    names = trace.kernel_names([csrc / "gabor_energies.cu"])
    assert names == {"gabor_mag_kernel", "smooth_kernel"}
    em = trace.kernel_names([csrc / s for s in ("maximin_t.cu", "lloyd_t.cu",
                                                  "precision_chol.cu", "em_pass.cu",
                                                  "common.cuh")])
    assert {"em_kernel", "precision_chol_kernel", "lloyd_t_kernel", "maximin_t_kernel",
            "block_order_sum_kernel"} <= em
    km = trace.kernel_names([csrc / s for s in ("coarse_centers.cu", "lloyd_chw.cu",
                                                  "maximin_chw.cu")])
    assert {"coarse_centers_kernel", "lloyd_kernel", "partial_sum_kernel"} <= km
    assert not (km & em) and not (names & (km | em))


def test_from_file_reads_a_chrome_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _events()}))
    assert trace.Trace.from_file(path).busy_s() == pytest.approx(trace.Trace(_events()).busy_s())
    with pytest.raises(ValueError):
        trace.Trace(_events()[1:])
