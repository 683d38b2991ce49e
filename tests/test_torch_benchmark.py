"""PyTorch port, the benchmark core (``benchmark.py``) and ``cli bench`` on
the CPU, against the JAX package's benchmark.py.

``build_batch`` gives the reference's mosaics bit for bit; the timed loop
(``_timed_loop``) adds i mod 256 to the uint8 batch, as the reference's
``b + i.astype(b.dtype)``, runs the labels-only path and sums the labels
into its checksum; ``run_benchmark`` returns the reference's keys, and its
``vs_baseline`` from the copied table for a stock preset, None for a
``cfg``; with no card ``device=None`` raises and names ``device="cpu"``;
``gaborseg-torch bench`` prints one JSON line, and ``--measure-cpu``
exits non-zero (the port imports no golden/ module)."""

import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gabor_color_image_segmentation_tpu import benchmark as jax_benchmark
from gabor_color_image_segmentation_tpu.config import preset as jax_preset
from gabor_color_image_segmentation_tpu_torch import benchmark
from gabor_color_image_segmentation_tpu_torch.cli import main as cli_main
from gabor_color_image_segmentation_tpu_torch.config import preset
from gabor_color_image_segmentation_tpu_torch.data import synthetic_mosaic
from gabor_color_image_segmentation_tpu_torch.models import pipeline
from gabor_color_image_segmentation_tpu_torch.ops.bank import make_bank

torch.set_num_threads(2)


def _small_batch(cfg, n_images):
    """64x96 bench mosaics (seeds 100, ...) in place of the preset's frame."""
    return np.stack([synthetic_mosaic(h=64, w=96, n_regions=5, seed=100 + i)[0]
                     for i in range(n_images)])


def test_cpu_baseline_is_the_references():
    assert benchmark.CPU_BASELINE_MP_S == jax_benchmark.CPU_BASELINE_MP_S


@pytest.mark.parametrize("name", ["config0", "config4"])
def test_build_batch_matches_jax(name):
    got = benchmark.build_batch(preset(name), 1)
    ref = jax_benchmark.build_batch(jax_preset(name), 1)
    assert got.dtype == np.uint8 and got.shape == (1, *preset(name).image_hw, 3)
    np.testing.assert_array_equal(got, ref)


def test_timed_loop_checksum_and_wrap(monkeypatch):
    """Three iterations at config0 on batch 2 of 64x96: the checksum is the
    sum over i of the labels' sums of ((batch + i) mod 256), computed
    apart; each call's input is the reference's b + i.astype(b.dtype) (a
    pixel of 255 wraps to 0 at i = 1); every call takes the labels-only
    transposed path."""
    cfg = preset("config0").replace(batch_size=2)
    batch = _small_batch(cfg, 2)
    batch[0, 0, 0] = 255
    seen, transposed = [], []
    real_segment, real_t = pipeline.segment_batch, pipeline._segment_batch_transposed
    monkeypatch.setattr(pipeline, "segment_batch", lambda rgb, *a, **kw: (
        seen.append(rgb.clone()) or real_segment(rgb, *a, **kw)))
    monkeypatch.setattr(pipeline, "_segment_batch_transposed", lambda *a, **kw: (
        transposed.append(1) or real_t(*a, **kw)))
    bank = make_bank(cfg.bank)
    seconds, checksum = benchmark._timed_loop(cfg, torch.from_numpy(batch), bank, 3, "cpu")
    assert seconds > 0 and len(seen) == 3 and len(transposed) == 3
    expected = 0
    for i in range(3):
        ref_in = np.asarray(jnp.asarray(batch) + jnp.asarray(i).astype(jnp.uint8))
        assert seen[i].dtype == torch.uint8
        np.testing.assert_array_equal(seen[i].numpy(), ref_in)
        wrapped = ((batch.astype(np.int64) + i) % 256).astype(np.uint8)
        labels, _ = real_segment(wrapped, cfg, bank, False, "cpu")
        expected += int(labels.to(torch.int64).sum())
    assert int(seen[1][0, 0, 0, 0]) == 0  # 255 + 1 wraps
    assert checksum == expected


def test_run_benchmark_keys_and_baseline(monkeypatch):
    """The reference's keys; with the same MP/s, the same value and
    vs_baseline for a stock preset; vs_baseline None for a cfg (where the
    reference would time its golden path)."""
    monkeypatch.setattr(jax_benchmark, "bench_device", lambda cfg, batch, iters: 2.5)
    monkeypatch.setattr(benchmark, "bench_device", lambda cfg, batch, iters, device: 2.5)
    ref = jax_benchmark.run_benchmark("config0", iters=1)
    got = benchmark.run_benchmark("config0", iters=1, device="cpu")
    assert set(got) == set(ref) == {"metric", "value", "unit", "vs_baseline"}
    assert got["value"] == ref["value"] and got["vs_baseline"] == ref["vs_baseline"]
    assert got["vs_baseline"] == round(2.5 / benchmark.CPU_BASELINE_MP_S["config0"], 1)
    assert got["unit"] == "MP/s/CPU" and "chip" not in got["metric"]
    assert got["metric"].startswith("end-to-end MP/s/CPU (config0:")
    cfg = preset("config0").replace(cluster=dataclasses.replace(preset("config0").cluster, k=3))
    assert benchmark.run_benchmark(cfg=cfg, iters=1, device="cpu")["vs_baseline"] is None


def test_run_benchmark_on_the_cpu(monkeypatch):
    """The whole chain at a small frame: a positive MP/s from the timed
    loop, batch_size honoured."""
    monkeypatch.setattr(benchmark, "build_batch", _small_batch)
    out = benchmark.run_benchmark("config0", batch_size=2, iters=1, dtype="float32",
                                  device="cpu")
    assert out["value"] > 0 and "batch 2" in out["metric"]
    assert out["vs_baseline"] == round(out["value"] / 0.1632, 1)


def test_device_none_without_a_card_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        benchmark.run_benchmark("config0", iters=1)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        benchmark.bench_device(preset("config0"), _small_batch(None, 1), 1)


@pytest.mark.parametrize("flags, stock", [([], True), (["--k", "3", "--dtype", "float32"], False)])
def test_cli_bench_prints_one_json_line(monkeypatch, capsys, flags, stock):
    monkeypatch.setattr(benchmark, "build_batch", _small_batch)
    cli_main(["bench", "--preset", "config0", "--iters", "1", "--device", "cpu", *flags])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert set(out) == {"metric", "value", "unit", "vs_baseline"} and out["value"] > 0
    assert (out["vs_baseline"] is not None) == stock
    assert ("k=3" in out["metric"]) == (not stock)


def test_cli_bench_measure_cpu_exits_non_zero():
    with pytest.raises(SystemExit) as exc:
        cli_main(["bench", "--preset", "config0", "--measure-cpu", "--device", "cpu"])
    assert exc.value.code not in (0, None) and "golden" in str(exc.value.code)
