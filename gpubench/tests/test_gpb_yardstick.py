"""The frozen counts: K1's at config1 give chip_smoke.py's 3.0526 ms bound
against the float32 peak; K8's pass is chip_smoke's formula."""

from __future__ import annotations

import json

import pytest

from gpubench import yardstick
from gpubench.tests.conftest import REPO


def _config(name):
    return json.loads((REPO / f"gpubench/configs/{name}.json").read_text())


def test_k1_count_reproduces_the_bound_at_config1():
    cfg = _config("config1-bf16")
    flops, nbytes = yardstick.energies_counts(16, 321, 481, 3, cfg["bank"], True, "bfloat16")
    ms, by = yardstick.least_seconds(flops, 0, yardstick.PEAKS["fp32_flop_per_s"])
    assert 1e3 * ms == pytest.approx(3.0526, abs=5e-5) and by == "operations"
    assert flops == 204521997312
    # the colour in float32, the energies and the twin out in bf16
    assert nbytes == 16 * 154401 * 3 * 4 + 16 * 240 * 154401 * 2 + 16 * 240 * 160 * 240 * 2
    least, by = yardstick.least_seconds(flops, nbytes, yardstick.PEAKS["bf16_tensor_flop_per_s"])
    assert by == "bytes" and 1e3 * least == pytest.approx(0.4509, abs=1e-4)


def test_bank_radii():
    assert yardstick.bank_radii(_config("config1-bf16")["bank"]) == [
        (16, 5, 5), (16, 8, 8), (16, 12, 12), (16, 15, 18), (16, 15, 24)]
    assert yardstick.bank_radii(_config("config2-bf16")["bank"]) == [
        (4, 6, 6), (4, 12, 12), (4, 15, 24)]


def test_k8_counts_at_config2():
    cfg = _config("config2-bf16")
    b, d, k = 50, 39, 5
    # chip_smoke's check_em: bsz * npx * (k d (d + 1) + k (d + 1) (d + 2))
    assert yardstick.em_pass_flops(b, 9600, k, d, True) == b * 9600 * (k * d * (d + 1)
                                                                        + k * (d + 1) * (d + 2))
    assert yardstick.fit_grid(321, 481, 2) == 80 * 120
    flops, nbytes = yardstick.em_counts(b, 321, 481, cfg["cluster"], d, "bfloat16")
    assert flops == (30 * yardstick.em_pass_flops(b, 9600, k, d, True)
                     + yardstick.em_pass_flops(b, 154401, k, d, True)
                     + yardstick.em_pass_flops(b, 154401, k, d, False))
    assert nbytes == b * d * (154401 + 9600) * 2 + b * 154401 * 4
    least, by = yardstick.least_seconds(flops, nbytes, yardstick.PEAKS["bf16_tensor_flop_per_s"])
    assert by == "operations" and 1e3 * least == pytest.approx(0.4187, abs=1e-4)
