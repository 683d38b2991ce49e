"""Whole runs on the CPU at a small size (the look for a card skipped): the
last line's form, the checks on standard error, the JAX guard, the
import scan, and no result without the program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from gpubench import harness, spec
from gpubench.tests.conftest import REPO

CELLS = tuple(w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"])
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


def result_config(cell):
    return spec.load_cell(REPO, cell).config_name


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_form(tiny_root, run_cell, cell):
    rc, result, err = run_cell(tiny_root, cell, seed=2 ** 31 + 77, trace=0)
    assert rc == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"mp_s", "batch_ms_p95", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(result["device"]) == DEVICE_KEYS
    limits = json.loads((tiny_root / f"gpubench/configs/{result_config(cell)}.json")
                        .read_text())["limits"]
    assert set(result["checks"]) == set(limits)
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"}
    n = len(result["checks"])
    assert [line.split()[1] for line in err[-n:]] == list(result["checks"])
    assert all(line.startswith("check ") and " limit " in line for line in err[-n:])


def test_traced_result_line_form(tiny_root, run_cell):
    rc, result, err = run_cell(tiny_root, CELLS[0], seed=11, trace=1)
    assert rc == 0 and result["correct"] is True
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                            "checks"]
    assert set(result["device"]) == DEVICE_KEYS | {"busy_s", "window_s"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(result["breakdown"]["idle_gaps"]) <= 10
    # the CPU has no device events: only the host-clock metric is read
    assert set(result["metrics"]) == {"resident_mp_s"}


def test_a_jax_module_in_the_process_refuses_the_result(tiny_root, run_cell, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    rc, result, err = run_cell(tiny_root, CELLS[0])
    assert rc == 3 and result is None and "jax" in err[-1]


def test_forbidden_names_are_compared_whole(monkeypatch):
    assert "gabor_color_image_segmentation_tpu_torch" not in harness.FORBIDDEN
    monkeypatch.setitem(sys.modules, "gabor_color_image_segmentation_tpu.config",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == ["gabor_color_image_segmentation_tpu"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_of_the_benchmark_imports_jax_and_the_reference_none_of_the_port():
    files = sorted((REPO / "gpubench").rglob("*.py"))
    assert files
    for path in files:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
        if path.parent.name == "reference":
            assert harness.PACKAGE not in tops, path


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and gpubench/: no program."""
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(REPO / "gpubench", tmp_path / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "gpubench/run.py", "--workload", CELLS[0], "--seed",
                        "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout
