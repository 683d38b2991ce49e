"""Fixtures of the benchmark's own tests (run on the CPU:
``python -m pytest gpubench/tests``; the card's: ``-m cuda`` on the card).
Nothing here imports JAX."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

TINY = {"frame_hw": [72, 96], "batch": 2, "pool": 2, "warmup_batches": 1, "check_batches": 1,
        "trace_batches": 2, "resident_iters": 2}


def make_root(dest: Path, **traffic_changes) -> Path:
    """A checkout's benchmark at ``dest``: BENCHMARK.json, the
    configuration files and the traffic mixes copied (the mixes shrunk by
    ``traffic_changes``), the metric readers and references copied."""
    src = REPO / "gpubench"
    dst = dest / "gpubench"
    for sub in ("configs", "workloads", "metrics", "reference"):
        shutil.copytree(src / sub, dst / sub, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    for path in (dst / "workloads").glob("*.json"):
        data = json.loads(path.read_text())
        data.update(traffic_changes)
        path.write_text(json.dumps(data))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    """The benchmark with every traffic mix cut to 72x96 frames, batches of
    2, a pool of 2 (the CPU's size)."""
    return make_root(tmp_path, **TINY)


@pytest.fixture
def cuda_card():
    """Skips unless a CUDA card is present (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (run on the card with -m cuda)")
    return torch.device("cuda", 0)


@pytest.fixture
def run_cell(capsys):
    """One CPU run of a cell: ``run_cell(root, workload, seed, seconds,
    trace)`` -> (exit code, the result or None, the standard error's
    lines)."""
    from gpubench import harness

    def run(root: Path, workload: str, seed: int = 5, seconds: float = 1.0, trace: int = 0):
        capsys.readouterr()
        rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds",
                           str(seconds), "--trace", str(trace)], device="cpu", root=root)
        out = capsys.readouterr()
        lines = out.out.strip().splitlines()
        result = json.loads(lines[-1]) if rc == 0 and lines else None
        return rc, result, out.err.strip().splitlines()

    return run
