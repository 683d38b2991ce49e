"""BENCHMARK.json's form, and the harness finding configurations, cells,
metrics and references by name, new ones from files alone."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from gpubench import judge, spec, traffic
from gpubench.tests.conftest import REPO, make_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("gpubench/") and (REPO / c["file"]).is_file()
        names.add(c["name"])
    cells = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["config"] in names and w["chips"] in (1, 4)
        cells.add(w["name"])
    metrics = set()
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["name"] not in metrics
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
        metrics.add(m["name"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = spec.load_cell(REPO, cell)
    traffic.check(c.traffic)
    assert {m["name"] for m in c.end_to_end} >= {"mp_s", "batch_ms_p95", "setup_s"}
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.metric_reader(REPO, m["name"]).read)
    assert callable(spec.reference(REPO, c.config_name).segment)
    assert {"mean_mismatch", "labels_outside_k"} <= set(c.config["limits"]) <= set(judge.NUMBERS)
    assert c.config["limits"]["labels_outside_k"] == 0


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_configuration_files_hold_the_published_presets(name):
    """Every field of the port's preset, in the configuration's dtype."""
    from gpubench import harness
    from gabor_color_image_segmentation_tpu_torch.config import preset

    data = json.loads((REPO / f"gpubench/configs/{name}.json").read_text())
    assert data["name"] == name
    want = preset(data["preset"]).replace(dtype=data["dtype"], name=name)
    assert harness.pipeline_config(data) == want
    assert dataclasses.asdict(want)["bank"]["scales"] == tuple(data["bank"]["scales"])


def test_a_new_cell_traffic_and_metric_are_found_from_files_alone(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    mix = json.loads((root / "gpubench/workloads/bsds-b16.json").read_text())
    mix.update(batch=8, pool=16)
    (root / "gpubench/workloads/bsds-b8.json").write_text(json.dumps(mix))
    (root / "gpubench/metrics/batches_seen.py").write_text(
        "def read(ctx):\n    return None if ctx.window is None else ctx.window.attempted\n")
    bench["workloads"].append({"name": "config1.bsds-b8", "config": "config1-bf16",
                               "traffic": "bsds-b8", "chips": 1, "why": "a smaller batch"})
    bench["per_layer"].append({"name": "batches_seen", "unit": "batches", "better": "higher",
                               "source": "host_clock", "layer": "entry and transfer",
                               "moves": "mp_s", "workloads": ["config1.bsds-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell(root, "config1.bsds-b8")
    assert cell.traffic["batch"] == 8 and cell.config_name == "config1-bf16"
    assert [m["name"] for m in cell.per_layer] == ["batches_seen"]
    assert spec.metric_reader(root, "batches_seen").read(
        type("Ctx", (), {"window": None})()) is None
    with pytest.raises(KeyError):
        spec.load_cell(root, "config9.none")


def test_a_per_layer_metric_without_workloads_goes_where_its_end_to_end_metric_is(tmp_path):
    root = make_root(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "device_idle2", "unit": "%", "better": "lower",
                               "source": "device_trace", "layer": "device", "moves": "mp_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for w in bench["workloads"]:
        assert "device_idle2" in {m["name"] for m in spec.load_cell(root, w["name"]).per_layer}
