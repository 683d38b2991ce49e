"""Finds what a cell needs by name: ``BENCHMARK.json`` at the checkout's
root, the configuration file it names, and under the checkout's
gpubench/ the traffic file ``workloads/<traffic>.json``, one reader a
metric (``metrics/<metric>.py``) and one reference a configuration
(``reference/<config>.py``). A new configuration, traffic mix or metric
is a new file; nothing here lists them."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType

HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration file's object
    traffic: dict  # the traffic file's object
    end_to_end: list  # BENCHMARK.json entries this cell reports with --trace 0
    per_layer: list  # and with --trace 1
    root: Path

    @property
    def config_name(self) -> str:
        return self.config["name"]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(entry: dict, cell: str, reported: set) -> bool:
    """An end-to-end metric (``reported`` None) or a per-layer metric that
    the cell reports: listed under ``workloads``, or without that key
    present everywhere its ``moves`` metric is."""
    if "workloads" in entry:
        return cell in entry["workloads"]
    return reported is None or entry["moves"] in reported


def load_cell(root: Path, workload: str) -> Cell:
    """The cell named ``workload`` of ``root``/BENCHMARK.json; raises
    KeyError for an unknown name."""
    root = Path(root)
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"unknown workload {workload!r}; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    if config["name"] != w["config"]:
        raise ValueError(f"{configs[w['config']]['file']} names {config['name']!r}, "
                         f"not {w['config']!r}")
    traffic = _load_json(root / "gpubench" / "workloads" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, workload, None)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload, reported)]
    return Cell(workload, int(w["chips"]), config, traffic, e2e, per_layer, root)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: Path, name: str) -> ModuleType:
    """gpubench/metrics/<name>.py: ``read(ctx)`` returns the value, or None
    where it finds nothing to read."""
    return _module(Path(root) / "gpubench" / "metrics" / f"{name}.py",
                   f"gpubench_metric_{name}")


def reference(root: Path, config_name: str) -> ModuleType:
    """gpubench/reference/<config>.py: ``segment(rgb, cfg, store)``."""
    return _module(Path(root) / "gpubench" / "reference" / f"{config_name}.py",
                   f"gpubench_reference_{config_name}")
