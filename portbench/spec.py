"""Everything a run reads, found by name: the cell in ``BENCHMARK.json``,
its configuration (``configs/<config>.json``), its traffic
(``traffic/<traffic>.json``), its correctness limits
(``limits/<cell>.json``) and the readers of its metrics
(``metrics/<metric>.py``).  A new cell, mix or metric is a new file and a
new entry; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BASE = Path(__file__).resolve().parent  # portbench/
ROOT = BASE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, base: Path = BASE) -> dict:
    return load_json(base / "configs" / f"{name}.json")


def traffic(name: str, base: Path = BASE) -> dict:
    return load_json(base / "traffic" / f"{name}.json")


def limits(cell_name: str, base: Path = BASE) -> dict:
    return load_json(base / "limits" / f"{cell_name}.json")


def metrics_for(bench: dict, cell_name: str, section: str) -> list[dict]:
    """The metrics of ``section`` ("end_to_end" or "per_layer") that the
    cell reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell_name in m["workloads"]]


def reader(name: str, base: Path = BASE):
    """The ``read(record, ctx)`` function of ``metrics/<name>.py``."""
    path = base / "metrics" / f"{name}.py"
    mod_name = "portbench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
