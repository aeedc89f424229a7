"""Finding a cell's pieces by name.

``BENCHMARK.json`` at the root of the checkout names the cells, the
configurations and the metrics.  Each piece is a file of its own under
``benchmark/``, found by its name, so a new cell, configuration, traffic
kind or per-layer metric is a new file and an entry, never an edit:

- ``configs/<config>.json``: the deployment's sizes and guarantees;
- ``workloads/<cell>.json``: the cell's configuration, traffic, driver,
  traffic parameters and the limit of each number its check compares;
- ``drivers/<driver>.py``: one kind of traffic, a ``Cell`` class;
- ``metrics/<metric>.py``: one per-layer metric, a ``read(view)``
  function that returns a number, or None where it finds nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(MANIFEST)


def cell_entry(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"BENCHMARK.json names no workload {name!r}")


def config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def workload(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "workloads", f"{name}.json"))


def _module(kind: str, name: str):
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return _module("drivers", name)


def metric(name: str):
    return _module("metrics", name)


def reports(metric_entry: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether a metric is reported in ``cell``: the cells its
    ``workloads`` key lists, or, without the key, every cell that reports
    the end-to-end metric it moves."""
    if "workloads" in metric_entry:
        return cell in metric_entry["workloads"]
    return metric_entry.get("moves") in e2e_of_cell


def end_to_end_of(man: dict, cell: str) -> list:
    """The cell's end-to-end metric entries, in manifest order."""
    return [m for m in man["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def per_layer_of(man: dict, cell: str) -> list:
    e2e = {m["name"] for m in end_to_end_of(man, cell)}
    return [m for m in man["per_layer"] if reports(m, cell, e2e)]
