"""One run of one cell: set-up, the measured window, the check, the
result line.

The window is a closed loop with one caller: the next call starts when the
previous one has returned its answer to the host.  It runs until
``seconds`` have passed; the last call finishes inside it.  With
``trace`` the window runs under ``torch.profiler`` and the run reports the
cell's per-layer metrics instead of its end-to-end ones.
"""

from __future__ import annotations

import contextlib
import math
import shutil
import sys
import tempfile
import time

from . import cells
from .trace import CALL_SPAN, WINDOW_SPAN, TraceView, profiled, span

# Top-level module names that may not be loaded in a run's process: the
# JAX package and JAX itself.  Names are compared whole, since the
# port's package name begins with the JAX package's.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "tse1m_tpu")


def forbidden_loaded() -> list:
    top = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(top & set(FORBIDDEN_MODULES))


class Phases:
    """Seconds of each named step of a cell's set-up, for its notes."""

    def __init__(self) -> None:
        self.seconds: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = time.perf_counter() - t0

    def line(self) -> str:
        return "set-up steps: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in self.seconds.items())


def seed_value(seed: int) -> int:
    """``--seed`` as the non-negative 64-bit value the cells draw from."""
    return int(seed) % 2**64


def percentile(values: list, q: float) -> float:
    """The nearest-rank q-th percentile: the smallest value that at least
    q% of the values do not exceed."""
    ordered = sorted(values)
    return ordered[max(0, math.ceil(q / 100.0 * len(ordered)) - 1)]


def timed_window(cell, seconds: float, trace: bool) -> tuple:
    """Calls ``cell.call(i)`` back to back until ``seconds`` have passed;
    returns (each call's seconds, the window's seconds)."""
    latencies = []
    with span(trace, WINDOW_SPAN):
        t_start = time.perf_counter()
        i = 0
        while True:
            with span(trace, CALL_SPAN):
                t0 = time.perf_counter()
                cell.call(i)
                t1 = time.perf_counter()
            latencies.append(t1 - t0)
            i += 1
            if t1 - t_start >= seconds:
                break
    return latencies, t1 - t_start


def _apply(base: dict, changes: dict | None) -> dict:
    out = dict(base)
    for k, v in (changes or {}).items():
        out[k] = _apply(out[k], v) if isinstance(v, dict) else v
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", t_process: float | None = None,
             overrides: dict | None = None) -> dict:
    """Run cell ``name`` once and return its result line as a dict.

    ``overrides`` ({"config": {...}, "params": {...}}) change the
    configuration's and the traffic's values: the tests' small sizes on
    the CPU.  ``t_process``: the process's start on ``time.perf_counter``
    (set-up is counted from it)."""
    t_process = time.perf_counter() if t_process is None else t_process
    man = cells.manifest()
    entry = cells.cell_entry(man, name)
    wl = cells.workload(name)
    if (wl["config"], wl["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json names {wl['config']}/"
                         f"{wl['traffic']}, BENCHMARK.json "
                         f"{entry['config']}/{entry['traffic']}")
    overrides = overrides or {}
    cfg = _apply(cells.config(entry["config"]), overrides.get("config"))
    params = _apply(wl["params"], overrides.get("params"))
    limits = wl["limits"]

    import torch

    on_card = device == "cuda"
    scratch = tempfile.mkdtemp(prefix="bench-", dir=tempfile.gettempdir())
    cell = cells.driver(wl["driver"]).Cell(cfg, params, seed_value(seed),
                                           device, scratch)
    try:
        cell.setup()
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_process
        with profiled(trace, scratch, on_card) as prof:
            latencies, window_s = timed_window(cell, seconds, trace)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        values = dict(cell.end_to_end(latencies, window_s), setup_s=setup_s)
        for line in cell.notes(latencies, window_s):
            print(line, file=sys.stderr)
        view = None
        if trace:
            view = TraceView(prof["events"], cell.shapes())
            print(f"trace: {len(prof['events'])} events exported and read "
                  f"in {prof['read_s']:.3f} s", file=sys.stderr)
        cell.release()
        if on_card:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        verdict = cell.check()
        print(f"check: the reference and the comparison took "
              f"{time.perf_counter() - t_check:.3f} s", file=sys.stderr)
    finally:
        cell.close()
        shutil.rmtree(scratch, ignore_errors=True)

    metrics = {}
    if trace:
        for m in cells.per_layer_of(man, name):
            v = cells.metric(m["name"]).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cells.end_to_end_of(man, name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(entry["chips"]), "memory_peak_bytes": int(peak)}
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in verdict["numbers"].items()}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values())
              and verdict["attempted"] > 0,
              "attempted": verdict["attempted"], "failed": verdict["failed"],
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = view.breakdown()
    result["checks"] = checks
    return result


def checks_lines(result: dict) -> list:
    """Each compared number beside its limit, one line each."""
    return [f"check {k}: {c['value']} (limit {c['limit']})"
            for k, c in result["checks"].items()]
