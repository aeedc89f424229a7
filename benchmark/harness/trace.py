"""The traced window: ``torch.profiler`` around it, and what the per-layer
metrics read from the trace.

The trace is exported as Chrome JSON into a file under the run's scratch
directory, read back and deleted.  Device events are kernels, copies and
fills.  The window is the harness's ``bench.window`` span, each timed
call a ``bench.call`` span inside it.  Busy time is the union of the
device intervals inside the window (the method of the port's smoke run,
phase 3f), so overlapping work on two streams counts once.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW_SPAN = "bench.window"
CALL_SPAN = "bench.call"
# Entries of each list in the result's breakdown.
BREAKDOWN_ENTRIES = 10


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments,
    parameters and namespaces; copies and fills keep theirs."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    head = name.replace("(anonymous namespace)::", "")
    head = head.removeprefix("void ").split("(")[0].split("<")[0]
    return head.rsplit("::", 1)[-1]


def union_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


def gaps_us(intervals, t0: float, t1: float) -> list:
    """The (start, end) stretches of [t0, t1] that no interval covers."""
    out, at = [], t0
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
        if at >= t1:
            break
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


class DeviceEvent:
    """One kernel, copy or fill: its names, category, start and length in
    microseconds, and the torch op that launched it (None for a kernel
    of the program's own extension, which no torch op launches)."""

    __slots__ = ("name", "short", "cat", "ts", "dur", "op")

    def __init__(self, e: dict, ops: dict) -> None:
        self.name = e["name"]
        self.short = short_name(e["name"])
        self.cat = e["cat"]
        self.ts = float(e["ts"])
        self.dur = float(e["dur"])
        self.op = ops.get(e.get("args", {}).get("External id"))


class TraceView:
    """What a per-layer metric reads: the device events inside the
    window, the window's length, the number of timed calls, the host
    spans (for what the host did while the device idled), and the cell's
    shapes (``shapes``, set by the cell's driver)."""

    def __init__(self, events: list, shapes: dict) -> None:
        window = [e for e in events if e.get("cat") == "user_annotation"
                  and e["name"] == WINDOW_SPAN]
        if not window:
            raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
        w = window[0]
        self.t0 = float(w["ts"])
        self.t1 = self.t0 + float(w["dur"])
        self.calls = sum(1 for e in events
                         if e.get("cat") == "user_annotation"
                         and e["name"] == CALL_SPAN)
        ops = {e["args"]["External id"]: e["name"] for e in events
               if e.get("cat") == "cpu_op"
               and "External id" in e.get("args", {})}
        self.device = [DeviceEvent(e, ops) for e in events
                       if e.get("cat") in DEVICE_CATS
                       and self.t0 <= float(e["ts"]) < self.t1]
        self.host = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                      e["name"]) for e in events
                     if e.get("cat") in HOST_CATS and e["name"] != WINDOW_SPAN
                     and float(e["ts"]) < self.t1
                     and float(e["ts"]) + float(e["dur"]) > self.t0]
        self.shapes = dict(shapes)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def intervals(self) -> list:
        return [(max(e.ts, self.t0), min(e.ts + e.dur, self.t1))
                for e in self.device]

    @property
    def busy_s(self) -> float:
        return union_us(self.intervals()) * 1e-6

    def device_us(self, pred) -> float:
        """Summed device time of the events ``pred`` accepts."""
        return sum(e.dur for e in self.device if pred(e))

    def breakdown(self) -> dict:
        """The device operations that took most time (``op/kernel``: the
        torch op that launched it and the kernel's short name), and the
        longest idle stretches summed by what the host was doing: the
        innermost host op or span that covers a stretch's middle, ``host``
        where none does."""
        ops: dict = {}
        for e in self.device:
            name = f"{e.op}/{e.short}" if e.op else e.short
            ops[name] = ops.get(name, 0.0) + e.dur * 1e-6
        idle: dict = {}
        host = sorted(self.host)
        active: list = []
        i = 0
        for s, e in gaps_us(self.intervals(), self.t0, self.t1):
            mid = (s + e) / 2
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            name = (min(active, key=lambda h: h[1] - h[0])[2] if active
                    else "host")
            idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
        top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]
        return {"device_ops": top(ops), "idle_gaps": top(idle)}


@contextlib.contextmanager
def profiled(enabled: bool, scratch: str, on_card: bool):
    """``torch.profiler`` around the block when ``enabled``; yields a dict
    whose ``events`` holds the trace's events after the block, and
    ``read_s`` the seconds their export and reading took."""
    out: dict = {"events": None}
    if not enabled:
        yield out
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield out
        if on_card:
            torch.cuda.synchronize()
    path = os.path.join(scratch, "trace.json")
    t0 = time.perf_counter()
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            out["events"] = [e for e in json.load(f)["traceEvents"]
                             if e.get("ph") == "X" and "dur" in e]
    finally:
        if os.path.exists(path):
            os.remove(path)
    out["read_s"] = time.perf_counter() - t0


def span(enabled: bool, name: str):
    """A host span the trace shows (``record_function``), or nothing."""
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(name)
