"""Slow-request log and the ``profile`` verb's answer: a copy of
``tse1m_tpu/observability/profiling.py:81-105, 397-518, 570-634``.

When a query or ingest blows its SLO budget, :func:`capture_slow_request`
freezes the evidence (open-span chain, completed spans of the same trace,
the daemon's in-flight absorb state) into a bounded ring, read by the TCP
``slowlog`` verb.  :func:`dump_profile` writes ``profile_NNN.json`` next
to the flight files; :func:`profile_status` is the ``profile`` verb's
answer.  Both keep the JAX package's keys.

Left out, each for the path that will call it (ROADMAP.md Queue 1): the
stack sampler (``TSE1M_PROF_HZ``), which only ``cluster --profile``
starts, so the serve plane's answers carry no sampler (``None``, no
stacks), as the JAX package's do in a daemon; the lock-wait recorder (it
times the JAX package's traced locks, which are not ported), so
:func:`lock_wait_summary` lists only ``lock_wait_seconds{site=...}``
histograms something else recorded, an empty list in the port; and the
XLA compile listener and ``jax.profiler`` device trace ("Device tooling":
``torch.profiler``).  The kill switch ``TSE1M_PROFILING`` is kept for
the ``profile`` verb's ``profiling_enabled``.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import threading

from ..resilience.watchdog import deadline_clock
from ..utils.atomic import atomic_write
from . import tracing
from .flight import get_flight_dir
from .metrics import counter, get_registry

log = logging.getLogger("tse1m_tpu_torch.profiling")

_DEFAULT_SLOWLOG = 64
_PROFILE_FMT = "profile_{:03d}.json"


_override: bool | None = None


def profiling_enabled() -> bool:
    """``TSE1M_PROFILING=0`` wins unless :func:`set_profiling` overrode
    it."""
    if _override is not None:
        return _override
    return os.environ.get("TSE1M_PROFILING", "1") != "0"


def set_profiling(on: bool | None) -> None:
    """Runtime override of the kill switch (``None`` restores the env
    var's verdict)."""
    global _override
    _override = None if on is None else bool(on)


def lock_wait_summary(top: int | None = None) -> list:
    """Per-site wait stats from the registry's ``lock_wait_seconds``
    histograms, worst p99 first: ``{site, count, p99_ms, max_ms}``."""
    out = []
    for m in get_registry().collect():
        if m.name != "lock_wait_seconds" or not hasattr(m, "snapshot"):
            continue
        snap = m.snapshot()
        if not snap.get("count"):
            continue
        out.append({"site": m.labels.get("site", "?"),
                    "count": snap["count"],
                    "p99_ms": snap["p99_ms"],
                    "max_ms": snap["max_ms"]})
    out.sort(key=lambda r: (-r["p99_ms"], r["site"]))
    if top is not None:
        out = out[:int(top)]
    return out


class SlowRequestLog:
    """Bounded ring of SLO-violation captures (thread-safe, overwrite
    oldest), JSON-safe records."""

    def __init__(self, capacity: int | None = None) -> None:
        if capacity is None:
            capacity = int(os.environ.get("TSE1M_SLOWLOG_CAP",
                                          _DEFAULT_SLOWLOG))
        self.capacity = max(1, int(capacity))
        self._lock = threading.Lock()
        self._buf: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._total = 0

    def append(self, record: dict) -> None:
        with self._lock:
            self._buf.append(record)
            self._total += 1

    def recent(self, n: int | None = None) -> list:
        with self._lock:
            out = list(self._buf)
        if n is not None:
            out = out[-int(n):]
        return out

    def total(self) -> int:
        with self._lock:
            return self._total

    def clear(self) -> None:
        with self._lock:
            self._buf.clear()
            self._total = 0


_slowlog = SlowRequestLog()


def recent_slow_requests(n: int | None = None) -> list:
    return _slowlog.recent(n)


def slow_requests_total() -> int:
    return _slowlog.total()


def capture_slow_request(kind: str, wall_s: float, budget_ms: float,
                         absorb: dict | None = None, **tags) -> dict:
    """Freeze the evidence for one budget-blowing request.  Call from the
    request's own thread right after it finishes.  ``lock_waits_ms`` and
    ``stacks`` stay in the record for the JAX package's shape and are
    empty (no lock-wait recorder, no sampler in the port)."""
    now = deadline_clock()
    trace = tracing.current_trace()
    record = {
        "kind": str(kind),
        "wall_ms": round(wall_s * 1e3, 3),
        "budget_ms": round(float(budget_ms), 3),
        "at_s": round(now, 3),
        "trace": trace,
        "span_chain": tracing.thread_span_chain(),
        "lock_waits_ms": [],
        "absorb": dict(absorb) if absorb else None,
        "stacks": [],
    }
    if trace:
        record["trace_spans"] = [
            s for s in tracing.recent_spans(64)
            if s and s.get("trace") == trace["t"]][-8:]
    if tags:
        record["tags"] = {str(k): v for k, v in tags.items()}
    _slowlog.append(record)
    counter("slow_requests_total", kind=str(kind)).inc()
    return record


def _next_profile_path(d: str) -> str:
    n = 0
    for name in os.listdir(d):
        if name.startswith("profile_") and name.endswith(".json"):
            try:
                n = max(n, int(name[len("profile_"):-len(".json")]) + 1)
            except ValueError:
                continue
    return os.path.join(d, _PROFILE_FMT.format(n))


def dump_profile(extra: dict | None = None,
                 d: str | None = None) -> str | None:
    """Write ``profile_NNN.json`` (atomic, numbered like the flight files)
    into ``d`` or the flight directory; returns the path, or None when no
    directory is configured."""
    if d is None:
        d = get_flight_dir()
    if not d:
        return None
    payload = {
        "pid": os.getpid(),
        "uptime_s": round(deadline_clock(), 3),
        "trace_id": tracing.pinned_trace(),
        "profiling_enabled": profiling_enabled(),
        "sampler": None,
        "collapsed_stacks": [],
        "lock_wait_sites": lock_wait_summary(),
        "slow_requests": _slowlog.recent(32),
        "slow_requests_total": _slowlog.total(),
    }
    if extra:
        payload["extra"] = dict(extra)
    os.makedirs(d, exist_ok=True)
    path = _next_profile_path(d)
    with atomic_write(path) as f:
        json.dump(payload, f, indent=2, default=str)
    log.info("profile dumped to %s", path)
    return path


def profile_status() -> dict:
    """The ``profile`` verb's answer: kill-switch state, the (absent)
    sampler, worst lock sites, slow-request tally."""
    return {
        "profiling_enabled": profiling_enabled(),
        "sampler_alive": False,
        "sampler": None,
        "lock_wait_top": lock_wait_summary(top=3),
        "slow_requests_total": _slowlog.total(),
    }


__all__ = ["SlowRequestLog", "capture_slow_request", "dump_profile",
           "lock_wait_summary", "profile_status", "profiling_enabled",
           "recent_slow_requests", "set_profiling", "slow_requests_total"]
