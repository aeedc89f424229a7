"""Crash-time flight recorder: a copy of
``tse1m_tpu/observability/flight.py``.

Crash paths call :func:`dump_flight`: the last spans, a metrics snapshot
and the recent degradation events land atomically in ``flight_NNN.json``
in the flight directory (the serving daemon sets it to its store
directory) before the process dies.  The dump prepends a terminal span
``flight.<reason>`` tagged with the firing site.  With no directory
configured it is a no-op, and a failing dump is logged, never raised: a
recorder failure must not mask the crash it records.  Triggers: the
serve command's SIGTERM/SIGINT handler, the ingest thread's exit on an
interrupt, and a watchdog's terminal deadline breach.
"""

from __future__ import annotations

import json
import logging
import os
import time

from ..resilience.faults import reraise_if_fault
from ..resilience.watchdog import deadline_clock
from ..utils.atomic import atomic_write
from . import tracing
from .export import metrics_snapshot

log = logging.getLogger("tse1m_tpu_torch.flight")

_FLIGHT_FMT = "flight_{:03d}.json"
_SPAN_WINDOW = 256

_flight_dir: str | None = None


def set_flight_dir(path: str | None) -> None:
    """Point the recorder at a directory; ``TSE1M_FLIGHT_DIR`` seeds it
    across process spawns, an explicit call wins."""
    global _flight_dir
    _flight_dir = str(path) if path else None


def get_flight_dir() -> str | None:
    if _flight_dir is not None:
        return _flight_dir
    return os.environ.get("TSE1M_FLIGHT_DIR") or None


def _next_path(d: str) -> str:
    n = 0
    for name in os.listdir(d):
        if name.startswith("flight_") and name.endswith(".json"):
            try:
                n = max(n, int(name[len("flight_"):-len(".json")]) + 1)
            except ValueError:
                continue
    return os.path.join(d, _FLIGHT_FMT.format(n))


def dump_flight(reason: str, site: str | None = None,
                extra: dict | None = None) -> str | None:
    """Write one flight file; returns its path, or None when no directory
    is configured or the dump itself failed."""
    d = get_flight_dir()
    if not d:
        return None
    try:
        with tracing.span(f"flight.{reason}", site=site or ""):
            pass
        payload = {
            "reason": str(reason),
            "site": site,
            "pid": os.getpid(),
            "written_at": time.time(),
            "uptime_s": round(deadline_clock(), 3),
            "trace_id": tracing.pinned_trace(),
            "spans": tracing.recent_spans(_SPAN_WINDOW),
            "metrics": metrics_snapshot(),
            "degradation_events": _recent_degradations(),
        }
        if extra:
            payload["extra"] = dict(extra)
        os.makedirs(d, exist_ok=True)
        path = _next_path(d)
        with atomic_write(path) as f:
            json.dump(payload, f, indent=2, default=str)
        log.warning("flight recorder: %s dumped to %s", reason, path)
        return path
    except Exception as e:  # a dump must not mask the crash, nor a fault
        reraise_if_fault(e)
        log.error("flight recorder: dump for %s failed (%s: %s)", reason,
                  type(e).__name__, e)
        return None


def _recent_degradations() -> list:
    from . import peek_degradation_events

    return peek_degradation_events()


__all__ = ["dump_flight", "get_flight_dir", "set_flight_dir"]
