"""The serving plane's telemetry: a copy of ``tse1m_tpu/observability``'s
degradation events (``record_degradation``) and of the modules the daemon
reports through: latency histograms (``latency``), the metrics registry
(``metrics``) and its export (``export``), spans (``tracing``), the flight
recorder (``flight``) and the profiler and slow-request log
(``profiling``).  The pipeline's per-stage ``StageRecorder`` stays in
``cluster/observability.py``; the JAX package's manifest merge and bench
regression modules are not ported.

Degradation events: every time the system survives a failure by
degrading (a halved chunk, a quant drop, a stall or device retry, a
quarantined store shard, admission refusing a batch, an SLO violation, a
replayed ingest, an evicted hub signature), one event lands here, and in
the ``degradations_total{kind=...}`` counter.  ``seq`` orders them within
a process.  The step runner (``utils/runner.py``) pops each step's events
into ``run_manifest.json``.
"""

from __future__ import annotations

from ..trace import sync as tsync

_degradations: list = []
_degradation_lock = tsync.Lock("observability._degradation_lock")
_degradation_seq = 0


def record_degradation(kind: str, site: str = "",
                       detail: dict | None = None) -> dict:
    """Append one degradation event; returns the event dict."""
    global _degradation_seq
    with _degradation_lock:
        _degradation_seq += 1
        event = {"seq": _degradation_seq, "kind": kind, "site": site,
                 "detail": dict(detail or {})}
        _degradations.append(event)
    from . import metrics

    metrics.counter("degradations_total", kind=kind).inc()
    return event


def peek_degradation_events() -> list:
    with _degradation_lock:
        return [dict(e) for e in _degradations]


def pop_degradation_events() -> list:
    """Take (and clear) the accumulated degradation events."""
    with _degradation_lock:
        out = list(_degradations)
        _degradations.clear()
    return out


def degradation_counts(events: list) -> dict:
    """kind -> count summary."""
    by: dict[str, int] = {}
    for e in events:
        by[e["kind"]] = by.get(e["kind"], 0) + 1
    return by


from .export import flat_metrics, metrics_snapshot, prometheus_text  # noqa: E402
from .flight import dump_flight, get_flight_dir, set_flight_dir  # noqa: E402
from .latency import LatencyRecorder  # noqa: E402
from .metrics import (MetricsRegistry, counter, gauge,  # noqa: E402
                      get_registry, histogram, reset_metrics)
from .tracing import (adopt_trace, continue_trace,  # noqa: E402
                      current_trace, pinned_trace, recent_spans,
                      set_tracing, span, spans_recorded)

__all__ = ["LatencyRecorder", "MetricsRegistry", "adopt_trace",
           "continue_trace", "counter", "current_trace",
           "degradation_counts", "dump_flight", "flat_metrics", "gauge",
           "get_flight_dir", "get_registry", "histogram",
           "metrics_snapshot", "peek_degradation_events", "pinned_trace",
           "pop_degradation_events",
           "prometheus_text", "recent_spans", "record_degradation",
           "reset_metrics", "set_flight_dir", "set_tracing", "span",
           "spans_recorded"]
