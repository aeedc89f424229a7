"""SLO layer of the serving plane, admission control first: a copy of
``tse1m_tpu/serve/slo.py``.

The daemon's contract is a query p99, and the lever that protects it under
load is refusing work early: ingest is the elastic class, so past the
policy's backlog bound new ingest batches are refused with a retry hint,
before query latency degrades.  Every refusal counts
(``serve_ingest_rejected_total``), and the first of an episode fires a
``serve_backpressure`` degradation event.  Query walls past the p99 target
count as SLO violations.  The environment names are the JAX package's:
``TSE1M_SERVE_MAX_BACKLOG``, ``TSE1M_SERVE_P99_TARGET_MS``,
``TSE1M_LIVE_DELTA_RUNS``.  The lockset detector's seats
(``shared_access``) sit under each lock, with the JAX package's field
names; JAX's ``note_depth`` has no caller and no counterpart here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from ..observability import metrics as obs_metrics
from ..observability import record_degradation
from ..resilience.watchdog import request_budget_s
from ..trace import sync as tsync
from ..trace.hooks import shared_access


@dataclass(frozen=True)
class SloPolicy:
    """Serving-plane targets and admission bounds.

    ``max_backlog_batches`` bounds the ingest queue: past it, submit is
    refused instead of queued.  ``query_p99_target_ms`` is the SLO the
    plane reports against (violations are counted, not enforced per
    request; the per-request guard is the watchdog budget).
    ``live_delta_runs`` bounds the live index's LSM delta runs (None
    leaves ``TSE1M_LIVE_DELTA_RUNS`` and the built-in default alone)."""

    max_backlog_batches: int = 64
    query_p99_target_ms: float = 50.0
    query_budget_s: float = field(
        default_factory=lambda: request_budget_s("query"))
    ingest_budget_s: float = field(
        default_factory=lambda: request_budget_s("ingest"))
    live_delta_runs: int | None = None

    @classmethod
    def from_env(cls) -> "SloPolicy":
        runs = os.environ.get("TSE1M_LIVE_DELTA_RUNS")
        return cls(
            max_backlog_batches=int(
                os.environ.get("TSE1M_SERVE_MAX_BACKLOG", 64)),
            query_p99_target_ms=float(
                os.environ.get("TSE1M_SERVE_P99_TARGET_MS", 50.0)),
            live_delta_runs=int(runs) if runs else None)


class AdmissionController:
    """Ingest admission and queue-depth accounting (thread-safe).

    ``try_admit`` is called with the queue depth before a batch may
    enqueue.  Only the admitted -> refused transition fires a degradation
    event (a sustained overload is one incident); every refusal counts.
    One critical section holds the whole decision, so two admitting
    threads cannot clear the backpressure flag between a refusal's count
    and its transition read."""

    def __init__(self, policy: SloPolicy) -> None:
        self.policy = policy
        self._lock = tsync.Lock("AdmissionController")
        self._rejected = 0
        self._in_backpressure = False
        self._backlog_max = 0

    def try_admit(self, depth: int) -> tuple[bool, float]:
        """(admitted, retry_after_s); ``depth`` counts batches queued
        ahead of this one."""
        with self._lock:
            shared_access(self, "backlog", write=True)
            if depth > self._backlog_max:
                self._backlog_max = depth
            admitted = depth < self.policy.max_backlog_batches
            if admitted:
                self._in_backpressure = False
            else:
                self._rejected += 1
                fresh = not self._in_backpressure
                self._in_backpressure = True
        obs_metrics.gauge("serve_ingest_backlog_max").set_max(depth)
        if admitted:
            return True, 0.0
        obs_metrics.counter("serve_ingest_rejected_total").inc()
        if fresh:
            record_degradation(
                "serve_backpressure", site="serve.ingest",
                detail={"depth": int(depth),
                        "max_backlog": self.policy.max_backlog_batches})
        # About one queued batch's drain time; the client owns the backoff.
        return False, max(0.05, self.policy.ingest_budget_s
                          / max(1, self.policy.max_backlog_batches))

    def stats(self) -> dict:
        with self._lock:
            shared_access(self, "backlog", write=False)
            return {"ingest_rejected": self._rejected,
                    "ingest_backlog_max": self._backlog_max,
                    "in_backpressure": self._in_backpressure}


class SloTracker:
    """Counts query walls past the p99 target; the first violation of a
    run fires a ``serve_slo_violation`` degradation event."""

    def __init__(self, policy: SloPolicy) -> None:
        self.policy = policy
        self._lock = tsync.Lock("SloTracker")
        self._violations = 0

    def observe_query(self, wall_s: float) -> None:
        if wall_s * 1e3 <= self.policy.query_p99_target_ms:
            return
        with self._lock:
            shared_access(self, "violations", write=True)
            self._violations += 1
            first = self._violations == 1
        if first:
            record_degradation(
                "serve_slo_violation", site="serve.query",
                detail={"wall_ms": round(wall_s * 1e3, 3),
                        "target_ms": self.policy.query_p99_target_ms})

    def stats(self) -> dict:
        with self._lock:
            shared_access(self, "violations", write=False)
            return {"query_slo_violations": self._violations,
                    "query_p99_target_ms": self.policy.query_p99_target_ms}


__all__ = ["AdmissionController", "SloPolicy", "SloTracker"]
