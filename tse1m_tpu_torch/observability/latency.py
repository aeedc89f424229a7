"""Request-latency histograms of the serving plane: a copy of
``tse1m_tpu/observability/latency.py``.

A fixed log-bucketed histogram (20 buckets a decade over 1 µs .. 1000 s,
the JAX package's edges, so the same walls give the same ``p50_ms`` and
``p99_ms``): p50/p99 cost O(buckets) to read, memory is constant under
load, and ``add`` is one increment under a lock.  Time is read through
``resilience.watchdog.deadline_clock``.  Percentiles interpolate within
the matched bucket's log-spaced bounds (error bounded by the ~12% bucket
ratio).  The lockset detector's seats (``shared_access(self,
"buckets")``) sit under the lock, as in the JAX package; JAX's
``reset_window`` (a bench-only call) and its seat have no counterpart.
"""

from __future__ import annotations

import math

from ..resilience.watchdog import deadline_clock
from ..trace import sync as tsync
from ..trace.hooks import shared_access

_BUCKETS_PER_DECADE = 20
_N_BUCKETS = 9 * _BUCKETS_PER_DECADE  # 1e-6 s .. 1e3 s
_LOG_MIN = -6.0  # log10 of the first bucket bound (1 µs)


def _bucket_of(seconds: float) -> int:
    if seconds <= 1e-6:
        return 0
    b = int((math.log10(seconds) - _LOG_MIN) * _BUCKETS_PER_DECADE)
    return min(max(b, 0), _N_BUCKETS - 1)


def _bucket_upper_s(b: int) -> float:
    return 10.0 ** (_LOG_MIN + (b + 1) / _BUCKETS_PER_DECADE)


def _bucket_lower_s(b: int) -> float:
    return 10.0 ** (_LOG_MIN + b / _BUCKETS_PER_DECADE)


class LatencyRecorder:
    """Thread-safe per-request-class latency histogram (query, topk,
    ingest); the daemon publishes ``summary()`` and ``snapshot()`` in its
    status."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = tsync.Lock(f"LatencyRecorder.{name}")
        self._counts = [0] * _N_BUCKETS
        self._n = 0
        self._total_s = 0.0
        self._max_s = 0.0
        self._t0 = deadline_clock()

    def add(self, seconds: float) -> None:
        b = _bucket_of(seconds)
        with self._lock:
            shared_access(self, "buckets", write=True)
            self._counts[b] += 1
            self._n += 1
            self._total_s += seconds
            if seconds > self._max_s:
                self._max_s = seconds

    def time(self):
        """Context manager timing one request into the histogram."""
        return _Timed(self)

    def _percentile_locked(self, q: float) -> float:
        """q in [0, 1] -> seconds, log-interpolated inside the bucket."""
        if self._n == 0:
            return 0.0
        target = q * self._n
        seen = 0
        for b, c in enumerate(self._counts):
            if c == 0:
                continue
            if seen + c >= target:
                frac = (target - seen) / c
                lo, hi = _bucket_lower_s(b), _bucket_upper_s(b)
                return lo * (hi / lo) ** frac
            seen += c
        return self._max_s

    def snapshot(self) -> dict:
        with self._lock:
            shared_access(self, "buckets", write=False)
            if self._n == 0:
                return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0,
                        "max_ms": 0.0, "mean_ms": 0.0, "qps": 0.0}
            elapsed = max(deadline_clock() - self._t0, 1e-9)
            return {
                "count": self._n,
                "p50_ms": round(self._percentile_locked(0.50) * 1e3, 3),
                "p99_ms": round(self._percentile_locked(0.99) * 1e3, 3),
                "max_ms": round(self._max_s * 1e3, 3),
                "mean_ms": round(self._total_s / self._n * 1e3, 3),
                "qps": round(self._n / elapsed, 1),
            }

    def summary(self) -> dict:
        """snapshot() keyed for flat JSON: ``<name>_p99_ms`` etc."""
        return {f"{self.name}_{k}": v for k, v in self.snapshot().items()}

    def buckets(self) -> dict:
        """Cumulative occupied buckets for the Prometheus text format, each
        ``{"le": upper_bound_s, "count": cumulative}``, plus ``sum`` and
        ``count``."""
        with self._lock:
            shared_access(self, "buckets", write=False)
            out = []
            cum = 0
            for b, c in enumerate(self._counts):
                if c == 0:
                    continue
                cum += c
                out.append({"le": round(_bucket_upper_s(b), 9),
                            "count": cum})
            return {"buckets": out, "sum": round(self._total_s, 6),
                    "count": self._n}


class _Timed:
    __slots__ = ("_rec", "_t0")

    def __init__(self, rec: LatencyRecorder) -> None:
        self._rec = rec

    def __enter__(self) -> "_Timed":
        self._t0 = deadline_clock()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self._rec.add(deadline_clock() - self._t0)


__all__ = ["LatencyRecorder"]
