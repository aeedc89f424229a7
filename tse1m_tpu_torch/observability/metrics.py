"""Typed metrics registry: a copy of ``tse1m_tpu/observability/metrics.py``.

Three Prometheus-shaped types, get-or-create keyed by ``(name, sorted
labels)``: :class:`Counter` (``degradations_total{kind=...}``,
``serve_ingest_rejected_total``, ``slow_requests_total{kind=...}``),
:class:`Gauge` (``serve_queue_depth``, ``serve_ingest_backlog_max``,
``serve_store_generation``, ``serve_store_rows``) and :class:`Histogram`
(on the :class:`~.latency.LatencyRecorder` core).  ``export.py`` renders
the registry.  Every type is thread-safe.
"""

from __future__ import annotations

from ..trace import sync as tsync
from ..trace.hooks import shared_access
from .latency import LatencyRecorder


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class Counter:
    """Monotonic event counter."""

    def __init__(self, name: str, labels: dict) -> None:
        self.name = name
        self.labels = dict(labels)
        self._lock = tsync.Lock(f"Counter.{name}")
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            shared_access(self, "value", write=True)
            self._value += int(n)

    @property
    def value(self) -> int:
        with self._lock:
            shared_access(self, "value", write=False)
            return self._value


class Gauge:
    """Settable level; ``set_max`` keeps the high-water mark."""

    def __init__(self, name: str, labels: dict) -> None:
        self.name = name
        self.labels = dict(labels)
        self._lock = tsync.Lock(f"Gauge.{name}")
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            shared_access(self, "value", write=True)
            self._value = float(v)

    def set_max(self, v: float) -> None:
        with self._lock:
            shared_access(self, "value", write=True)
            if float(v) > self._value:
                self._value = float(v)

    @property
    def value(self) -> float:
        with self._lock:
            shared_access(self, "value", write=False)
            return self._value


class Histogram:
    """Distribution on the log-bucketed LatencyRecorder core (seconds)."""

    def __init__(self, name: str, labels: dict) -> None:
        self.name = name
        self.labels = dict(labels)
        self._rec = LatencyRecorder(name)

    def observe(self, value_s: float) -> None:
        self._rec.add(float(value_s))

    def snapshot(self) -> dict:
        return self._rec.snapshot()

    def buckets(self) -> dict:
        return self._rec.buckets()


class MetricsRegistry:
    """Get-or-create registry over the three metric types; one
    process-wide instance backs the module-level helpers."""

    def __init__(self) -> None:
        self._lock = tsync.Lock("MetricsRegistry")
        self._metrics: dict = {}

    def _get(self, kind, name: str, labels: dict):
        key = (name, _label_key(labels))
        with self._lock:
            shared_access(self, "metrics", write=True)
            m = self._metrics.get(key)
            if m is None:
                m = kind(name, labels)
                self._metrics[key] = m
            elif not isinstance(m, kind):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, not {kind.__name__}")
            return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(Histogram, name, labels)

    def collect(self) -> list:
        """All registered metrics, sorted by (name, labels)."""
        with self._lock:
            shared_access(self, "metrics", write=False)
            items = sorted(self._metrics.items())
        return [m for _, m in items]

    def clear(self) -> None:
        with self._lock:
            shared_access(self, "metrics", write=True)
            self._metrics = {}


_registry = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _registry


def counter(name: str, **labels) -> Counter:
    return _registry.counter(name, **labels)


def gauge(name: str, **labels) -> Gauge:
    return _registry.gauge(name, **labels)


def histogram(name: str, **labels) -> Histogram:
    return _registry.histogram(name, **labels)


def reset_metrics() -> None:
    """Drop every registered metric."""
    _registry.clear()


__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "counter",
           "gauge", "get_registry", "histogram", "reset_metrics"]
