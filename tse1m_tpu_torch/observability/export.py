"""Three views of one metrics registry: a copy of
``tse1m_tpu/observability/export.py``.

- :func:`prometheus_text`: the Prometheus text exposition format (the TCP
  ``metrics`` verb).
- :func:`metrics_snapshot`: a JSON-safe dict with full label detail (the
  flight recorder's dumps).
- :func:`flat_metrics`: ``metrics_<name>`` scalars, labels aggregated
  (counters sum, gauges take the max, histograms ``_count`` and
  ``_p99_ms``).
"""

from __future__ import annotations

from .metrics import Counter, Gauge, Histogram, MetricsRegistry, get_registry


def _label_str(labels: dict) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'{k}="{v}"')
    return "{" + ",".join(parts) + "}"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prometheus_text(registry: MetricsRegistry | None = None) -> str:
    reg = registry or get_registry()
    lines: list = []
    typed: set = set()
    for m in reg.collect():
        kind = ("counter" if isinstance(m, Counter)
                else "gauge" if isinstance(m, Gauge) else "histogram")
        if m.name not in typed:
            typed.add(m.name)
            lines.append(f"# TYPE {m.name} {kind}")
        if isinstance(m, Histogram):
            b = m.buckets()
            for bk in b["buckets"]:
                lab = _label_str({**m.labels, "le": bk["le"]})
                lines.append(f"{m.name}_bucket{lab} {bk['count']}")
            inf = _label_str({**m.labels, "le": "+Inf"})
            lines.append(f"{m.name}_bucket{inf} {b['count']}")
            lab = _label_str(m.labels)
            lines.append(f"{m.name}_sum{lab} {_fmt(b['sum'])}")
            lines.append(f"{m.name}_count{lab} {b['count']}")
        else:
            lines.append(f"{m.name}{_label_str(m.labels)} {_fmt(m.value)}")
    return "\n".join(lines) + ("\n" if lines else "")


def metrics_snapshot(registry: MetricsRegistry | None = None) -> dict:
    reg = registry or get_registry()
    out: dict = {"counters": [], "gauges": [], "histograms": []}
    for m in reg.collect():
        if isinstance(m, Counter):
            out["counters"].append(
                {"name": m.name, "labels": m.labels, "value": m.value})
        elif isinstance(m, Gauge):
            out["gauges"].append(
                {"name": m.name, "labels": m.labels, "value": m.value})
        else:
            snap = m.snapshot()
            out["histograms"].append(
                {"name": m.name, "labels": m.labels, **snap,
                 **{k: v for k, v in m.buckets().items()
                    if k in ("buckets", "sum")}})
    return out


def flat_metrics(registry: MetricsRegistry | None = None,
                 prefix: str = "metrics_") -> dict:
    reg = registry or get_registry()
    out: dict = {}
    for m in reg.collect():
        if isinstance(m, Counter):
            key = f"{prefix}{m.name}"
            out[key] = out.get(key, 0) + m.value
        elif isinstance(m, Gauge):
            key = f"{prefix}{m.name}"
            out[key] = max(out.get(key, 0.0), m.value)
        else:
            snap = m.snapshot()
            ck, pk = f"{prefix}{m.name}_count", f"{prefix}{m.name}_p99_ms"
            out[ck] = out.get(ck, 0) + snap["count"]
            out[pk] = max(out.get(pk, 0.0), snap["p99_ms"])
    return out


__all__ = ["flat_metrics", "metrics_snapshot", "prometheus_text"]
