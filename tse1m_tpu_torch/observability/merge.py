"""Manifest aggregation of a multi-process run: one merged
``run_manifest.json``.  A copy of ``tse1m_tpu/observability/merge.py``;
merged manifests equal the JAX package's on the same fragments
(``tests/test_torch_multihost.py``).

Each process's StepRunner writes a per-process FRAGMENT
(``run_manifest.p<NNN>.json``) and process 0 folds every fragment into
the one ``run_manifest.json`` operators read:

- ``degradation_counts`` sums across processes — the one-glance answer
  to "what did the supervision plane absorb, pod-wide";
- ``steps`` concatenates every process's step records, each tagged with
  its ``process`` id (stage timings and per-step degradation events ride
  along inside the records, exactly as single-process);
- ``pod`` records the topology and which fragments were merged vs
  missing — a host that died before writing its fragment shows up as
  ``missing`` rather than silently narrowing the record;
- ``ok`` is the pod-wide conjunction: any failed step on any host, or
  any missing fragment, marks the merged run not-ok;
- ``metrics`` folds the fragments' registry snapshots (counters sum,
  gauges keep the pod-wide max, histogram counts sum with the worst
  p99/max), and ``trace_id`` carries the run's shared trace id when
  every fragment agrees (the negotiated nonce, so they do unless a
  fragment predates the telemetry plane).

Fragments are merged, never deleted: the per-host originals stay next to
the merged manifest for post-mortems.
"""

from __future__ import annotations

import glob
import json
import logging
import os

from ..utils.atomic import atomic_write

log = logging.getLogger("tse1m_tpu_torch.observability.merge")

MERGED_MANIFEST = "run_manifest.json"
_FRAGMENT_FMT = "run_manifest.p{:03d}.json"
_FRAGMENT_GLOB = "run_manifest.p*.json"


def fragment_manifest_path(result_dir: str, process_id: int) -> str:
    """The per-process manifest fragment path for a pod run."""
    return os.path.join(result_dir, _FRAGMENT_FMT.format(int(process_id)))


def _load_fragment(path: str) -> dict | None:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, ValueError) as e:
        log.warning("unreadable manifest fragment %s (%s); recording as "
                    "missing", path, e)
        return None


def _merge_metric_snapshots(snapshots: list) -> dict:
    """Fold per-process registry snapshots (`export.metrics_snapshot`
    shape) into one pod-wide view.  Counters are additive by nature;
    gauges here are levels/high-water marks so the pod-wide max is the
    honest aggregate; histograms cannot be re-bucketed from their
    summaries, so counts/sums add and the worst p99/max is kept."""
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    for snap in snapshots:
        for c in (snap or {}).get("counters", []):
            key = (c["name"], tuple(sorted((c.get("labels") or {}).items())))
            if key not in counters:
                counters[key] = {"name": c["name"],
                                 "labels": dict(c.get("labels") or {}),
                                 "value": 0}
            counters[key]["value"] += int(c.get("value", 0))
        for g in (snap or {}).get("gauges", []):
            key = (g["name"], tuple(sorted((g.get("labels") or {}).items())))
            if key not in gauges:
                gauges[key] = {"name": g["name"],
                               "labels": dict(g.get("labels") or {}),
                               "value": 0.0}
            gauges[key]["value"] = max(gauges[key]["value"],
                                       float(g.get("value", 0.0)))
        for h in (snap or {}).get("histograms", []):
            key = (h["name"], tuple(sorted((h.get("labels") or {}).items())))
            if key not in hists:
                hists[key] = {"name": h["name"],
                              "labels": dict(h.get("labels") or {}),
                              "count": 0, "sum": 0.0, "p99_ms": 0.0,
                              "max_ms": 0.0}
            agg = hists[key]
            agg["count"] += int(h.get("count", 0))
            agg["sum"] = round(agg["sum"] + float(h.get("sum", 0.0)), 6)
            agg["p99_ms"] = max(agg["p99_ms"], float(h.get("p99_ms", 0.0)))
            agg["max_ms"] = max(agg["max_ms"], float(h.get("max_ms", 0.0)))
    return {"counters": [counters[k] for k in sorted(counters)],
            "gauges": [gauges[k] for k in sorted(gauges)],
            "histograms": [hists[k] for k in sorted(hists)]}


def merge_run_manifests(result_dir: str, n_processes: int,
                        out_path: str | None = None) -> dict:
    """Fold every process's manifest fragment into the merged manifest.

    Fragments beyond ``n_processes`` (stale from an earlier, larger pod)
    are ignored; expected-but-absent fragments are recorded under
    ``pod.missing``.  Returns the merged payload (also written atomically
    to ``out_path`` / ``<result_dir>/run_manifest.json``)."""
    out_path = out_path or os.path.join(result_dir, MERGED_MANIFEST)
    fragments: dict[int, dict] = {}
    missing: list[int] = []
    for pid in range(int(n_processes)):
        frag = _load_fragment(fragment_manifest_path(result_dir, pid))
        if frag is None:
            missing.append(pid)
        else:
            fragments[pid] = frag
    counts: dict[str, int] = {}
    steps: list[dict] = []
    summary: dict[str, int] = {}
    epochs: dict[str, int] = {}
    metric_snaps: list = []
    trace_ids: set = set()
    started = None
    wall = 0.0
    for pid in sorted(fragments):
        frag = fragments[pid]
        if frag.get("metrics"):
            metric_snaps.append(frag["metrics"])
        if frag.get("trace_id"):
            trace_ids.add(str(frag["trace_id"]))
        # Each fragment's degradation events are popped destructively
        # into exactly one step record by its own StepRunner, so summing
        # the per-fragment counts here counts every event exactly once —
        # across processes AND across membership epochs (a host that
        # re-admitted in a later epoch writes one fragment, tagged).
        for kind, n in (frag.get("degradation_counts") or {}).items():
            counts[kind] = counts.get(kind, 0) + int(n)
        for status, n in (frag.get("summary") or {}).items():
            summary[status] = summary.get(status, 0) + int(n)
        epoch = frag.get("epoch")
        if epoch is not None:
            epochs[str(pid)] = int(epoch)
        for step in frag.get("steps", []):
            tagged = {**step, "process": pid}
            if epoch is not None:
                tagged["epoch"] = int(epoch)
            steps.append(tagged)
        if frag.get("started_at") is not None:
            started = (frag["started_at"] if started is None
                       else min(started, frag["started_at"]))
        wall = max(wall, float(frag.get("wall_seconds", 0.0)))
    payload = {
        "started_at": started,
        "wall_seconds": wall,
        "ok": (not missing
               and all(f.get("ok", False) for f in fragments.values())),
        "summary": summary,
        "degradation_counts": counts,
        # One shared id means the pod really ran as one trace; multiple
        # ids are preserved verbatim (a diagnostic in themselves).
        "trace_id": (trace_ids.pop() if len(trace_ids) == 1
                     else sorted(trace_ids) or None),
        "metrics": _merge_metric_snapshots(metric_snaps),
        "pod": {
            "n_processes": int(n_processes),
            "merged_from": sorted(fragments),
            "missing": missing,
            # Membership accounting: the epoch each fragment ran under
            # (a re-admitted host appears at its later epoch) and the
            # pod-wide latest epoch.
            "epochs": epochs,
            "epoch": (max(epochs.values()) if epochs else None),
        },
        "steps": steps,
    }
    os.makedirs(result_dir or ".", exist_ok=True)
    with atomic_write(out_path) as f:
        json.dump(payload, f, indent=2, default=str)
    if missing:
        log.warning("pod manifest merged with %d missing fragment(s): %s "
                    "(hosts that died before recording)", len(missing),
                    missing)
    return payload


def sweep_stale_fragments(result_dir: str) -> int:
    """Remove fragments from a PREVIOUS pod run so a smaller re-run's
    merge cannot pick up a dead topology's records; returns count."""
    n = 0
    for p in glob.glob(os.path.join(result_dir, _FRAGMENT_GLOB)):
        try:
            os.remove(p)
            n += 1
        except OSError:
            pass
    return n


__all__ = ["MERGED_MANIFEST", "fragment_manifest_path",
           "merge_run_manifests", "sweep_stale_fragments"]
