"""Bench-JSON schema + noise-aware perf-regression harness (graftprof): a
port of ``tse1m_tpu/observability/regress.py``, its ``BENCH_SCHEMA``
copied as data.

The repo has accumulated nine committed ``BENCH_r*.json`` rounds and
three *separately maintained* copies of "which keys must a bench JSON
carry" — the bench-smoke heredoc, the serve-smoke heredoc, and
``tests/ci_fault_matrix.py``'s ``BENCH_KEYS``.  Three-way drift is a
matter of time, and none of the copies can answer the question the
trajectory exists for: *did this round regress?*

This module is the single source of truth for both:

- :data:`BENCH_SCHEMA` — one machine-readable entry per contract key:
  which CI contexts require it (``bench`` / ``degradation`` / ``fault``
  / ``serve``), which direction is better, and — for gated keys — the
  noise tolerance the perf gate allows before it goes red.  The CI
  smokes and the fault matrix import :func:`required_keys` /
  :func:`assert_bench_keys`; a missing key fails with the offending
  key named.
- the regression harness: :func:`diff` renders a human-readable delta
  report across any two rounds, and :func:`gate` checks a fresh run
  against a committed baseline with noise-aware bands —
  ``median(history) * (1 +/- tolerance) +/- 3*MAD +/- abs_slack`` per
  key, direction-aware.  MAD (median absolute deviation) makes the
  band robust to one outlier round; the relative tolerance absorbs
  machine-class skew; the absolute slack keeps near-zero baselines
  (an 0.05 s stage) from turning timer jitter into a red build.

Edge-case contract (tests/test_regress.py, held on this port by
tests/test_torch_regress.py): a gated key missing from
the *current* run fails (the contract shrank); missing from the
*baseline* only warns (the contract grew — re-baseline); zero or NaN
baselines degrade to the absolute band or a skip, never a crash; a
single-run baseline gates on tolerance alone (MAD needs history).

Lives in the ``watchdog-clock`` lint plane: no wall-clock reads, and
the only write (``baseline`` assembly) goes through ``atomic_write``.
"""

from __future__ import annotations

import json
import math
import statistics

from ..utils.atomic import atomic_write

# -- the schema ---------------------------------------------------------------
#
# One entry per contract key.  Fields:
#   contexts  - CI contexts that require the key's *presence*
#               ("bench" = bench-smoke, "degradation" = the clean-run
#               degradation-key step, "fault" = the fault-matrix
#               driver, "serve" = serve-smoke)
#   dir       - "lower" / "higher" when the key is a quality/perf
#               number with a better direction; None for identity
#               keys (encodings, flags, ids)
#   gate      - the perf gate checks this key against the baseline
#   tol       - relative tolerance band for gated keys
#   abs       - absolute slack added to the band (same unit as key)
#   desc      - one line for reports

def _k(contexts=(), direction=None, gate=False, tol=0.0, abs_slack=0.0,
       desc=""):
    return {"contexts": tuple(contexts), "dir": direction, "gate": gate,
            "tol": float(tol), "abs": float(abs_slack), "desc": desc}


BENCH_SCHEMA: dict = {
    # headline
    "value": _k(("bench",), "lower", gate=True, tol=0.75, abs_slack=0.5,
                desc="headline wall seconds (best of runs_s)"),
    "stage_total_wall_s": _k((), "lower", gate=True, tol=0.75,
                             abs_slack=0.5,
                             desc="stage-recorder total wall"),
    "ari_vs_planted": _k(("bench",), "higher", gate=True, tol=0.02,
                         abs_slack=0.005,
                         desc="label quality vs planted clusters"),
    # stage walls
    "stage_compute_s": _k(("bench",), "lower", gate=True, tol=0.75,
                          abs_slack=0.5, desc="device compute wall"),
    "stage_encode_s": _k(("bench",), "lower", gate=True, tol=0.75,
                         abs_slack=0.5, desc="host wire-encode wall"),
    "stage_h2d_s": _k(("bench",), "lower", gate=True, tol=1.0,
                      abs_slack=0.5, desc="host-to-device copy wall"),
    "stage_entropy_s": _k(("bench", "fault"), "lower", gate=True, tol=1.0,
                          abs_slack=0.5, desc="rANS entropy-lane wall"),
    "stage_prefilter_s": _k(("bench",), "lower", gate=True, tol=1.0,
                            abs_slack=0.5, desc="host prefilter wall"),
    "h2d_overlap_fraction": _k(("bench",), "higher",
                               desc="H2D/compute overlap"),
    # wire accounting
    "cluster_wire_mb": _k(("bench",), "lower", gate=True, tol=0.02,
                          abs_slack=0.5, desc="bytes shipped to device"),
    "cluster_encoding": _k(("bench",), desc="wire encoding in use"),
    "transfer_mb": _k(("bench",), "lower", desc="transfer-probe MB"),
    "transfer_chunk_bits": _k(("bench",), desc="probe chunk widths"),
    "wire_drift_bytes": _k(("bench",), "lower",
                           desc="probe-vs-stage byte drift (must be 0)"),
    "wire_v3_saved_mb": _k(("bench", "fault"), "higher",
                           desc="entropy+prefilter lever savings"),
    "prefilter_hit_rate": _k(("bench", "fault"), "higher",
                             desc="prefilter rows dropped fraction"),
    "prefilter_recall": _k(("bench", "fault"), "higher", gate=True,
                           tol=0.0, abs_slack=0.001,
                           desc="prefilter recall (must stay 1.0)"),
    # warm store / cache
    "cluster_warm_wall_s": _k(("bench",), "lower",
                              desc="warm re-cluster wall"),
    "cache_hit_rate": _k(("bench",), "higher",
                         desc="signature-store hit rate"),
    "cache_wire_saved_mb": _k(("bench",), "higher",
                              desc="wire skipped via store"),
    # degradation / scrub plane (present, zero, on clean runs)
    "degradation_events": _k(("degradation", "fault"), "lower",
                             desc="degradation ladder events"),
    "degradation_counts": _k(("degradation", "fault"),
                             desc="per-kind degradation tally"),
    "chunk_halvings": _k(("degradation", "fault"), "lower",
                         desc="OOM-ladder chunk halvings"),
    "store_scrub_shards": _k(("degradation", "fault"),
                             desc="store shards scrubbed"),
    "store_scrub_corrupt": _k(("degradation", "fault"), "lower",
                              desc="corrupt shards found"),
    "store_scrub_quarantined": _k(("fault",), "lower",
                                  desc="shards quarantined"),
    "store_scrub_state_ok": _k(("degradation", "fault"),
                               desc="store state file verdict"),
    # runtime sanitizer
    "sanitizer_transfer_guard": _k((), desc="transfer guard was on"),
    "sanitizer_compile_count": _k((), "lower",
                                  desc="compiles in timed window"),
    # telemetry plane
    "trace_id": _k(("fault", "serve"), desc="pinned round trace id"),
    "trace_spans_recorded": _k(("fault", "serve"), "higher",
                               desc="spans recorded this round"),
    "metrics_stage_seconds_count": _k(("fault",), "higher",
                                      desc="flat registry export proof"),
    # serving plane
    "serve_p50_ms": _k(("serve",), "lower", desc="daemon query p50"),
    "serve_p99_ms": _k(("serve",), "lower", gate=True, tol=1.0,
                       abs_slack=1.0, desc="daemon query p99"),
    "serve_qps": _k(("serve",), "higher", desc="sustained query rate"),
    "serve_client_p50_ms": _k(("serve",), "lower",
                              desc="TCP round-trip p50"),
    "serve_client_p99_ms": _k(("serve",), "lower",
                              desc="TCP round-trip p99"),
    "serve_query_count": _k(("serve",), "higher",
                            desc="queries served in window"),
    "serve_rows": _k(("serve",), desc="rows ingested"),
    "serve_generation": _k(("serve",), desc="final store generation"),
    "ingest_backlog_max": _k(("serve",), "lower",
                             desc="ingest backlog high-water"),
    "serve_ingest_rejected": _k(("serve",), "lower",
                                desc="admission rejections"),
    "serve_slo_violations": _k(("serve",), "lower",
                               desc="queries past SLO target"),
    "serve_parity": _k(("serve",), desc="post-quiesce parity gate"),
    "serve_ingest_rows_s": _k(("serve",), "higher",
                              desc="sustained ingest rate"),
    "serve_untraced_p99_ms": _k(("serve",), "lower",
                                desc="probe p99, tracing off"),
    "serve_traced_p99_ms": _k(("serve",), "lower",
                              desc="probe p99, tracing on"),
    # graftprof (this PR)
    "serve_unprofiled_p99_ms": _k(("serve",), "lower",
                                  desc="probe p99, profiler off"),
    "serve_profiled_p99_ms": _k(("serve",), "lower",
                                desc="probe p99, sampler+lock-wait on"),
    "serve_lock_wait_sites": _k(("serve",),
                                desc="per-site lock-wait p99 table"),
    "serve_slow_requests": _k(("serve",), "lower",
                              desc="slow-request captures in round"),
    # sharded serve plane (this PR)
    "serve_shards": _k(("serve",), desc="shard daemons behind the router"),
    "serve_router_p99_ms": _k(("serve",), "lower", gate=True, tol=1.0,
                              abs_slack=1.0,
                              desc="router fan-out query p99"),
    "serve_replica_qps": _k(("serve",), "higher",
                            desc="read-replica sustained query rate"),
    "serve_failover_lost_acks": _k(("serve",), "lower", gate=True,
                                   tol=0.0, abs_slack=0.0,
                                   desc="acked rows lost across a shard "
                                        "writer failover (must be 0)"),
    # batched scoring plane (this PR)
    "bulk_score_rows_s": _k(("serve",), "higher", gate=True, tol=0.75,
                            desc="store row-visits/s in the sanitized "
                                 "bulk top-k scan"),
    "topk_p99_ms": _k(("serve",), "lower", gate=True, tol=1.0,
                      abs_slack=1.0,
                      desc="candidate-path topk verb p99"),
    "topk_recall": _k(("serve",), "higher", gate=True, tol=0.0,
                      abs_slack=0.0,
                      desc="scan top-k vs the exact host oracle "
                           "(must stay 1.0)"),
    "topk_parity": _k(("serve",),
                      desc="device/host rank parity sweep over "
                           "schemes x quant bits"),
}


def required_keys(context: str) -> tuple:
    """Keys whose presence the given CI context asserts."""
    return tuple(k for k, spec in BENCH_SCHEMA.items()
                 if context in spec["contexts"])


def assert_bench_keys(result: dict, context: str) -> None:
    """The one key-contract assert all CI smokes share: fails naming
    the first offending key and the schema context that requires it."""
    for key in required_keys(context):
        assert key in result, (
            f"bench JSON lost key {key!r} "
            f"(required by schema context {context!r} — see "
            f"tse1m_tpu_torch/observability/regress.py)")


def gated_keys() -> tuple:
    return tuple(k for k, spec in BENCH_SCHEMA.items() if spec["gate"])


# -- shared number plumbing ---------------------------------------------------

def _num(v):
    """The value as a finite float, else None (bools are flags, not
    measurements)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    f = float(v)
    return f if math.isfinite(f) else None


def load_runs(path: str) -> list:
    """A baseline file is either one bench result or
    ``{"runs": [...]}`` (median-of-k history)."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and isinstance(data.get("runs"), list):
        runs = [r for r in data["runs"] if isinstance(r, dict)]
    elif isinstance(data, dict):
        runs = [data]
    else:
        raise ValueError(f"{path}: expected a bench result object or "
                         "{'runs': [...]}")
    if not runs:
        raise ValueError(f"{path}: no runs")
    return runs


def write_baseline(out_path: str, runs: list, note: str = "") -> None:
    """Assemble ``{"runs": [...]}`` atomically (re-baselining is a
    reviewed commit, not a side effect of a green build)."""
    payload = {"note": note, "runs": runs}
    with atomic_write(out_path) as f:
        json.dump(payload, f, indent=2, sort_keys=True)


# -- the gate -----------------------------------------------------------------

def gate(current: dict, baseline_runs: list, keys=None) -> dict:
    """Check one fresh run against the baseline history.

    Returns ``{"ok": bool, "rows": [...]}``; each row carries the key,
    the current value, the baseline median/MAD/n, the computed bound
    and a verdict — ``format_gate_report`` renders it, the CI job acts
    on ``ok``."""
    rows = []
    ok = True
    for key in (keys if keys is not None else gated_keys()):
        spec = BENCH_SCHEMA.get(key) or _k(gate=True)
        hist = [_num(r.get(key)) for r in baseline_runs]
        hist = [v for v in hist if v is not None]
        cur = _num(current.get(key))
        if not hist:
            rows.append({"key": key, "current": cur, "ok": True,
                         "note": "no baseline history — re-baseline to "
                                 "start gating this key"})
            continue
        med = statistics.median(hist)
        mad = (statistics.median(abs(v - med) for v in hist)
               if len(hist) > 1 else 0.0)
        if key not in current:
            rows.append({"key": key, "current": None, "median": med,
                         "ok": False,
                         "note": "gated key missing from current run — "
                                 "the bench contract shrank"})
            ok = False
            continue
        if cur is None:
            rows.append({"key": key, "current": current.get(key),
                         "median": med, "ok": True,
                         "note": "non-finite current value — skipped"})
            continue
        direction = spec["dir"] or "lower"
        band = abs(med) * spec["tol"] + 3.0 * mad + spec["abs"]
        if direction == "lower":
            bound = med + band
            key_ok = cur <= bound
        else:
            bound = med - band
            key_ok = cur >= bound
        row = {"key": key, "current": cur, "median": round(med, 4),
               "mad": round(mad, 4), "n": len(hist),
               "bound": round(bound, 4), "dir": direction, "ok": key_ok}
        if len(hist) == 1:
            row["note"] = "single-run baseline (no MAD term)"
        rows.append(row)
        ok = ok and key_ok
    return {"ok": ok, "rows": rows}


def format_gate_report(report: dict) -> str:
    lines = ["perf gate: " + ("PASS" if report["ok"] else "FAIL")]
    for row in report["rows"]:
        mark = "ok " if row["ok"] else "REG"
        if "bound" in row:
            arrow = "<=" if row["dir"] == "lower" else ">="
            lines.append(
                f"  [{mark}] {row['key']:<28} {row['current']:>12.4f} "
                f"{arrow} {row['bound']:>12.4f}  "
                f"(median {row['median']} of {row['n']}, "
                f"MAD {row['mad']})" + (
                    f"  -- {row['note']}" if row.get("note") else ""))
        else:
            lines.append(f"  [{mark}] {row['key']:<28} "
                         f"{row.get('note', '')}")
    return "\n".join(lines)


# -- the diff -----------------------------------------------------------------

def _short(v, width: int = 48) -> str:
    s = repr(v)
    return s if len(s) <= width else s[:width - 3] + "..."


def _group_of(key: str) -> str:
    for prefix in ("stage_", "cluster_", "transfer_", "serve_",
                   "scheme_", "cache_", "store_", "link_", "trace_",
                   "metrics_", "sanitizer_", "degradation_",
                   "prefilter_", "wire_", "profile_", "lock_"):
        if key.startswith(prefix):
            return prefix.rstrip("_")
    return "core"


def diff(a: dict, b: dict, name_a: str = "A", name_b: str = "B",
         show_all: bool = False) -> str:
    """Human-readable delta report between two bench rounds.

    Numeric keys show value, delta and percent with a direction-aware
    verdict (``better`` / ``WORSE`` / ``~`` within 2%); identity keys
    show ``old -> new`` when changed; keys present on only one side
    are listed so a contract change is visible in the same report.
    Scale changes (different ``n_sessions``/``metric``) are flagged up
    top — walls across different scales are context, not regressions."""
    lines = [f"bench diff: {name_a} -> {name_b}"]
    for ctx_key in ("metric", "n_sessions", "backend", "scheme"):
        va, vb = a.get(ctx_key), b.get(ctx_key)
        if va != vb:
            lines.append(f"  NOTE {ctx_key}: {va!r} -> {vb!r} — "
                         "rounds are not scale-comparable on walls")
    shared = sorted(set(a) & set(b))
    by_group: dict = {}
    for key in shared:
        va, vb = a[key], b[key]
        fa, fb = _num(va), _num(vb)
        spec = BENCH_SCHEMA.get(key)
        if fa is not None and fb is not None:
            delta = fb - fa
            if delta == 0:
                pct = 0.0
            elif fa:
                pct = delta / abs(fa) * 100.0
            else:
                pct = float("inf")
            if abs(pct) < 2.0:
                verdict = "~"
            elif spec and spec["dir"]:
                better = (delta < 0) == (spec["dir"] == "lower")
                verdict = "better" if better else "WORSE"
            else:
                verdict = ""
            if not show_all and verdict == "~" and not (spec and
                                                        spec["gate"]):
                continue
            pct_s = f"{pct:+8.1f}%" if math.isfinite(pct) else "     new"
            by_group.setdefault(_group_of(key), []).append(
                f"    {key:<32} {fa:>12.4f} -> {fb:>12.4f}  "
                f"{pct_s}  {verdict}")
        elif va != vb:
            by_group.setdefault(_group_of(key), []).append(
                f"    {key:<32} {_short(va)} -> {_short(vb)}")
    for group in sorted(by_group):
        lines.append(f"  [{group}]")
        lines.extend(by_group[group])
    only_a = sorted(set(a) - set(b))
    only_b = sorted(set(b) - set(a))
    if only_a:
        lines.append(f"  only in {name_a}: {', '.join(only_a)}")
    if only_b:
        lines.append(f"  only in {name_b}: {', '.join(only_b)}")
    if len(lines) == 1:
        lines.append("  (no differences)")
    return "\n".join(lines)


__all__ = ["BENCH_SCHEMA", "assert_bench_keys", "diff", "gate",
           "format_gate_report", "gated_keys", "load_runs",
           "required_keys", "write_baseline"]
