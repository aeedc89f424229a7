"""tse1m_tpu_torch's telemetry and watchdog modules against the JAX
package's: latency histograms, the metrics registry and its three
exports, spans and the trace envelope, the flight recorder, the profiler
and slow-request log, degradation events, ``run_with_deadline`` and
``SloPolicy.from_env``.  Tolerance: exact."""

import json
import threading
import time

import pytest

from tse1m_tpu import observability as jobs
from tse1m_tpu.observability import export as jexport
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.observability import latency as jlatency
from tse1m_tpu.observability import metrics as jmetrics
from tse1m_tpu.observability import profiling as jprof
from tse1m_tpu.observability import tracing as jtracing
from tse1m_tpu.resilience import watchdog as jwatchdog
from tse1m_tpu.serve import slo as jslo
from tse1m_tpu_torch import observability as tobs
from tse1m_tpu_torch.observability import export as texport
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.observability import latency as tlatency
from tse1m_tpu_torch.observability import metrics as tmetrics
from tse1m_tpu_torch.observability import profiling as tprof
from tse1m_tpu_torch.observability import tracing as ttracing
from tse1m_tpu_torch.resilience import watchdog as twatchdog
from tse1m_tpu_torch.serve import slo as tslo

WALLS = {
    "ramp": [ms / 1e3 for ms in range(1, 101)],
    "edges": [0.0, 1e-7, 1e-6, 1.0000001e-6, 0.05, 999.0, 5e3],
    "tail": [0.002] * 97 + [0.4, 0.9, 3.0],
    "one": [0.0123],
}


@pytest.mark.parametrize("case", sorted(WALLS))
def test_latency_recorder_matches_jax(case):
    t, j = tlatency.LatencyRecorder("x"), jlatency.LatencyRecorder("x")
    for w in WALLS[case]:
        t.add(w)
        j.add(w)
    drop = lambda s: {k: v for k, v in s.items() if k != "qps"}  # noqa: E731
    assert drop(t.snapshot()) == drop(j.snapshot())
    assert t.buckets() == j.buckets()
    assert set(t.summary()) == set(j.summary())
    with t.time():
        pass
    assert t.snapshot()["count"] == len(WALLS[case]) + 1
    empty = tlatency.LatencyRecorder("y")
    assert empty.snapshot() == {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0,
                                "max_ms": 0.0, "mean_ms": 0.0, "qps": 0.0}
    assert empty.summary()["y_count"] == 0


def _drive_registry(reg):
    reg.counter("degradations_total", kind="stall").inc()
    reg.counter("degradations_total", kind="oom").inc(3)
    reg.counter("serve_ingest_rejected_total").inc(2)
    reg.gauge("serve_queue_depth").set(4)
    reg.gauge("serve_ingest_backlog_max").set_max(7)
    reg.gauge("serve_ingest_backlog_max").set_max(5)
    reg.gauge("odd", site='a"b\\c').set(1.5)
    for w in (0.001, 0.002, 0.2, 0.0005):
        reg.histogram("lock_wait_seconds", site="s1").observe(w)
    reg.histogram("lock_wait_seconds", site="s2").observe(0.03)
    with pytest.raises(TypeError):
        reg.gauge("degradations_total", kind="stall")
    with pytest.raises(ValueError):
        reg.counter("c").inc(-1)


def test_registry_exports_match_jax():
    t, j = tmetrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _drive_registry(t)
    _drive_registry(j)
    assert texport.prometheus_text(t) == jexport.prometheus_text(j)
    assert texport.flat_metrics(t) == jexport.flat_metrics(j)
    assert texport.flat_metrics(t, prefix="m_") == jexport.flat_metrics(
        j, prefix="m_")

    def no_qps(snap):
        for h in snap["histograms"]:
            h.pop("qps")
        return snap

    assert no_qps(texport.metrics_snapshot(t)) == no_qps(
        jexport.metrics_snapshot(j))
    assert texport.prometheus_text(tmetrics.MetricsRegistry()) == ""
    t.clear()
    assert t.collect() == []


def _span_program(mod):
    """Root and child spans, a child in another thread through the
    envelope, a failed span, then a pinned trace; returns the records
    as (name, parent's name, ok, tags) and the envelope."""
    mod.clear_spans()
    seen = {}
    with mod.span("root", a=1) as root:
        ctx = mod.current_trace()
        with mod.span("child") as ch:
            ch.set_tag("rows", 3)
            seen["chain"] = mod.thread_span_chain()

        def remote():
            with mod.continue_trace(ctx):
                with mod.span("remote"):
                    seen["remote_ctx"] = mod.current_trace()

        th = threading.Thread(target=remote)
        th.start()
        th.join(10)
        with pytest.raises(KeyError):
            with mod.span("bad"):
                raise KeyError("x")
        seen["root_trace"] = root.trace
    assert mod.current_trace() is None
    mod.adopt_trace("feedfacefeedface")
    try:
        with mod.span("pinned"):
            seen["pinned"] = mod.current_trace()["t"]
    finally:
        mod.adopt_trace(None)
    mod.set_tracing(False)
    try:
        with mod.span("off"):
            pass
    finally:
        mod.set_tracing(True)
    recs = mod.recent_spans()
    by_id = {r["span"]: r["name"] for r in recs}
    shape = [(r["name"], by_id.get(r["parent"], r["parent"]), r["ok"],
              r["tags"], r["trace"] == seen["root_trace"]) for r in recs]
    return shape, seen, ctx, mod.spans_recorded()


def test_spans_and_the_trace_envelope_match_jax():
    t_shape, t_seen, t_ctx, t_n = _span_program(ttracing)
    j_shape, j_seen, j_ctx, j_n = _span_program(jtracing)
    assert t_shape == j_shape
    assert t_shape == [("child", "root", True, {"rows": 3}, True),
                       ("remote", "root", True, {}, True),
                       ("bad", "root", False, {}, True),
                       ("root", "", True, {"a": 1}, True),
                       ("pinned", "", True, {}, False)]
    assert t_n == j_n == 5
    assert set(t_ctx) == set(j_ctx) == {"t", "s"}
    assert t_seen["chain"] == j_seen["chain"] == ["root", "child"]
    assert t_seen["remote_ctx"]["t"] == t_ctx["t"]
    assert t_seen["pinned"] == j_seen["pinned"] == "feedfacefeedface"
    ring = ttracing.SpanRing(capacity=3)
    for i in range(5):
        ring.append({"i": i})
    assert [r["i"] for r in ring.recent()] == [2, 3, 4]
    assert ring.total() == 5 and [r["i"] for r in ring.recent(2)] == [3, 4]


def test_flight_dump_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("TSE1M_FLIGHT_DIR", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    try:
        dumps = []
        for mod, name in ((tflight, "t"), (jflight, "j")):
            mod.set_flight_dir(None)
            assert mod.dump_flight("nowhere") is None
            mod.set_flight_dir(str(tmp_path / name))
            p0 = mod.dump_flight("test", site="serve.ingest",
                                 extra={"error": "E"})
            p1 = mod.dump_flight("again")
            assert p0.endswith("flight_000.json")
            assert p1.endswith("flight_001.json")
            with open(p0) as f:
                dumps.append(json.load(f))
        t, j = dumps
        assert set(t) == set(j)
        assert set(t["metrics"]) == set(j["metrics"])
        assert t["spans"][-1]["name"] == j["spans"][-1]["name"] == \
            "flight.test"
        assert t["spans"][-1]["tags"] == {"site": "serve.ingest"}
        assert (t["reason"], t["site"], t["extra"]) == (
            "test", "serve.ingest", {"error": "E"})
    finally:
        jflight._flight_dir, tflight._flight_dir = saved


def test_degradation_events_match_jax():
    for obs in (tobs, jobs):
        before = len(obs.peek_degradation_events())
        e = obs.record_degradation("unit_test_kind", site="s",
                                   detail={"n": 1})
        assert e["kind"] == "unit_test_kind" and e["detail"] == {"n": 1}
        events = obs.peek_degradation_events()
        assert len(events) == before + 1 and events[-1]["seq"] == e["seq"]
        assert obs.degradation_counts(events)["unit_test_kind"] >= 1
    assert tmetrics.counter("degradations_total",
                            kind="unit_test_kind").value >= 1


def test_run_with_deadline_raises_stall_error():
    release = threading.Event()
    for mod in (twatchdog, jwatchdog):
        t0 = time.monotonic()
        with pytest.raises(mod.StallError) as exc:
            mod.run_with_deadline(lambda: release.wait(30), 0.05,
                                  "serve.ingest")
        assert time.monotonic() - t0 < 5
        assert exc.value.site == "serve.ingest"
        assert exc.value.budget_s == 0.05
        assert mod.run_with_deadline(lambda: 7, 0, "x") == 7
        assert mod.run_with_deadline(lambda: 8, 1.0, "x") == 8
        with pytest.raises(ZeroDivisionError):
            mod.run_with_deadline(lambda: 1 / 0, 1.0, "x")
    release.set()
    assert str(twatchdog.StallError("s", 1.5)) == str(
        jwatchdog.StallError("s", 1.5))
    # The worker keeps the caller's trace span.
    with ttracing.span("caller"):
        ctx = ttracing.current_trace()
        assert twatchdog.run_with_deadline(ttracing.current_trace, 5.0,
                                           "x") == ctx


@pytest.mark.parametrize("env", [
    {}, {"TSE1M_SERVE_MAX_BACKLOG": "3"},
    {"TSE1M_SERVE_P99_TARGET_MS": "12.5", "TSE1M_LIVE_DELTA_RUNS": "4"},
    {"TSE1M_SERVE_INGEST_BUDGET_S": "9", "TSE1M_SERVE_QUERY_BUDGET_S": "0.5"}])
def test_slo_policy_from_env_matches_jax(monkeypatch, env):
    for name in ("TSE1M_SERVE_MAX_BACKLOG", "TSE1M_SERVE_P99_TARGET_MS",
                 "TSE1M_LIVE_DELTA_RUNS", "TSE1M_SERVE_INGEST_BUDGET_S",
                 "TSE1M_SERVE_QUERY_BUDGET_S", "TSE1M_WATCHDOG"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    t, j = tslo.SloPolicy.from_env(), jslo.SloPolicy.from_env()
    fields = ("max_backlog_batches", "query_p99_target_ms",
              "query_budget_s", "ingest_budget_s", "live_delta_runs")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    ta, ja = tslo.AdmissionController(t), jslo.AdmissionController(j)
    for depth in (0, 2, 5, 70, 70, 1, 80):
        assert ta.try_admit(depth) == ja.try_admit(depth)
    assert ta.stats() == ja.stats()


def test_profiler_and_slow_request_log_match_jax(tmp_path, monkeypatch):
    """The slow-request record, the ``profile`` verb's answer and the
    profile dump carry JAX's keys; with no sampler running (a daemon
    starts none in either package) they agree on the values too."""
    monkeypatch.delenv("TSE1M_PROFILING", raising=False)
    assert jprof.get_sampler() is None
    try:
        with ttracing.span("serve.query"):
            rec = tprof.capture_slow_request("query", 0.2, 50.0,
                                             absorb={"rows": 4}, rows=2)
        with jtracing.span("serve.query"):
            jrec = jprof.capture_slow_request("query", 0.2, 50.0,
                                              absorb={"rows": 4}, rows=2)
        assert set(rec) == set(jrec)
        assert rec["span_chain"] == jrec["span_chain"] == ["serve.query"]
        assert (rec["wall_ms"], rec["budget_ms"], rec["tags"]) == (
            200.0, 50.0, {"rows": 2})
        assert (rec["stacks"], rec["lock_waits_ms"]) == (
            jrec["stacks"], jrec["lock_waits_ms"]) == ([], [])
        assert rec["absorb"] == jrec["absorb"] == {"rows": 4}
        assert tprof.recent_slow_requests(1)[-1] is rec
        status, jstatus = tprof.profile_status(), jprof.profile_status()
        jstatus.pop("slow_requests_total")
        assert {k: v for k, v in status.items()
                if k != "slow_requests_total"} == jstatus
        path = tprof.dump_profile(d=str(tmp_path))
        jpath = jprof.dump_profile(d=str(tmp_path / "j"))
        with open(path) as f, open(jpath) as g:
            got, want = json.load(f), json.load(g)
        assert set(got) == set(want)
        for key in ("sampler", "collapsed_stacks", "profiling_enabled"):
            assert got[key] == want[key]
        assert path.endswith("profile_000.json")
        tprof.set_profiling(False)
        assert not tprof.profiling_enabled()
        assert not tprof.profile_status()["profiling_enabled"]
    finally:
        tprof.set_profiling(None)
    assert tprof.profiling_enabled()
    monkeypatch.setenv("TSE1M_PROFILING", "0")
    assert not tprof.profiling_enabled()
    log = tprof.SlowRequestLog(capacity=2)
    for i in range(3):
        log.append({"i": i})
    assert [r["i"] for r in log.recent()] == [1, 2] and log.total() == 3
    assert tprof.lock_wait_summary() == []
