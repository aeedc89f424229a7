"""tse1m_tpu_torch's profiling plane (``observability/profiling.py``,
``trace/sync.py``) against the JAX package's: the stack sampler's
lifecycle, kill switch and snapshot keys, planes, collapsed stacks and
sample windows; lock-wait attribution under the same site names; the
named locks at JAX's sites; slow-request capture behind an absorb; the
profile artifacts; and ``cluster --profile`` in a subprocess.  Mirrors
``tests/test_profiling.py``.  Tolerance: exact (keys, names, counts and
reports; timings are compared only as present)."""

import ast
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tse1m_tpu import observability as jobs
from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.observability import latency as jlatency
from tse1m_tpu.observability import metrics as jmetrics
from tse1m_tpu.observability import profiling as jprof
from tse1m_tpu.observability import tracing as jtracing
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu.serve import SloPolicy as JSlo
from tse1m_tpu.serve import router as jrouter
from tse1m_tpu.serve import slo as jslo
from tse1m_tpu.trace import sync as jsync
from tse1m_tpu_torch import observability as tobs
from tse1m_tpu_torch.cluster import observability as tstage
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.observability import latency as tlatency
from tse1m_tpu_torch.observability import metrics as tmetrics
from tse1m_tpu_torch.observability import profiling as tprof
from tse1m_tpu_torch.observability import tracing as ttracing
from tse1m_tpu_torch.resilience.watchdog import deadline_clock
from tse1m_tpu_torch.serve import ServeDaemon as TDaemon
from tse1m_tpu_torch.serve import SloPolicy as TSlo
from tse1m_tpu_torch.serve import router as trouter
from tse1m_tpu_torch.serve import slo as tslo
from tse1m_tpu_torch.trace import sync as tsync

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tse1m_tpu_torch")
# (profiling module, its named-lock module, its tracing module)
PACKAGES = {"torch": (tprof, tsync, ttracing), "jax": (jprof, jsync,
                                                     jtracing)}
SAMPLER_THREAD = "tse1m-prof-sampler"


def _reset_plane():
    for prof in (tprof, jprof):
        prof.set_profiling(None)
        prof.stop_sampler()
        prof.enable_lock_wait(False)
        prof.slow_request_log().clear()
    tmetrics.reset_metrics()
    jmetrics.reset_metrics()


@pytest.fixture(autouse=True)
def _clean_profiling_plane(monkeypatch):
    """Every test starts and ends with no sampler and no recorder in
    either package, empty slow-request logs and fresh registries."""
    monkeypatch.delenv("TSE1M_PROFILING", raising=False)
    _reset_plane()
    yield
    _reset_plane()


def _sampler_threads():
    return [t for t in threading.enumerate() if t.name == SAMPLER_THREAD]


def _burn(seconds: float) -> None:
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        sum(i * i for i in range(500))


def _contend(sync_mod, site: str, hold_s: float = 0.03) -> None:
    """The calling thread queues about ``hold_s`` on a lock named
    ``site`` of ``sync_mod``."""
    lk = sync_mod.Lock(site)
    held, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(2.0)

    t = threading.Thread(target=holder, daemon=True)
    t.start()
    assert held.wait(2.0)
    threading.Timer(hold_s, release.set).start()
    with lk:
        pass
    t.join(2.0)
    assert not t.is_alive()


# -- the sampler --------------------------------------------------------------

def test_sampler_snapshot_matches_jax():
    snaps = {}
    for name, (prof, _, tracing) in PACKAGES.items():
        s = prof.start_sampler(hz=200.0)
        assert s is not None and len(_sampler_threads()) == 1
        with tracing.span("prof.test.burn"):
            _burn(0.15)
        snaps[name] = s.snapshot()
        prof.stop_sampler()
        assert not _sampler_threads()
    t, j = snaps["torch"], snaps["jax"]
    assert set(t) == set(j) == {"hz", "samples", "window_s", "plane_self",
                                "span_self"}
    assert t["hz"] == j["hz"] == 200.0
    assert t["samples"] > 0 and j["samples"] > 0
    assert "prof.test.burn" in t["span_self"], t["span_self"]
    assert "prof.test.burn" in j["span_self"], j["span_self"]


def test_start_sampler_is_idempotent():
    a = tprof.start_sampler(hz=200.0)
    b = tprof.start_sampler()
    assert a is b and tprof.get_sampler() is a
    assert len(_sampler_threads()) == 1


def _kill_switch_case(prof, sync_mod, case: str, monkeypatch) -> tuple:
    """One of JAX's kill-switch scenarios against ``prof``; returns what
    an operator can observe of it."""
    if case == "env_refuses_start":
        monkeypatch.setenv("TSE1M_PROFILING", "0")
        out = (prof.profiling_enabled(), prof.start_sampler(),
               prof.enable_lock_wait(True), bool(_sampler_threads()))
        monkeypatch.delenv("TSE1M_PROFILING")
        return out
    if case == "set_profiling_tears_down":
        assert prof.start_sampler(hz=200.0) is not None
        assert prof.enable_lock_wait(True) is True
        assert _sampler_threads()
        prof.set_profiling(False)
        alive = bool(_sampler_threads())
        with sync_mod.Lock("prof.test.dead"):
            pass
        recorded = any(r["site"] == "prof.test.dead"
                       for r in prof.lock_wait_summary())
        prof.set_profiling(None)
        return (alive, recorded, prof.get_sampler())
    assert case == "env_ends_running_loop"
    assert prof.start_sampler(hz=200.0) is not None
    monkeypatch.setenv("TSE1M_PROFILING", "0")
    deadline = time.monotonic() + 2.0
    while _sampler_threads() and time.monotonic() < deadline:
        time.sleep(0.01)
    out = (bool(_sampler_threads()),)
    monkeypatch.delenv("TSE1M_PROFILING")
    prof.stop_sampler()
    return out


@pytest.mark.parametrize("case", ["env_refuses_start",
                                  "set_profiling_tears_down",
                                  "env_ends_running_loop"])
def test_kill_switch_matches_jax(case, monkeypatch):
    """``TSE1M_PROFILING=0`` or ``set_profiling(False)`` means no sampling
    thread and no recorder, in the port as in the JAX package."""
    got = _kill_switch_case(tprof, tsync, case, monkeypatch)
    assert not _sampler_threads()
    want = _kill_switch_case(jprof, jsync, case, monkeypatch)
    assert not _sampler_threads()
    assert got == want
    expected = {"env_refuses_start": (False, None, False, False),
                "set_profiling_tears_down": (False, False, None),
                "env_ends_running_loop": (False,)}
    assert got == expected[case]


def test_sampler_thread_is_a_daemon_named_for_the_kill_switch():
    s = tprof.start_sampler(hz=200.0)
    assert s is not None
    (th,) = _sampler_threads()
    assert th.daemon and th.name == SAMPLER_THREAD


def _prof_plane_sources():
    out = []
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _enclosing_names(node, parents) -> str:
    names = []
    while node is not None:
        node = parents.get(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name.lower())
    return " ".join(names)


def test_profiling_threads_keep_the_prof_overhead_contract():
    """The JAX package's ``prof-overhead`` lint rule, as a test over the
    port (graftlint walks only the JAX package): every thread the
    profiling module, or a function or class named for a sampler or
    profiler, constructs has a literal ``daemon=True``, and a file that
    spawns one consults ``TSE1M_PROFILING``."""
    plane = os.path.join(PKG, "observability", "profiling.py")
    spawning = []
    for path in _prof_plane_sources():
        text = open(path, encoding="utf-8").read()
        tree = ast.parse(text)
        parents = {c: p for p in ast.walk(tree)
                   for c in ast.iter_child_nodes(p)}
        spawns = []
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and (
                    getattr(node.func, "attr", None) == "Thread"
                    or getattr(node.func, "id", None) == "Thread")):
                continue
            scope = _enclosing_names(node, parents)
            if path != plane and not any(m in scope for m in (
                    "sampler", "profiler")):
                continue
            spawns.append(node)
            assert any(kw.arg == "daemon"
                       and isinstance(kw.value, ast.Constant)
                       and kw.value.value is True
                       for kw in node.keywords), (path, node.lineno)
        if spawns:
            spawning.append(path)
            assert "TSE1M_PROFILING" in text, path
    assert plane in spawning


def test_stacks_between_and_collapsed_format():
    s = tprof.start_sampler(hz=200.0)
    t0 = deadline_clock()
    with ttracing.span("prof.window.test"):
        _burn(0.1)
    t1 = deadline_clock()
    win = s.stacks_between(t0, t1)
    assert win, "no samples landed in a 100 ms busy window at 200 Hz"
    assert all(t0 - 0.01 <= w["t_s"] <= t1 + 0.01 for w in win)
    assert any(w["span"] == "prof.window.test" for w in win), win[:3]
    me = threading.get_ident()
    assert all(w["tid"] == me for w in s.stacks_between(t0, t1, tid=me))
    np.sort(np.random.default_rng(0).integers(0, 100, 1000))
    lines = s.collapsed(limit=10)
    assert lines and len(lines) <= 10
    stack, count = lines[0].rsplit(" ", 1)
    assert int(count) >= 1 and ":" in stack
    assert any("test_torch_profiling:_burn" in line for line in
               s.collapsed())


@pytest.mark.parametrize("rel", [
    "serve/daemon.py", "serve/router.py", "cluster/pipeline.py",
    "cluster/kernels/minhash.py", "observability/profiling.py",
    "resilience/watchdog.py", "trace/sync.py", "lint/runtime.py",
    "config.py"])
def test_plane_of_matches_jax_on_counterpart_paths(rel):
    """A frame under ``tse1m_tpu_torch/<rel>`` falls in the plane of the
    JAX package's frame under ``tse1m_tpu/<rel>``.  JAX's own rule never
    matches the port's directory, which is why the port has its own."""
    port, jax_path = f"/r/tse1m_tpu_torch/{rel}", f"/r/tse1m_tpu/{rel}"
    assert tprof._plane_of(port) == jprof._plane_of(jax_path)
    assert tprof._plane_of(port) != "ext"
    assert jprof._plane_of(port) == "ext"
    assert tprof._plane_of(jax_path) == "ext"
    assert tprof._plane_of("/usr/lib/python3/threading.py") == "ext"


# -- lock waits ---------------------------------------------------------------

def test_contended_named_lock_lands_under_the_same_site():
    rows = {}
    for name, (prof, sync_mod, _) in PACKAGES.items():
        assert prof.enable_lock_wait(True) is True
        _contend(sync_mod, "prof.test.contended")
        rows[name] = {r["site"]: r for r in prof.lock_wait_summary()}
        prof.enable_lock_wait(False)
    for name, by_site in rows.items():
        assert "prof.test.contended" in by_site, (name, by_site)
        row = by_site["prof.test.contended"]
        assert row["count"] >= 1 and row["max_ms"] >= 10.0, (name, row)
        assert set(row) == {"site", "count", "p99_ms", "max_ms"}
    assert {s for s in rows["torch"] if s.startswith("prof.")} == {
        s for s in rows["jax"] if s.startswith("prof.")}


def test_lock_wait_recorder_survives_registry_locks():
    """Recording a wait for the registry's own lock must not take it
    again (the pending-buffer design)."""
    tprof.enable_lock_wait(True)
    done = []

    def worker():
        for i in range(200):
            tmetrics.histogram("prof_test_regress",
                               lane=str(i % 3)).observe(0.001)
        done.append(True)

    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert len(done) == 4, "registry traffic deadlocked under the recorder"
    sites = {r["site"] for r in tprof.lock_wait_summary()}
    assert "MetricsRegistry" in sites
    assert "LatencyRecorder.prof_test_regress" in sites


def test_drain_lock_waits_is_per_thread_and_one_shot():
    tprof.enable_lock_wait(True)
    _contend(tsync, "prof.test.drain")
    other = []
    th = threading.Thread(target=lambda: other.append(
        tprof.drain_lock_waits()), daemon=True)
    th.start()
    th.join(2.0)
    assert other == [[]]
    waits = tprof.drain_lock_waits()
    assert any(site == "prof.test.drain" and ms >= 10.0
               for site, ms in waits), waits
    assert tprof.drain_lock_waits() == []


def _queued_on(tid: int, lk) -> bool:
    """Thread ``tid`` sits in ``lk.acquire``."""
    f = sys._current_frames().get(tid)
    while f is not None:
        if f.f_code.co_name == "acquire" and f.f_locals.get("self") is lk:
            return True
        f = f.f_back
    return False


def _stuck_query(daemon, items, prof, hold_s: float = 0.35) -> dict:
    """A query that blows a 0 ms budget while the daemon is mid-absorb,
    queued ``hold_s`` on its query histogram's lock, which another thread
    holds until the query is seen waiting on it."""
    daemon.ingest(items, timeout=60)
    daemon.quiesce(timeout=60)
    prof.enable_lock_wait(True)
    lk = daemon.lat_query._lock
    held, release = threading.Event(), threading.Event()

    def holder():
        with lk:
            held.set()
            release.wait(30.0)

    def ask():
        with PACKAGES["torch" if prof is tprof else "jax"][2].span(
                "serve.query"):
            daemon.query(items[:1])

    th = threading.Thread(target=holder, daemon=True)
    th.start()
    assert held.wait(2.0)
    daemon._busy = True
    daemon._inflight = {"site": "serve.index.swap", "rows": 4096,
                        "since_s": 0.0}
    q = threading.Thread(target=ask, daemon=True)
    try:
        q.start()
        deadline = time.monotonic() + 30.0
        while not _queued_on(q.ident, lk) and time.monotonic() < deadline:
            time.sleep(0.005)
        time.sleep(hold_s)
    finally:
        release.set()
        q.join(30.0)
        th.join(5.0)
        daemon._busy = False
    assert not q.is_alive() and not th.is_alive()
    prof.enable_lock_wait(False)
    assert prof.slow_requests_total() >= 1
    return prof.recent_slow_requests()[-1]


def test_daemon_query_slow_capture_behind_absorb_matches_jax(tmp_path):
    """A daemon query stuck behind an absorb and a held histogram lock
    records, in both packages, the same keys, the absorbing site, the
    query's span chain and the lock it queued on by JAX's name."""
    items = synth_session_sets(64, set_size=64, seed=5)[0]
    tdm = TDaemon(str(tmp_path / "t"), params=TParams(n_hashes=32,
                                                       n_bands=4),
                  slo=TSlo(query_p99_target_ms=0.0), device="cpu").start()
    try:
        rec = _stuck_query(tdm, items, tprof)
    finally:
        tdm.stop(commit=False)
    jdm = JDaemon(str(tmp_path / "j"), params=JParams(
        n_hashes=32, n_bands=4, use_pallas="never"),
        slo=JSlo(query_p99_target_ms=0.0)).start()
    try:
        jrec = _stuck_query(jdm, items, jprof)
    finally:
        jdm.stop(commit=False)
    assert set(rec) == set(jrec)
    for r in (rec, jrec):
        assert r["kind"] == "query" and r["budget_ms"] == 0.0
        assert r["absorb"] == {"site": "serve.index.swap", "rows": 4096,
                               "since_s": 0.0}
        assert "serve.query" in r["span_chain"], r["span_chain"]
    sites = [{s for s, ms in r["lock_waits_ms"] if ms >= 300.0}
             for r in (rec, jrec)]
    assert sites[0] == sites[1] == {"LatencyRecorder.serve_query"}


# -- the named locks ----------------------------------------------------------

def _router_lock(mod):
    router = mod.ShardRouter({0: object()})
    try:
        return router._lock
    finally:
        close = getattr(router, "close", None)
        if close is not None:
            close()


LOCK_SITES = {
    "SpanRing": (lambda: ttracing.SpanRing()._lock,
                 lambda: jtracing.SpanRing()._lock),
    "StageRecorder": (lambda: tstage.StageRecorder()._lock,
                      lambda: jobs.StageRecorder()._lock),
    "observability._degradation_lock": (
        lambda: tobs._degradation_lock, lambda: jobs._degradation_lock),
    "Counter.x": (lambda: tmetrics.Counter("x", {})._lock,
                  lambda: jmetrics.Counter("x", {})._lock),
    "Gauge.x": (lambda: tmetrics.Gauge("x", {})._lock,
                lambda: jmetrics.Gauge("x", {})._lock),
    "MetricsRegistry": (lambda: tmetrics.MetricsRegistry()._lock,
                        lambda: jmetrics.MetricsRegistry()._lock),
    "LatencyRecorder.x": (lambda: tlatency.LatencyRecorder("x")._lock,
                          lambda: jlatency.LatencyRecorder("x")._lock),
    "Sampler": (lambda: tprof.Sampler()._lock,
                lambda: jprof.Sampler()._lock),
    "SlowRequestLog": (lambda: tprof.SlowRequestLog()._lock,
                       lambda: jprof.SlowRequestLog()._lock),
    "ShardRouter": (lambda: _router_lock(trouter),
                    lambda: _router_lock(jrouter)),
    "AdmissionController": (
        lambda: tslo.AdmissionController(TSlo())._lock,
        lambda: jslo.AdmissionController(JSlo())._lock),
    "SloTracker": (lambda: tslo.SloTracker(TSlo())._lock,
                   lambda: jslo.SloTracker(JSlo())._lock),
}


def _named_site(site: str) -> bool:
    """One of the JAX package's lock names (item sites of ``LOCK_SITES``,
    the per-metric ones by their prefix)."""
    return site in LOCK_SITES or site.startswith(
        ("Counter.", "Gauge.", "LatencyRecorder."))


@pytest.mark.parametrize("site", sorted(LOCK_SITES))
def test_named_lock_carries_jax_name(site):
    """Each lock the JAX package builds from ``tsync.Lock`` has a port
    counterpart of the same name (JAX's ``observability._last_lock``
    guards a stage slot the port does not keep), so
    ``lock_wait_seconds{site=...}`` reads the same sites."""
    make_t, make_j = LOCK_SITES[site]
    t, j = make_t(), make_j()
    assert isinstance(t, tsync.Lock) and not isinstance(t, tsync.RLock)
    assert t.name == j.name == site
    tprof.enable_lock_wait(True)
    with t:
        pass
    assert site in {r["site"] for r in tprof.lock_wait_summary()}


def test_rlock_is_reentrant_and_recorded():
    lk = tsync.RLock("prof.test.rlock")
    tprof.enable_lock_wait(True)
    with lk:
        with lk:
            pass
    assert lk.acquire(blocking=False)
    lk.release()
    rows = {r["site"]: r for r in tprof.lock_wait_summary()}
    assert rows["prof.test.rlock"]["count"] == 3
    assert repr(lk) == "<trace.sync.RLock prof.test.rlock>"


# -- profile artifacts --------------------------------------------------------

def test_dump_profile_and_status_with_live_sampler_match_jax(tmp_path):
    paths, status = {}, {}
    for name, (prof, sync_mod, _) in PACKAGES.items():
        assert prof.start_sampler(hz=200.0) is not None
        prof.enable_lock_wait(True)
        _contend(sync_mod, "prof.test.dump", hold_s=0.01)
        _burn(0.05)
        status[name] = prof.profile_status()
        d = str(tmp_path / name)
        paths[name] = (prof.dump_profile(extra={"step": "t"}, d=d),
                       prof.dump_profile(d=d))
        prof.stop_sampler()
        prof.enable_lock_wait(False)
        assert prof.profile_status()["sampler_alive"] is False
    for name, (p0, p1) in paths.items():
        assert p0.endswith("profile_000.json")
        assert p1.endswith("profile_001.json")
        assert sorted(os.listdir(os.path.dirname(p0))) == [
            "profile_000.json", "profile_001.json"]
    with open(paths["torch"][0]) as f, open(paths["jax"][0]) as g:
        got, want = json.load(f), json.load(g)
    assert set(got) == set(want)
    assert set(got["sampler"]) == set(want["sampler"])
    assert got["sampler"]["hz"] == want["sampler"]["hz"] == 200.0
    assert got["sampler"]["samples"] > 0 and got["collapsed_stacks"]
    assert got["extra"] == want["extra"] == {"step": "t"}
    assert "prof.test.dump" in {r["site"] for r in got["lock_wait_sites"]}
    t, j = status["torch"], status["jax"]
    assert set(t) == set(j)
    assert t["sampler_alive"] is j["sampler_alive"] is True
    assert set(t["sampler"]) == set(j["sampler"])
    assert len(t["lock_wait_top"]) <= 3


# -- cluster --profile --------------------------------------------------------

_TIMINGS = ("cluster_wall_s", "h2d_overlap_fraction")


def _untimed(report: dict) -> dict:
    return {k: v for k, v in report.items()
            if k not in _TIMINGS and not (k.startswith("stage_")
                                          and k.endswith("_s"))}


def test_cluster_profile_cli_writes_profile_and_trace(tmp_path):
    """``cluster --profile --device cpu``: ``profile_000.json`` beside
    ``run_manifest.json`` with JAX's top-level keys and a live sampler's
    snapshot, a Chrome trace under ``device_trace/``, the report of the
    unprofiled run; under ``TSE1M_PROFILING=0`` the flag writes nothing."""
    runs = {"profiled": (["--profile"], {}), "plain": ([], {}),
            "killed": (["--profile"], {"TSE1M_PROFILING": "0"})}
    procs = {}
    for name, (flags, extra_env) in runs.items():
        env = dict(os.environ, TSE1M_RESULT_DIR=str(tmp_path / name),
                   TSE1M_SIG_STORE="", **extra_env)
        env.pop("TSE1M_FLIGHT_DIR", None)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "tse1m_tpu_torch", "cluster", "--n",
             "3000", "--seed", "0", "--device", "cpu", *flags], cwd=REPO,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    reports = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, err[-2000:])
        reports[name] = json.loads(out.strip().splitlines()[-1])
    assert _untimed(reports["profiled"]) == _untimed(reports["plain"])
    assert _untimed(reports["killed"]) == _untimed(reports["plain"])
    res = tmp_path / "profiled"
    assert sorted(os.listdir(res)) == ["device_trace", "profile_000.json",
                                       "run_manifest.json"]
    for name in ("plain", "killed"):
        assert sorted(os.listdir(tmp_path / name)) == ["run_manifest.json"]
    with open(res / "profile_000.json") as f:
        payload = json.load(f)
    jprof.start_sampler(hz=200.0)
    with open(jprof.dump_profile(extra={"step": "cluster", "n": 3000},
                                 d=str(tmp_path / "j"))) as f:
        want = json.load(f)
    assert set(payload) == set(want)
    assert payload["extra"] == {"step": "cluster", "n": 3000}
    assert set(payload["sampler"]) == set(want["sampler"])
    assert payload["sampler"]["samples"] > 0
    assert "cluster" in payload["sampler"]["plane_self"]
    assert payload["collapsed_stacks"]
    assert all(_named_site(r["site"]) for r in payload["lock_wait_sites"])
    (trace_name,) = os.listdir(res / "device_trace")
    assert trace_name == "trace_000.json"
    with open(res / "device_trace" / trace_name) as f:
        trace = json.load(f)
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any(n.startswith("aten::") for n in names)
    with open(res / "run_manifest.json") as f:
        steps = json.load(f)["steps"]
    assert [s["name"] for s in steps] == ["cluster"]
    assert steps[0]["status"] == "ok"
