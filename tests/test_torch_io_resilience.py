"""The port's I/O resilience against the JAX package's: the full retry
engine (attempts, sleeps, exceptions, recovery hooks and the
``retries_total`` counter on scripted failure sequences under a seeded
rng and a fake clock), the HTTP transport (scripted sessions, and the
port's urllib fetcher beside JAX's requests fetcher against one loopback
``http.server``), the study database's retry and reconnect, the CSV
checkpointer under torn writes and a SIGKILL, and `all` under transient
database faults.  Each seat of ``resilience/fault_matrix.py``'s four I/O
entries is driven with the kinds listed there."""

from __future__ import annotations

import glob
import http.server
import json
import os
import random
import sqlite3
import subprocess
import sys
import threading

import pandas as pd
import pytest

import tse1m_tpu.collect.transport as jtr
import tse1m_tpu.observability.metrics as jmetrics
import tse1m_tpu.resilience as jres
import tse1m_tpu.resilience.retry as jretry
import tse1m_tpu_torch.collect.transport as ttr
import tse1m_tpu_torch.observability.metrics as tmetrics
import tse1m_tpu_torch.resilience as tres
import tse1m_tpu_torch.utils.retry as tretry
from tse1m_tpu.config import Config as JConfig
from tse1m_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = {"jax": (jretry, jres, jmetrics, jtr),
       "torch": (tretry, tres, tmetrics, ttr)}


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    jres.clear_plan()
    tres.clear_plan()
    yield
    jres.clear_plan()
    tres.clear_plan()


# -- the retry engine ---------------------------------------------------------

class Hinted(RuntimeError):
    retry_after = 7.5


class NoRetry(RuntimeError):
    no_retry = True


SCRIPTS = {
    "succeeds": (["os"] * 3, dict(max_attempts=5, base_delay=0.01), {}),
    "exhausts": (["os"] * 10, dict(max_attempts=3, base_delay=0.5), {}),
    "allowlist": (["value"], dict(max_attempts=5, retry_on="os"), {}),
    "hint": (["hint"] * 5, dict(max_attempts=3, base_delay=0.01), {}),
    "deadline": (["os"] * 50, dict(max_attempts=50, base_delay=1.0,
                                   jitter=False, deadline=3.5), {}),
    "hint_capped": (["hint"] * 4, dict(max_attempts=6, base_delay=0.1,
                                       deadline=10.0), {}),
    "should_retry": (["os", "noretry"], dict(max_attempts=5,
                                             base_delay=0.2),
                     {"should_retry": True}),
    "injected": (["fault", "drop", "fault"], dict(max_attempts=4,
                                                  base_delay=0.3,
                                                  max_delay=0.4), {}),
    "max_delay": (["os"] * 7, dict(max_attempts=8, base_delay=0.1,
                                   max_delay=0.5, jitter=False), {}),
}


def _exc(pkg, kind):
    res = PKG[pkg][1]
    return {"os": OSError("transient"), "value": ValueError("not transient"),
            "hint": Hinted("slow down"), "noretry": NoRetry("hard"),
            "fault": res.InjectedFault("injected"),
            "drop": res.InjectedConnectionDrop("dropped")}[kind]


def _run_script(pkg, name, seed):
    retry, _, metrics, _ = PKG[pkg]
    fails, pol, extra = SCRIPTS[name]
    pol = dict(pol)
    if pol.get("retry_on") == "os":
        pol["retry_on"] = (OSError,)
    clock = [0.0]
    sleeps, hooks, calls = [], [], [0]

    def sleep(s):
        sleeps.append(s)
        clock[0] += s

    def fn():
        calls[0] += 1
        clock[0] += 0.01
        if calls[0] <= len(fails):
            raise _exc(pkg, fails[calls[0] - 1])
        return "ok"

    site = f"script.{name}.{seed}"
    before = metrics.counter("retries_total", site=site).value
    stats = retry.RetryStats()
    kw = {}
    if extra.get("should_retry"):
        kw["should_retry"] = lambda e: not getattr(e, "no_retry", False)
    try:
        out = ("ok", retry.retry_call(
            fn, policy=retry.RetryPolicy(**pol), site=site, sleep=sleep,
            rng=random.Random(seed), clock=lambda: clock[0], stats=stats,
            on_retry=lambda e, a: hooks.append((type(e).__name__, a)),
            **kw))
    except Exception as e:  # noqa: BLE001 - the outcome is compared
        cause = e.__cause__
        out = (type(e).__name__, str(e), getattr(e, "attempts", None),
               type(cause).__name__ if cause else None)
    after = metrics.counter("retries_total", site=site).value
    return out, sleeps, hooks, calls[0], stats.attempts, stats.sleeps, \
        after - before


@pytest.mark.parametrize("name", list(SCRIPTS))
@pytest.mark.parametrize("seed", [0, 7])
def test_retry_call_equals_jax(name, seed):
    got = _run_script("torch", name, seed)
    want = _run_script("jax", name, seed)
    assert got == want
    assert got[-1] == len(got[1])   # one retries_total per retry


def test_retry_deadline_and_hint_semantics():
    out, sleeps, *_ = _run_script("torch", "deadline", 0)
    assert out[0] == "RetryError" and sum(sleeps) <= 3.5 + 1e-9
    _, sleeps, *_ = _run_script("torch", "hint", 0)
    assert sleeps and all(s >= 7.5 for s in sleeps)
    _, sleeps, *_ = _run_script("torch", "hint_capped", 0)
    assert all(s <= 10.0 for s in sleeps)


def test_retry_attempt_spans_tag_injected_faults():
    from tse1m_tpu_torch.observability import tracing

    tracing.set_tracing(True)
    tracing.clear_spans()
    _run_script("torch", "injected", 0)
    tags = [r["tags"] for r in tracing.recent_spans()
            if r["name"] == "attempt.script.injected.0"]
    assert [t.get("error") for t in tags] == [
        "InjectedFault", "InjectedConnectionDrop", "InjectedFault", None]
    assert [t.get("fault") for t in tags] == ["injected"] * 3 + [None]
    assert [t["attempt"] for t in tags] == [1, 2, 3, 4]


def test_existing_callers_keep_their_behaviour(tmp_path):
    """The signature store and checkpoint writers still call the engine
    with only a policy and a site."""
    from tse1m_tpu_torch.utils.retry import io_retry_policy, retry_call

    n = [0]

    def flaky():
        n[0] += 1
        if n[0] < 3:
            raise OSError("flaky mount")
        return n[0]

    assert retry_call(flaky, policy=io_retry_policy(base_delay=0.0),
                      site="store.sig.save") == 3


# -- the HTTP transport -------------------------------------------------------

class _FakeResp:
    def __init__(self, status, content=b"", headers=None):
        self.status_code = status
        self.content = content
        self.headers = headers or {}

    def raise_for_status(self):
        if self.status_code >= 400:
            raise RuntimeError(f"HTTP {self.status_code}")


class _UrlSession:
    def __init__(self, pages):
        self.pages = pages
        self.requests = []

    def get(self, url, params=None, timeout=None):
        full = jtr._with_params(url, params)
        self.requests.append(full)
        if full not in self.pages:
            return _FakeResp(404)
        return _FakeResp(200, self.pages[full])


@pytest.mark.parametrize("kind", ["raise", "connection_drop", "delay"])
def test_http_fetch_survives_injected_faults(kind):
    pages = {"https://x/a": b"payload"}
    clean = ttr.HttpFetcher(ttr.FetchPolicy(retries=0, backoff_factor=0.0),
                            session=_UrlSession(pages)).get("https://x/a")
    plan = tres.FaultPlan([tres.FaultRule(site="http.fetch", times=3,
                                          kind=kind, delay_s=0.01)])
    with plan.active():
        faulty = ttr.HttpFetcher(ttr.FetchPolicy(retries=3,
                                                 backoff_factor=0.0),
                                 session=_UrlSession(pages)).get(
            "https://x/a")
    # A delay passes through: it fires on the one call there is.
    assert len(plan.fired) == (1 if kind == "delay" else 3)
    assert faulty.content == clean.content


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_http_retry_after_honoured_and_capped(pkg, monkeypatch):
    _, _, _, tr = PKG[pkg]

    class _Scripted:
        def __init__(self, script):
            self.script = list(script)

        def get(self, url, params=None, timeout=None):
            return self.script.pop(0)

    sleeps = []
    orig = tr.retry_call
    monkeypatch.setattr(tr, "retry_call",
                        lambda fn, **kw: orig(fn, sleep=sleeps.append, **kw))
    f = tr.HttpFetcher(tr.FetchPolicy(retries=3, backoff_factor=0.0,
                                      deadline=30.0), session=_Scripted([
        _FakeResp(429, headers={"Retry-After": "3"}),
        _FakeResp(503, headers={"Retry-After": "9999"}),
        _FakeResp(200, b"done")]))
    assert f.get("https://x/limited").content == b"done"
    assert sleeps[0] >= 3.0 and sleeps[1] <= 30.0


def test_parse_retry_after_as_jax():
    for v in ("120", " 0 ", "-5", None, "", "not a date or number",
              "Wed, 21 Oct 2015 07:28:00 GMT", "1.5"):
        assert ttr.parse_retry_after(v) == jtr.parse_retry_after(v)


def test_http_hard_4xx_is_not_retried():
    class _Counting:
        calls = 0

        def get(self, url, params=None, timeout=None):
            self.calls += 1
            return _FakeResp(403)

    s = _Counting()
    with pytest.raises(RuntimeError, match="HTTP 403"):
        ttr.HttpFetcher(ttr.FetchPolicy(retries=3, backoff_factor=0.0),
                        session=s).get("https://x/forbidden")
    assert s.calls == 1


class _Handler(http.server.BaseHTTPRequestHandler):
    """Serves ``root`` by path; ``script`` maps a path to the statuses
    returned before its content (429 and 503 with Retry-After)."""

    root = ""
    script: dict = {}
    hits: dict = {}
    lock = threading.Lock()

    def do_GET(self):  # noqa: N802 - http.server's name
        with self.lock:
            self.hits[self.path] = self.hits.get(self.path, 0) + 1
            queue = self.script.get(self.path, [])
            status = queue.pop(0) if queue else None
        if status is not None:
            self.send_response(status)
            if status in (429, 503):
                self.send_header("Retry-After", "0")
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        path = os.path.join(self.root, *self.path.lstrip("/").split("/"))
        if not os.path.isfile(path):
            self.send_response(404)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        body = open(path, "rb").read()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


def test_urllib_fetcher_equals_requests_fetcher_on_loopback(tmp_path,
                                                            monkeypatch):
    """One loopback ``http.server``: JAX's requests fetcher and the port's
    urllib fetcher get the same bytes, the same 404s, the same hard 403
    and the same number of requests through scripted 429 and 503s."""
    for var in ("http_proxy", "HTTP_PROXY", "https_proxy", "HTTPS_PROXY",
                "all_proxy", "ALL_PROXY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("NO_PROXY", "127.0.0.1,localhost")
    (tmp_path / "a").mkdir()
    for i in range(4):
        (tmp_path / "a" / f"f{i}.txt").write_bytes(bytes(range(i * 50,
                                                               i * 50 + 50)))
    server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
    _Handler.root = str(tmp_path)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    results = {}
    try:
        for pkg in ("jax", "torch"):
            tr = PKG[pkg][3]
            _Handler.script = {"/a/f1.txt": [429, 503], "/a/f2.txt": [503],
                               "/forbidden": [403]}
            _Handler.hits = {}
            f = tr.HttpFetcher(tr.FetchPolicy(retries=3, backoff_factor=0.0,
                                              timeout=10.0))
            got = {}
            for name in ("f0.txt", "f1.txt", "f2.txt", "f3.txt", "none"):
                r = f.get(f"{base}/a/{name}")
                got[name] = None if r is None else (r.status, r.content)
            with pytest.raises(Exception, match="403") as ei:
                f.get(f"{base}/forbidden")
            got["403_retried"] = getattr(ei.value, "no_retry", False)
            results[pkg] = (got, dict(_Handler.hits))
    finally:
        server.shutdown()
        server.server_close()
    assert results["torch"] == results["jax"]
    got, hits = results["torch"]
    assert got["f1.txt"][1] == bytes(range(50, 100)) and got["none"] is None
    assert hits["/a/f1.txt"] == 3 and hits["/forbidden"] == 1


def test_collect_under_http_faults_matches_fault_free(tmp_path):
    """The GCS pager through HttpFetcher under >= 3 injected faults of
    each kind writes the fault-free run's bytes, and JAX's."""
    from tse1m_tpu.collect.gcs_metadata import GcsMetadataCollector as JG
    from tse1m_tpu_torch.collect.gcs_metadata import (API_URL_TEMPLATE,
                                                      GcsMetadataCollector)

    url = API_URL_TEMPLATE.format(bucket="oss-fuzz-gcb-logs")
    uuid = "0f8b9a2c-1111-2222-3333-44445555666"

    def page(items, token):
        return json.dumps({"items": items, **(
            {"nextPageToken": token} if token else {})}).encode()

    items1 = [{"name": f"log-{uuid}{d}.txt", "selfLink": "s", "mediaLink":
               "m", "size": "1", "timeCreated": "t"} for d in "012"]
    items2 = [{"name": f"log-{uuid}{d}.txt", "selfLink": "s", "mediaLink":
               None, "size": "2", "timeCreated": "t"} for d in "345"]
    pages = {url: page(items1, "tok2"),
             url + "?pageToken=tok2": page(items2, None)}

    def run(cls, tr, sub, plan=None):
        fetcher = tr.HttpFetcher(tr.FetchPolicy(retries=4,
                                                backoff_factor=0.0),
                                 session=_UrlSession(pages))
        coll = cls(fetcher, str(tmp_path / sub / "batches"))
        final = str(tmp_path / sub / "meta.csv")
        if plan:
            with plan.active():
                n = coll.collect(final)
        else:
            n = coll.collect(final)
        return n, open(final, "rb").read()

    clean = run(GcsMetadataCollector, ttr, "clean")
    assert clean == run(JG, jtr, "jax")
    for kind in ("raise", "connection_drop", "delay"):
        plan = tres.FaultPlan([tres.FaultRule(site="http.fetch", times=3,
                                              kind=kind, delay_s=0.01)])
        assert run(GcsMetadataCollector, ttr, kind, plan) == clean
        assert len(plan.fired) == (2 if kind == "delay" else 3)


# -- the study database -------------------------------------------------------

def _db(tmp_path, name="r.sqlite", **kw):
    from tse1m_tpu_torch.db.connection import DB

    return DB(config=Config(engine="sqlite", sqlite_path=str(tmp_path / name),
                            **kw)).connect()


@pytest.mark.parametrize("kind", ["raise", "connection_drop", "delay"])
def test_db_execute_survives_transient_faults(tmp_path, kind):
    db = _db(tmp_path)
    db.execute("CREATE TABLE t (x INTEGER)")
    db.commit()
    before = db.connection
    plan = tres.FaultPlan([tres.FaultRule(site="db.execute", times=3,
                                          kind=kind, delay_s=0.01)])
    with plan.active():
        db.executeMany("INSERT INTO t VALUES (?)", [(i,) for i in range(5)])
        rows = db.query("SELECT COUNT(*) FROM t")
    assert rows == [(5,)]
    assert len(plan.fired) == (2 if kind == "delay" else 3)
    assert (db.connection is not before) == (kind == "connection_drop")
    db.closeConnection()


@pytest.mark.parametrize("kind", ["raise", "connection_drop"])
def test_db_connect_is_retried(tmp_path, kind):
    from tse1m_tpu_torch.db.connection import DB

    plan = tres.FaultPlan([tres.FaultRule(site="db.connect", times=2,
                                          kind=kind)])
    with plan.active():
        db = DB(config=Config(engine="sqlite",
                              sqlite_path=str(tmp_path / "c.sqlite"),
                              db_retry_base_delay=0.0)).connect()
    assert len(plan.fired) == 2 and db.query("SELECT 1") == [(1,)]
    db.closeConnection()


def test_db_reference_surface_and_errors(tmp_path):
    import sqlite3 as sq

    from tse1m_tpu_torch.db.connection import is_disconnect, is_transient

    db = _db(tmp_path, db_statement_timeout_ms=1234)
    (ms,) = db.connection.execute("PRAGMA busy_timeout").fetchone()
    assert ms == 1234
    db.executeQuery("insert", "CREATE TABLE t (a INTEGER, b TEXT)")
    db.executeValues("INSERT INTO t (a, b) VALUES ?", [(1, "x"), (2, "y")])
    db.executeValues("INSERT INTO t (a, b) VALUES ?", [])
    assert db.executeQuery("select", "SELECT a, b FROM t ORDER BY a") == \
        [(1, "x"), (2, "y")]
    with pytest.raises(sq.OperationalError):
        db.query("SELECT * FROM definitely_missing_table")
    db.closeConnection()
    assert db.connection is None
    assert is_disconnect(ConnectionResetError()) and is_transient(
        sq.OperationalError("database is locked"))
    assert not is_transient(sq.OperationalError("no such table: x"))
    from tse1m_tpu.db.connection import is_transient as j_is_transient

    for e in (OSError("broken pipe"), ValueError("x"),
              sq.ProgrammingError("Cannot operate on a closed database."),
              sq.DatabaseError("disk I/O error")):
        assert is_transient(e) == j_is_transient(e)


def test_db_open_caller_transaction_is_not_silently_retried(tmp_path):
    db = _db(tmp_path)
    db.execute("CREATE TABLE t (x INTEGER)")
    db.commit()
    db.execute("INSERT INTO t VALUES (1)")   # opens a caller transaction
    plan = tres.FaultPlan([tres.FaultRule(site="db.execute", times=1)])
    with plan.active():
        with pytest.raises(tres.InjectedFault):
            db.execute("INSERT INTO t VALUES (2)")
    db.rollback()
    assert db.query("SELECT COUNT(*) FROM t") == [(0,)]
    db.closeConnection()


def test_derive_projects_retries_the_whole_unit(tmp_path):
    from tse1m_tpu_torch.db.ingest import derive_projects
    from tse1m_tpu_torch.db.schema import create_schema

    db = _db(tmp_path)
    create_schema(db)
    db.executeMany(
        "INSERT INTO buildlog_data (name, project, timecreated, build_type,"
        " result) VALUES (?, ?, ?, ?, ?)",
        [(f"n{i}", f"p{i}", "2024-01-01", "Fuzzing", "Finish")
         for i in range(3)])
    derive_projects(db)
    plan = tres.FaultPlan([tres.FaultRule(site="db.execute", times=1,
                                          after_calls=1)])
    with plan.active():
        derive_projects(db)
    assert plan.fired == [("db.execute", "raise")]
    assert db.query("SELECT project_name FROM projects ORDER BY 1") == \
        [("p0",), ("p1",), ("p2",)]
    db.closeConnection()


def _dump(path) -> dict:
    with sqlite3.connect(path) as conn:
        return {t: sorted(conn.execute(f"SELECT * FROM {t}").fetchall(),
                          key=repr)
                for t in ("projects", "project_info", "buildlog_data",
                          "total_coverage", "issues")}


def test_ingest_under_db_faults_matches_fault_free_and_jax(tmp_path):
    from tse1m_tpu.db.connection import DB as JDB
    from tse1m_tpu.db.ingest import ingest_csv_dir as j_ingest
    from tse1m_tpu_torch.data.synth import SynthSpec, generate_study
    from tse1m_tpu_torch.db.ingest import ingest_csv_dir

    csv_dir = str(tmp_path / "csv")
    generate_study(SynthSpec(n_projects=3, days=40, seed=5)).to_csv_dir(
        csv_dir)
    clean = _db(tmp_path, "clean.sqlite")
    clean_counts = ingest_csv_dir(clean, csv_dir)
    clean.closeConnection()
    faulty = _db(tmp_path, "faulty.sqlite")
    plan = tres.FaultPlan([
        tres.FaultRule(site="db.execute", times=2),
        tres.FaultRule(site="db.execute", times=1, kind="connection_drop",
                       after_calls=4),
        tres.FaultRule(site="db.execute", times=1, kind="delay",
                       after_calls=6, delay_s=0.01)])
    with plan.active():
        assert ingest_csv_dir(faulty, csv_dir) == clean_counts
    faulty.closeConnection()
    assert len(plan.fired) >= 4
    jdb = JDB(config=JConfig(engine="sqlite", sqlite_path=str(
        tmp_path / "jax.sqlite"))).connect()
    j_ingest(jdb, csv_dir)
    jdb.closeConnection()
    assert _dump(tmp_path / "faulty.sqlite") == _dump(
        tmp_path / "clean.sqlite") == _dump(tmp_path / "jax.sqlite")


def test_restore_insert_dump_survives_db_faults(tmp_path):
    from tse1m_tpu_torch.db.restore import restore_sql_dump

    dump = tmp_path / "dump.sql"
    dump.write_text("\n".join(
        "INSERT INTO buildlog_data (name, project, timecreated, build_type,"
        f" result) VALUES ('n{i}', 'p', '2024-01-01', 'Fuzzing', 'Finish');"
        for i in range(6)) + "\n")
    clean_db = _db(tmp_path, "clean.sqlite")
    clean = restore_sql_dump(clean_db, str(dump))
    clean_db.closeConnection()
    faulty_db = _db(tmp_path, "faulty.sqlite")
    plan = tres.FaultPlan([
        tres.FaultRule(site="db.execute", times=2, after_calls=9),
        tres.FaultRule(site="db.execute", times=1, kind="connection_drop",
                       after_calls=14)])
    with plan.active():
        faulty = restore_sql_dump(faulty_db, str(dump))
    faulty_db.closeConnection()
    assert len(plan.fired) >= 3 and faulty == clean
    assert _dump(tmp_path / "faulty.sqlite") == _dump(
        tmp_path / "clean.sqlite")


# -- the CSV checkpointer -----------------------------------------------------

def test_csv_checkpointer_survives_torn_writes_as_jax(tmp_path):
    from tse1m_tpu.collect.checkpoint import CsvBatchCheckpointer as J
    from tse1m_tpu_torch.collect.checkpoint import CsvBatchCheckpointer as T

    def run(cls, directory, plan=None):
        ck = cls(str(directory), "b", batch_size=3, fieldnames=["id", "v"])
        final = str(directory / "final.csv")
        if plan:
            with plan.active():
                for i in range(10):
                    ck.add({"id": i, "v": f"row{i}"})
                ck.merge(final)
        else:
            for i in range(10):
                ck.add({"id": i, "v": f"row{i}"})
            ck.merge(final)
        return open(final, "rb").read()

    clean = run(T, tmp_path / "clean")
    plan = tres.FaultPlan([
        tres.FaultRule(site="checkpoint.csv.flush", times=2,
                       kind="torn_write"),
        tres.FaultRule(site="checkpoint.csv.flush", times=1, after_calls=3)])
    assert run(T, tmp_path / "faulty", plan) == clean
    assert len(plan.fired) >= 3
    assert run(J, tmp_path / "jax") == clean


_CSV_DRIVER = """
import sys
from tse1m_tpu_torch.collect.checkpoint import (CsvBatchCheckpointer,
                                                processed_ids_from_csvs)
d, final = sys.argv[1], sys.argv[2]
done = processed_ids_from_csvs(d, id_column="id")
ck = CsvBatchCheckpointer(d, "chaos", batch_size=7,
                          fieldnames=["id", "value"])
for i in range(40):
    if i not in done:
        ck.add({"id": i, "value": f"v{i * i}"})
ck.merge(final)
"""


def _driver(args, plan=None):
    env = dict(os.environ)
    env.pop("TSE1M_FAULT_PLAN", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if plan:
        env["TSE1M_FAULT_PLAN"] = plan
    return subprocess.run([sys.executable, "-c", _CSV_DRIVER, *args],
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_csv_checkpointer_sigkill_resume_equals_uninterrupted(tmp_path):
    import signal

    clean_final = str(tmp_path / "clean.csv")
    assert _driver([str(tmp_path / "clean"), clean_final]).returncode == 0
    plan = str(tmp_path / "plan.json")
    tres.FaultPlan([tres.FaultRule(site="checkpoint.csv.flush", kind="kill",
                                   after_calls=2)]).save(plan)
    chaos_dir = str(tmp_path / "chaos")
    chaos_final = str(tmp_path / "chaos.csv")
    proc = _driver([chaos_dir, chaos_final], plan)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-2000:]
    assert not os.path.exists(chaos_final)
    assert len(glob.glob(os.path.join(chaos_dir, "chaos_batch_*.csv"))) == 2
    assert glob.glob(os.path.join(chaos_dir, "*.tmp"))
    assert _driver([chaos_dir, chaos_final]).returncode == 0
    assert open(chaos_final, "rb").read() == open(clean_final, "rb").read()
    pd.testing.assert_frame_equal(pd.read_csv(chaos_final),
                                  pd.read_csv(clean_final))
    assert not glob.glob(os.path.join(chaos_dir, "*.tmp"))


# -- `all` under transient database faults ------------------------------------

def _cli(args, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("TSE1M_FAULT_PLAN", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", "tse1m_tpu_torch", *args],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=600)


def test_cli_all_under_transient_db_faults_matches_fault_free(tmp_path):
    db = str(tmp_path / "s.sqlite")
    corpus = str(tmp_path / "corpus.csv")
    env = {"TSE1M_CORPUS_CSV": corpus, "TSE1M_ENVFILE": "",
           "TSE1M_BACKEND": "jax_tpu", "TSE1M_ROUTER_CAL": ""}
    proc = _cli(["synth", "--db", db, "--projects", "8", "--days", "400",
                 "--seed", "4"], env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    plan = str(tmp_path / "plan.json")
    with open(plan, "w") as f:
        json.dump({"seed": 1, "rules": [
            {"site": "db.execute", "times": 3},
            {"site": "db.connect", "times": 1, "kind": "connection_drop",
             "after_calls": 1}]}, f)
    outs = {}
    for name, extra in (("clean", {}), ("faulty", {
            "TSE1M_FAULT_PLAN": plan, "TSE1M_RETRY_BASE_DELAY": "0.01"})):
        out = str(tmp_path / name)
        proc = _cli(["all", "--db", db, "--result-dir", out, "--device",
                     "cpu", "--corpus-csv", corpus], {**env, **extra})
        assert proc.returncode == 0, (proc.stdout[-2000:],
                                      proc.stderr[-2000:])
        with open(os.path.join(out, "run_manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["ok"] is True
        assert all(s["status"] == "ok" for s in manifest["steps"])
        outs[name] = {os.path.relpath(p, out): open(p, "rb").read()
                      for p in glob.glob(os.path.join(out, "**", "*.csv"),
                                         recursive=True)}
    assert outs["faulty"] == outs["clean"] and len(outs["clean"]) >= 6


# -- the lint's transport seat ------------------------------------------------

_URLOPEN = ("import time\nimport urllib.request\n\n\n"
            "def fetch(url):\n"
            "    return urllib.request.urlopen(url, timeout=5)\n\n\n"
            "def stamp():\n"
            "    return time.time()\n")


@pytest.mark.parametrize("relpath,flagged", [
    ("tse1m_tpu_torch/collect/transport.py", False),
    ("tse1m_tpu_torch/collect/coverage.py", True),
    ("tse1m_tpu_torch/analysis/fixture.py", True),
    ("tse1m_tpu_torch/serve/client.py", True)])
def test_lint_flags_urlopen_outside_the_transport(tmp_path, relpath,
                                                  flagged):
    """The transport's urlopen is the port's counterpart of JAX's
    transport's requests: exempt there, flagged anywhere else, as JAX's
    rule treats ``requests``."""
    from tse1m_tpu.lint import engine as jengine
    from tse1m_tpu.lint.rules import RULES as JRULES
    from tse1m_tpu_torch.lint import engine as tengine
    from tse1m_tpu_torch.lint.rules import RULES as TRULES

    path = tmp_path / "m.py"
    path.write_text(_URLOPEN)
    src = tengine.load_source(str(path), relpath)
    got = [f.line for f in TRULES["retry-bypass"](src)]
    assert got == ([6] if flagged else [])
    # JAX's rule flags urlopen in every file, its transport's too.
    jsrc = jengine.load_source(str(path), relpath.replace(
        "tse1m_tpu_torch", "tse1m_tpu"))
    assert [f.line for f in JRULES["retry-bypass"](jsrc)] == [6]
    # collect/ is a replay plane: its wall-clock reads are findings there.
    clock = [f.line for f in TRULES["nondeterminism"](src)]
    assert clock == ([10] if relpath.startswith("tse1m_tpu_torch/collect/")
                     else [])


def test_the_ports_seat_inventory_lists_the_io_seats():
    from tse1m_tpu_torch.resilience.fault_matrix import PRODUCTION_SEATS
    from tests.ci_fault_matrix import PRODUCTION_SEATS as JSEATS

    for seat in ("http.fetch", "db.connect", "db.execute",
                 "checkpoint.csv.flush"):
        assert PRODUCTION_SEATS[seat]["kinds"] == JSEATS[seat]["kinds"]
        assert "test_torch_io_resilience.py" in \
            PRODUCTION_SEATS[seat]["covered_by"]
