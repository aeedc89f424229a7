"""tse1m_tpu_torch's serving transport: the wire bytes against the JAX
package's, a TCP round trip of every verb, each package's client driving
the other's server to the same answers (trace ids and timings masked),
the trace envelope crossing between them, and the ``serve`` and
``serve-client`` commands (``serve --status`` recorded in
``run_manifest.json``, as ``tests/test_serve.py`` checks for JAX).
Tolerance: exact."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.observability import metrics as jmetrics
from tse1m_tpu.observability import profiling as jprofiling
from tse1m_tpu.observability import tracing as jtracing
from tse1m_tpu.serve import ServeClient as JClient
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu.serve import ServeServer as JServer
from tse1m_tpu.serve import server as jserver
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.observability import metrics as tmetrics
from tse1m_tpu_torch.observability import profiling as tprofiling
from tse1m_tpu_torch.observability import tracing as ttracing
from tse1m_tpu_torch.serve import ServeClient, ServeDaemon, ServeError
from tse1m_tpu_torch.serve import ServeServer
from tse1m_tpu_torch.serve import server as tserver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JP = JParams(n_hashes=32, n_bands=4, use_pallas="never")
TP = TParams(n_hashes=32, n_bands=4)
# Keys whose values are times, trace ids or timing-dependent tallies.
VOLATILE = ("trace", "qps", "slow_requests_total", "query_slo_violations")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    yield
    jflight._flight_dir, tflight._flight_dir = saved


def _items(n, seed):
    return synth_session_sets(n, set_size=32, seed=seed)[0]


def _mask(obj):
    if isinstance(obj, dict):
        return {k: _mask(v) for k, v in obj.items()
                if k not in VOLATILE and not k.endswith(("_ms", "_qps"))}
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    return obj


def _serve(server):
    th = threading.Thread(target=server.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    return th


def test_wire_bytes_match_jax():
    v = _items(5, 1)
    assert tserver.encode_vectors(v) == jserver.encode_vectors(v)
    msg = {"op": "ingest", "request_id": "ab", **tserver.encode_vectors(v)}
    for write, read in ((tserver.write_msg, jserver.read_msg),
                        (jserver.write_msg, tserver.read_msg)):
        a, b = socket.socketpair()
        with a, b:
            write(a, msg)
            got = read(b)
        assert got == msg
        assert np.array_equal(tserver.decode_vectors(got), v)
    a, b = socket.socketpair()
    with a, b:
        tserver.write_msg(a, msg)
        raw_t = b.recv(1 << 20)
        jserver.write_msg(a, msg)
        assert b.recv(1 << 20) == raw_t
    assert raw_t[:4] == len(raw_t[4:]).to_bytes(4, "big")
    lists = {"vectors": v.tolist()}
    assert np.array_equal(tserver.decode_vectors(lists),
                          jserver.decode_vectors(lists))
    bad = {**tserver.encode_vectors(v), "shape": [6, 32]}
    for decode in (tserver.decode_vectors, jserver.decode_vectors):
        with pytest.raises(ValueError, match="needs"):
            decode(bad)


def test_every_verb_over_tcp(tmp_path):
    items = _items(300, 2)
    tflight.set_flight_dir(str(tmp_path / "flight"))
    d = ServeDaemon(str(tmp_path / "s"), params=TP, device="cpu").start()
    server = ServeServer(d)
    _serve(server)
    try:
        with ServeClient(port=server.port) as c:
            assert c.ping()["rows"] == 0
            ack = c.ingest(items, timeout_s=300)
            assert ack["ok"] and ack["acked"] == 300
            q = c.query(items[:10])
            assert q["known"].all() and q["labels"].dtype == np.int64
            assert np.array_equal(q["labels"],
                                  d.query(items[:10])["labels"])
            for mode in ("candidates", "scan"):
                r = c.topk(items[:3], k=4, mode=mode)
                assert r["scores"].shape == (3, 4)
                assert r["scores"][0, 0] == TP.n_hashes
                assert len(r["ids"][0][0]) == 32
            with pytest.raises(ServeError, match="unknown topk mode"):
                c.topk(items[:1], k=3, mode="bogus")
            assert c.quiesce()["ok"]
            st = c.status()
            assert st["rows"] == 300 and st["uncommitted_generations"] == 0
            assert st["latency_by_verb"]["topk"]["count"] == 2
            assert st["serve_ingest_count"] == 1
            m = c.metrics()
            assert "# TYPE serve_store_rows gauge" in m["prometheus"]
            assert m["metrics"]["metrics_serve_store_rows"] == d.store.n_rows
            tr = c.trace(5)
            assert len(tr["spans"]) == 5 and tr["spans_recorded"] >= 5
            assert {"slow_requests", "slow_requests_total"} <= set(
                c.slowlog(3))
            prof = c.profile(dump=True)
            assert os.path.isfile(prof["profile_path"])
            assert os.path.dirname(prof["profile_path"]) == str(
                tmp_path / "flight")
            with pytest.raises(ServeError, match="unknown op"):
                c.request("nope")
            assert c.shutdown()["ok"]
    finally:
        server.server_close()
        d.stop()


def test_each_package_drives_the_others_server(tmp_path):
    """A port client against a JAX server and a JAX client against a port
    server, the same requests: the same answers, trace ids and timings
    masked; each response echoes the client's trace id."""
    items, more = _items(400, 3), _items(100, 4)
    # Lock waits an earlier test in this process recorded but never
    # folded would surface in one server's status: fold them, then reset.
    tprofiling.flush_lock_waits()
    jprofiling.flush_lock_waits()
    tmetrics.reset_metrics()
    jmetrics.reset_metrics()
    td = ServeDaemon(str(tmp_path / "t"), params=TP, device="cpu").start()
    jd = JDaemon(str(tmp_path / "j"), params=JP).start()
    ts, js = ServeServer(td), JServer(jd)
    _serve(ts)
    _serve(js)
    answers = {}
    try:
        for name, client, span, current in (
                ("port->jax", ServeClient(port=js.port), ttracing.span,
                 ttracing.current_trace),
                ("jax->port", JClient(port=ts.port), jtracing.span,
                 jtracing.current_trace)):
            out = []
            with client as c, span("test.drive"):
                trace = current()["t"]
                out.append(c.ping())
                out.append(c.ingest(items, timeout_s=300,
                                    request_id="r1"))
                out.append(c.ingest(items, timeout_s=300,
                                    request_id="r1"))  # a replay
                out.append(c.ingest(more, timeout_s=300))
                out.append(c.query(np.concatenate([items[:20],
                                                   _items(5, 9)])))
                for mode in ("candidates", "scan"):
                    out.append(c.topk(items[::40], k=6, mode=mode))
                out.append(c.quiesce())
                out.append(c.status())
                assert all(r["trace"] == trace for r in out)
                kinds = {op: set(getattr(c, op)()) for op in (
                    "metrics", "trace", "slowlog", "profile")}
                c.shutdown()
            answers[name] = ([_mask(r) for r in out], kinds)
        (a, ka), (b, kb) = answers["port->jax"], answers["jax->port"]
        for i, (ra, rb) in enumerate(zip(a, b)):
            for key in sorted(set(ra) | set(rb)):
                if (i, key) != (2, "rows"):
                    assert ra.get(key) == rb.get(key), (i, key)
        assert len(a) == len(b) and ka == kb
        assert answers["port->jax"][0][2]["replayed"] is True
        # The replay's rows: the port's server names the rows the original
        # ack named; JAX's names each row's first index row of its content,
        # which differs where the batch repeats content, as this one does.
        assert b[2]["rows"] == b[1]["rows"] == a[1]["rows"]
        assert a[2]["rows"] != a[1]["rows"]
        # The server's span joined the client's trace as its child.
        spans = [s for s in ttracing.recent_spans()
                 if s["name"] == "serve.quiesce"]
        assert spans and spans[-1]["parent"]
    finally:
        ts.server_close()
        js.server_close()
        td.stop()
        jd.stop()


def test_serve_status_records_the_manifest(tmp_path, monkeypatch):
    items = _items(120, 14)
    d = ServeDaemon(str(tmp_path / "s"), params=TP, device="cpu").start()
    server = ServeServer(d)
    _serve(server)
    result_dir = tmp_path / "results"
    monkeypatch.setenv("TSE1M_RESULT_DIR", str(result_dir))
    try:
        d.ingest(items, timeout=300)
        assert cli_main(["serve", "--status", "--port",
                         str(server.port)]) == 0
        manifest = json.loads((result_dir / "run_manifest.json").read_text())
        steps = {s["name"]: s for s in manifest["steps"]}
        assert steps["serve_status"]["status"] == "ok"
        res = steps["serve_status"]["result"]
        assert res["rows"] == 120
        assert "generation" in res and "queue_depth" in res
        assert "last_scrub" in res and "latency_by_verb" in res
    finally:
        server.shutdown()
        server.server_close()
        d.stop()
    # No daemon there any more: a failed step, exit 1.
    assert cli_main(["serve", "--status", "--port",
                     str(server.port)]) == 1
    manifest = json.loads((result_dir / "run_manifest.json").read_text())
    assert manifest["steps"][-1]["status"] == "failed"
    # Shard mode runs; --range without --root is refused as the JAX
    # package refuses it (tse1m_tpu/cli.py:914-917).
    assert cli_main(["serve", "--range", "0"]) == 2


def test_serve_command_end_to_end(tmp_path, capsys):
    """``python -m tse1m_tpu_torch serve --device cpu`` in its own
    process, driven by ``serve-client``: ingest, query, topk, shutdown."""
    items = _items(200, 15)
    npy = tmp_path / "v.npy"
    np.save(npy, items)
    port_file = tmp_path / "serve.port"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "tse1m_tpu_torch", "serve", "--sig-store",
         str(tmp_path / "s"), "--port-file", str(port_file), "--device",
         "cpu"], env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    try:
        deadline = time.monotonic() + 120
        while not port_file.exists() and time.monotonic() < deadline:
            assert proc.poll() is None, proc.stdout.read().decode()
            time.sleep(0.1)
        pf = ["--port-file", str(port_file)]
        capsys.readouterr()
        assert cli_main(["serve-client", "ingest", "--npy", str(npy),
                         *pf]) == 0
        assert json.loads(capsys.readouterr().out)["acked"] == 200
        assert cli_main(["serve-client", "query", "--npy", str(npy),
                         *pf]) == 0
        assert all(json.loads(capsys.readouterr().out)["known"])
        assert cli_main(["serve-client", "topk", "--npy", str(npy), "--k",
                         "2", "--mode", "scan", *pf]) == 0
        top = json.loads(capsys.readouterr().out)
        assert [r[0] for r in top["scores"]] == [128] * 200  # full agreement
        assert cli_main(["serve-client", "shutdown", *pf]) == 0
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
    # The store holds the acked rows and the state the stop committed.
    assert (tmp_path / "s" / "state.json").exists()
