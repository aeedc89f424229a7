"""tse1m_tpu_torch's serving daemon (``serve.ServeDaemon`` on the CPU,
through the kernels' plain versions) against the JAX package's daemon
(``use_pallas="never"``) and against cold batch runs: the same ingest
batches give the same acks, post-quiesce labels and store bytes; restart
with and without the committed state; each package opens the other's
store; a ``request_id`` replay; concurrent ingest and queries; the query
path launching nothing; admission control, the SLO counter and request
budgets against JAX's; no card, no daemon; an ingest batch's torch calls
not growing with the set width.  Also the kernel launch counters under
several threads, and no module but ``kernels/_count.py`` changing them.
Mirrors ``tests/test_serve.py``.  Tolerance: exact (acks, labels,
counters and file bytes)."""

import ast
import filecmp
import os
import sys
import threading

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.cluster import cluster_sessions as jcluster
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.observability import metrics as jmetrics
from tse1m_tpu.resilience import watchdog as jwatchdog
from tse1m_tpu.serve import IngestRejected as JRejected
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu.serve import SloPolicy as JSlo
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster import kernels
from tse1m_tpu_torch.cluster.kernels import _count
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.cluster.pipeline import cluster_sessions as tcluster
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.observability import metrics as tmetrics
from tse1m_tpu_torch.observability import peek_degradation_events
from tse1m_tpu_torch.resilience import watchdog as twatchdog
from tse1m_tpu_torch.serve import IngestRejected, ServeDaemon, SloPolicy

JP = JParams(n_hashes=32, n_bands=4, use_pallas="never")
TP = TParams(n_hashes=32, n_bands=4)
ACK_KEYS = ("ok", "acked", "novel", "generation", "labels", "rows")


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Each test leaves the process as it found it: the daemons write
    TSE1M_LIVE_DELTA_RUNS and adopt a flight directory."""
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    yield
    jflight._flight_dir, tflight._flight_dir = saved


def _items(n=600, seed=3, set_size=64):
    return synth_session_sets(n, set_size=set_size, seed=seed)[0]


def _port(path, **kw):
    return ServeDaemon(str(path), params=TP, device="cpu", **kw)


def _jax(path, **kw):
    return JDaemon(str(path), params=JP, **kw)


def _same_dir(a, b):
    """The two trees hold the same names and the same bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _same_dir(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name


def _ack(resp):
    return {k: resp.get(k) for k in ACK_KEYS}


def _feed(daemons, items, batch, rids=None):
    """The same batches into each daemon; returns each one's acks."""
    acks = [[] for _ in daemons]
    for i, lo in enumerate(range(0, items.shape[0], batch)):
        rid = None if rids is None else f"{rids}-{i}"
        for d, out in zip(daemons, acks):
            out.append(_ack(d.ingest(items[lo:lo + batch], timeout=300,
                                     request_id=rid)))
    return acks


def test_acks_and_labels_match_jax_and_cold(tmp_path):
    items = _items(600)
    t, j = _port(tmp_path / "t").start(), _jax(tmp_path / "j").start()
    try:
        tacks, jacks = _feed((t, j), items, 150)
        assert tacks == jacks
        assert [a["acked"] for a in tacks] == [150] * 4
        assert t.quiesce(timeout=300)["generation"] == 4
        j.quiesce(timeout=300)
        tq, jq = t.query(items), j.query(items)
        assert tq["known"].all() and jq["known"].all()
        assert np.array_equal(tq["labels"], jq["labels"])
        assert np.array_equal(tq["labels"], tcluster(items, TP,
                                                     device="cpu"))
        assert np.array_equal(jq["labels"], jcluster(items, JP))
        # Novel vectors (host MinHash, band probe, exact verification).
        nov = _items(40, seed=97)
        nov[:8] = items[:8]
        nov[8:16, :3] = 7  # near copies of stored rows
        nov[8:16, 3:] = items[8:16, 3:]
        tn, jn = t.query(nov), j.query(nov)
        assert np.array_equal(tn["labels"], jn["labels"])
        assert np.array_equal(tn["known"], jn["known"])
        assert tn["generation"] == jn["generation"]
    finally:
        t.stop()
        j.stop()


def test_store_directories_equal_byte_for_byte(tmp_path):
    items = _items(500, seed=4)
    t = _port(tmp_path / "t", state_commit_every=2).start()
    j = _jax(tmp_path / "j", state_commit_every=2).start()
    try:
        _feed((t, j), items, 100, rids="batch")
        for d in (t, j):
            d.quiesce(timeout=300)
    finally:
        t.stop()
        j.stop()
    _same_dir(tmp_path / "t", tmp_path / "j")


def test_restart_with_state_and_recovery_without(tmp_path):
    items = _items(400, seed=11)
    # With the state: a clean stop commits it, a restart adopts it.
    t = _port(tmp_path / "a").start()
    _feed((t,), items, 100)
    t.stop()
    again = _port(tmp_path / "a")
    res = again.query(items)
    assert res["known"].all()
    assert np.array_equal(res["labels"], tcluster(items, TP, device="cpu"))
    # Without it: acked rows come back from the store's shards, as JAX's
    # recovery brings them back.
    t = _port(tmp_path / "t", state_commit_every=10**6).start()
    j = _jax(tmp_path / "j", state_commit_every=10**6).start()
    _feed((t, j), items, 100)
    t.stop(commit=False)
    j.stop(commit=False)
    tr, jr = _port(tmp_path / "t"), _jax(tmp_path / "j")
    assert tr.status()["rows"] == jr.status()["rows"] == 400
    tq, jq = tr.query(items), jr.query(items)
    assert tq["known"].all()
    assert np.array_equal(tq["labels"], jq["labels"])


def test_each_package_opens_the_others_store(tmp_path):
    items = _items(600, seed=6)
    j = _jax(tmp_path / "s").start()
    _feed((j,), items[:300], 100)
    j.stop()
    t = _port(tmp_path / "s").start()
    assert t.status()["rows"] == 300
    assert np.array_equal(t.query(items[:300])["labels"],
                          jcluster(items[:300], JP))
    _feed((t,), items[300:], 150)
    t.stop()
    j2 = _jax(tmp_path / "s")
    res = j2.query(items)
    assert res["known"].all()
    assert np.array_equal(res["labels"], tcluster(items, TP, device="cpu"))


def test_request_id_replay_matches_jax(tmp_path):
    items = _items(300, seed=8)
    t, j = _port(tmp_path / "t").start(), _jax(tmp_path / "j").start()
    try:
        first = _feed((t, j), items[:200], 200, rids="once")
        rows_before = t.store.n_rows
        again = _feed((t, j), items[:200], 200, rids="once")
        assert again[0] == again[1]
        assert t.ingest(items[:200], request_id="once-0")["replayed"]
        assert again[0][0]["acked"] == first[0][0]["acked"] == 200
        assert t.store.n_rows == rows_before
        assert t.status()["rows"] == j.status()["rows"] == 200
        assert "serve_ingest_replayed" in [
            e["kind"] for e in peek_degradation_events()]
    finally:
        t.stop()
        j.stop()


def test_concurrent_ingest_and_query(tmp_path):
    """Queries during ingest: an acked row is always known, and a label
    seen mid-ingest is a hub of the row's final cluster; after quiesce
    the labels are a cold run's element for element."""
    items = _items(800, seed=5)
    t = _port(tmp_path / "t").start()
    acked = [0]
    observed, errors = [], []
    done = threading.Event()

    first = threading.Event()

    def querier():
        rng = np.random.default_rng(17)
        first.wait(120)
        try:
            # A short pause between queries.  Two query threads that never
            # block hand the GIL to each other, and the ingest thread waits
            # seconds at each release of it (a torch op, a file open): an
            # 80-row batch then takes minutes in either package.  JAX's
            # test spins, but under its lockset tracer, which slows its
            # queries.
            while not done.wait(0.002):
                hi = acked[0]
                i = int(rng.integers(0, hi))
                res = t.query(items[i:i + 1])
                if not res["known"][0]:
                    raise AssertionError(f"acked row {i} unknown")
                observed.append((i, int(res["labels"][0])))
        except Exception as e:  # noqa: BLE001 - relayed below
            errors.append(e)

    threads = [threading.Thread(target=querier) for _ in range(2)]
    try:
        for th in threads:
            th.start()
        for lo in range(0, 800, 80):
            t.ingest(items[lo:lo + 80], timeout=120)
            acked[0] = lo + 80
            first.set()
        t.quiesce(timeout=120)
    finally:
        done.set()
        for th in threads:
            th.join(timeout=60)
        t.stop()
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[0]
    assert observed
    final = t.query(items)["labels"]
    assert np.array_equal(final, tcluster(items, TP, device="cpu"))
    for i, lab in observed:
        assert int(final[i]) <= lab
        assert final[lab] == final[i]


def test_query_path_launches_nothing(tmp_path, monkeypatch):
    """``query`` and ``topk(mode="candidates")`` are host only: with the
    novel-row signer, the scan and every kernel wrapper made to raise,
    they still answer, and no launch is counted."""
    items = _items(300, seed=9)
    t = _port(tmp_path / "t").start()
    try:
        t.ingest(items, timeout=300)
        t.quiesce(timeout=300)

        def forbidden(*a, **k):
            raise AssertionError("device work on the query path")

        from tse1m_tpu_torch.cluster.kernels import _build

        wrappers = {id(w) for w in kernels._WRAPPERS}
        for name, mod in list(sys.modules.items()):
            if not name.startswith("tse1m_tpu_torch") or mod is None:
                continue
            for attr, val in list(vars(mod).items()):
                if id(val) in wrappers or attr in ("minhash_novel_rows",
                                                   "bulk_topk_store"):
                    monkeypatch.setattr(mod, attr, forbidden)
        monkeypatch.setattr(_build, "load_extension", forbidden)
        kernels.reset_launch_counts()
        nov = _items(8, seed=997)
        assert t.query(items[:64])["known"].all()
        assert not t.query(nov)["known"].any()
        cand = t.topk(np.concatenate([items[:4], nov[:2]]), k=5)
        assert cand["scores"][0][0] == 32
        with pytest.raises(AssertionError, match="device work"):
            t.topk(items[:2], k=5, mode="scan")
        assert set(kernels.launch_counts().values()) == {0}
    finally:
        monkeypatch.undo()
        t.stop()


def test_backpressure_and_backlog_match_jax(tmp_path):
    items = _items(60, seed=21)
    tmetrics.reset_metrics()
    jmetrics.reset_metrics()
    t = _port(tmp_path / "t", slo=SloPolicy(max_backlog_batches=2))
    j = _jax(tmp_path / "j", slo=JSlo(max_backlog_batches=2))
    # Ingest threads not started: the queues can only fill.
    for d, rejected in ((t, IngestRejected), (j, JRejected)):
        d.submit(items[:20])
        d.submit(items[20:40])
        with pytest.raises(rejected) as exc:
            d.submit(items[40:])
        assert exc.value.retry_after_s > 0 and exc.value.depth == 2
    assert t.admission.stats() == j.admission.stats()
    keys = ("queue_depth", "queue_depth_hwm", "ingest_rejected_total",
            "ingest_rejected", "ingest_backlog_max", "in_backpressure",
            "rows", "generation", "uncommitted_generations")
    ts, js = t.status(), j.status()
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["ingest_rejected_total"] == 1
    assert "serve_backpressure" in [e["kind"]
                                    for e in peek_degradation_events()]
    for d in (t, j):
        d.start()
    try:
        for d in (t, j):
            d.quiesce(timeout=300)
        assert _ack(t.ingest(items[40:], timeout=300)) == _ack(
            j.ingest(items[40:], timeout=300))
        assert not t.status()["in_backpressure"]
    finally:
        t.stop()
        j.stop()


def test_slo_violation_counter_matches_jax(tmp_path):
    t = _port(tmp_path / "t", slo=SloPolicy(query_p99_target_ms=0.0))
    j = _jax(tmp_path / "j", slo=JSlo(query_p99_target_ms=0.0))
    for d in (t, j):
        d.tracker.observe_query(0.5)
        d.tracker.observe_query(0.5)
        d.tracker.observe_query(0.0)
    assert t.tracker.stats() == j.tracker.stats()
    assert t.status()["query_slo_violations"] == 2
    kinds = [e["kind"] for e in peek_degradation_events()]
    assert "serve_slo_violation" in kinds


@pytest.mark.parametrize("env", [
    {}, {"TSE1M_SERVE_QUERY_BUDGET_S": "1.5"},
    {"TSE1M_SERVE_INGEST_BUDGET_S": "0"}, {"TSE1M_WATCHDOG": "0"},
    {"TSE1M_SERVE_STATUS_BUDGET_S": "2.25", "TSE1M_WATCHDOG": "1"}])
def test_request_budgets_under_the_environment(monkeypatch, env):
    for name in ("TSE1M_WATCHDOG", "TSE1M_SERVE_QUERY_BUDGET_S",
                 "TSE1M_SERVE_INGEST_BUDGET_S", "TSE1M_SERVE_STATUS_BUDGET_S"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for cls in ("query", "ingest", "status", "other"):
        assert twatchdog.request_budget_s(cls) == \
            jwatchdog.request_budget_s(cls)
    if not env:
        assert twatchdog.request_budget_s("query") == pytest.approx(0.25)


def test_no_card_no_daemon(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeDaemon(str(tmp_path / "s"), params=TP)
    assert not (tmp_path / "s").exists()  # raised before touching it
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["serve", "--sig-store", str(tmp_path / "s")])
    assert not (tmp_path / "s").exists()


def test_launch_counts_exact_across_threads():
    """Eight threads bump every wrapper's count at once: the total is
    exact (a lost update would show as a lower count)."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    n_threads, n_bumps = 8, 2000
    kernels.reset_launch_counts()
    try:
        def bump():
            for _ in range(n_bumps):
                for w in kernels._WRAPPERS:
                    _count.count_launch(w)

        threads = [threading.Thread(target=bump) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert kernels.launch_counts() == {
            w.__name__: n_threads * n_bumps for w in kernels._WRAPPERS}
    finally:
        sys.setswitchinterval(old)
        kernels.reset_launch_counts()
    assert set(kernels.launch_counts().values()) == {0}


class _TorchCalls(TorchFunctionMode):
    """Counts the torch functions, methods and operators called under
    it."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("scheme", ["kminhash", "cminhash", "weighted"])
def test_ingest_torch_calls_independent_of_set_width(tmp_path, scheme):
    """An ingest batch makes the same number of torch calls at 16 ids a
    row as at 64.  Each call drops and retakes the GIL, and a busy request
    thread beside the ingest thread makes each retake slow, so the count
    must not grow with the set width (``tests/serve_gil_probe.py`` prints
    the walls)."""
    calls = []
    for width in (16, 64):
        items = synth_session_sets(160, set_size=width, seed=5)[0]
        t = ServeDaemon(str(tmp_path / f"{width}"), device="cpu",
                        params=TParams(n_hashes=32, n_bands=4,
                                       scheme=scheme))
        t._ingest_batch(items[:80])
        with _TorchCalls() as mode:
            ack = t._ingest_batch(items[80:])
        assert ack["novel"] > 0
        calls.append(mode.n)
    assert calls[0] == calls[1] <= 256


def test_only_the_counter_module_changes_launch_counts():
    """``kernels/_count.py`` alone bumps or resets ``<wrapper>.launches``
    (under its lock); elsewhere a module may only set the count to 0 once,
    at import, where the wrapper is defined."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    paths = [os.path.join(root, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, files in
        os.walk(os.path.join(root, "tse1m_tpu_torch"))
        for f in files if f.endswith(".py")]
    bad, inits = [], 0
    for path in paths:
        if path.endswith(os.path.join("kernels", "_count.py")):
            continue
        tree = ast.parse(open(path, encoding="utf-8").read())
        top = {id(n) for n in tree.body}
        for node in ast.walk(tree):
            targets = (node.targets if isinstance(node, ast.Assign) else
                       [node.target] if isinstance(
                           node, (ast.AugAssign, ast.AnnAssign)) else [])
            for tgt in targets:
                if not (isinstance(tgt, ast.Attribute)
                        and tgt.attr == "launches"):
                    continue
                if (id(node) in top and isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Constant)
                        and node.value.value == 0):
                    inits += 1
                else:
                    bad.append((os.path.relpath(path, root), node.lineno))
    assert bad == []
    assert inits == len(kernels._WRAPPERS)
