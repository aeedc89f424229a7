"""tse1m_tpu_torch's fan-out router (``serve/router.py``) against the JAX
package's, on the CPU.

The port's ``ShardRouter`` over two port daemons and JAX's over two JAX
daemons (``ClusterParams(n_hashes=32, n_bands=4, use_pallas="never")``,
as ``tests/test_serve_sharded.py`` runs them) take the same batches:
the acks, the labels (element for element and canonically), the index
rows and the store rows must be equal.  Then the edges (the empty batch,
a fresh router's all-foreign labels, one shard), the lost-ack window (a
dropped forward replays its ack), the request id over TCP, each
package's client against the other's router, and the rule that the
router opens no store.  Tolerance: exact."""

import ast
import os
import threading

import numpy as np
import pytest

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.resilience.faults import FaultPlan as JPlan
from tse1m_tpu.resilience.faults import FaultRule as JRule
from tse1m_tpu.resilience.faults import clear_plan as jclear
from tse1m_tpu.resilience.faults import install_plan as jinstall
from tse1m_tpu.serve import LocalTransport as JLocal
from tse1m_tpu.serve import RouterServer as JRouterServer
from tse1m_tpu.serve import ServeClient as JClient
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu.serve import ShardRouter as JRouter
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.cluster.store import digest_range_ids, row_digests
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.resilience.faults import (FaultPlan, FaultRule,
                                               clear_plan, install_plan)
from tse1m_tpu_torch.serve import (LocalTransport, RouterServer, ServeClient,
                                   ServeDaemon, ServeServer, ShardRouter,
                                   TcpTransport)
from tse1m_tpu_torch.serve.server import encode_vectors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JP = JParams(n_hashes=32, n_bands=4, use_pallas="never")
TP = TParams(n_hashes=32, n_bands=4)
N_SHARDS = 2


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    monkeypatch.delenv("TSE1M_FAULT_PLAN", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    yield
    jflight._flight_dir, tflight._flight_dir = saved
    clear_plan()
    jclear()


def _unique_vectors(n, seed=5, width=16):
    """Content-distinct random rows: the only cluster structure is the
    exact duplicates a test plants (the JAX test's helper)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, width),
                        dtype=np.int64).astype(np.uint32)


def _near_dup_vectors(n, seed):
    """Rows with near-duplicates across ranges: a base set and copies
    with one id changed, so clusters span shards."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**20, size=(n // 2, 32),
                        dtype=np.int64).astype(np.uint32)
    twins = base.copy()
    twins[:, 0] = rng.integers(2**20, 2**21, size=n // 2).astype(np.uint32)
    return np.concatenate([base, twins])[rng.permutation(n - n % 2)]


def _canon(labels):
    seen = {}
    return [seen.setdefault(int(v), len(seen)) for v in labels]


def _port_shards(tmp_path, n=N_SHARDS, tag="t"):
    return {sid: ServeDaemon(str(tmp_path / tag / f"range_{sid:04d}"),
                             params=TP, state_commit_every=1,
                             device="cpu").start()
            for sid in range(n)}


def _jax_shards(tmp_path, n=N_SHARDS, tag="j"):
    return {sid: JDaemon(str(tmp_path / tag / f"range_{sid:04d}"),
                         params=JP, state_commit_every=1).start()
            for sid in range(n)}


def _stop(daemons):
    for d in daemons.values():
        d.stop(commit=False)


def _ack(resp):
    """An ack without its volatile keys."""
    return {k: v for k, v in resp.items() if k != "trace"}


@pytest.mark.parametrize("corpus", ["exact_dups", "near_dups"])
def test_router_partition_parity_vs_jax(tmp_path, corpus):
    """The inputs of ``test_router_partition_parity_vs_single_daemon``
    (and a corpus whose clusters span the ranges) through both routers:
    the same acks, labels, index rows and store rows; the partition a
    single port daemon's."""
    if corpus == "exact_dups":
        base = _unique_vectors(40)
        items = np.concatenate([base, base[[0, 3, 7, 3]]])
    else:
        items = _near_dup_vectors(60, seed=3)
    tds, jds = _port_shards(tmp_path), _jax_shards(tmp_path)
    single = ServeDaemon(str(tmp_path / "single"), params=TP,
                         device="cpu").start()
    try:
        tr = ShardRouter({s: LocalTransport(d) for s, d in tds.items()})
        jr = JRouter({s: JLocal(d) for s, d in jds.items()})
        for lo in range(0, len(items), 16):
            t = tr.ingest(items[lo:lo + 16])
            j = jr.ingest(items[lo:lo + 16])
            assert _ack(t) == _ack(j)
            assert t["acked"] == len(items[lo:lo + 16])
            single.ingest(items[lo:lo + 16])
        tr.quiesce()
        jr.quiesce()
        single.quiesce()
        tq, jq = tr.query(items), jr.query(items)
        assert tq["known"].all() and jq["known"].all()
        np.testing.assert_array_equal(tq["labels"], jq["labels"])
        assert tq["shard_generations"] == jq["shard_generations"]
        assert _canon(tq["labels"]) == _canon(single.query(items)["labels"])
        owners = digest_range_ids(row_digests(items), N_SHARDS)
        assert len(np.unique(owners)) == N_SHARDS
        for sid in range(N_SHARDS):
            assert int(tds[sid]._index.n_rows) == int(jds[sid]._index.n_rows)
            assert int(tds[sid].store.n_rows) == int(jds[sid].store.n_rows)
        assert sum(int(d._index.n_rows) for d in tds.values()) == len(items)
        assert (sum(int(d.store.n_rows) for d in tds.values())
                == int(single.store.n_rows))
        tt, jt = tr.topk(items[:6], k=4, mode="scan"), \
            jr.topk(items[:6], k=4, mode="scan")
        assert (tt["scores"], tt["ids"], tt["labels"]) == \
            (jt["scores"], jt["ids"], jt["labels"])
        st, sj = tr.status(), jr.status()
        for key in ("router_rows", "router_requests", "router_replayed_acks",
                    "router_mapped_rows", "shards", "topology"):
            assert st[key] == sj[key], key
    finally:
        single.stop(commit=False)
        _stop(tds)
        _stop(jds)


@pytest.mark.parametrize("case", ["empty_batch", "all_foreign"])
def test_router_edges_match_jax(tmp_path, case):
    """The empty batch answers zero rows; a fresh router (no row map:
    the failover shape) labels every row with a synthetic id below -1
    whose partition is the routed one.  Both as JAX's router answers."""
    base = _unique_vectors(20, seed=67)
    items = np.concatenate([base, base[[1, 4, 1]]])
    tds, jds = _port_shards(tmp_path), _jax_shards(tmp_path)
    try:
        tt = {s: LocalTransport(d) for s, d in tds.items()}
        jt = {s: JLocal(d) for s, d in jds.items()}
        tr, jr = ShardRouter(tt), JRouter(jt)
        assert tr.ingest(items)["ok"] and jr.ingest(items)["ok"]
        tr.quiesce()
        jr.quiesce()
        if case == "empty_batch":
            empty = np.empty((0, 16), np.uint32)
            q, jq = tr.query(empty), jr.query(empty)
            assert q["labels"].shape == (0,) and q["known"].shape == (0,)
            assert q["generation"] == jq["generation"] >= 1
            assert _ack(tr.ingest(empty)) == _ack(jr.ingest(empty))
        else:
            routed = tr.query(items)
            q, jq = ShardRouter(tt).query(items), JRouter(jt).query(items)
            assert q["known"].all()
            assert (q["labels"] < -1).all()
            np.testing.assert_array_equal(q["labels"], jq["labels"])
            assert _canon(q["labels"]) == _canon(routed["labels"])
    finally:
        _stop(tds)
        _stop(jds)


def test_router_single_shard_topology_matches_unsharded_daemon(tmp_path):
    base = _unique_vectors(24, seed=71)
    items = np.concatenate([base, base[[2, 9]]])
    single = ServeDaemon(str(tmp_path / "single"), params=TP,
                         device="cpu").start()
    shard = ServeDaemon(str(tmp_path / "range_0000"), params=TP,
                        state_commit_every=1, device="cpu").start()
    try:
        router = ShardRouter({0: LocalTransport(shard)})
        for lo in range(0, len(items), 10):
            s = single.ingest(items[lo:lo + 10])
            r = router.ingest(items[lo:lo + 10])
            assert s["ok"] and r["ok"] and r["acked"] == s["acked"]
            assert r["labels"] == s["labels"] and r["rows"] == s["rows"]
        single.quiesce()
        router.quiesce()
        qs, qr = single.query(items), router.query(items)
        assert qs["known"].all() and qr["known"].all()
        np.testing.assert_array_equal(qr["labels"], qs["labels"])
        assert int(shard._index.n_rows) == int(single._index.n_rows)
        assert router.status()["shards"] == 1
    finally:
        single.stop(commit=False)
        shard.stop(commit=False)


def test_router_forward_drop_replays_ack_idempotently(tmp_path):
    """The lost-ack window: the drop eats a committed shard's answer; the
    retried same request id is answered by the journal's replay, zero
    rows absorbed twice, as JAX's router under the same plan."""
    items = _unique_vectors(24, seed=9)
    tds, jds = _port_shards(tmp_path), _jax_shards(tmp_path)
    try:
        tr = ShardRouter({s: LocalTransport(d) for s, d in tds.items()})
        jr = JRouter({s: JLocal(d) for s, d in jds.items()})
        rule = dict(site="serve.router.forward", kind="connection_drop",
                    times=1)
        install_plan(FaultPlan([FaultRule(**rule)]))
        try:
            r = tr.ingest(items, request_id="drop-regress")
        finally:
            clear_plan()
        jinstall(JPlan([JRule(**rule)]))
        try:
            j = jr.ingest(items, request_id="drop-regress")
        finally:
            jclear()
        assert r["ok"] and r["acked"] == 24 and r.get("replayed")
        assert _ack(r) == _ack(j)
        assert sum(int(d._index.n_rows) for d in tds.values()) == 24
        assert tr.query(items)["known"].all()
        st = tr.status()
        assert st["router_replayed_acks"] == 1 == \
            jr.status()["router_replayed_acks"]
        assert st["router_rows"] == 24
    finally:
        _stop(tds)
        _stop(jds)


def _serve(server):
    th = threading.Thread(target=server.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    return th


def test_serve_client_over_router_server_carries_request_id(tmp_path):
    items = _unique_vectors(18, seed=21)
    tds = _port_shards(tmp_path)
    router = ShardRouter({s: LocalTransport(d) for s, d in tds.items()})
    server = RouterServer(router, port=0)
    _serve(server)
    try:
        with ServeClient(port=server.port) as c:
            assert c.ping()["ok"]
            install_plan(FaultPlan([FaultRule(site="serve.router.forward",
                                              kind="connection_drop",
                                              times=1)]))
            try:
                r = c.ingest(items, timeout_s=120)
            finally:
                clear_plan()
            assert r["ok"] and r["acked"] == 18 and r.get("replayed")
            assert sum(int(d._index.n_rows) for d in tds.values()) == 18
            assert c.query(items, timeout_s=60)["known"].all()
            st = c.status()
            assert st["topology"] == "sharded" and st["shards"] == N_SHARDS
            assert st["router_replayed_acks"] == 1
            assert c.quiesce(timeout_s=120)["ok"]
    finally:
        server.shutdown()
        server.server_close()
        router.close()
        _stop(tds)


@pytest.mark.parametrize("side", ["jax_client_port_router",
                                  "port_client_jax_router"])
def test_clients_cross_routers(tmp_path, side):
    """Each package's client drives the other's router (each over its
    own package's daemons): acks, a replayed request id, and the labels
    the router itself answers in process."""
    items = _near_dup_vectors(40, seed=8)
    if side == "jax_client_port_router":
        ds = _port_shards(tmp_path)
        server = RouterServer(
            ShardRouter({s: LocalTransport(d) for s, d in ds.items()}))
        Client = JClient
    else:
        ds = _jax_shards(tmp_path)
        server = JRouterServer(JRouter({s: JLocal(d) for s, d in ds.items()}))
        Client = ServeClient
    _serve(server)
    try:
        with Client(port=server.port) as c:
            acks = [c.ingest(items[lo:lo + 10], timeout_s=120,
                             request_id=f"b{lo}")
                    for lo in range(0, len(items), 10)]
            assert [a["acked"] for a in acks] == [10] * 4
            assert [a["rows"] for a in acks] == \
                [list(range(lo, lo + 10)) for lo in range(0, 40, 10)]
            again = c.ingest(items[:10], timeout_s=120, request_id="b0")
            assert again.get("replayed") and again["acked"] == 10
            assert c.quiesce(timeout_s=120)["ok"]
            q = c.query(items, timeout_s=60)
            assert q["known"].all()
            direct = server.router.query(items)
            np.testing.assert_array_equal(q["labels"], direct["labels"])
            assert len(set(q["labels"].tolist())) < len(items)
            t = c.topk(items[:3], k=3, mode="scan", timeout_s=60)
            assert np.asarray(t["scores"])[:, 0].tolist() == [32] * 3
            st = c.status()
            assert st["topology"] == "sharded" and st["router_rows"] == 50
            assert st["router_replayed_acks"] == 2
    finally:
        server.shutdown()
        server.server_close()
        _stop(ds)


def test_router_opens_no_store():
    """The router holds no device and writes no store file: of the store
    module it imports only the deal and the digests, it names no store
    class, and it imports nothing of torch."""
    path = os.path.join(REPO, "tse1m_tpu_torch", "serve", "router.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    from_store, modules, names = [], [], set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            modules.append(node.module or "")
            if (node.module or "").endswith("store"):
                from_store += [a.name for a in node.names]
        elif isinstance(node, ast.Import):
            modules += [a.name for a in node.names]
        elif isinstance(node, ast.Name):
            names.add(node.id)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    assert sorted(from_store) == ["digest_range_ids", "row_digests"]
    assert not any(m.split(".")[0] == "torch" for m in modules)
    assert not names & {"SignatureStore", "ServeDaemon", "ServeReplica",
                        "save_state", "bulk_probe", "journal_record",
                        "open_existing", "makedirs", "load_signatures"}


def test_concurrent_requests_share_a_shard_connection(tmp_path):
    """Two client threads through one RouterServer over TCP shard servers:
    each shard's one pinned connection carries both threads' forwards
    without interleaving their frames (every answer matches its own
    request)."""
    tds = _port_shards(tmp_path)
    servers = {s: ServeServer(d) for s, d in tds.items()}
    for srv in servers.values():
        _serve(srv)
    router = ShardRouter({s: TcpTransport(port=srv.port)
                          for s, srv in servers.items()})
    front = RouterServer(router)
    _serve(front)
    items = _near_dup_vectors(60, seed=12)
    errors, answers = [], {}
    try:
        with ServeClient(port=front.port) as c:
            assert c.ingest(items, timeout_s=120)["ok"]
            c.quiesce(timeout_s=120)
            want = c.query(items, timeout_s=60)["labels"]

        def worker(tid):
            try:
                with ServeClient(port=front.port) as c:
                    for i in range(15):
                        sel = np.arange(tid + i, 60, 7)
                        got = c.query(items[sel], timeout_s=60)["labels"]
                        answers[(tid, i)] = np.array_equal(got, want[sel])
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert errors == [] and len(answers) == 45 and all(answers.values())
    finally:
        front.shutdown()
        front.server_close()
        router.close()
        for srv in servers.values():
            srv.shutdown()
            srv.server_close()
        _stop(tds)


def test_scan_forwards_take_the_ingest_budget():
    """A scan-mode topk is a bulk request: the router server forwards it
    with the ingest class's budget (a candidates probe keeps the connect
    timeout), so a scan longer than 5 s is not re-sent while it runs."""
    from tse1m_tpu_torch.resilience.watchdog import request_budget_s

    seen = []

    def transport(msg, timeout_s=None):
        seen.append((msg["op"], msg.get("mode"), timeout_s))
        n = int(msg["shape"][0])
        return {"ok": True, "generation": 1, "scores": [[-1]] * n,
                "ids": [[""]] * n, "labels": [[-1]] * n}

    server = RouterServer(ShardRouter({0: transport, 1: transport}))
    try:
        v = _unique_vectors(2)
        for mode in ("scan", "candidates"):
            resp = server.dispatch({"op": "topk", "k": 1, "mode": mode,
                                    **encode_vectors(v)})
            assert resp["ok"], resp
    finally:
        server.server_close()
    budget = request_budget_s("ingest")
    assert sorted(seen) == [("topk", "candidates", None)] * 2 + \
        [("topk", "scan", budget)] * 2
    assert budget > 5.0


def test_replayed_ack_keeps_the_uninterrupted_labels(tmp_path):
    """A replayed ack names the rows the original ack named, so the router
    maps the same rows as in an uninterrupted run: with rows put into the
    shards outside the router and a tail that repeats their content, a
    drop at every tail batch in turn leaves every label the uninterrupted
    run's, element for element.  (JAX's replay names each row's first
    index row of its content, and its router then moves that row's global
    label: this data differs in some labels there.)"""
    from tse1m_tpu_torch.data import synth_session_sets

    items = synth_session_sets(600, set_size=32, seed=3)[0]
    base, tail = items[:400], np.concatenate([items[400:], items[:30]])
    owner = digest_range_ids(row_digests(base), N_SHARDS)

    def run(tag, drop_at, package):
        if package == "port":
            ds, Router, Local = _port_shards(tmp_path, tag=tag), \
                ShardRouter, LocalTransport
            plan = (install_plan, clear_plan, FaultPlan, FaultRule)
        else:
            ds, Router, Local = _jax_shards(tmp_path, tag=tag), JRouter, \
                JLocal
            plan = (jinstall, jclear, JPlan, JRule)
        try:
            for s, d in ds.items():
                d.ingest(base[owner == s])
            r = Router({s: Local(d) for s, d in ds.items()})
            replayed = 0
            for i, lo in enumerate(range(0, len(tail), 50)):
                if i == drop_at:
                    plan[0](plan[2]([plan[3](site="serve.router.forward",
                                             kind="connection_drop",
                                             times=1)]))
                try:
                    ack = r.ingest(tail[lo:lo + 50], request_id=f"b{i}")
                finally:
                    plan[1]()
                replayed += bool(ack.get("replayed"))
            r.quiesce()
            labels = r.query(np.concatenate([base, tail]))["labels"]
            return labels, replayed
        finally:
            _stop(ds)

    want, _ = run("oracle", -1, "port")
    for drop_at in range(5):
        got, replayed = run(f"drop{drop_at}", drop_at, "port")
        assert replayed == 1
        np.testing.assert_array_equal(got, want)
    jwant, _ = run("joracle", -1, "jax")
    np.testing.assert_array_equal(jwant, want)
    jgot, _ = run("jdrop", 4, "jax")
    assert (jgot != want).any()


@pytest.mark.parametrize("heals", [True, False])
def test_forward_retries_for_the_failover_window(monkeypatch, heals):
    """A forward to a shard that does not answer retries until three
    heartbeat timeouts have passed (JAX's router stops after 8 attempts):
    a shard back within the window answers, one that stays down raises
    once the window is spent."""
    import time

    from tse1m_tpu_torch.serve.router import failover_policy
    from tse1m_tpu_torch.utils.retry import RetryError

    monkeypatch.setenv("TSE1M_HEARTBEAT_TIMEOUT_S", "0.4")
    policy = failover_policy()
    assert policy.deadline == pytest.approx(1.2)
    assert policy.max_attempts > 8
    calls = []

    def transport(msg, timeout_s=None):  # noqa: ARG001
        calls.append(time.monotonic())
        if not heals or calls[-1] - calls[0] < 0.6:
            raise ConnectionRefusedError("shard writer restarting")
        return {"ok": True, "rows": 3, "generation": 2}

    router = ShardRouter({0: transport})
    try:
        t0 = time.monotonic()
        if heals:
            assert router.ping()["rows"] == 3
            # The sleep before the last attempt is cut at the deadline.
            assert 0.6 <= time.monotonic() - t0 < 1.2 + 0.5
        else:
            with pytest.raises(RetryError):
                router.ping()
            assert 1.2 <= time.monotonic() - t0 < 1.2 + 0.5
    finally:
        router.close()
