"""tse1m_tpu_torch's ``backfill`` command against the JAX package's, on the
CPU: over one store, in process (``--sig-store``) and through a running
daemon (``--port``/``--port-file``), both commands print the same scores,
ids, labels and summary keys, the scores and ids those of
``score_topk_host`` over the store.  Tolerance: exact."""

import json
import threading

import numpy as np
import pytest

from tse1m_tpu import cli as jcli
from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu.serve import ServeServer as JServer
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster import score_topk_host, store_scan_locator
from tse1m_tpu_torch.cluster.encode import quantize_ids
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.cluster.schemes import make_params, scheme_host_signatures
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.serve import ServeDaemon, ServeServer

JP = JParams(n_hashes=32, n_bands=4, use_pallas="never")
TP = TParams(n_hashes=32, n_bands=4, wire_quant_bits=10)
SUMMARY_KEYS = {"ok", "queries", "k", "store_rows", "pairs_scored",
                "wall_s", "pairs_scored_s", "results"}


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    yield
    jflight._flight_dir, tflight._flight_dir = saved


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = tmp_path_factory.mktemp("backfill")
    items = synth_session_sets(300, set_size=32, seed=12)[0]
    w = ServeDaemon(str(d / "store"), params=TP, state_commit_every=1,
                    device="cpu").start()
    for lo in range(0, 300, 100):
        assert w.ingest(items[lo:lo + 100], timeout=120)["ok"]
    w.stop()
    queries = np.concatenate([items[::40],
                              synth_session_sets(5, set_size=32,
                                                 seed=13)[0]])
    np.save(d / "q.npy", queries)
    return {"dir": str(d / "store"), "npy": str(d / "q.npy"),
            "queries": queries, "items": items, "tmp": d}


def _run(main, argv, capsys) -> dict:
    capsys.readouterr()
    assert main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _host_answer(store_dir, queries, k):
    from tse1m_tpu_torch.cluster.store import SignatureStore

    with open(f"{store_dir}/store_manifest.json", encoding="utf-8") as f:
        policy = json.load(f)["policy"]
    st = SignatureStore(store_dir, policy, read_only=True)
    loc = store_scan_locator(st, np.arange(st.n_rows))
    sigs = st.load_signatures(loc[:, 0], loc[:, 1])
    qs = scheme_host_signatures(quantize_ids(queries, 10),
                                make_params("kminhash", 32, 0))
    counts, rows = score_topk_host(qs, sigs, k)
    scores, ids = [], []
    for c, r in zip(counts, rows):
        ok = r >= 0
        dg = st.load_digests(loc[r[ok], 0], loc[r[ok], 1])
        hits = sorted(zip(c[ok].tolist(), ["%016x%016x" % (int(a), int(b))
                                           for a, b in dg]),
                      key=lambda h: (-h[0], h[1]))
        scores.append([h[0] for h in hits] + [-1] * (k - len(hits)))
        ids.append([h[1] for h in hits] + [""] * (k - len(hits)))
    return scores, ids, int(st.n_rows)


def _same(t, j, store, k):
    assert set(t) == set(j) == SUMMARY_KEYS
    for key in ("ok", "queries", "k", "store_rows", "pairs_scored"):
        assert t[key] == j[key], key
    assert t["results"] == j["results"]
    scores, ids, n_rows = _host_answer(store["dir"], store["queries"], k)
    assert t["results"]["scores"] == scores
    assert t["results"]["ids"] == ids
    # The store is content-addressed: the corpus's exact duplicates
    # share a row.
    assert t["store_rows"] == n_rows and 0 < n_rows < 300
    assert t["pairs_scored"] == n_rows * len(store["queries"])


@pytest.mark.parametrize("k", [1, 5])
def test_backfill_sig_store_equals_jax(store, capsys, k):
    argv = ["backfill", "--npy", store["npy"], "--sig-store", store["dir"],
            "--k", str(k), "--batch", "4"]
    t = _run(cli_main, argv + ["--device", "cpu"], capsys)
    j = _run(jcli.main, argv, capsys)
    _same(t, j, store, k)


def _serve(server):
    th = threading.Thread(target=server.serve_forever,
                          kwargs={"poll_interval": 0.05}, daemon=True)
    th.start()
    return th


@pytest.mark.parametrize("server_side", ["port", "jax"])
def test_backfill_over_tcp_equals_jax(store, capsys, server_side):
    """Both commands through one daemon's topk verb (a daemon of each
    package over its own copy of the store): the same answers, and the
    --out file the answers printed inline."""
    import shutil

    copy = str(store["tmp"] / f"copy_{server_side}")
    shutil.copytree(store["dir"], copy)
    if server_side == "port":
        d = ServeDaemon(copy, params=TP, device="cpu").start()
        server = ServeServer(d)
    else:
        d = JDaemon(copy, params=JP).start()
        server = JServer(d)
    _serve(server)
    port_file = store["tmp"] / f"port_{server_side}"
    port_file.write_text(str(server.port))
    try:
        argv = ["backfill", "--npy", store["npy"], "--port-file",
                str(port_file), "--k", "5", "--batch", "3"]
        t = _run(cli_main, argv, capsys)
        j = _run(jcli.main, argv, capsys)
        _same(t, j, store, 5)
        out = str(store["tmp"] / f"out_{server_side}.json")
        s = _run(cli_main, argv + ["--out", out], capsys)
        assert s["out"] == out and "results" not in s
        with open(out, encoding="utf-8") as f:
            assert json.load(f) == t["results"]
    finally:
        server.shutdown()
        server.server_close()
        d.stop(commit=False)


def test_backfill_through_a_router_counts_every_shard(store, capsys):
    """Through a router the port's backfill counts the rows of every
    shard (a router's status carries them per shard), where the JAX
    package's command reads a ``store_rows`` the router does not report
    and prints 0 pairs scored; the answers are the same."""
    from tse1m_tpu_torch.cluster.store import digest_range_ids, row_digests
    from tse1m_tpu_torch.serve import LocalTransport, RouterServer, ShardRouter

    items = store["items"]
    owner = digest_range_ids(row_digests(items), 2)
    shards = {s: ServeDaemon(str(store["tmp"] / f"range_{s:04d}"), params=TP,
                             state_commit_every=1, device="cpu").start()
              for s in range(2)}
    router = ShardRouter({s: LocalTransport(d) for s, d in shards.items()})
    server = RouterServer(router)
    _serve(server)
    port_file = store["tmp"] / "router_port"
    port_file.write_text(str(server.port))
    try:
        for lo in range(0, 300, 100):
            assert router.ingest(items[lo:lo + 100])["ok"]
        router.quiesce()
        argv = ["backfill", "--npy", store["npy"], "--port-file",
                str(port_file), "--k", "5"]
        t = _run(cli_main, argv, capsys)
        j = _run(jcli.main, argv, capsys)
        rows = sum(int(d.store.n_rows) for d in shards.values())
        assert len(np.unique(owner)) == 2
        assert t["store_rows"] == rows == 283
        assert t["pairs_scored"] == rows * len(store["queries"])
        assert j["store_rows"] == 0 and j["pairs_scored"] == 0
        assert t["results"] == j["results"]
        scores, ids, _ = _host_answer(store["dir"], store["queries"], 5)
        assert t["results"]["scores"] == scores
    finally:
        server.shutdown()
        server.server_close()
        router.close()
        for d in shards.values():
            d.stop(commit=False)
