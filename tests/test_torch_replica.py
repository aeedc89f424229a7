"""tse1m_tpu_torch's read replicas (``serve/replicate.py``) against the
JAX package's, on the CPU.

A pull of one store gives the same bytes in the replica's directory as
JAX's pull; staleness, refresh and the read-only refusals follow
``tests/test_serve_sharded.py:289-351`` step for step in both packages;
the puller converges; the replica's ``query`` equals JAX's replica's and
its ``topk(mode="scan")`` equals JAX's and ``score_topk_host`` over the
store.  Tolerance: exact."""

import os

import numpy as np
import pytest

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu.serve import ServeReplica as JReplica
from tse1m_tpu.serve import replica_staleness as j_staleness
from tse1m_tpu.serve import stream_shards as j_stream
from tse1m_tpu_torch.cluster import score_topk_host, store_scan_locator
from tse1m_tpu_torch.cluster.encode import quantize_ids
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.cluster.schemes import make_params, scheme_host_signatures
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.resilience.faults import (FaultPlan, FaultRule,
                                               clear_plan, install_plan)
from tse1m_tpu_torch.serve import (ReplicationPuller, ServeDaemon,
                                   ServeReplica, replica_staleness,
                                   stream_shards)

JP = JParams(n_hashes=32, n_bands=4, use_pallas="never")
TP = TParams(n_hashes=32, n_bands=4)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    monkeypatch.delenv("TSE1M_FAULT_PLAN", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    yield
    jflight._flight_dir, tflight._flight_dir = saved
    clear_plan()


def _items(n, seed):
    return synth_session_sets(n, set_size=32, seed=seed)[0]


def _canon(labels):
    seen = {}
    return [seen.setdefault(int(v), len(seen)) for v in labels]


def _tree(directory):
    """{name: bytes} of a directory's files (flight dumps aside)."""
    out = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if os.path.isfile(path) and not name.startswith("flight_"):
            with open(path, "rb") as f:
                out[name] = f.read()
    return out


def _writer(tmp_path, items, parts=(0, 60, 120)):
    src = str(tmp_path / "writer")
    w = ServeDaemon(src, params=TP, state_commit_every=1,
                    device="cpu").start()
    for lo, hi in zip(parts, parts[1:]):
        assert w.ingest(items[lo:hi], timeout=120)["ok"]
    w.quiesce()
    return src, w


def test_stream_shards_bytes_equal_jax(tmp_path):
    items = _items(160, 3)
    src, w = _writer(tmp_path, items)
    try:
        t = stream_shards(src, str(tmp_path / "t"))
        j = j_stream(src, str(tmp_path / "j"))
        assert t == j and t["shards_copied"] == 2 and t["state_copied"]
        assert t["bytes_copied"] > 0
        assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))
        # Committed shards are immutable: a second pull copies no shard.
        again = stream_shards(src, str(tmp_path / "t"))
        assert again["shards_copied"] == 0 == j_stream(
            src, str(tmp_path / "j"))["shards_copied"]
        assert w.ingest(items[120:], timeout=120)["ok"]
        w.quiesce()
        t = stream_shards(src, str(tmp_path / "t"))
        assert t == j_stream(src, str(tmp_path / "j"))
        assert t["shards_copied"] == 1
        assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))
    finally:
        w.stop(commit=False)


def test_pull_killed_before_its_manifest_keeps_the_old_view(tmp_path):
    """The seat ``serve.replica.stream`` sits before the manifest commit:
    a pull that dies there leaves the replica on its generation."""
    items = _items(120, 4)
    src, w = _writer(tmp_path, items, parts=(0, 60))
    dst = str(tmp_path / "replica")
    try:
        stream_shards(src, dst)
        replica = ServeReplica(dst, params=TP, device="cpu")
        gen = replica.store.generation
        assert w.ingest(items[60:], timeout=120)["ok"]
        w.quiesce()
        install_plan(FaultPlan([FaultRule(site="serve.replica.stream")]))
        with pytest.raises(Exception, match="injected"):
            stream_shards(src, dst)
        clear_plan()
        assert not replica.refresh() and replica.store.generation == gen
        assert replica_staleness(src, replica) > 0
        stream_shards(src, dst)
        assert replica.refresh() and replica_staleness(src, replica) == 0
    finally:
        w.stop(commit=False)


def test_replica_staleness_refresh_and_read_only_match_jax(tmp_path):
    """``test_replica_staleness_bound_refresh_and_read_only``'s steps in
    both packages, each over its own writer: the same staleness, known
    masks, labels and refusals at every step."""
    items = _items(30, 41)
    seen = {}
    for name in ("port", "jax"):
        src, dst = str(tmp_path / name / "w"), str(tmp_path / name / "r")
        if name == "port":
            w = ServeDaemon(src, params=TP, state_commit_every=1,
                            device="cpu").start()
            stream, stale = stream_shards, replica_staleness

            def make():
                return ServeReplica(dst, params=TP, device="cpu")
        else:
            w = JDaemon(src, params=JP, state_commit_every=1).start()
            stream, stale = j_stream, j_staleness

            def make():
                return JReplica(dst, params=JP)
        got = []
        try:
            assert w.ingest(items[:20])["ok"]
            w.quiesce()
            stream(src, dst)
            replica = make()
            q = replica.query(items[:20])
            got += [stale(src, replica), q["known"].tolist(),
                    q["labels"].tolist(),
                    _canon(q["labels"]) == _canon(
                        w.query(items[:20])["labels"])]
            assert w.ingest(items[20:])["ok"]
            w.quiesce()
            lagged = replica.query(items)
            got += [stale(src, replica) > 0, lagged["known"].tolist()]
            stream(src, dst)
            got += [replica.refresh(), stale(src, replica)]
            fresh = replica.query(items)
            got += [fresh["known"].tolist(), fresh["labels"].tolist(),
                    replica.read_only, replica.store.read_only]
            with pytest.raises(RuntimeError, match="read replica"):
                replica.ingest(items[:1])
            with pytest.raises(RuntimeError, match="read replica"):
                replica.quiesce()
            st = replica.status()
            got += [st["read_only"], st["generation_adopted"], st["rows"],
                    st["store_rows"], st["store_generation"]]
        finally:
            w.stop(commit=False)
        seen[name] = got
    assert seen["port"] == seen["jax"]
    assert seen["port"][0] == 0 and seen["port"][3] is True
    assert seen["port"][4] is True and not all(seen["port"][5][20:])


def test_replication_puller_converges(tmp_path):
    items = _items(18, 55)
    src, dst = str(tmp_path / "w"), str(tmp_path / "r")
    w = ServeDaemon(src, params=TP, state_commit_every=1,
                    device="cpu").start()
    try:
        assert w.ingest(items[:12], timeout=120)["ok"]
        w.quiesce()
        stream_shards(src, dst)
        replica = ServeReplica(dst, params=TP, device="cpu")
        puller = ReplicationPuller(src, replica, interval_s=0.05)
        assert puller.pull_once() is False  # already fresh
        assert w.ingest(items[12:], timeout=120)["ok"]
        w.quiesce()
        assert puller.pull_once() is True
        assert replica_staleness(src, replica) == 0
        assert puller.pulls == 2
        # The thread keeps it fresh on its own.
        puller.start()
        assert w.ingest(_items(6, 56), timeout=120)["ok"]
        w.quiesce()
        for _ in range(200):
            if replica_staleness(src, replica) == 0 and \
                    replica.status()["rows"] == 24:
                break
            puller._stop.wait(0.05)
        puller.stop()
        assert replica_staleness(src, replica) == 0
        assert replica.query(_items(6, 56))["known"].all()
    finally:
        w.stop(commit=False)


def _host_scan(store, qbits, queries, k):
    """``score_topk_host`` over every store row in scan order, in the
    topk verb's wire order (-count, digest hex), ("", -1) padded."""
    loc = store_scan_locator(store, np.arange(store.n_rows))
    sigs = store.load_signatures(loc[:, 0], loc[:, 1])
    qs = scheme_host_signatures(quantize_ids(queries, qbits) if qbits
                                else queries, make_params("kminhash", 32, 0))
    counts, rows = score_topk_host(qs, sigs, k)
    scores, ids = [], []
    for c, r in zip(counts, rows):
        ok = r >= 0
        dg = store.load_digests(loc[r[ok], 0], loc[r[ok], 1])
        hits = sorted(zip(c[ok].tolist(), ["%016x%016x" % (int(a), int(b))
                                           for a, b in dg]),
                      key=lambda h: (-h[0], h[1]))
        pad = k - len(hits)
        scores.append([h[0] for h in hits] + [-1] * pad)
        ids.append([h[1] for h in hits] + [""] * pad)
    return scores, ids


@pytest.mark.parametrize("quant_bits", [0, 10])
def test_replica_query_and_scan_equal_jax_and_host(tmp_path, quant_bits):
    items = _items(150, 6)
    src = str(tmp_path / "w")
    params = TParams(n_hashes=32, n_bands=4, wire_quant_bits=quant_bits)
    w = ServeDaemon(src, params=params, state_commit_every=1,
                    device="cpu").start()
    try:
        for lo in range(0, 150, 50):
            assert w.ingest(items[lo:lo + 50], timeout=120)["ok"]
        w.quiesce()
        stream_shards(src, str(tmp_path / "t"))
        j_stream(src, str(tmp_path / "j"))
        tr = ServeReplica(str(tmp_path / "t"), params=TP, device="cpu")
        jr = JReplica(str(tmp_path / "j"), params=JP)
        assert tr.qbits == jr.qbits == quant_bits
        probe = np.concatenate([items[::7], _items(20, 99)])
        tq, jq = tr.query(probe), jr.query(probe)
        np.testing.assert_array_equal(tq["labels"], jq["labels"])
        np.testing.assert_array_equal(tq["known"], jq["known"])
        np.testing.assert_array_equal(
            tq["labels"][:len(items[::7])],
            w.query(items[::7])["labels"])
        for mode in ("scan", "candidates"):
            tt = tr.topk(probe[:12], k=5, mode=mode)
            jt = jr.topk(probe[:12], k=5, mode=mode)
            assert (tt["scores"], tt["ids"], tt["labels"]) == \
                (jt["scores"], jt["ids"], jt["labels"]), mode
        scores, ids = _host_scan(tr.store, tr.qbits, probe[:12], 5)
        tt = tr.topk(probe[:12], k=5, mode="scan")
        assert tt["scores"] == scores and tt["ids"] == ids
    finally:
        w.stop(commit=False)


def test_replica_needs_the_card_unless_asked_for_the_cpu(tmp_path,
                                                        monkeypatch):
    import torch

    src, w = _writer(tmp_path, _items(60, 8), parts=(0, 60))
    w.stop(commit=False)
    stream_shards(src, str(tmp_path / "r"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeReplica(str(tmp_path / "r"), params=TP)
    assert ServeReplica(str(tmp_path / "r"), params=TP,
                        device="cpu").status()["rows"] == 60
