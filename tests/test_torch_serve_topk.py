"""The ``topk`` verb of tse1m_tpu_torch's serving daemon (on the CPU,
through the top-k kernel's plain version) against the JAX package's
daemon (``use_pallas="never"``) and the host oracle ``score_topk_host``:
the scan of every committed store row, the band-candidate probe, the
edges (k = 0, no queries, k past the row count, an unknown mode), and
scans from a second thread while ingest batches are in flight.
Mirrors ``tests/test_serve_topk.py``.  Tolerance: exact (scores, digest
ids, labels, order)."""

import threading

import numpy as np
import pytest

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu_torch.cluster.kernels.score import (score_topk_host,
                                                   store_scan_locator)
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.serve import ServeDaemon

JP = JParams(n_hashes=32, n_bands=4, use_pallas="never")
TP = TParams(n_hashes=32, n_bands=4)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    yield
    jflight._flight_dir, tflight._flight_dir = saved


def _planted(n_family: int = 12, n_filler: int = 40, seed: int = 5,
             width: int = 16):
    """(vectors, queries): row i of the family disagrees with the base on
    exactly i positions (strictly separated agreement counts), plus
    content-distinct filler."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 2**32, size=(1, width), dtype=np.int64
                        ).astype(np.uint32)
    fam = np.repeat(base, n_family, axis=0)
    for i in range(n_family):
        fam[i, :i] = rng.integers(1, 2**32, size=i,
                                  dtype=np.int64).astype(np.uint32)
    filler = rng.integers(0, 2**32, size=(n_filler, width),
                          dtype=np.int64).astype(np.uint32)
    return np.concatenate([fam, filler]), base


def _pair(tmp_path, batches):
    """A port and a JAX daemon over the same ingested batches."""
    t = ServeDaemon(str(tmp_path / "t"), params=TP, device="cpu",
                    state_commit_every=1).start()
    j = JDaemon(str(tmp_path / "j"), params=JP,
                state_commit_every=1).start()
    for b in batches:
        for d in (t, j):
            d.ingest(b, timeout=300)
    return t, j


def _store_sigs(daemon, n_shards=None) -> np.ndarray:
    """Every committed signature row in scan order (sorted shard id), or
    those of the first ``n_shards`` shards."""
    store = daemon.reader
    store.refresh()
    shards = sorted(store.shards, key=lambda e: int(e["id"]))[:n_shards]
    return np.concatenate(
        [np.asarray(store._sig_mmap(int(e["id"]))) for e in shards])


def _oracle(daemon, queries, k, n_shards=None):
    """``score_topk_host`` over the store's rows (or its first
    ``n_shards`` shards), as the wire answer: digest ids, sorted by
    (-count, digest hex)."""
    counts, rows = score_topk_host(daemon._sign_novel(queries),
                                   _store_sigs(daemon, n_shards), k)
    store = daemon.reader
    out_s, out_i = [], []
    for c, r in zip(counts, rows):
        ok = r >= 0
        loc = store_scan_locator(store, r[ok])
        dg = store.load_digests(loc[:, 0], loc[:, 1])
        hx = ["%016x%016x" % (int(a), int(b)) for a, b in dg]
        hits = sorted(zip(c[ok].tolist(), hx), key=lambda p: (-p[0], p[1]))
        pad = k - len(hits)
        out_s.append([s for s, _ in hits] + [-1] * pad)
        out_i.append([h for _, h in hits] + [""] * pad)
    return out_s, out_i


def test_scan_matches_jax_and_the_host_oracle(tmp_path):
    vecs, q = _planted()
    t, j = _pair(tmp_path, [vecs[:20], vecs[20:]])
    try:
        got = t.topk(q, k=5, mode="scan")
        assert got == j.topk(q, k=5, mode="scan")
        assert (got["scores"], got["ids"]) == _oracle(t, q, 5)
        assert got["scores"][0][0] == TP.n_hashes  # the self-hit
        assert all(len(i) == 32 for i in got["ids"][0])
        assert got["labels"][0][0] == 0
    finally:
        t.stop(commit=False)
        j.stop(commit=False)


def test_scan_over_sessions_with_ties_matches_jax(tmp_path):
    """Planted near-duplicate sessions over several shards: agreement
    ties at the k boundary resolve the same way in both packages and in
    the oracle."""
    items = synth_session_sets(500, set_size=32, seed=12)[0]
    t, j = _pair(tmp_path, [items[lo:lo + 125] for lo in range(0, 500, 125)])
    try:
        assert len(t.reader.shards) > 1
        q = np.concatenate([items[::50], synth_session_sets(
            6, set_size=32, seed=99)[0]])
        for k in (1, 10, 37):
            got = t.topk(q, k=k, mode="scan")
            assert got == j.topk(q, k=k, mode="scan")
            assert (got["scores"], got["ids"]) == _oracle(t, q, k)
    finally:
        t.stop(commit=False)
        j.stop(commit=False)


def test_candidates_match_jax(tmp_path):
    items = synth_session_sets(400, set_size=32, seed=13)[0]
    t, j = _pair(tmp_path, [items[:200], items[200:]])
    try:
        nov = synth_session_sets(5, set_size=32, seed=101)[0]
        q = np.concatenate([items[:12], nov])
        for k in (1, 4, 16):
            got = t.topk(q, k=k)
            assert got == j.topk(q, k=k)
            assert got["mode"] == "candidates"
        # Every candidate hit is scored as the scan scores it.
        scan = t.topk(items[:12], k=4, mode="scan")
        cand = t.topk(items[:12], k=4)
        assert [r[0] for r in cand["ids"]] == [r[0] for r in scan["ids"]]
        assert [r[0] for r in cand["scores"]] == [TP.n_hashes] * 12
    finally:
        t.stop(commit=False)
        j.stop(commit=False)


def test_topk_edges_match_jax(tmp_path):
    vecs, q = _planted(n_family=3, n_filler=5)
    t, j = _pair(tmp_path, [vecs])
    try:
        for mode in ("scan", "candidates"):
            empty = t.topk(np.zeros((0, 16), np.uint32), k=4, mode=mode)
            assert empty == j.topk(np.zeros((0, 16), np.uint32), k=4,
                                   mode=mode)
            assert empty["scores"] == [] and empty["ids"] == []
            k0 = t.topk(q, k=0, mode=mode)
            assert k0 == j.topk(q, k=0, mode=mode)
            assert k0["scores"] == [[]]
            big = t.topk(q, k=20, mode=mode)
            assert big == j.topk(q, k=20, mode=mode)
        n = vecs.shape[0]
        assert big["scores"][0][n:] == [-1] * (20 - n)
        assert t.topk(q, k=20, mode="scan")["ids"][0][n:] == [""] * (20 - n)
        for d in (t, j):
            with pytest.raises(ValueError, match="unknown topk mode"):
                d.topk(q, k=3, mode="nope")
        assert t.status()["latency_by_verb"]["topk"]["count"] == 7
    finally:
        t.stop(commit=False)
        j.stop(commit=False)


def test_scan_during_ingest_matches_a_prefix_oracle(tmp_path):
    """Scan-mode ``topk`` from a second thread while ingest batches are in
    flight: each batch, once its novel rows are signed, waits until a scan
    has started, then appends and refreshes the reader while that scan may
    still read it.  Every answer equals ``score_topk_host`` over the first
    m shards, for an m between the reader's shard counts before and after
    the call."""
    items = synth_session_sets(480, set_size=32, seed=14)[0]
    q = np.concatenate([items[:400:50], items[400::20]])
    t = ServeDaemon(str(tmp_path / "t"), params=TP, device="cpu").start()
    cond, done = threading.Condition(), threading.Event()
    started, scans, errors = [0], [], []
    sign = t._sign_novel

    def gated(rows):
        out = sign(rows)
        with cond:
            seen = started[0]
            assert cond.wait_for(lambda: started[0] > seen, timeout=120)
        return out

    def scanner():
        try:
            while not done.is_set():
                n0 = len(t.reader.shards)
                with cond:
                    started[0] += 1
                    cond.notify_all()
                res = t.topk(q, k=5, mode="scan")
                scans.append((n0, len(t.reader.shards), res))
        except Exception as e:  # noqa: BLE001 - relayed below
            errors.append(e)

    try:
        t.ingest(items[:80], timeout=300)
        t._sign_novel = gated
        th = threading.Thread(target=scanner)
        th.start()
        try:
            for lo in range(80, 480, 80):
                t.ingest(items[lo:lo + 80], timeout=300)
        finally:
            done.set()
            th.join(timeout=120)
        del t._sign_novel
        assert not th.is_alive() and not errors, errors[:1]
        assert len(scans) >= 5
        assert max(n1 for _, n1, _ in scans) == len(t.reader.shards) == 6
        oracles = {m: _oracle(t, q, 5, m) for m in range(1, 7)}
        for n0, n1, res in scans:
            assert res["mode"] == "scan"
            assert any((res["scores"], res["ids"]) == oracles[m]
                       for m in range(n0, n1 + 1)), (n0, n1)
        # The late rows' self-hits appear once their shard is read.
        assert oracles[6][0][-1][0] == TP.n_hashes
        assert oracles[1][0][-1][0] < TP.n_hashes
    finally:
        t.stop(commit=False)
