"""The trace plane over the port's own serve plane on the CPU: the parts
that differ from the JAX package by design.

- The ``router`` scenario with the router's parallel read fan-out: under
  the scheduler each per-shard forward of ``query`` runs on a child
  thread the scheduler steps (``q.0``, ``q.1``), and every one of JAX's
  invariants holds on at least 40 seeded schedules and the bounded
  exhaustive enumeration; the ``replica`` scenario likewise.
- A planted router whose ``query`` merges the shards' answers without
  the router's lock is caught as a lockset race on ``ShardRouter.gmap``,
  with a replay string that re-fails, while the real router passes
  under it.
- ``TcpTransport``: under ``traced()`` (the lockset detector alone, no
  dependence on timing) two threads through one transport to a real
  ``ServeServer`` raise no race; a planted transport whose exchange
  skips the lock raises ``RaceError`` naming ``TcpTransport.sock``.
- ``ServeDaemon(signer=...)``: ``"host"`` and ``"device"`` on the CPU
  store the same signatures byte for byte and give the same labels, and
  both equal the JAX package's ``signer="host"`` daemon.

Tolerance: exact.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import pytest
import torch

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.serve.daemon import ServeDaemon as JDaemon
from tse1m_tpu_torch.cluster.pipeline import ClusterParams
from tse1m_tpu_torch.cluster.store import (SignatureStore, digest_range_ids,
                                           row_digests)
from tse1m_tpu_torch.serve.daemon import ServeDaemon
from tse1m_tpu_torch.serve.router import _NONE, ShardRouter, TcpTransport
from tse1m_tpu_torch.serve.server import ServeServer, encode_vectors
from tse1m_tpu_torch.trace import (RaceError, Schedule, ScheduleError,
                                   shared_access, traced)
from tse1m_tpu_torch.trace.explore import (_router_scenario, explore,
                                           run_scenario)

DEV = "cpu"


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    monkeypatch.delenv("TSE1M_FAULT_PLAN", raising=False)


# -- fan_out with no scheduler: the pool, as before ---------------------------


def test_fan_out_without_a_scheduler_uses_the_pool():
    """No tracer: every call on the pool, answers by key; a failure comes
    back as the first failing key's, in key order."""
    from concurrent.futures import ThreadPoolExecutor

    from tse1m_tpu_torch.trace.hooks import fan_out

    main = threading.get_ident()
    with ThreadPoolExecutor(3) as pool:
        got = fan_out(pool, lambda k: (k * k, threading.get_ident()),
                      [2, 0, 1])
        assert list(got) == [2, 0, 1]
        assert {k: v[0] for k, v in got.items()} == {2: 4, 0: 0, 1: 1}
        assert all(v[1] != main for v in got.values())

        def fail(k):
            if k:
                raise ValueError(f"shard {k}")
            return k

        with pytest.raises(ValueError, match="shard 1"):
            fan_out(pool, fail, [0, 1, 2])


# -- the router scenario with the parallel fan-out ----------------------------

def test_router_scenario_steps_the_fan_out_children():
    """The querier's per-shard forwards are decision points of their own:
    a realized trace names ``q.0`` and ``q.1``, and replays exactly."""
    out = run_scenario("router", Schedule.pct(0), device=DEV)
    assert {"q.0", "q.1"} <= set(out.decisions)
    again = run_scenario("router", Schedule.fixed(out.decisions),
                         device=DEV)
    assert again.decisions == out.decisions
    assert again.sites == out.sites


@pytest.mark.parametrize("scenario", ["router", "replica"])
def test_explore_router_and_replica(scenario):
    """At least 40 seeded schedules and the bounded exhaustive
    enumeration: the router's JAX invariants (no double absorb, one label
    set per request id, duplicates with their originals, monotone shard
    generations, a routed label never changing) and the replica's (a
    committed source view, a monotone adopted generation)."""
    stats = explore(scenario, n_seeded=40, exhaustive_bound=4, device=DEV)
    assert stats["trace_schedules_explored"] >= 40
    assert stats["trace_races_found"] == 0
    assert stats["trace_distinct_traces"] >= 8


class _LocklessShardRouter(ShardRouter):
    """``ShardRouter.query`` with the merge's ``with self._lock`` removed
    (the row map read while the writers' ingests update it)."""

    def query(self, vectors):
        vectors = np.ascontiguousarray(vectors, np.uint32)
        n = int(vectors.shape[0])
        owner = digest_range_ids(row_digests(vectors), self.n_shards)
        resps = self._broadcast({"op": "query", **encode_vectors(vectors)})
        gens = {sid: int(r.get("generation", 0))
                for sid, r in resps.items()}
        known = np.zeros(n, bool)
        best = np.full(n, _NONE, np.int64)
        foreign = np.full(n, _NONE, np.int64)
        shared_access(self, "gmap", write=False)  # no lock held
        for sid, resp in resps.items():
            mine = owner == sid
            known[mine] = np.asarray(resp["known"], bool)[mine]
            local = np.asarray(resp["labels"], np.int64).reshape(n)
            sel = np.flatnonzero(local >= 0)
            if sel.size == 0:
                continue
            g = self._map_labels(sid, local[sel])
            routed = g >= 0
            best[sel[routed]] = np.minimum(best[sel[routed]], g[routed])
            foreign[sel[~routed]] = np.minimum(foreign[sel[~routed]],
                                               g[~routed])
        out = np.where(best != _NONE, best,
                       np.where(foreign != _NONE, foreign, -1))
        return {"labels": out.astype(np.int64), "known": known,
                "generation": max(gens.values()),
                "shard_generations": gens}


def test_lockless_router_merge_is_a_gmap_race_that_replays():
    def build(tmp):
        return _router_scenario(tmp, torch.device(DEV), "host",
                                router_cls=_LocklessShardRouter)

    with pytest.raises(ScheduleError) as ei:
        explore("router", n_seeded=40, exhaustive_bound=4, build=build,
                device=DEV)
    msg = str(ei.value)
    assert "lockset race" in msg and "ShardRouter.gmap" in msg
    assert "NO locks" in msg
    replay_str = ei.value.schedule_str
    assert replay_str.startswith("v1:fix:")
    with pytest.raises(ScheduleError, match="ShardRouter.gmap"):
        run_scenario("router", Schedule.from_string(replay_str),
                     build=build, device=DEV)
    # the port's router under the same schedule: no race, every invariant
    run_scenario("router", Schedule.from_string(replay_str), device=DEV)


# -- TcpTransport's lock under the lockset detector ---------------------------

class _LocklessTcpTransport(TcpTransport):
    """The exchange without the transport's lock: two threads can
    interleave their frames on the one socket."""

    def __call__(self, msg, timeout_s=None):
        shared_access(self, "sock", write=True)  # no lock held
        from tse1m_tpu_torch.serve.server import read_msg, write_msg

        sock = self._connect()
        sock.settimeout(timeout_s or 5.0)
        write_msg(sock, msg)
        return read_msg(sock)


def _two_threads_through(transport, items) -> list:
    errors: list = []

    def worker(tid):
        try:
            for i in range(6):
                sel = np.arange(tid + i, len(items), 5)
                r = transport({"op": "query",
                               **encode_vectors(items[sel])})
                assert r["ok"], r
        except Exception as e:  # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    return errors


@pytest.fixture
def shard_server(tmp_path):
    daemon = ServeDaemon(str(tmp_path / "range_0000"),
                         params=ClusterParams(n_hashes=16, n_bands=4),
                         device=DEV).start()
    items = np.random.default_rng(3).integers(
        0, 2**20, size=(24, 16), dtype=np.int64).astype(np.uint32)
    daemon.ingest(items, timeout=60)
    srv = ServeServer(daemon)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv, items
    finally:
        srv.shutdown()
        srv.server_close()
        daemon.stop(commit=False)


def test_tcp_transport_lock_guards_the_socket(shard_server):
    srv, items = shard_server
    transport = TcpTransport(port=srv.port)
    try:
        with traced() as tr:
            errors = _two_threads_through(transport, items)
        assert errors == []
        assert tr.lockset.races == []
    finally:
        transport.close()


def test_lockless_tcp_transport_raises_race_error(shard_server):
    srv, items = shard_server
    transport = _LocklessTcpTransport(port=srv.port)
    try:
        with pytest.raises(RaceError) as ei:
            with traced():
                # A thread at a time: the race is in the lock discipline,
                # so the detector needs no unlucky timing to see it.
                for tid in range(2):
                    t = threading.Thread(target=transport, args=(
                        {"op": "ping"},))
                    t.start()
                    t.join(timeout=60)
                    assert not t.is_alive()
        names = [r.name for r in ei.value.races]
        assert any("TcpTransport.sock" in n for n in names), names
    finally:
        transport.close()


# -- the daemon's signer ------------------------------------------------------

def _ingest_all(daemon, items) -> list:
    return [daemon._ingest_batch(items[lo:lo + 4])["labels"]
            for lo in range(0, len(items), 4)]


def _stored(directory: str, digests: np.ndarray) -> np.ndarray:
    store = SignatureStore.open_existing(directory)
    hit, shard, row = store.bulk_probe(digests)
    assert hit.all()
    return store.load_signatures(shard, row)


@pytest.mark.parametrize("quant_bits", [0, 10])
def test_host_and_device_signers_agree_with_jax(tmp_path, quant_bits):
    from tse1m_tpu_torch.data.synth import synth_session_sets

    items = synth_session_sets(16, set_size=16, seed=9,
                               dup_fraction=0.5)[0]
    digests = row_digests(items)
    policy = {"n_hashes": 16, "n_bands": 4, "seed": 0}
    labels, sigs = {}, {}
    for signer in ("host", "device"):
        d = str(tmp_path / signer)
        daemon = ServeDaemon(d, params=ClusterParams(
            **policy, wire_quant_bits=quant_bits or -1),
            device=DEV, signer=signer)
        assert daemon.signer == signer
        labels[signer] = _ingest_all(daemon, items)
        sigs[signer] = _stored(d, digests)
    jd = str(tmp_path / "jax")
    jdaemon = JDaemon(jd, params=JParams(**policy, use_pallas="never",
                                         wire_quant_bits=quant_bits or -1),
                      signer="host")
    jlabels = _ingest_all(jdaemon, items)
    assert labels["host"] == labels["device"] == jlabels
    assert sigs["host"].tobytes() == sigs["device"].tobytes()
    assert sigs["host"].tobytes() == _stored(jd, digests).tobytes()


def test_unknown_signer_refused_in_jax_words(tmp_path):
    with pytest.raises(ValueError, match="unknown signer 'gpu'; expected "
                       "'device' or 'host'"):
        ServeDaemon(str(tmp_path / "s"), device=DEV, signer="gpu")
    with pytest.raises(ValueError, match="unknown signer 'gpu'; expected "
                       "'device' or 'host'"):
        JDaemon(str(tmp_path / "j"), signer="gpu")
    assert not os.path.exists(tmp_path / "s")
