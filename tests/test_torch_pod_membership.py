"""The port's elastic pod membership against the JAX package's, on the CPU
(the counterpart of tests/test_elastic_membership.py).

- ``MembershipLedger``: the same sequences of bootstrap, loss and
  re-admission write ``membership.json`` byte for byte as JAX's and
  record the same degradation events; a ledger advanced by one package is
  continued by the other.
- ``PeerMonitor``: the replay guard (a rolled-back nonce, a regressed
  seq) and the epoch-scoped latch, beside JAX's monitor over the same
  heartbeat files.
- Epoch leases and the lease-fenced ``ShardedSignatureStore``: lease
  files byte for byte, and a zombie's append fences with zero rows
  written, in either package against a root the other holds.
- ``cluster_sessions_pod`` re-admission at an epoch boundary, the labels
  JAX's.

Tolerance: exact (bytes, JSON, labels).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest

from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.cluster import store as jstore
from tse1m_tpu.observability import \
    pop_degradation_events as j_pop_events
from tse1m_tpu.observability import tracing as jtracing
from tse1m_tpu.resilience import coordinator as jco
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.cluster import store as tstore
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.observability import \
    pop_degradation_events as t_pop_events
from tse1m_tpu_torch.observability import tracing as ttracing
from tse1m_tpu_torch.resilience import coordinator as tco
from tse1m_tpu_torch.utils.atomic import atomic_write

POLICY = {"n_hashes": 32, "seed": 13, "quant_bits": 0}
PACKAGES = {"torch": (tco, tstore, t_pop_events),
            "jax": (jco, jstore, j_pop_events)}


@pytest.fixture(autouse=True)
def _unpinned(monkeypatch):
    """Both packages start with no pinned trace id, as a fresh process
    does: an id an earlier test in this process pinned rides one
    package's beats and exchange payloads.  What a test pins is undone
    after it."""
    monkeypatch.setattr(jtracing, "_pinned", None)
    monkeypatch.setattr(ttracing, "_pinned", None)


def _events(pop) -> list:
    return [(e["kind"], e.get("site"), e.get("detail")) for e in pop()]


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _items(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**20, size=(n, 16), dtype=np.uint32)


# -- the membership ledger ---------------------------------------------------

SEQUENCES = {
    "bootstrap": [("bootstrap", [0, 1], "n0")],
    "same_members": [("bootstrap", [0, 1], "n0"),
                     ("bootstrap", [0, 1], "n1")],
    "loss": [("bootstrap", [0, 1], "n0"),
             ("advance", [0], "n1", "host_lost")],
    "leader_loss": [("bootstrap", [0, 1, 2], "n0"),
                    ("advance", [1, 2], "n1", "host_lost")],
    "readmission": [("bootstrap", [0, 1], "n0"),
                    ("advance", [0], "n1", "host_lost"),
                    ("bootstrap", [0, 1], "n2")],
    "shrink_then_grow": [("bootstrap", [0, 1, 2, 3], "a"),
                         ("bootstrap", [0, 2], "b"),
                         ("advance", [2], "c", "host_lost"),
                         ("bootstrap", [0, 1, 2, 3], "d")],
}


def _apply(ledger, op) -> dict:
    if op[0] == "bootstrap":
        return ledger.bootstrap(op[1], op[2])
    return ledger.advance(op[1], op[2], reason=op[3])


@pytest.mark.parametrize("n_ranges", [2, 5])
@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_ledger_records_equal_jax(tmp_path, name, n_ranges):
    """Each step's record, the file's bytes and the degradation events are
    JAX's."""
    t_pop_events(), j_pop_events()
    tl = tco.MembershipLedger(str(tmp_path / "t"), n_ranges)
    jl = jco.MembershipLedger(str(tmp_path / "j"), n_ranges)
    for op in SEQUENCES[name]:
        assert _apply(tl, op) == _apply(jl, op)
        assert _bytes(tl.path) == _bytes(jl.path)
        assert tl.load() == jl.load()
        assert _events(t_pop_events) == _events(j_pop_events)


@pytest.mark.parametrize("first", ["torch", "jax"])
def test_ledger_continued_by_the_other_package(tmp_path, first):
    """A ledger advanced by one package, continued by the other, equals
    one package's ledger over the whole sequence."""
    ops = SEQUENCES["readmission"] + [("advance", [1], "n3", "host_lost")]
    a, b = (tco, jco) if first == "torch" else (jco, tco)
    mixed = str(tmp_path / "mixed")
    for i, op in enumerate(ops):
        _apply((a if i % 2 == 0 else b).MembershipLedger(mixed, 4), op)
    one = tco.MembershipLedger(str(tmp_path / "one"), 4)
    for op in ops:
        _apply(one, op)
    assert _bytes(os.path.join(mixed, "membership.json")) == _bytes(one.path)
    t_pop_events(), j_pop_events()


def test_ledger_deal_and_wait_for(tmp_path):
    led = tco.MembershipLedger(str(tmp_path), n_ranges=4)
    rec = led.bootstrap([0, 1], "n0")
    assert rec["epoch"] == 0 and rec["moved"] == []
    assert rec["owners"] == {0: 0, 1: 1, 2: 0, 3: 1}  # == r % nproc
    for members in ([0], [1], [0, 2], [0, 1, 2], [3, 1]):
        for prior in (None, {0: 0, 1: 1, 2: 0, 3: 1}, {0: 1, 1: 1}):
            assert tco.MembershipLedger._deal(prior, members, 7) == \
                jco.MembershipLedger._deal(prior, members, 7)
    # JAX's wait_for adopts the port's record, and the reverse.
    assert jco.MembershipLedger(str(tmp_path), 4).wait_for(
        "n0", timeout_s=1.0) == rec
    jco.MembershipLedger(str(tmp_path), 4).bootstrap([0, 1], "n1")
    assert led.wait_for("n1", timeout_s=1.0)["nonce"] == "n1"
    with pytest.raises(TimeoutError, match="no membership record"):
        led.wait_for("other", timeout_s=0.3)


def test_ledger_wait_for_polls_the_monitor(tmp_path):
    """A leader that dies before publishing the deal: HostLostError, not a
    hang."""
    led = tco.MembershipLedger(str(tmp_path), n_ranges=2)
    mon = tco.PeerMonitor(str(tmp_path), n_processes=2, process_id=1,
                          timeout_s=0.2)
    t0 = time.monotonic()
    with pytest.raises(tco.HostLostError) as ei:
        led.wait_for("never", monitor=mon)
    assert ei.value.lost == [0] and ei.value.site == "pod.membership"
    assert time.monotonic() - t0 < 3.0
    t_pop_events()


# -- the heartbeat replay guard and the epoch latch ---------------------------


def _monitors(d: str, timeout_s: float = 0.3) -> list:
    return [m.PeerMonitor(d, n_processes=2, process_id=0,
                          timeout_s=timeout_s) for m in (tco, jco)]


def _polls(mons) -> list:
    return [m.poll() for m in mons]


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_monitor_rejects_nonce_rollback(tmp_path, writer):
    d = str(tmp_path)
    co = PACKAGES[writer][0]
    co.HeartbeatWriter(d, 1).beat_once()
    stale = _bytes(co.heartbeat_path(d, 1))   # nonce A, seq 1
    mons = _monitors(d)
    assert _polls(mons) == [[], []]
    co.HeartbeatWriter(d, 1).beat_once()      # a restarted peer: nonce B
    assert _polls(mons) == [[], []]
    with atomic_write(co.heartbeat_path(d, 1), "wb") as f:
        f.write(stale)                        # nonce A resurfaces
    time.sleep(0.45)
    assert _polls(mons) == [[1], [1]]
    t_pop_events(), j_pop_events()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_monitor_rejects_seq_regression(tmp_path, writer):
    d = str(tmp_path)
    co = PACKAGES[writer][0]
    w = co.HeartbeatWriter(d, 1)
    for _ in range(3):
        w.beat_once()
    mons = _monitors(d)
    assert _polls(mons) == [[], []]
    rec = json.loads(_bytes(co.heartbeat_path(d, 1)))
    rec["seq"] = 1
    with atomic_write(co.heartbeat_path(d, 1)) as f:
        json.dump(rec, f)
    time.sleep(0.45)
    assert _polls(mons) == [[1], [1]]
    t_pop_events(), j_pop_events()


def test_monitor_epoch_scoped_latch_and_stale_file(tmp_path):
    """Lost in epoch 0 and latched; in epoch 1 a new nonce re-admits, the
    old file alone does not.  The loss latch is set."""
    d = str(tmp_path)
    w = tco.HeartbeatWriter(d, 1)
    w.beat_once()
    mons = _monitors(d)
    _polls(mons)
    time.sleep(0.45)
    assert _polls(mons) == [[1], [1]]
    assert tco.saw_host_loss()
    # No torch.distributed world here: the exit code comes back.
    assert tco.hard_exit_if_host_lost(3) == 3
    w.beat_once()
    assert _polls(mons) == [[1], [1]]         # latched within the epoch
    assert [m.advance_epoch() for m in mons] == [1, 1]
    assert _polls(mons) == [[], []]           # a fresh grace window
    time.sleep(0.45)
    assert _polls(mons) == [[1], [1]]         # nothing new on disk
    assert [m.advance_epoch() for m in mons] == [2, 2]
    tco.HeartbeatWriter(d, 1).beat_once()     # a new nonce: re-admitted
    time.sleep(0.2)
    assert _polls(mons) == [[], []]
    assert [m.ever_lost() for m in mons] == [[1], [1]]
    events = [e for e in t_pop_events() if e["kind"] == "host_lost"]
    assert [e["detail"]["epoch"] for e in events] == [0, 1]
    j_pop_events()


# -- leases and the lease-fenced store ------------------------------------------


def test_leases_equal_jax_and_fence_across_packages(tmp_path):
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    os.makedirs(t), os.makedirs(j)
    for root, co in ((t, tco), (j, jco)):
        co.acquire_lease(root, 0, epoch=0, owner=1, nonce="old")
        co.acquire_lease(root, 0, epoch=1, owner=0, nonce="new")
        co.write_lease(root, 3, epoch=2, owner=0, nonce="x")
    for r in (0, 3):
        assert _bytes(tco.lease_path(t, r)) == _bytes(jco.lease_path(j, r))
    # Each package fences against the other's lease.
    with pytest.raises(tco.LeaseSupersededError) as ei:
        tco.verify_lease(j, 0, epoch=0, owner=1, nonce="old")
    assert ei.value.current["epoch"] == 1
    with pytest.raises(jco.LeaseSupersededError):
        jco.acquire_lease(t, 0, epoch=0, owner=1, nonce="old")
    with pytest.raises(tco.LeaseSupersededError):
        tco.acquire_lease(j, 3, epoch=2, owner=1, nonce="y")
    with pytest.raises(tco.LeaseSupersededError):
        tco.verify_lease(t, 7, epoch=0, owner=0, nonce="n")   # absent


def _membership(epoch, owners, nonce="n", moved=()):
    return {"epoch": epoch, "nonce": nonce, "owners": owners,
            "members": sorted(set(owners.values())),
            "moved": list(moved)}


def _range_files(root: str) -> dict:
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            out[os.path.relpath(p, root)] = _bytes(p)
    return out


@pytest.mark.parametrize("zombie_pkg,survivor_pkg",
                         [("torch", "jax"), ("jax", "torch"),
                          ("torch", "torch")])
def test_zombie_append_fences_with_zero_writes(tmp_path, zombie_pkg,
                                               survivor_pkg):
    """A writer on an epoch-0 lease whose range was re-dealt at epoch 1, by
    either package, raises LeaseSupersededError at its append, demotes to
    read-only, writes nothing, and records ``lease_superseded``."""
    root = str(tmp_path / "pod")
    zstore = PACKAGES[zombie_pkg][1]
    sstore = PACKAGES[survivor_pkg][1]
    zombie = zstore.ShardedSignatureStore(
        root, POLICY, n_processes=2, process_id=1, n_ranges=2,
        membership=_membership(0, {0: 0, 1: 1}, nonce="z"))
    survivor = sstore.ShardedSignatureStore(
        root, POLICY, n_processes=1, process_id=0, n_ranges=2,
        membership=_membership(1, {0: 0, 1: 0}, nonce="s", moved=[1]))
    assert survivor.owned == [0, 1] and survivor.reassigned_ranges == [1]
    d = tstore.row_digests(_items(200, seed=3))
    sigs = np.arange(200 * 32, dtype=np.uint32).reshape(200, 32)
    before = _range_files(root)
    t_pop_events(), j_pop_events()
    err = PACKAGES[zombie_pkg][0].LeaseSupersededError
    with pytest.raises(err):
        zombie.append(d, sigs)
    assert zombie.fenced and zombie.owned == []
    assert _range_files(root) == before
    assert any(e["kind"] == "lease_superseded"
               for e in PACKAGES[zombie_pkg][2]())
    with pytest.raises(err):
        zombie._check_lease(1)
    assert zombie.append(d, sigs) == 0
    assert survivor.append(d, sigs) == 200
    reader = tstore.ShardedSignatureStore(root, POLICY)
    assert reader.n_rows == 200
    t_pop_events(), j_pop_events()


def test_lease_fenced_store_opens_like_jax(tmp_path):
    """Ownership, reassignment events and the leases taken at open equal
    JAX's; an unleased open of a leased root fences at append; an
    unleased root appends."""
    t, j = str(tmp_path / "t"), str(tmp_path / "j")
    m = _membership(2, {0: 0, 1: 1, 2: 1}, nonce="k", moved=[2])
    t_pop_events(), j_pop_events()
    ts = tstore.ShardedSignatureStore(t, POLICY, n_processes=2, process_id=1,
                                      n_ranges=3, membership=m)
    js = jstore.ShardedSignatureStore(j, POLICY, n_processes=2, process_id=1,
                                      n_ranges=3, membership=m)
    assert (ts.owned, ts.reassigned_ranges, ts.epoch, ts.lease_nonce) == (
        js.owned, js.reassigned_ranges, js.epoch, js.lease_nonce)
    assert _events(t_pop_events) == _events(j_pop_events)
    assert _range_files(t) == _range_files(j)
    legacy = tstore.ShardedSignatureStore(t, POLICY, n_processes=2,
                                          process_id=1)
    with pytest.raises(tco.LeaseSupersededError):
        legacy.append(tstore.row_digests(_items(50, seed=5)),
                      np.zeros((50, 32), np.uint32))
    assert legacy.fenced
    free = tstore.ShardedSignatureStore(str(tmp_path / "free"), POLICY,
                                        n_ranges=2)
    assert free.append(tstore.row_digests(_items(50, seed=7)),
                       np.zeros((50, 32), np.uint32)) == 50
    t_pop_events(), j_pop_events()


# -- the pod path under membership --------------------------------------------


def test_pod_pipeline_epoch_advances_on_readmission(tmp_path):
    """A two-member history, then a solo resume in each package: the ledger
    advances to epoch 1 and every range re-deals to the solo process; the
    labels are JAX's and a second run is all hits at the same epoch."""
    items, _ = synth_session_sets(300, set_size=16, seed=13)
    got = {}
    for name, pipe in (("torch", tpipe), ("jax", jpipe)):
        root = str(tmp_path / name)
        co = PACKAGES[name][0]
        co.MembershipLedger(os.path.join(root, "pod"), 1).bootstrap(
            [0, 1], "h0")
        kw = {"device": "cpu"} if name == "torch" else {}
        params = pipe.ClusterParams(n_hashes=32, n_bands=4, sig_store=root,
                                    **({} if name == "torch"
                                       else {"use_pallas": "never"}))
        first = pipe.cluster_sessions_pod(items, 300, params, **kw)
        assert pipe.last_run_info["pod_epoch"] == 1
        assert pipe.last_run_info["pod_reassigned_ranges"] == []
        again = pipe.cluster_sessions_pod(items, 300, params, **kw)
        np.testing.assert_array_equal(first, again)
        assert pipe.last_run_info["cache_hit_rate"] == 1.0
        assert pipe.last_run_info["pod_epoch"] == 1
        got[name] = first
    np.testing.assert_array_equal(got["torch"], got["jax"])
    t_pop_events(), j_pop_events()
