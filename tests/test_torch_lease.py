"""tse1m_tpu_torch's epoch leases and heartbeats
(``resilience/coordinator.py``) against the JAX package's, on the CPU.

The files must be the JAX package's byte for byte, so that either
package fences the other's shard writer and reads its heartbeats: after
the same claims the lease and heartbeat files are equal; a lease JAX
claims at the next epoch fences a port daemon (zero rows appended), and
the reverse; both ``PeerMonitor`` s name the same lost peers over the
same heartbeat files.  Tolerance: exact."""

import os
import time

import numpy as np
import pytest

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.observability import flight as jflight
from tse1m_tpu.resilience import coordinator as jco
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.resilience import coordinator as tco
from tse1m_tpu_torch.serve import ServeDaemon

JP = JParams(n_hashes=32, n_bands=4, use_pallas="never")
TP = TParams(n_hashes=32, n_bands=4)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    saved = jflight._flight_dir, tflight._flight_dir
    yield
    jflight._flight_dir, tflight._flight_dir = saved


def _vectors(n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, 16),
                        dtype=np.int64).astype(np.uint32)


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def test_lease_and_heartbeat_files_equal_jax(tmp_path):
    roots = {"jax": str(tmp_path / "j"), "port": str(tmp_path / "t")}
    mods = {"jax": jco, "port": tco}
    for name, mod in mods.items():
        os.makedirs(roots[name])
        g1 = mod.RangeLeaseGuard.claim(roots[name], 3, owner=111,
                                       nonce="aa11")
        g2 = mod.RangeLeaseGuard.claim(roots[name], 3, owner=222,
                                       nonce="bb22")
        assert (g1.epoch, g2.epoch) == (1, 2)
        mod.RangeLeaseGuard.acquire(roots[name], 4, epoch=7, owner=5,
                                    nonce="cc33")
        hb = mod.HeartbeatWriter(roots[name], process_id=3, interval_s=60)
        hb._run_id = "0123456789abcdef"
        assert [hb.beat_once(), hb.beat_once()] == [1, 2]
    for rel in ("lease_0003.json", "lease_0004.json", "hb_003.json"):
        assert _read(os.path.join(roots["port"], rel)) == \
            _read(os.path.join(roots["jax"], rel)), rel
    # Each package reads and checks the other's files the same way.
    for reader, writer in (("jax", "port"), ("port", "jax")):
        mod, root = mods[reader], roots[writer]
        assert mod.read_lease(root, 3) == {"range": 3, "epoch": 2,
                                           "owner": 222, "nonce": "bb22"}
        mod.verify_lease(root, 3, 2, 222, "bb22")
        for held in ((1, 111, "aa11"), (2, 222, "zz"), (2, 9, "bb22")):
            with pytest.raises(mod.LeaseSupersededError):
                mod.verify_lease(root, 3, *held)
        with pytest.raises(mod.LeaseSupersededError):
            mod.acquire_lease(root, 3, 1, 111, "aa11")  # the zombie
        with pytest.raises(mod.LeaseSupersededError):
            mod.acquire_lease(root, 4, 7, 6, "dd44")  # same epoch, owner
        assert mod.read_lease(root, 9) is None


@pytest.mark.parametrize("fencer", ["jax_fences_port", "port_fences_jax"])
def test_next_epoch_claim_fences_the_other_package(tmp_path, fencer):
    """A writer holding epoch 1 appends; the other package claims epoch 2
    on the same range; the old writer's next batch raises at its fence
    point with zero rows appended and its ingest latched off."""
    root = str(tmp_path)
    items = _vectors(16, seed=33)
    writer_co, claimer_co = ((tco, jco) if fencer == "jax_fences_port"
                             else (jco, tco))
    guard = writer_co.RangeLeaseGuard.claim(root, 0, owner=111)
    store = str(tmp_path / "range_0000")
    if fencer == "jax_fences_port":
        zombie = ServeDaemon(store, params=TP, state_commit_every=1,
                             device="cpu", lease_guard=guard).start()
    else:
        zombie = JDaemon(store, params=JP, state_commit_every=1,
                         lease_guard=guard).start()
    try:
        assert zombie.ingest(items[:8], timeout=120)["ok"]
        rows_before = int(zombie.store.n_rows)
        new_guard = claimer_co.RangeLeaseGuard.claim(root, 0, owner=222)
        assert new_guard.epoch == 2
        with pytest.raises(Exception, match="superseded"):
            zombie.ingest(items[8:], timeout=120)
        assert int(zombie.store.n_rows) == rows_before == 8
        assert zombie._ingest_error is not None
        with pytest.raises(RuntimeError):
            zombie.ingest(items[8:], timeout=120)
    finally:
        zombie.stop(commit=False)
    # The replacement, in the claiming package, absorbs the same batch.
    if fencer == "jax_fences_port":
        repl = JDaemon(store, params=JP, state_commit_every=1,
                       lease_guard=new_guard).start()
    else:
        repl = ServeDaemon(store, params=TP, state_commit_every=1,
                           device="cpu", lease_guard=new_guard).start()
    try:
        r = repl.ingest(items[8:], timeout=120)
        assert r["ok"] and r["acked"] == 8
        assert repl.query(items)["known"].all()
        assert int(repl.store.n_rows) == 16
    finally:
        repl.stop(commit=False)


def test_fenced_state_commit_writes_nothing(tmp_path):
    """The second fence point: a superseded writer's state commit raises
    before the state file changes."""
    root = str(tmp_path)
    guard = tco.RangeLeaseGuard.claim(root, 0, owner=1)
    d = ServeDaemon(str(tmp_path / "range_0000"), params=TP,
                    state_commit_every=100, device="cpu",
                    lease_guard=guard).start()
    try:
        assert d.ingest(_vectors(8, seed=4), timeout=120)["ok"]
        state = os.path.join(root, "range_0000", "state.json")
        assert not os.path.exists(state)
        jco.RangeLeaseGuard.claim(root, 0, owner=2)
        with pytest.raises(tco.LeaseSupersededError):
            d._commit_state()
        assert not os.path.exists(state)
    finally:
        d.stop(commit=False)


def test_peer_monitor_matches_jax(tmp_path):
    """Over the same heartbeat files both monitors declare the same peers
    lost: one that never beat, one that stopped, one whose file rolled
    back to a nonce already seen; the live one stays."""
    root = str(tmp_path)
    writers = {}
    for pid in (0, 1, 2):
        w = tco.HeartbeatWriter(root, process_id=pid, interval_s=60)
        w.beat_once()
        writers[pid] = w
    old_nonce = writers[2].run_id
    monitors = {"jax": jco.PeerMonitor(root, 4, process_id=-1,
                                       timeout_s=0.3, peers=[0, 1, 2, 3]),
                "port": tco.PeerMonitor(root, 4, process_id=-1,
                                        timeout_s=0.3, peers=[0, 1, 2, 3])}
    for m in monitors.values():
        assert m.poll() == []
    # Peer 2 restarts under a new nonce, then its old file resurfaces.
    writers[2]._run_id = "feedfacefeedface"
    writers[2].beat_once()
    for m in monitors.values():
        assert m.poll() == []
    writers[2]._run_id = old_nonce
    writers[2].beat_once()
    deadline = time.monotonic() + 5.0
    lost = {}
    while time.monotonic() < deadline:
        writers[0].beat_once()
        lost = {name: m.poll() for name, m in monitors.items()}
        if lost["jax"] and lost["port"] and lost["jax"] == lost["port"] \
                and len(lost["port"]) == 3:
            break
        time.sleep(0.05)
    assert lost["port"] == lost["jax"] == [1, 2, 3]
    # The next epoch clears the latch: a new nonce readmits peer 1.
    for m in monitors.values():
        assert m.advance_epoch() == 1
    writers[1]._run_id = "0000000000000001"
    writers[1].beat_once()
    writers[0].beat_once()
    got = {name: m.poll() for name, m in monitors.items()}
    assert got["port"] == got["jax"] == []
    assert monitors["port"].ever_lost() == monitors["jax"].ever_lost() \
        == [1, 2, 3]
