"""The port's pod supervision against the JAX package's, on the CPU (the
counterpart of tests/test_pod_supervision.py).

- ``pod_row_range`` equal to JAX's over a grid of (n, processes, id), and
  ``fs_exchange`` across packages: each reads the other's npz, the files
  byte for byte under one clock and trace id, and a silent peer raises
  ``HostLostError`` in the wait.
- Heartbeats, the peer monitor, ``PodSupervisor.guarded`` (a hung phase
  becomes ``HostLostError``, a fence signal relays verbatim), the run
  nonce adopted across packages, the exchange directory's names.
- ``ShardedSignatureStore``: a root written by the same calls equal to
  JAX's byte for byte, each package continuing the other's root, its
  refusals in JAX's words, one writer a range, gather and reassignment.
- ``scrub`` and ``--verify-sigs`` of a pod root: the report JAX's, in
  process and through both command lines.

Tolerance: exact (bytes, JSON, arrays).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile

import numpy as np
import pytest

from tse1m_tpu import cli as jcli
from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.cluster import store as jstore
from tse1m_tpu.observability import \
    pop_degradation_events as j_pop_events
from tse1m_tpu.observability import tracing as jtracing
from tse1m_tpu.parallel import multihost as jmh
from tse1m_tpu.resilience import coordinator as jco
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.cluster import store as tstore
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.observability import \
    pop_degradation_events as t_pop_events
from tse1m_tpu_torch.observability import tracing as ttracing
from tse1m_tpu_torch.parallel import multihost as tmh
from tse1m_tpu_torch.resilience import coordinator as tco

POLICY = {"n_hashes": 32, "seed": 13, "quant_bits": 0}


@pytest.fixture(autouse=True)
def _unpinned(monkeypatch):
    """Both packages start with no pinned trace id, as a fresh process
    does: an id an earlier test in this process pinned rides one
    package's beats and exchange payloads.  What a test pins is undone
    after it."""
    monkeypatch.setattr(jtracing, "_pinned", None)
    monkeypatch.setattr(ttracing, "_pinned", None)


def _items(n: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(1, 2**20, size=(n, 16), dtype=np.uint32)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _tree(root: str, skip=("hb_",)) -> dict:
    """Every file under ``root`` (heartbeats aside: their run ids are
    random) -> its bytes."""
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            if n.startswith(skip):
                continue
            p = os.path.join(base, n)
            out[os.path.relpath(p, root)] = _bytes(p)
    return out


# -- the row deal and the file exchange ---------------------------------------


@pytest.mark.parametrize("nproc", [1, 2, 3, 4, 7])
def test_pod_row_range_equals_jax(nproc):
    for n in (0, 1, 2, 7, 800, 801, 1001, 1_050_000):
        spans = [tmh.pod_row_range(n, nproc, p) for p in range(nproc)]
        assert spans == [jmh.pod_row_range(n, nproc, p)
                         for p in range(nproc)]
        assert spans[0][0] == 0 and spans[-1][1] == n
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    assert tmh.pod_row_range(10, 0, 0) == jmh.pod_row_range(10, 0, 0)


def _payload(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    miss = rng.random(9) < 0.5
    return {"digests": rng.integers(0, 2**63, (9, 2), dtype=np.uint64),
            "miss": miss,
            "novel_sigs": rng.integers(0, 2**32, (int(miss.sum()), 8),
                                       dtype=np.uint64).astype(np.uint32)}


@pytest.mark.parametrize("order", [("torch", "jax"), ("jax", "torch")])
def test_fs_exchange_across_packages(tmp_path, order):
    """Process 0 of one package and process 1 of the other swap payloads
    through one directory: each gets both, in process order."""
    mods = {"torch": tmh, "jax": jmh}
    pays = [_payload(0), _payload(1)]
    out: dict = {}

    def run(pid: int) -> None:
        out[pid] = mods[order[pid]].fs_exchange(
            str(tmp_path), "novel", pays[pid], timeout_s=30,
            n_processes=2, process_id=pid)

    threads = [threading.Thread(target=run, args=(p,)) for p in (0, 1)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    for pid in (0, 1):
        assert len(out[pid]) == 2
        for got, want in zip(out[pid], pays):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
                assert got[k].dtype == want[k].dtype
    assert sorted(os.listdir(tmp_path)) == ["novel.p000.npz",
                                            "novel.p001.npz"]


def test_fs_exchange_files_equal_jax(tmp_path, monkeypatch):
    """One payload, one pinned trace id, one clock: the port's npz is
    JAX's byte for byte, its ``__trace__`` entry included."""
    monkeypatch.setattr(zipfile.time, "time", lambda: 1_700_000_000.0)
    trace = "00112233445566778899aabbccddeeff"
    ttracing.adopt_trace(trace)
    jtracing.adopt_trace(trace)
    try:
        for name, mod in (("t", tmh), ("j", jmh)):
            got = mod.fs_exchange(str(tmp_path / name), "novel",
                                  _payload(3), n_processes=1, process_id=0)
            assert sorted(got[0]) == ["digests", "miss", "novel_sigs"]
    finally:
        ttracing.adopt_trace(None)
        jtracing.adopt_trace(None)
    t = _bytes(tmp_path / "t" / "novel.p000.npz")
    assert t == _bytes(tmp_path / "j" / "novel.p000.npz")
    with np.load(tmp_path / "t" / "novel.p000.npz") as z:
        assert bytes(z["__trace__"]).hex() == trace


def test_fs_exchange_polls_the_monitor(tmp_path):
    """A peer that never writes its payload and never beats: HostLostError
    within a heartbeat timeout, not a hang; without a monitor, the
    backstop timeout."""
    mon = tco.PeerMonitor(str(tmp_path / "hb"), n_processes=2,
                          process_id=0, timeout_s=0.3)
    t0 = time.monotonic()
    with pytest.raises(tco.HostLostError) as ei:
        tmh.fs_exchange(str(tmp_path / "x"), "novel", _payload(0),
                        monitor=mon, n_processes=2, process_id=0)
    assert ei.value.lost == [1] and ei.value.site == "pod.exchange:novel"
    assert time.monotonic() - t0 < 5.0
    with pytest.raises(TimeoutError, match="no payload from process"):
        tmh.fs_exchange(str(tmp_path / "y"), "novel", _payload(0),
                        timeout_s=0.2, n_processes=2, process_id=0)
    t_pop_events()


# -- heartbeats, the monitor, the supervisor ------------------------------------


def test_heartbeat_files_and_suspension(tmp_path):
    d = str(tmp_path)
    w = tco.HeartbeatWriter(d, 3, interval_s=0.02)
    assert w.beat_once() == 1 and w.beat_once() == 2
    rec = json.loads(_bytes(tco.heartbeat_path(d, 3)))
    assert sorted(rec) == ["process_id", "run", "seq", "trace"]
    assert (rec["seq"], rec["process_id"], rec["run"]) == (2, 3, w.run_id)
    assert tco.heartbeat_path(d, 3) == jco.heartbeat_path(d, 3)
    w.start()
    try:
        tco.suspend_heartbeats()
        time.sleep(0.1)
        frozen = json.loads(_bytes(tco.heartbeat_path(d, 3)))["seq"]
        time.sleep(0.15)
        assert json.loads(_bytes(tco.heartbeat_path(d, 3)))["seq"] == frozen
        tco.resume_heartbeats()
        time.sleep(0.15)
        assert json.loads(_bytes(tco.heartbeat_path(d, 3)))["seq"] > frozen
    finally:
        tco.resume_heartbeats()
        w.stop()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_monitors_agree_on_a_live_and_a_silent_peer(tmp_path, writer):
    """Over one heartbeat directory the port's monitor and JAX's see the
    same: a beating peer alive, a silent one lost and latched."""
    d = str(tmp_path)
    co = tco if writer == "torch" else jco
    live = co.HeartbeatWriter(d, 1, interval_s=0.05).start()
    co.HeartbeatWriter(d, 2).beat_once()
    try:
        mons = [m.PeerMonitor(d, n_processes=3, process_id=0,
                              timeout_s=0.4) for m in (tco, jco)]
        for _ in range(2):
            time.sleep(0.15)
            assert [m.poll() for m in mons] == [[], []]
        time.sleep(0.4)
        assert [m.poll() for m in mons] == [[2], [2]]
        with pytest.raises(tco.HostLostError) as ei:
            mons[0].check(site="unit")
        assert str(ei.value) == str(jco.HostLostError([2], site="unit"))
    finally:
        live.stop()
    t_pop_events(), j_pop_events()


def test_supervisor_guarded(tmp_path):
    """A phase hung on a silent peer raises HostLostError within about a
    timeout; a result passes through; a fence signal relays at once and
    verbatim; a failure with every peer alive re-raises as itself."""
    sup = tco.PodSupervisor(str(tmp_path / "a"), n_processes=2,
                            process_id=0, interval_s=0.05, timeout_s=0.3)
    hang = threading.Event()
    t0 = time.monotonic()
    with pytest.raises(tco.HostLostError):
        sup.guarded(hang.wait, site="unit.hang")
    assert time.monotonic() - t0 < 5.0
    hang.set()
    assert sup.survivors() == [0]
    one = tco.PodSupervisor(str(tmp_path / "b"), n_processes=1, process_id=0)
    assert one.guarded(lambda: 41 + 1, site="unit.ok") == 42

    def fenced():
        raise tco.LeaseSupersededError(
            0, {"epoch": 1, "owner": 0, "nonce": "a"},
            {"epoch": 2, "owner": 1, "nonce": "b"})

    sup2 = tco.PodSupervisor(str(tmp_path / "c"), n_processes=2,
                             process_id=0, interval_s=0.05, timeout_s=0.2)
    t0 = time.monotonic()
    with pytest.raises(tco.LeaseSupersededError):
        sup2.guarded(fenced, site="unit.fence")
    assert time.monotonic() - t0 < 2.0
    with pytest.raises(KeyError):
        one.guarded(lambda: {}["x"], site="unit.err")
    t_pop_events()


@pytest.mark.parametrize("leader", ["torch", "jax"])
def test_run_nonce_adopted_across_packages(tmp_path, leader):
    """The leader of one package publishes ``run_nonce.json`` stamped with
    its heartbeat run id; a peer of the other adopts it and pins it as its
    trace id."""
    pod = str(tmp_path)
    lead_co, peer_co = (tco, jco) if leader == "torch" else (jco, tco)
    lead = lead_co.PodSupervisor(pod, 2, 0, interval_s=0.05,
                                 timeout_s=2.0).start()
    peer = peer_co.PodSupervisor(pod, 2, 1, interval_s=0.05, timeout_s=2.0)
    try:
        nonce = lead_co.negotiate_run_nonce(lead, pod_dir=pod)
        rec = json.loads(_bytes(os.path.join(pod, "run_nonce.json")))
        assert _bytes(os.path.join(pod, "run_nonce.json")).decode() == \
            json.dumps({"nonce": nonce, "leader_run": lead.writer.run_id})
        assert rec["leader_run"] == lead.writer.run_id
        assert peer_co.negotiate_run_nonce(peer, pod_dir=pod) == nonce
        assert (ttracing.pinned_trace() if leader == "jax"
                else jtracing.pinned_trace()) == nonce
    finally:
        lead.stop()
        ttracing.adopt_trace(None)
        jtracing.adopt_trace(None)
    single = tco.negotiate_run_nonce(None)
    assert len(single) == 16 and single != nonce
    int(single, 16)
    ttracing.adopt_trace(None)


def test_stale_run_nonce_is_not_adopted(tmp_path):
    """A previous run left a nonce file and a leader heartbeat that agree.
    A peer that starts before this run's leader has beaten waits for the
    leader's heartbeat to advance: it adopts the new run's nonce, never the
    dead run's (JAX's peer adopts the stale one and then waits in another
    exchange directory than its leader's), and with no leader at all it
    declares process 0 lost."""
    pod = str(tmp_path)
    old = tco.PodSupervisor(pod, 2, 0, interval_s=0.05).start()
    stale = tco.negotiate_run_nonce(old, pod_dir=pod)
    old.stop()
    time.sleep(0.15)  # the dead run's last beat is on disk
    peer = jco.PodSupervisor(pod, 2, 1, timeout_s=1.0)
    assert jco.negotiate_run_nonce(peer, pod_dir=pod) == stale
    peer = tco.PodSupervisor(pod, 2, 1, timeout_s=0.5)
    with pytest.raises(tco.HostLostError) as ei:
        tco.negotiate_run_nonce(peer, pod_dir=pod)
    assert ei.value.lost == [0] and ei.value.site == "pod.nonce"
    got: dict = {}
    peer = tco.PodSupervisor(pod, 2, 1, timeout_s=5.0)
    t = threading.Thread(target=lambda: got.update(
        nonce=tco.negotiate_run_nonce(peer, pod_dir=pod)))
    t.start()
    time.sleep(0.3)
    lead = tco.PodSupervisor(pod, 2, 0, interval_s=0.05).start()
    try:
        fresh = tco.negotiate_run_nonce(lead, pod_dir=pod)
        t.join(timeout=10)
        assert not t.is_alive()
    finally:
        lead.stop()
    assert got["nonce"] == fresh != stale
    ttracing.adopt_trace(None)
    jtracing.adopt_trace(None)
    t_pop_events(), j_pop_events()


def test_exchange_dir_names_and_sweep(tmp_path):
    pod = str(tmp_path)
    old = tco.exchange_dir(pod, "deadbeef00000000")
    assert old == jco.exchange_dir(pod, "deadbeef00000000")
    open(os.path.join(old, "novel.p000.npz"), "wb").close()
    new = tco.exchange_dir(pod, "feedface00000000", sweep_stale=True)
    assert os.path.basename(new) == "xch_feedface00000000"
    assert os.path.isdir(new) and not os.path.exists(old)
    assert tco.exchange_dir(pod, "feedface00000000", sweep_stale=True) == new
    assert os.path.isdir(new)


# -- the digest-range sharded store ------------------------------------------


@pytest.mark.parametrize("n_ranges", [2, 3])
def test_sharded_root_equals_jax(tmp_path, n_ranges):
    """The same opens and appends, by process, write the same root: the
    topology, every range's files and every lease, byte for byte; the
    probes and gathers agree."""
    d = tstore.row_digests(_items(300, seed=2))
    sigs = np.arange(300 * 32, dtype=np.uint32).reshape(300, 32)
    for name, st in (("t", tstore), ("j", jstore)):
        root = str(tmp_path / name)
        for pid in range(n_ranges):
            s = st.ShardedSignatureStore(root, POLICY, n_processes=n_ranges,
                                         process_id=pid)
            s.append(d[pid::2], sigs[pid::2])
    assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))
    ts = tstore.ShardedSignatureStore(str(tmp_path / "t"), POLICY)
    js = jstore.ShardedSignatureStore(str(tmp_path / "j"), POLICY)
    th, tl = ts.probe(d)
    jh, jl = js.probe(d)
    np.testing.assert_array_equal(th, jh)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(ts.load_signatures(tl[th]),
                                  js.load_signatures(jl[jh]))
    np.testing.assert_array_equal(ts.owned_mask(d), js.owned_mask(d))
    assert ts.n_rows == js.n_rows and ts.n_ranges == n_ranges
    assert tstore.ShardedSignatureStore.root_n_ranges(str(tmp_path / "t")) \
        == n_ranges
    assert tstore.ShardedSignatureStore.root_n_ranges(
        str(tmp_path / "none"), default=4) == 4
    t_pop_events(), j_pop_events()


@pytest.mark.parametrize("first", ["torch", "jax"])
def test_each_package_continues_the_others_root(tmp_path, first):
    """One package creates and half fills a root; the other appends the
    rest, and the root equals one package's over both appends."""
    d = tstore.row_digests(_items(200, seed=4))
    sigs = np.arange(200 * 32, dtype=np.uint32).reshape(200, 32)
    a, b = (tstore, jstore) if first == "torch" else (jstore, tstore)
    mixed, one = str(tmp_path / "mixed"), str(tmp_path / "one")
    a.ShardedSignatureStore(mixed, POLICY, n_ranges=2).append(d[:100],
                                                              sigs[:100])
    b.ShardedSignatureStore(mixed, POLICY, n_ranges=2).append(d, sigs)
    s = tstore.ShardedSignatureStore(one, POLICY, n_ranges=2)
    s.append(d[:100], sigs[:100])
    tstore.ShardedSignatureStore(one, POLICY, n_ranges=2).append(d, sigs)
    assert _tree(mixed) == _tree(one)
    hit, loc = a.ShardedSignatureStore(mixed, POLICY).probe(d)
    assert hit.all()
    t_pop_events(), j_pop_events()


def _refusal(fn) -> tuple:
    with pytest.raises(Exception) as e:
        fn()
    return type(e.value).__name__, str(e.value)


def test_sharded_store_refusals_in_jax_words(tmp_path):
    single = str(tmp_path / "single")
    tstore.SignatureStore(single, POLICY)
    pod = str(tmp_path / "pod")
    tstore.ShardedSignatureStore(pod, POLICY)
    bad = {**POLICY, "seed": 99}
    for fn_t, fn_j in (
            (lambda: tstore.ShardedSignatureStore(single, POLICY, 2, 0),
             lambda: jstore.ShardedSignatureStore(single, POLICY, 2, 0)),
            (lambda: tstore.ShardedSignatureStore(pod, bad),
             lambda: jstore.ShardedSignatureStore(pod, bad))):
        got = _refusal(fn_t)
        assert got == _refusal(fn_j)
        assert got[0] == "ValueError"
    assert "single-host store" in _refusal(
        lambda: tstore.ShardedSignatureStore(single, POLICY))[1]
    assert tstore.ShardedSignatureStore.is_sharded_root(pod)
    assert not tstore.is_sharded_root(single)


def test_sharded_store_single_writer_gather_and_reassignment(tmp_path):
    root = str(tmp_path / "pod")
    d = tstore.row_digests(_items(300, seed=2))
    sigs = np.arange(300 * 32, dtype=np.uint32).reshape(300, 32)
    s0 = tstore.ShardedSignatureStore(root, POLICY, n_processes=2,
                                      process_id=0)
    s1 = tstore.ShardedSignatureStore(root, POLICY, n_processes=2,
                                      process_id=1)
    assert s0.owned == [0] and s1.owned == [1]
    w0, w1 = s0.append(d, sigs), s1.append(d, sigs)
    assert w0 > 0 and w1 > 0 and w0 + w1 == 300
    ro = s0.range_store(1)
    assert ro.read_only
    with pytest.raises(RuntimeError, match="read-only"):
        ro.append(d[:1], sigs[:1])
    s0.refresh()
    t_pop_events(), j_pop_events()
    solo = tstore.ShardedSignatureStore(root, POLICY, n_processes=1,
                                        process_id=0)
    jsolo = jstore.ShardedSignatureStore(root, POLICY, n_processes=1,
                                         process_id=0)
    assert (solo.owned, solo.reassigned_ranges) == (
        jsolo.owned, jsolo.reassigned_ranges) == ([0, 1], [1])
    events = [(e["kind"], e["detail"]) for e in t_pop_events()]
    assert events == [(e["kind"], e["detail"]) for e in j_pop_events()]
    assert events[0][0] == "shard_range_reassigned"
    hit, loc = solo.probe(d)
    assert hit.all()
    np.testing.assert_array_equal(solo.load_signatures(loc), sigs)
    solo.demote_to_read_only()
    assert solo.fenced and all(s.read_only for s in solo._stores.values())


# -- scrub and --verify-sigs of a pod root --------------------------------------


@pytest.fixture(scope="module")
def pod_root(tmp_path_factory):
    """A root populated through the port's pod path (one process), over
    the rows the scrub's --verify-sigs synthesizes."""
    items, _ = synth_session_sets(400, set_size=16, seed=13)
    root = str(tmp_path_factory.mktemp("pod_scrub") / "root")
    tpipe.cluster_sessions_pod(items, 400, tpipe.ClusterParams(
        n_hashes=32, n_bands=4, sig_store=root), device="cpu")
    t_pop_events()
    return root, items


def _corrupt_one_shard(root: str) -> None:
    """Flip a byte in a committed signature shard and restamp its CRC: the
    frame vouches for the rot, and only the recompute can catch it."""
    for rd in sorted(x for x in os.listdir(root) if x.startswith("range_")):
        man_path = os.path.join(root, rd, "store_manifest.json")
        man = json.loads(_bytes(man_path))
        if not man["shards"]:
            continue
        entry = man["shards"][0]
        sig_path = os.path.join(root, rd, f"sig_{entry['id']:05d}.npy")
        with open(sig_path, "r+b") as f:
            f.seek(os.path.getsize(sig_path) - 4)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
        entry["sig_crc"] = tstore.file_crc(sig_path)
        with open(man_path, "w") as f:
            json.dump(man, f)
        return
    raise AssertionError("no committed shard")


@pytest.mark.parametrize("corrupt", [False, True])
def test_pod_scrub_and_verify_equal_jax(tmp_path, pod_root, corrupt):
    root, items = pod_root
    reports = {}
    for name, st in (("t", tstore), ("j", jstore)):
        copy = str(tmp_path / name)
        shutil.copytree(root, copy)
        if corrupt:
            _corrupt_one_shard(copy)
        policy = json.loads(_bytes(os.path.join(copy,
                                                "pod_topology.json")))[
            "policy"]
        store = st.ShardedSignatureStore(copy, policy)
        rep = store.scrub(repair=True)
        rep.update(store.verify_signatures(items, sample=10_000, seed=0))
        hit, _ = store.probe(tstore.row_digests(items))
        reports[name] = (rep, bool(hit.all()))
    assert reports["t"] == reports["j"]
    rep, all_hit = reports["t"]
    assert rep["store_scrub_ranges"] == 1 and rep["store_scrub_owned_ranges"]
    assert rep["store_scrub_verify_ok"] is (not corrupt)
    assert (rep["store_scrub_verify_mismatch"] >= 1) is corrupt
    assert all_hit is (not corrupt)
    assert _tree(str(tmp_path / "t")) == _tree(str(tmp_path / "j"))
    t_pop_events(), j_pop_events()


def test_scrub_command_of_a_pod_root_equals_jax(tmp_path, pod_root, capsys,
                                                monkeypatch):
    root, _ = pod_root
    args = ["--verify-sigs", "--verify-n", "400", "--verify-seed", "13",
            "--verify-set-size", "16", "--verify-sample", "64"]
    out = {}
    for name, main in (("t", cli_main), ("j", jcli.main)):
        copy = str(tmp_path / name)
        shutil.copytree(root, copy)
        monkeypatch.setenv("TSE1M_RESULT_DIR", str(tmp_path / f"res_{name}"))
        assert main(["scrub", copy, *args]) == 0
        rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        rep.pop("store_scrub_dir")
        out[name] = rep
    assert out["t"] == out["j"]
    assert out["t"]["store_scrub_verify_ok"] is True
    assert out["t"]["store_scrub_verify_sampled"] > 0
    manifest = json.loads(_bytes(tmp_path / "res_t" / "run_manifest.json"))
    assert manifest["steps"][0]["name"] == "scrub"
    assert manifest["steps"][0]["status"] == "ok"
    t_pop_events(), j_pop_events()


# -- the pod path's refusals ----------------------------------------------------


def test_cluster_sessions_pod_refusals_in_jax_words(tmp_path):
    items = _items(8)
    assert _refusal(lambda: tpipe.cluster_sessions_pod(
        items, 8, tpipe.ClusterParams(), device="cpu")) == _refusal(
        lambda: jpipe.cluster_sessions_pod(items, 8, jpipe.ClusterParams()))
    store = str(tmp_path / "s")
    kw = dict(n_processes=2, process_id=0)
    assert _refusal(lambda: tpipe.cluster_sessions_pod(
        items, 16, tpipe.ClusterParams(sig_store=store), device="cpu",
        **kw)) == _refusal(lambda: jpipe.cluster_sessions_pod(
            items, 16, jpipe.ClusterParams(sig_store=store), **kw))
    assert _refusal(lambda: tpipe.cluster_sessions_pod(
        items, 16, tpipe.ClusterParams(sig_store=store), device="cpu",
        exchange_dir=str(tmp_path / "x"), **kw)) == _refusal(
        lambda: jpipe.cluster_sessions_pod(
            items, 16, jpipe.ClusterParams(sig_store=store),
            exchange_dir=str(tmp_path / "x"), **kw))
    name, msg = _refusal(lambda: tpipe.cluster_sessions_pod(
        items, 8, tpipe.ClusterParams(sig_store=store), mesh=object(),
        device="cpu"))
    assert name == "ValueError" and "torch.distributed world" in msg
    assert not os.path.exists(store)
