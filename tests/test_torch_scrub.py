"""``SignatureStore.scrub`` and ``verify_signatures`` of the port against
the JAX package's on copies of one store (clean, bit-flipped, legacy
unframed, signatures corrupted before framing), the fault seats of the
store's writes, and the ``scrub`` command with its ``--strict`` exit
codes.  Reports are compared key for key."""

import json
import os
import shutil

import numpy as np
import pytest

from tse1m_tpu.cluster import store as jstore
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu_torch import observability as tobs
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.cluster import store as tstore
from tse1m_tpu_torch.cluster.schemes import (make_params,
                                             scheme_host_signatures)
from tse1m_tpu_torch.resilience import faults as tfaults


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("TSE1M_ROUTER_CAL", "")
    monkeypatch.setenv("TSE1M_RESULT_DIR", str(tmp_path / "results"))
    tobs.pop_degradation_events()
    tfaults.clear_plan()
    yield
    tfaults.clear_plan()


def _flip(path, offset=300):
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0x40]))


def _populated(tmp_path, n=512, seed=19, scheme="kminhash"):
    d = tmp_path / "store"
    items = synth_session_sets(n, set_size=16, seed=seed)[0]
    tpipe.cluster_sessions(items, tpipe.ClusterParams(
        n_hashes=32, n_bands=4, sig_store=str(d), scheme=scheme),
        device="cpu")
    return d, items


def _both(d, tmp_path, fn):
    """``fn(store class, directory)`` on two copies of ``d``: (port, JAX)."""
    out = []
    for name, mod in (("t", tstore), ("j", jstore)):
        copy = tmp_path / f"copy_{name}"
        shutil.copytree(d, copy)
        out.append(fn(mod.SignatureStore, str(copy)))
    return out


@pytest.mark.parametrize("damage", ["clean", "sig", "key", "state"])
def test_scrub_reports_as_jax(tmp_path, damage):
    d, _ = _populated(tmp_path)
    if damage in ("sig", "key"):
        _flip(d / f"{damage}_00000.npy")
    elif damage == "state":
        _flip(next(d.glob("state_*.npz")), offset=100)
    t, j = _both(d, tmp_path, lambda cls, p: cls.open_existing(p).scrub())
    assert t == j
    assert t["store_scrub_corrupt"] == (1 if damage in ("sig", "key")
                                        else 0)
    assert t["store_scrub_state_ok"] == (damage != "state")


def test_scrub_repair_frames_legacy_shards_as_jax(tmp_path):
    d = tmp_path / "store"
    policy = {"n_hashes": 32, "seed": 0, "quant_bits": 0}
    store = tstore.SignatureStore(str(d), policy)
    rng = np.random.default_rng(0)
    items = rng.integers(0, 1 << 20, size=(64, 16), dtype=np.uint32)
    store.append(tstore.row_digests(items),
                 rng.integers(0, 1 << 31, size=(64, 32), dtype=np.uint32))
    for e in store.shards:
        e.pop("sig_crc", None)
        e.pop("key_crc", None)
    store._write_manifest()

    def scrub_twice(cls, p):
        s = cls.open_existing(p)
        return s.scrub(repair=False), s.scrub(repair=True), cls.open_existing(
            p).quarantined_at_open

    t, j = _both(d, tmp_path, scrub_twice)
    assert t == j
    assert t[0]["store_scrub_missing_crc"] == 1
    assert t[1]["store_scrub_missing_crc"] == 0 and t[2] == []
    # The repaired frame catches a later flip.
    _flip(tmp_path / "copy_t" / "sig_00000.npy", offset=200)
    assert len(tstore.SignatureStore.open_existing(
        str(tmp_path / "copy_t")).quarantined_at_open) == 1


@pytest.mark.parametrize("scheme", ["kminhash", "cminhash"])
def test_verify_signatures_catches_pre_framing_corruption(tmp_path, scheme):
    """Signatures wrong before their frame was written pass every CRC;
    the sampled host recompute finds them and quarantines their shard,
    as JAX's does; a sound store verifies clean."""
    d = tmp_path / "store"
    items = synth_session_sets(200, set_size=16, seed=23)[0]
    policy = {"n_hashes": 32, "seed": 0, "quant_bits": 0, "scheme": scheme}
    sigs = scheme_host_signatures(items, make_params(scheme, 32, 0))
    bad = sigs.copy()
    bad[100:] ^= np.uint32(1)
    store = tstore.SignatureStore(str(d), policy)
    store.append(tstore.row_digests(items[:100]), sigs[:100])
    store.append(tstore.row_digests(items[100:]), bad[100:])

    def verify(cls, p):
        s = cls.open_existing(p)
        return (s.scrub(), s.verify_signatures(items, sample=64, seed=3),
                s.verify_signatures(items, sample=0))

    t, j = _both(d, tmp_path, verify)
    assert t == j
    assert t[0]["store_scrub_corrupt"] == 0
    assert t[1]["store_scrub_verify_mismatch"] > 0
    assert t[1]["store_scrub_verify_quarantined"] == 1
    # The sound shard's rows (and the later rows that repeat them) verify.
    assert t[2]["store_scrub_verify_sampled"] >= 100
    assert t[2]["store_scrub_verify_ok"] is True


@pytest.mark.parametrize("site", ["store.sig.save", "store.state.save"])
def test_store_write_seats_retry_a_torn_write(tmp_path, site):
    """A torn write at a store seat rewrites its temp files from scratch:
    the run completes with the labels of a run without the fault."""
    items = synth_session_sets(300, set_size=16, seed=29)[0]
    params = tpipe.ClusterParams(n_hashes=32, n_bands=4,
                                 sig_store=str(tmp_path / "s"))
    want = tpipe.cluster_sessions(items, tpipe.ClusterParams(
        n_hashes=32, n_bands=4), device="cpu")
    plan = tfaults.FaultPlan.from_dict({"rules": [
        {"site": site, "kind": "torn_write", "times": 1}]})
    with plan.active():
        got = tpipe.cluster_sessions(items, params, device="cpu")
    assert plan.fired == [(site, "torn_write")]
    np.testing.assert_array_equal(got, want)
    store = tstore.SignatureStore.open_existing(str(tmp_path / "s"))
    assert store.quarantined_at_open == [] and store.scrub()[
        "store_scrub_state_ok"]


def test_compaction_seat(tmp_path):
    d, items = _populated(tmp_path)
    tpipe.cluster_sessions(synth_session_sets(64, set_size=16, seed=31)[0],
                           tpipe.ClusterParams(n_hashes=32, n_bands=4,
                                               sig_store=str(d)),
                           device="cpu")
    plan = tfaults.FaultPlan.from_dict({"rules": [
        {"site": "store.compact.save", "kind": "raise", "times": 1}]})
    store = tstore.SignatureStore.open_existing(str(d))
    with plan.active():
        assert store.compact() == 2
    assert plan.fired == [("store.compact.save", "raise")]
    assert tstore.SignatureStore.open_existing(str(d)).scrub()[
        "store_scrub_shards"] == 1


def test_scrub_command(tmp_path, capsys):
    d, items = _populated(tmp_path)
    assert cli_main(["scrub", str(d), "--strict"]) == 0
    clean = json.loads(capsys.readouterr().out.strip())
    assert clean["store_scrub_corrupt"] == 0
    assert clean["store_scrub_dir"] == str(d)
    _flip(d / "sig_00000.npy", offset=200)
    assert cli_main(["scrub", str(d)]) == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["store_scrub_corrupt"] == 1
    assert out["store_scrub_quarantined"] >= 1
    with open(tmp_path / "results" / "run_manifest.json") as f:
        manifest = json.load(f)
    step = manifest["steps"][0]
    assert step["name"] == "scrub" and step["status"] == "ok"
    assert step["result"]["store_scrub_corrupt"] == 1
    assert manifest["degradation_counts"] == {"shard_quarantine": 1}
    # --strict: 1 when this walk found corruption (repopulate first: the
    # flipped shard is already quarantined).
    tpipe.cluster_sessions(items, tpipe.ClusterParams(
        n_hashes=32, n_bands=4, sig_store=str(d)), device="cpu")
    _flip(d / "key_00000.npy", offset=200)
    assert cli_main(["scrub", str(d), "--strict"]) == 1
    capsys.readouterr()
    tpipe.cluster_sessions(items, tpipe.ClusterParams(
        n_hashes=32, n_bands=4, sig_store=str(d)), device="cpu")
    assert cli_main(["scrub", str(d), "--verify-sigs", "--verify-n", "512",
                     "--verify-set-size", "16", "--verify-seed", "19"]) == 0
    verified = json.loads(capsys.readouterr().out.strip())
    assert verified["store_scrub_verify_ok"] is True
    assert verified["store_scrub_verify_sampled"] > 0


def test_scrub_command_refusals(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("TSE1M_SIG_STORE", "")
    monkeypatch.setenv("TSE1M_ENVFILE", str(tmp_path / "absent.ini"))
    assert cli_main(["scrub"]) == 2
    root = tmp_path / "pod"
    root.mkdir()
    (root / "pod_topology.json").write_text('{"n_ranges": 2}')
    with pytest.raises(NotImplementedError, match='"Multi-GPU"'):
        cli_main(["scrub", str(root)])
    assert cli_main(["scrub", str(tmp_path / "nothing")]) == 1
    assert not os.path.exists(tmp_path / "nothing" / "store_manifest.json")
