"""Chunk checkpoints (``tse1m_tpu_torch/cluster/checkpoint.py``) and
``cluster_sessions_resumable`` against the JAX package's, on the CPU (JAX
with ``use_pallas="never"``): resumed labels, recomputed chunks, torn and
bit-rotted shards, refusals, cleanup, the auto-policy clamp, the encoded
layout, the store populated from a resumed run, checkpoints handed between
the packages both ways, and the ``cluster --checkpoint-dir`` command killed
by the fault plane in a subprocess.  Comparisons are exact; shard files
are compared by their arrays and the manifest by its meta, since
``np.savez`` stamps each zip entry with the time."""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from tse1m_tpu.cluster import checkpoint as jck
from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu_torch.cluster import checkpoint as tck
from tse1m_tpu_torch.cluster import pipeline as tpipe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 2048  # 4 shards of 512 rows at h2d_chunks=4
DELTA = dict(encoding="delta", entropy="force", prefilter="on")


@pytest.fixture(autouse=True)
def _no_calibration(monkeypatch):
    monkeypatch.setenv("TSE1M_ROUTER_CAL", "")


@pytest.fixture(scope="module")
def items():
    return synth_session_sets(N, set_size=16, seed=13)[0]


def _tp(**kw):
    return tpipe.ClusterParams(**{"n_hashes": 32, "n_bands": 4,
                                  "h2d_chunks": 4, **kw})


def _jp(**kw):
    return jpipe.ClusterParams(**{"n_hashes": 32, "n_bands": 4,
                                  "h2d_chunks": 4, "use_pallas": "never",
                                  **kw})


def _port(items, d, **kw):
    cleanup = kw.pop("cleanup", True)
    return tpipe.cluster_sessions_resumable(items, _tp(**kw),
                                            checkpoint_dir=str(d),
                                            cleanup=cleanup, device="cpu")


def _jax(items, d, **kw):
    cleanup = kw.pop("cleanup", True)
    return jpipe.cluster_sessions_resumable(items, _jp(**kw),
                                            checkpoint_dir=str(d),
                                            cleanup=cleanup)


class Boom(RuntimeError):
    pass


def _dying_save(monkeypatch, mod, after: int):
    """``mod.ClusterCheckpoint.save_chunk`` raises once ``after`` shards
    are saved: the kill window."""
    real = mod.ClusterCheckpoint.save_chunk
    saved = []

    def save(self, index, sig, keys):
        if len(saved) == after:
            raise Boom(index)
        real(self, index, sig, keys)
        saved.append(index)

    monkeypatch.setattr(mod.ClusterCheckpoint, "save_chunk", save)
    return saved


def _count_chunks(monkeypatch):
    calls = []
    real = tpipe._chunk_minhash
    monkeypatch.setattr(tpipe, "_chunk_minhash",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    return calls


def _same_store(a, b):
    """The same file names; the same bytes, but for the LSH state's npz
    (its zip entries carry the time it was written): the same arrays."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        if name.startswith("state_") and name.endswith(".npz"):
            with np.load(a / name) as x, np.load(b / name) as y:
                assert sorted(x.files) == sorted(y.files)
                for k in x.files:
                    np.testing.assert_array_equal(x[k], y[k])
        elif name != "state.json":
            assert (a / name).read_bytes() == (b / name).read_bytes(), name
    with open(a / "state.json") as f, open(b / "state.json") as g:
        x, y = json.load(f), json.load(g)
    assert {k: v for k, v in x.items() if k != "crc"} == {
        k: v for k, v in y.items() if k != "crc"}


def _meta(d):
    with open(os.path.join(d, "manifest.json")) as f:
        m = json.load(f)
    return {k: v for k, v in m.items()
            if k not in ("chunks_done", "chunk_crcs")}


@pytest.mark.parametrize("kw", [{}, DELTA, dict(scheme="cminhash")])
def test_resumable_equals_cold_and_jax(items, tmp_path, kw):
    """The same labels as ``cluster_sessions`` and as JAX's resumable
    run, and the same manifest meta and shard arrays."""
    got = _port(items, tmp_path / "t", cleanup=False, **kw)
    want = _jax(items, tmp_path / "j", cleanup=False, **kw)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, tpipe.cluster_sessions(items, _tp(**kw), device="cpu"))
    assert _meta(tmp_path / "t") == _meta(tmp_path / "j")
    shards = sorted(os.listdir(tmp_path / "t"))
    assert shards == sorted(os.listdir(tmp_path / "j"))
    for name in shards:
        if name.endswith(".npz"):
            with np.load(tmp_path / "t" / name) as a, \
                    np.load(tmp_path / "j" / name) as b:
                assert a["sig"].dtype == np.uint32
                np.testing.assert_array_equal(a["sig"], b["sig"])
                np.testing.assert_array_equal(a["keys"], b["keys"])


def test_kill_and_resume_recomputes_only_missing_chunks(items, tmp_path,
                                                        monkeypatch):
    want = tpipe.cluster_sessions(items, _tp(), device="cpu")
    _dying_save(monkeypatch, tck, after=2)
    with pytest.raises(Boom):
        _port(items, tmp_path / "ck")
    monkeypatch.undo()
    monkeypatch.setenv("TSE1M_ROUTER_CAL", "")
    calls = _count_chunks(monkeypatch)
    np.testing.assert_array_equal(_port(items, tmp_path / "ck"), want)
    assert len(calls) == 4 - 2


@pytest.mark.parametrize("damage", ["torn", "bitflip"])
def test_torn_or_bit_rotted_shard_recomputes(items, tmp_path, monkeypatch,
                                             damage):
    """A shard whose temp file landed without its manifest entry, or a
    committed shard with a flipped byte, reads as not done; the resume
    recomputes that chunk alone and sweeps the orphan."""
    d = tmp_path / "ck"
    _port(items, d, cleanup=False)
    ck = tck.ClusterCheckpoint(str(d), items, _tp(), 512)
    shard = d / "shard_00001.npz"
    if damage == "torn":
        os.replace(shard, str(shard) + ".tmp.npz")
        ck.done.discard(1)
        ck._write_manifest()
    else:
        raw = bytearray(shard.read_bytes())
        raw[len(raw) // 2] ^= 0x40
        shard.write_bytes(bytes(raw))
    ck = tck.ClusterCheckpoint(str(d), items, _tp(), 512)
    assert not ck.chunk_done(1) and ck.chunk_done(0)
    want = tpipe.cluster_sessions(items, _tp(), device="cpu")
    calls = _count_chunks(monkeypatch)
    np.testing.assert_array_equal(_port(items, d), want)
    assert len(calls) == 1
    assert os.listdir(d) == []


def test_mismatched_run_refuses_as_jax(items, tmp_path):
    d = str(tmp_path / "ck")
    tck.ClusterCheckpoint(d, items, _tp(), 512)
    for pkg, params in ((tck, _tp(n_hashes=64)), (jck, _jp(n_hashes=64))):
        with pytest.raises(ValueError, match="different run"):
            pkg.ClusterCheckpoint(d, items, params, 512)
    other = synth_session_sets(N, set_size=16, seed=99)[0]
    with pytest.raises(ValueError, match="fingerprint"):
        tck.ClusterCheckpoint(d, other, _tp(), 512)
    # The meta either package writes is the other's, key for key.
    jd = str(tmp_path / "j")
    jck.ClusterCheckpoint(jd, items, _jp(), 512, extra={"x": 1}, n_chunks=5)
    t = tck.ClusterCheckpoint(jd, items, _tp(), 512, extra={"x": 1},
                              n_chunks=5)
    assert t.meta == _meta(jd) and t.n_chunks == 5


def test_cleanup_sweeps_shards_orphans_and_manifest(items, tmp_path):
    d = tmp_path / "ck"
    _port(items, d, cleanup=False)
    (d / "shard_00002.npz.tmp.npz").write_bytes(b"orphan")
    assert len(glob.glob(str(d / "shard_*"))) == 5
    tck.ClusterCheckpoint(str(d), items, _tp(), 512).cleanup()
    assert os.listdir(d) == []


def test_auto_policy_resume_adopts_the_surviving_width(tmp_path):
    """An auto-width resume adopts the width the shards hold; an explicit
    other width still refuses; a floor persisted after an unquantized
    checkpoint does not re-plan its resume."""
    items = synth_session_sets(300, set_size=16, seed=5)[0]
    d = tmp_path / "ck"
    first = _port(items, d, cleanup=False, wire_quant_bits=10)
    with pytest.raises(ValueError):
        _port(items, d, wire_quant_bits=8)
    np.testing.assert_array_equal(_port(items, d), first)
    np.testing.assert_array_equal(first, jpipe.cluster_sessions(
        items, _jp(wire_quant_bits=10)))


def test_unquantized_resume_ignores_a_later_floor(tmp_path, monkeypatch):
    items = synth_session_sets(300, set_size=16, seed=9)[0]
    monkeypatch.setenv("TSE1M_ROUTER_CAL", str(tmp_path / "cal.json"))
    d = tmp_path / "ck"
    first = _port(items, d, cleanup=False)
    tpipe._persist_quant_bits(10)  # degradation happened elsewhere
    np.testing.assert_array_equal(_port(items, d), first)


def test_encoded_layout_resumes_after_its_full_lane(items, tmp_path,
                                                    monkeypatch):
    """Killed at the delta shard: the resume loads the full-lane shards,
    re-ships and decodes the full lane without hashing it (no chunk
    compute), hashes the delta rows, and labels as JAX's run."""
    d = tmp_path / "ck"
    _dying_save(monkeypatch, tck, after=1)
    with pytest.raises(Boom):
        _port(items, d, **DELTA)
    monkeypatch.undo()
    monkeypatch.setenv("TSE1M_ROUTER_CAL", "")
    meta = tck.ClusterCheckpoint.peek_meta(str(d))
    assert meta["encoding"] == "delta" and meta["chunks_done"] == [0]
    assert meta["n_chunks"] == 2
    calls = _count_chunks(monkeypatch)
    got = _port(items, d, **DELTA)
    assert calls == []
    np.testing.assert_array_equal(got, _jax(items, tmp_path / "j", **DELTA))


def test_store_populated_from_a_resumed_run_equals_jax(items, tmp_path,
                                                       monkeypatch):
    """A store run the store cannot merge runs checkpointed, then
    populates the store; after a kill and a resume the store's files equal
    JAX's after its uninterrupted run, and a second run merges."""
    ts, js = tmp_path / "ts", tmp_path / "js"
    _dying_save(monkeypatch, tck, after=2)
    with pytest.raises(Boom):
        _port(items, tmp_path / "ck", sig_store=str(ts))
    monkeypatch.undo()
    monkeypatch.setenv("TSE1M_ROUTER_CAL", "")
    got = _port(items, tmp_path / "ck", sig_store=str(ts))
    assert tpipe.last_run_info["cache_mode"] == "populate"
    want = _jax(items, tmp_path / "jck", sig_store=str(js))
    np.testing.assert_array_equal(got, want)
    _same_store(ts, js)
    again = _port(items, tmp_path / "ck", sig_store=str(ts))
    assert tpipe.last_run_info["cache_mode"] == "merge"
    np.testing.assert_array_equal(again, got)


@pytest.mark.parametrize("first", ["jax", "port"])
def test_a_checkpoint_resumes_in_the_other_package(items, tmp_path,
                                                   monkeypatch, first):
    d = tmp_path / "ck"
    want = tpipe.cluster_sessions(items, _tp(), device="cpu")
    _dying_save(monkeypatch, jck if first == "jax" else tck, after=2)
    with pytest.raises(Boom):
        (_jax if first == "jax" else _port)(items, d)
    monkeypatch.undo()
    monkeypatch.setenv("TSE1M_ROUTER_CAL", "")
    assert tck.ClusterCheckpoint.peek_meta(str(d))["chunks_done"] == [0, 1]
    got = (_port if first == "jax" else _jax)(items, d)
    np.testing.assert_array_equal(got, want)
    assert os.listdir(d) == []


def test_cli_killed_by_the_plan_then_resumed(tmp_path):
    """``cluster --checkpoint-dir`` under a plan that SIGKILLs the first
    shard save dies with -9, its temp file left behind; the same command
    again resumes to an undisturbed run's report and empties the
    directory."""
    d = tmp_path / "ck"
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({"rules": [{
        "site": "checkpoint.cluster.save", "kind": "kill", "times": 1}]}))
    env = dict(os.environ, TSE1M_ROUTER_CAL="",
               TSE1M_RESULT_DIR=str(tmp_path / "results"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    cmd = [sys.executable, "-m", "tse1m_tpu_torch", "cluster", "--n", "2048",
           "--device", "cpu", "--ari-sample", "0", "--checkpoint-dir",
           str(d)]
    killed = subprocess.run(cmd, env=dict(env, TSE1M_FAULT_PLAN=str(plan)),
                            capture_output=True, text=True, timeout=300)
    assert killed.returncode == -9, killed.stderr[-2000:]
    assert sorted(os.listdir(d)) == ["manifest.json",
                                     "shard_00000.npz.tmp.npz"]
    with open(tmp_path / "results" / "run_manifest.json") as f:
        assert json.load(f)["steps"][0]["status"] == "running"
    resumed = subprocess.run(cmd, env=env, capture_output=True, text=True,
                             timeout=300)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    report = json.loads(resumed.stdout.strip().splitlines()[-1])
    items, truth = synth_session_sets(2048, seed=0)
    labels = tpipe.cluster_sessions(items, tpipe.ClusterParams(),
                                    device="cpu")
    assert report["n_clusters"] == int(np.unique(labels).size)
    assert report["checkpoint_dir"] == str(d)
    assert os.listdir(d) == []
