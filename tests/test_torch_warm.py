"""tse1m_tpu_torch's warm path (``cluster_sessions`` with a signature
store, on the CPU through the kernels' plain versions) against a cold run
and against the JAX package's warm path: union runs of reordered input,
accreted-tail merges, the encoding x quantization grid, the wire a warm
run ships, the run telemetry, stores handed between the two packages,
the novel-row signer and the refusals.  Mirrors
``tests/test_cluster_store.py``.  Tolerance: exact (labels, signatures,
telemetry and file bytes)."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.utils import calibration as jcal
from tse1m_tpu_torch import minhash_novel_rows
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster import kernels
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.cluster.kernels import cminhash as kcm
from tse1m_tpu_torch.cluster.kernels import minhash as kmod

# The run telemetry of a store run, shared with the JAX package.
STORE_KEYS = ("encoding", "wire_quant_bits", "cache_hit_rate",
              "cache_store_rows", "cache_mode", "cache_novel_rows",
              "chunk_bits", "wire_mb", "wire_bytes")


@pytest.fixture(autouse=True)
def _no_calibration(monkeypatch):
    monkeypatch.setenv("TSE1M_ROUTER_CAL", "")


def _same_dir(a, b):
    """The two trees hold the same names and the same bytes."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for name in names:
        pa, pb = os.path.join(a, name), os.path.join(b, name)
        if os.path.isdir(pa):
            _same_dir(pa, pb)
        else:
            assert filecmp.cmp(pa, pb, shallow=False), name


def _tparams(store=None, **kw):
    base = dict(n_hashes=32, n_bands=4,
                sig_store=str(store) if store else None)
    base.update(kw)
    return tpipe.ClusterParams(**base)


def _jparams(store=None, **kw):
    base = dict(n_hashes=32, n_bands=4, use_pallas="never",
                sig_store=str(store) if store else None)
    base.update(kw)
    return jpipe.ClusterParams(**base)


def _port(items, params):
    return tpipe.cluster_sessions(items, params, device="cpu")


def _info_keys(info):
    return {k: info.get(k) for k in STORE_KEYS}


def test_union_of_a_shuffled_corpus_matches_cold_and_jax(tmp_path):
    """All signatures cached but the corpus reordered: the union run
    reuses them and labels as a cold run and as JAX's union run."""
    items, _ = synth_session_sets(1200, set_size=16, seed=5)
    perm = np.random.default_rng(7).permutation(items.shape[0])
    shuffled = items[perm]
    _port(items, _tparams(tmp_path / "t"))
    warm = _port(shuffled, _tparams(tmp_path / "t"))
    info = dict(tpipe.last_run_info)
    assert info["cache_mode"] == "union" and info["cache_hit_rate"] > 0.95
    jpipe.cluster_sessions(items, _jparams(tmp_path / "j"))
    jwarm = jpipe.cluster_sessions(shuffled, _jparams(tmp_path / "j"))
    assert _info_keys(info) == _info_keys(jpipe.last_run_info)
    np.testing.assert_array_equal(warm, _port(shuffled, _tparams()))
    np.testing.assert_array_equal(warm, jwarm)
    _same_dir(str(tmp_path / "t"), str(tmp_path / "j"))


def test_merge_bridges_old_components(tmp_path):
    """A novel row whose set straddles two stored clusters merges them
    (the fixture of ``tests/test_cluster_store.py``)."""
    rng = np.random.default_rng(5)
    common = rng.integers(0, 1 << 24, size=6, dtype=np.uint32)
    ua = rng.integers(0, 1 << 24, size=10, dtype=np.uint32)
    ub = rng.integers(0, 1 << 24, size=10, dtype=np.uint32)
    base = np.concatenate([np.tile(np.concatenate([common, ua]), (6, 1)),
                           np.tile(np.concatenate([common, ub]), (6, 1))])
    bridge = np.concatenate([common, ua[:5], ub[:5]])[None, :]
    union = np.concatenate([base, bridge])
    kw = dict(n_bands=16, merge_max_novel=0.2)
    _port(base, _tparams(tmp_path / "s", **kw))
    assert len(set(_port(base, _tparams(n_bands=16)).tolist())) == 2
    warm = _port(union, _tparams(tmp_path / "s", **kw))
    assert tpipe.last_run_info["cache_mode"] == "merge"
    cold = _port(union, _tparams(n_bands=16))
    np.testing.assert_array_equal(warm, cold)
    assert len(set(cold.tolist())) == 1
    jpipe.cluster_sessions(base, _jparams(tmp_path / "j", **kw))
    np.testing.assert_array_equal(
        warm, jpipe.cluster_sessions(union, _jparams(tmp_path / "j", **kw)))


@pytest.mark.parametrize("encoding", ["auto", "delta", "pack24"])
@pytest.mark.parametrize("quant_bits", [0, -1, 8, 12])
def test_warm_equals_cold_and_jax_across_encodings(tmp_path, encoding,
                                                   quant_bits):
    """A cached base plus 25 novel rows: the merge labels equal a cold run
    of the port and the JAX package's warm labels, for every encoding and
    quantization; the store left behind is JAX's byte for byte."""
    items, _ = synth_session_sets(600, set_size=16, seed=6)
    novel, _ = synth_session_sets(25, set_size=16, seed=606)
    union = np.concatenate([items, novel])
    kw = dict(encoding=encoding, wire_quant_bits=quant_bits)
    _port(items, _tparams(tmp_path / "t", **kw))
    warm = _port(union, _tparams(tmp_path / "t", **kw))
    info = dict(tpipe.last_run_info)
    assert info["cache_mode"] == "merge"
    jpipe.cluster_sessions(items, _jparams(tmp_path / "j", **kw))
    jwarm = jpipe.cluster_sessions(union, _jparams(tmp_path / "j", **kw))
    assert _info_keys(info) == _info_keys(jpipe.last_run_info)
    np.testing.assert_array_equal(warm, _port(union, _tparams(**kw)))
    np.testing.assert_array_equal(warm, jwarm)
    _same_dir(str(tmp_path / "t"), str(tmp_path / "j"))


def test_warm_run_ships_a_fraction_of_cold_wire(tmp_path):
    items, _ = synth_session_sets(4000, set_size=16, seed=8)
    novel, _ = synth_session_sets(40, set_size=16, seed=808)
    union = np.concatenate([items, novel])
    cold = _port(union, _tparams())
    cold_bytes = tpipe.last_run_info["wire_bytes"]
    _port(items, _tparams(tmp_path / "s"))
    warm = _port(union, _tparams(tmp_path / "s"))
    info = dict(tpipe.last_run_info)
    assert info["cache_mode"] == "merge"
    assert 0 < info["wire_bytes"] <= 0.1 * cold_bytes
    np.testing.assert_array_equal(warm, cold)


def test_all_hit_run_calls_no_plain_kernel(tmp_path, monkeypatch):
    """The same corpus again: no new row, no wire, labels from the state;
    neither a kernel nor a plain version runs."""
    items, _ = synth_session_sets(800, set_size=16, seed=10)
    first = _port(items, _tparams(tmp_path / "s"))

    def refuse(*args, **kwargs):
        raise AssertionError("a kernel's plain version ran")

    for mod, name in ((kmod, "minhash_and_keys_plain"),
                      (kmod, "minhash_and_keys_packed_plain"),
                      (kcm, "cminhash_binmin_plain")):
        monkeypatch.setattr(mod, name, refuse)
    kernels.reset_launch_counts()
    again = _port(items, _tparams(tmp_path / "s"))
    info = dict(tpipe.last_run_info)
    assert info["cache_mode"] == "merge" and info["cache_hit_rate"] == 1.0
    assert info["cache_novel_rows"] == 0 and info["wire_bytes"] == 0
    assert set(kernels.launch_counts().values()) == {0}
    np.testing.assert_array_equal(again, first)


def test_store_telemetry_matches_jax(tmp_path):
    """Populate, merge, all-hit and union runs: the port's store keys and
    values equal JAX's, and its stages are JAX's store stages."""
    items, _ = synth_session_sets(500, set_size=16, seed=12)
    novel, _ = synth_session_sets(20, set_size=16, seed=1212)
    union = np.concatenate([items, novel])
    perm = np.random.default_rng(3).permutation(union.shape[0])
    for run in (items, union, union, union[perm]):
        _port(run, _tparams(tmp_path / "t"))
        jpipe.cluster_sessions(run, _jparams(tmp_path / "j"))
        info = dict(tpipe.last_run_info)
        assert _info_keys(info) == _info_keys(jpipe.last_run_info)
        assert info["encoding"] == "store"
        assert "stage_probe_s" in info["stages"]
        assert set(info["stages"]) <= set(jpipe.last_run_info["stages"])
        assert "store_quarantined" not in info
    assert [s for s in ("load", "h2d", "compute", "d2h")
            if f"stage_{s}_s" in info["stages"]] == ["load", "h2d",
                                                     "compute", "d2h"]


@pytest.mark.parametrize("first", ["jax", "port"])
def test_stores_hand_over_between_the_packages(tmp_path, first):
    """One package populates, the other merges an accreted tail into the
    same store, then the first runs a union over a reordering: labels
    equal a cold run at each step, and the store equals the one a single
    package leaves."""
    items, _ = synth_session_sets(700, set_size=16, seed=13)
    novel, _ = synth_session_sets(30, set_size=16, seed=1313)
    union = np.concatenate([items, novel])
    perm = np.random.default_rng(4).permutation(union.shape[0])
    runs = {"port": lambda rows, d: _port(rows, _tparams(d)),
            "jax": lambda rows, d: jpipe.cluster_sessions(rows, _jparams(d))}
    other = "jax" if first == "port" else "port"
    mixed, single = tmp_path / "mixed", tmp_path / "single"
    for who, rows, mode in ((first, items, "union"), (other, union, "merge"),
                            (first, union[perm], "union")):
        got = runs[who](rows, mixed)
        info = (tpipe if who == "port" else jpipe).last_run_info
        assert info["cache_mode"] == mode
        np.testing.assert_array_equal(got, _port(rows, _tparams()))
        np.testing.assert_array_equal(got, runs["port"](rows, single))
    _same_dir(str(mixed), str(single))


@pytest.mark.parametrize("scheme", ["kminhash", "cminhash", "weighted"])
@pytest.mark.parametrize("qbits", [0, 10])
def test_minhash_novel_rows_matches_jax(scheme, qbits):
    rows, _ = synth_session_sets(40, set_size=16, seed=14)
    for k, pad in ((1, True), (3, True), (8, True), (9, True), (37, True),
                   (9, False), (0, True)):
        got = minhash_novel_rows(rows[:k], _tparams(scheme=scheme), qbits,
                                 device="cpu", pad_pow2=pad)
        want = jpipe.minhash_novel_rows(rows[:k], _jparams(scheme=scheme),
                                        qbits, pad_pow2=pad)
        assert got.dtype == np.uint32 and got.shape == (k, 32)
        np.testing.assert_array_equal(got, want)


def test_store_run_keeps_the_policy_width_over_the_calibrated_floor(
        tmp_path, monkeypatch):
    """A calibration floor of 8 clamps storeless runs only: a store run
    keeps the policy's width, as JAX's does, and both agree."""
    path = tmp_path / "cal.json"
    jcal.update_calibration(str(path), wire={"quant_bits": 8})
    monkeypatch.setenv("TSE1M_ROUTER_CAL", str(path))
    items = np.random.default_rng(11).integers(0, 1 << 24, size=(300, 16),
                                               dtype=np.uint32)
    for qb in (0, 12, -1):
        tp, jp = (_tparams(tmp_path / "t", wire_quant_bits=qb),
                  _jparams(tmp_path / "j", wire_quant_bits=qb))
        assert tpipe._quant_bits(items, tp) == jpipe._quant_bits(items, jp) \
            == max(qb, 0)
        storeless = dataclasses.replace(tp, sig_store=None)
        assert tpipe._quant_bits(items, storeless) == (8 if qb >= 0 else 0)
    labels = _port(items, _tparams(tmp_path / "s", wire_quant_bits=12))
    assert tpipe.last_run_info["wire_quant_bits"] == 12
    np.testing.assert_array_equal(labels, jpipe.cluster_sessions(
        items, _jparams(tmp_path / "js", wire_quant_bits=12)))


def test_compacted_store_still_merges_as_jax(tmp_path, monkeypatch):
    """Runs that leave several shards, then an open that compacts them:
    the remapped state still merges the next tail, as in JAX."""
    items, _ = synth_session_sets(900, set_size=16, seed=15)
    cuts = (600, 620, 640, 660)
    for name, run in (("t", lambda r, d: _port(r, _tparams(d))),
                      ("j", lambda r, d: jpipe.cluster_sessions(
                          r, _jparams(d)))):
        d = tmp_path / name
        monkeypatch.delenv("TSE1M_SIG_STORE_COMPACT_SHARDS", raising=False)
        for cut in cuts[:-1]:
            run(items[:cut], d)
        monkeypatch.setenv("TSE1M_SIG_STORE_COMPACT_SHARDS", "3")
        got = run(items[:cuts[-1]], d)
        info = (tpipe if name == "t" else jpipe).last_run_info
        assert info["cache_mode"] == "merge"
        np.testing.assert_array_equal(got, _port(items[:cuts[-1]],
                                                 _tparams()))
    manifest = json.load(open(tmp_path / "t" / "store_manifest.json"))
    assert len(manifest["shards"]) == 2      # the folded one and the tail
    _same_dir(str(tmp_path / "t"), str(tmp_path / "j"))


def test_quarantine_reaches_last_run_info(tmp_path):
    items, _ = synth_session_sets(300, set_size=16, seed=16)
    first = _port(items, _tparams(tmp_path / "s"))
    path = tmp_path / "s" / "sig_00000.npy"
    raw = bytearray(path.read_bytes())
    raw[-1] ^= 1
    path.write_bytes(bytes(raw))
    again = _port(items, _tparams(tmp_path / "s"))
    info = dict(tpipe.last_run_info)
    assert info["store_quarantined"][0]["shard"] == 0
    assert info["cache_mode"] == "union" and info["cache_hit_rate"] == 0.0
    np.testing.assert_array_equal(again, first)


def test_refusals(tmp_path):
    items, _ = synth_session_sets(50, set_size=16, seed=17)
    root = tmp_path / "pod"
    root.mkdir()
    (root / "pod_topology.json").write_text('{"n_ranges": 2}')
    # A pod root runs the pod path, which refuses a topology of another
    # policy in JAX's words.
    with pytest.raises(ValueError) as e:
        _port(items, _tparams(root))
    with pytest.raises(ValueError) as j:
        jpipe.cluster_sessions(items, _jparams(root))
    assert str(e.value) == str(j.value)
    assert "different policy" in str(e.value)
    with pytest.raises(ValueError, match="storeless-only"):
        tpipe.cluster_sessions(items, _tparams(tmp_path / "s"), device="cpu",
                               return_signatures=True)
    with pytest.raises(ValueError, match="storeless-only"):
        _port(items, _tparams(tmp_path / "s", prefilter="on"))
    with pytest.raises(ValueError, match="different policy"):
        tpipe.cluster_sessions_resumable(items, _tparams(root),
                                         checkpoint_dir=str(tmp_path / "c"),
                                         device="cpu")
    assert not os.path.exists(tmp_path / "s")
    np.testing.assert_array_equal(
        _port(items[:0], _tparams(tmp_path / "e")), np.empty(0, np.int32))


def test_cli_sig_store_twice_reports_jax_cache_keys(tmp_path, capsys):
    store = str(tmp_path / "store")
    reports = []
    for _ in range(2):
        assert cli_main(["cluster", "--n", "3000", "--sig-store", store,
                         "--device", "cpu"]) == 0
        reports.append(json.loads(capsys.readouterr().out.strip()
                                  .splitlines()[-1]))
    jpipe.cluster_sessions(*_cli_items(), jpipe.ClusterParams(
        use_pallas="never", sig_store=str(tmp_path / "j")))
    first, second = reports
    for report in reports:
        assert report["sig_store"] == store
        assert report["ari_sample_n"] == 3000
        assert report["ari_vs_host_sample"] == 1.0
        assert {"cache_hit_rate", "cache_store_rows", "cache_mode",
                "cache_novel_rows", "wire_mb"} <= set(report)
    assert {k: first[k] for k in first if k.startswith("cache_")} == {
        k: v for k, v in jpipe.last_run_info.items()
        if k.startswith("cache_")}
    assert first["cache_mode"] == "union"
    assert second["cache_mode"] == "merge"
    assert second["cache_hit_rate"] == 1.0 and second["wire_mb"] == 0.0
    assert second["n_clusters"] == first["n_clusters"]


def _cli_items():
    from tse1m_tpu_torch import synth_session_sets as t_synth

    return (t_synth(3000, seed=0)[0],)
