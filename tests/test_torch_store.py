"""tse1m_tpu_torch's signature store (``cluster/store.py``, host numpy)
against the JAX package's: content digests, the policy key, the on-disk
layout byte for byte, each package reading and extending the other's
store, and the store's own mechanics (refusal, torn and corrupt shards,
LRU eviction, state, compaction, the materialized index, retries),
mirroring ``tests/test_cluster_store.py``.  Tolerance: exact (digests,
signatures, locators and file bytes are integers)."""

import filecmp
import json
import os

import numpy as np
import pytest

from tse1m_tpu.cluster import incremental as jinc
from tse1m_tpu.cluster import store as jstore
from tse1m_tpu_torch.cluster import incremental as tinc
from tse1m_tpu_torch.cluster import store as tstore
from tse1m_tpu_torch.utils import retry as tretry

POLICY = {"n_hashes": 32, "seed": 0, "quant_bits": 0}


@pytest.fixture(autouse=True)
def _clean_store_env(monkeypatch):
    for k in ("TSE1M_SIG_STORE_MAX_MB", "TSE1M_SIG_STORE_COMPACT_SHARDS",
              "TSE1M_SIG_STORE_IDX_ROWS", "TSE1M_SIG_STORE_DELTA_SHARDS"):
        monkeypatch.delenv(k, raising=False)


def _rows(seed, n, s=16, high=1 << 24):
    return np.random.default_rng(seed).integers(0, high, size=(n, s),
                                                dtype=np.uint64).astype(
                                                    np.uint32)


def _sigs(seed, n, h=32):
    return _rows(seed, n, h, 1 << 32)


def _batches(n_batches=3, rows=40, seed=0):
    """(digests, signatures) pairs, one a shard, with duplicates inside
    the first batch and across batches."""
    out = []
    for b in range(n_batches):
        items = _rows(seed + b, rows)
        if b == 0:
            items[5] = items[0]
        if b:
            items[:3] = _rows(seed, rows)[10:13]   # rows of batch 0
        out.append((tstore.row_digests(items), _sigs(100 + seed + b, rows)))
    return out


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


# -- content digests ---------------------------------------------------------

@pytest.mark.parametrize("n,s,high", [
    (300, 1, 1 << 32), (1000, 16, 1 << 24), (500, 64, 1 << 32),
    ((1 << 17) + 77, 3, 1 << 32),   # crosses the 2^17-row step
])
def test_row_digests_match_jax(n, s, high):
    items = _rows(n + s, n, s, high)
    items[: n // 4] |= np.uint32(1 << 31)   # ids >= 2^31
    got = tstore.row_digests(items)
    assert got.dtype == np.uint64 and got.shape == (n, 2)
    np.testing.assert_array_equal(got, jstore.row_digests(items))


def test_row_digests_deterministic_and_distinct():
    items = _rows(0, 5000)
    d1 = tstore.row_digests(items)
    np.testing.assert_array_equal(d1, tstore.row_digests(items.copy()))
    assert len({bytes(r) for r in d1}) == 5000
    dup = items.copy()
    dup[7] = dup[0]
    dd = tstore.row_digests(dup)
    np.testing.assert_array_equal(dd[7], dd[0])
    mod = items.copy()
    mod[3, 5] ^= 1
    assert bytes(tstore.row_digests(mod)[3]) != bytes(d1[3])
    a, b = np.zeros((1, 8), np.uint32), np.zeros((1, 16), np.uint32)
    assert bytes(tstore.row_digests(a)[0]) != bytes(tstore.row_digests(b)[0])


def test_fingerprint_and_policy_match_jax():
    d = tstore.row_digests(_rows(1, 50))
    assert tstore.digests_fingerprint(d) == jstore.digests_fingerprint(d)
    assert tstore.digests_fingerprint(d) != tstore.digests_fingerprint(
        d[::-1].copy())
    assert tstore.POLICY_KEYS == jstore.POLICY_KEYS
    for policy in (POLICY, {**POLICY, "scheme": "cminhash"},
                   {"n_hashes": "64", "seed": 3.0, "quant_bits": 10,
                    "scheme": "weighted"}):
        assert tstore.normalize_policy(policy) == jstore.normalize_policy(
            policy)
    with pytest.raises(ValueError, match="unknown signature scheme"):
        tstore.normalize_policy({**POLICY, "scheme": "simhash"})
    assert tstore._CRC_ALGO == jstore._CRC_ALGO


# -- the on-disk layout ------------------------------------------------------

def test_same_appends_give_byte_equal_stores(tmp_path):
    """The same appends, probes and state commit in both packages leave
    the same files, byte for byte (shards, manifest, state)."""
    dirs = {}
    for name, mod, inc in (("t", tstore, tinc), ("j", jstore, jinc)):
        d = str(tmp_path / name)
        store = mod.SignatureStore(d, POLICY)
        written = [store.append(dg, sg) for dg, sg in _batches()]
        hit, sh, rw = store.bulk_probe(_batches()[1][0])
        keys = _rows(9, 40, 4, 1 << 32)
        assert store.save_state(np.arange(40, dtype=np.int32),
                                np.stack([sh, rw], 1),
                                inc.build_band_tables(keys),
                                _batches()[1][0], 4, 0.5)
        dirs[name] = (d, written, hit.sum())
    assert dirs["t"][1] == dirs["j"][1] == [39, 37, 37]
    _same_dir(dirs["t"][0], dirs["j"][0])
    with open(os.path.join(dirs["t"][0], "store_manifest.json")) as f:
        manifest = json.load(f)
    assert [s["rows"] for s in manifest["shards"]] == [39, 37, 37]


@pytest.mark.parametrize("writer,reader", [(jstore, tstore),
                                           (tstore, jstore)])
def test_each_package_reads_and_extends_the_others_store(tmp_path, writer,
                                                         reader):
    d = str(tmp_path / "s")
    batches = _batches(4)
    w = writer.SignatureStore(d, POLICY)
    for dg, sg in batches[:3]:
        w.append(dg, sg)
    r = reader.SignatureStore(d, POLICY)
    ref = writer.SignatureStore(d, POLICY)
    probe = np.concatenate([b[0] for b in batches])
    got, want = r.bulk_probe(probe), ref.bulk_probe(probe)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    hit, sh, rw = got
    np.testing.assert_array_equal(r.load_signatures(sh[hit], rw[hit]),
                                  ref.load_signatures(sh[hit], rw[hit]))
    np.testing.assert_array_equal(r.load_digests(sh[hit], rw[hit]),
                                  probe[hit])
    # The reader appends; the writer's package sees the new shard.
    assert r.append(*batches[3]) == 37
    again = writer.SignatureStore(d, POLICY)
    assert again.n_rows == r.n_rows == 39 + 37 * 3
    h2, s2, w2 = again.bulk_probe(batches[3][0])
    assert h2.all()
    np.testing.assert_array_equal(again.load_signatures(s2, w2),
                                  r.load_signatures(*r.bulk_probe(
                                      batches[3][0])[1:]))


def test_probe_append_dedupe_and_reopen(tmp_path):
    store = tstore.SignatureStore(str(tmp_path), POLICY)
    d = tstore.row_digests(_rows(1, 100))
    sig = _sigs(2, 100)
    hit, _, _ = store.bulk_probe(d)
    assert not hit.any()
    assert store.append(d, sig) == 100
    assert store.append(d, sig) == 0
    assert store.append(np.concatenate([d[:2], d[:2]]),
                        np.concatenate([sig[:2], sig[:2]])) == 0
    hit, sh, rw = store.bulk_probe(d)
    assert hit.all()
    np.testing.assert_array_equal(store.load_signatures(sh, rw), sig)
    store2 = tstore.SignatureStore(str(tmp_path), POLICY)
    assert store2.n_rows == 100
    _, sh, rw = store2.bulk_probe(d[::3])
    np.testing.assert_array_equal(store2.load_signatures(sh, rw), sig[::3])


def test_policy_mismatch_refuses(tmp_path):
    jstore.SignatureStore(str(tmp_path), POLICY)
    with pytest.raises(ValueError, match="different policy"):
        tstore.SignatureStore(str(tmp_path), {**POLICY, "n_hashes": 64})
    with pytest.raises(ValueError, match="quant_bits"):
        tstore.SignatureStore(str(tmp_path), {**POLICY, "quant_bits": 10})
    with pytest.raises(ValueError, match="scheme"):
        tstore.SignatureStore(str(tmp_path), {**POLICY, "scheme": "cminhash"})


def test_pre_scheme_manifest_opens_and_heals_as_jax(tmp_path):
    """A manifest without the ``scheme`` key is a kminhash store; a
    writable open adds the key, in both packages alike."""
    for name, mod in (("t", tstore), ("j", jstore)):
        d = str(tmp_path / name)
        store = mod.SignatureStore(d, POLICY)
        store.append(*_batches(1)[0])
        path = os.path.join(d, "store_manifest.json")
        with open(path) as f:
            manifest = json.load(f)
        del manifest["policy"]["scheme"]
        with open(path, "w") as f:
            json.dump(manifest, f)
        mod.SignatureStore(d, POLICY)
    _same_dir(str(tmp_path / "t"), str(tmp_path / "j"))
    with open(str(tmp_path / "t" / "store_manifest.json")) as f:
        assert json.load(f)["policy"]["scheme"] == "kminhash"


def test_torn_shard_reads_as_absent(tmp_path):
    store = tstore.SignatureStore(str(tmp_path), POLICY)
    d = tstore.row_digests(_rows(2, 50))
    store.append(d, _sigs(3, 50))
    shard = os.path.join(str(tmp_path), "sig_00000.npy")
    with open(shard, "rb+") as f:
        f.truncate(os.path.getsize(shard) // 2)
    store2 = tstore.SignatureStore(str(tmp_path), POLICY)
    assert store2.n_rows == 0
    assert not store2.bulk_probe(d)[0].any()
    assert store2.quarantined_at_open[0]["shard"] == 0
    assert os.path.exists(os.path.join(str(tmp_path), "quarantine",
                                       "sig_00000.npy"))


def test_flipped_byte_quarantines_as_jax(tmp_path):
    """A flipped byte fails the CRC frame: both packages quarantine the
    shard and leave the same store behind."""
    for name, mod in (("t", tstore), ("j", jstore)):
        d = str(tmp_path / name)
        store = mod.SignatureStore(d, POLICY)
        for dg, sg in _batches(2):
            store.append(dg, sg)
        path = os.path.join(d, "sig_00001.npy")
        raw = bytearray(open(path, "rb").read())
        raw[-5] ^= 0x10
        open(path, "wb").write(bytes(raw))
        reopened = mod.SignatureStore(d, POLICY)
        assert [q["shard"] for q in reopened.quarantined_at_open] == [1]
        assert "CRC" in reopened.quarantined_at_open[0]["reason"]
    _same_dir(str(tmp_path / "t"), str(tmp_path / "j"))


def test_lru_eviction_and_state_invalidation_as_jax(tmp_path):
    """Each shard: 10 rows x 32 hashes x 4 B; a cap of 2.5 shards evicts
    the least recently probed one, and a state pointing at it is
    unusable."""
    stores = {}
    for name, mod in (("t", tstore), ("j", jstore)):
        store = mod.SignatureStore(str(tmp_path / name), POLICY,
                                   max_bytes=3200)
        batches = []
        for i in range(3):
            d = tstore.row_digests(_rows(10 + i, 10))
            batches.append(d)
            store.append(d, _sigs(20 + i, 10))
            if i == 1:
                store.bulk_probe(batches[0])   # shard 0 now hotter than 1
        assert [int(s["id"]) for s in store.shards] == [0, 2]
        assert not store.bulk_probe(batches[1])[0].any()
        assert store.bulk_probe(batches[2])[0].all()
        tables = ([np.zeros(0, np.uint32)] * 4, [np.zeros(0, np.int32)] * 4)
        assert store.save_state(np.zeros(10, np.int32),
                                np.ones((10, 2), np.int32), tables,
                                batches[1], 4, 0.5)
        assert store.load_state(4, 0.5) is None   # shard 1 is gone
        stores[name] = store
    _same_dir(str(tmp_path / "t"), str(tmp_path / "j"))


def test_max_mb_from_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("TSE1M_SIG_STORE_MAX_MB", "0.5")
    assert tstore.SignatureStore(str(tmp_path), POLICY).max_bytes == 2**19


def test_state_roundtrip_and_mismatch(tmp_path):
    store = tstore.SignatureStore(str(tmp_path), POLICY)
    d = tstore.row_digests(_rows(4, 20))
    store.append(d, _sigs(5, 20))
    _, sh, rw = store.bulk_probe(d)
    labels = np.arange(20, dtype=np.int32)
    tables = tinc.build_band_tables(_rows(6, 20, 4, 99))
    assert store.save_state(labels, np.stack([sh, rw], 1), tables, d, 4,
                            0.5)
    for reader in (store, jstore.SignatureStore(str(tmp_path), POLICY)):
        st = reader.load_state(4, 0.5)
        assert st is not None and st.n_rows == 20
        np.testing.assert_array_equal(st.labels, labels)
        for got, want in zip(st.band_keys_sorted + st.band_reps,
                             tables[0] + tables[1]):
            np.testing.assert_array_equal(got, want)
        assert st.matches_prefix(d)
        assert not st.matches_prefix(d[::-1].copy())
        assert reader.load_state(8, 0.5) is None
        assert reader.load_state(4, 0.6) is None


def test_corrupt_state_is_quarantined(tmp_path):
    store = tstore.SignatureStore(str(tmp_path), POLICY)
    d = tstore.row_digests(_rows(4, 20))
    store.append(d, _sigs(5, 20))
    _, sh, rw = store.bulk_probe(d)
    store.save_state(np.arange(20, dtype=np.int32), np.stack([sh, rw], 1),
                     tinc.build_band_tables(_rows(6, 20, 4, 99)), d, 4, 0.5)
    meta = json.load(open(os.path.join(str(tmp_path), "state.json")))
    path = os.path.join(str(tmp_path), meta["file"])
    raw = bytearray(open(path, "rb").read())
    raw[100] ^= 1
    open(path, "wb").write(bytes(raw))
    assert store.load_state(4, 0.5) is None
    assert not os.path.exists(os.path.join(str(tmp_path), "state.json"))
    assert os.listdir(os.path.join(str(tmp_path), "quarantine")) == [
        meta["file"]]


@pytest.mark.parametrize("opener", [tstore, jstore])
def test_compaction_remaps_state_as_jax(tmp_path, monkeypatch, opener):
    """Four shards and a state over them; an open with a compaction
    threshold of 4 folds them into one and remaps the state's locator, in
    the port as in JAX, and the folded state still gathers the same
    signatures."""
    d = str(tmp_path / "s")
    store = tstore.SignatureStore(d, POLICY)
    batches = _batches(4)
    for dg, sg in batches:
        store.append(dg, sg)
    digests = np.concatenate([b[0] for b in batches])
    _, sh, rw = store.bulk_probe(digests)
    before = store.load_signatures(sh, rw)
    store.save_state(np.arange(digests.shape[0], dtype=np.int32),
                     np.stack([sh, rw], 1),
                     tinc.build_band_tables(_rows(7, digests.shape[0], 4)),
                     digests, 4, 0.5)
    twin = str(tmp_path / "twin")
    os.makedirs(twin)
    for name in os.listdir(d):
        os.link(os.path.join(d, name), os.path.join(twin, name))
    monkeypatch.setenv("TSE1M_SIG_STORE_COMPACT_SHARDS", "4")
    compacted = opener.SignatureStore(d, POLICY)
    other = (jstore if opener is tstore else tstore).SignatureStore(twin,
                                                                    POLICY)
    assert [int(s["id"]) for s in compacted.shards] == [4]
    _same_dir(d, twin)
    st = tstore.SignatureStore(d, POLICY).load_state(4, 0.5)
    assert (st.locator[:, 0] == 4).all()
    np.testing.assert_array_equal(
        other.load_signatures(st.locator[:, 0], st.locator[:, 1]), before)


@pytest.mark.parametrize("idx_rows", [1, 50])
def test_materialized_index_probes_as_jax(tmp_path, monkeypatch, idx_rows):
    """Past TSE1M_SIG_STORE_IDX_ROWS rows the probe index is written to
    disk and mmap'd; probes (with delta shards after it) equal JAX's, and
    both packages name the index files alike."""
    monkeypatch.setenv("TSE1M_SIG_STORE_IDX_ROWS", str(idx_rows))
    monkeypatch.setenv("TSE1M_SIG_STORE_DELTA_SHARDS", "1")
    batches = _batches(4)
    probe = np.concatenate([b[0] for b in batches]
                           + [tstore.row_digests(_rows(99, 30))])
    results = {}
    for name, mod in (("t", tstore), ("j", jstore)):
        d = str(tmp_path / name)
        store = mod.SignatureStore(d, POLICY)
        for dg, sg in batches:
            store.append(dg, sg)
        reopened = mod.SignatureStore(d, POLICY)
        assert reopened._idx_mode == "mmap"
        results[name] = (store.bulk_probe(probe), reopened.bulk_probe(probe))
    for got, want in zip(results["t"], results["j"]):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert results["t"][0][0].sum() == 4 * 40   # every stored row hits
    _same_dir(str(tmp_path / "t"), str(tmp_path / "j"))


def test_refresh_adopts_another_writers_shards(tmp_path):
    d = str(tmp_path)
    batches = _batches(3)
    reader = tstore.SignatureStore(d, POLICY, read_only=True)
    writer = jstore.SignatureStore(d, POLICY)
    assert not reader.refresh()
    writer.append(*batches[0])
    writer.append(*batches[1])
    assert reader.refresh()
    hit, sh, rw = reader.bulk_probe(batches[1][0])
    assert hit.all()
    np.testing.assert_array_equal(
        reader.load_signatures(sh, rw),
        writer.load_signatures(*writer.bulk_probe(batches[1][0])[1:]))
    with pytest.raises(RuntimeError, match="read-only"):
        reader.append(*batches[2])


def test_serve_journal_rides_the_manifest_as_jax(tmp_path):
    for name, mod in (("t", tstore), ("j", jstore)):
        store = mod.SignatureStore(str(tmp_path / name), POLICY)
        store.journal_record("req-1", {"rows": 3})
        store.append(*_batches(1)[0])
        assert mod.SignatureStore(str(tmp_path / name),
                                  POLICY).serve_journal == {
                                      "req-1": {"rows": 3}}
    _same_dir(str(tmp_path / "t"), str(tmp_path / "j"))


def test_shard_write_is_retried(tmp_path, monkeypatch):
    """A transient OSError in a shard write rewrites the shard; past the
    attempts the append raises RetryError and commits nothing."""
    monkeypatch.setenv("TSE1M_RETRY_BASE_DELAY", "0")
    store = tstore.SignatureStore(str(tmp_path), POLICY)
    real_save = np.save
    fails = {"left": 1}

    def flaky_save(path, arr):
        if fails["left"]:
            fails["left"] -= 1
            raise OSError("transient")
        real_save(path, arr)

    monkeypatch.setattr(tstore.np, "save", flaky_save)
    dg, sg = _batches(1)[0]
    assert store.append(dg, sg) == 39
    assert store.bulk_probe(dg)[0].all()
    fails["left"] = 10
    with pytest.raises(tretry.RetryError, match="giving up after 4"):
        store.append(*_batches(2)[1])
    assert len(tstore.SignatureStore(str(tmp_path), POLICY).shards) == 1


def test_retry_policy_reads_the_environment_as_jax(monkeypatch):
    from tse1m_tpu.resilience import io_retry_policy as j_policy

    monkeypatch.setenv("TSE1M_RETRY_ATTEMPTS", "6")
    monkeypatch.setenv("TSE1M_RETRY_DEADLINE", "1.5")
    got, want = tretry.io_retry_policy(), j_policy()
    for field in ("max_attempts", "base_delay", "max_delay", "deadline",
                  "jitter"):
        assert getattr(got, field) == getattr(want, field)
    assert got.max_attempts == 6 and got.deadline == 1.5
