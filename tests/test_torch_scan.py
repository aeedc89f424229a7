"""tse1m_tpu_torch's streaming top-k scan over a signature store
(``bulk_topk_store``, on the CPU through the kernel's plain version)
against the JAX package's scan and the numpy oracle ``score_topk_host``
(recall 1.0), with the scan-order locator, the staging that feeds both
the scan and ``topk_agreement``, and the edge cases.  Tolerance: exact,
element for element."""

import numpy as np
import pytest
import torch

from tse1m_tpu.cluster import store as jstore
from tse1m_tpu.cluster.kernels import score as jscore
from tse1m_tpu_torch import bulk_topk_store, score_topk_host, \
    store_scan_locator
from tse1m_tpu_torch.cluster import kernels
from tse1m_tpu_torch.cluster import store as tstore
from tse1m_tpu_torch.cluster.kernels import score as ksc

H = 16
BLOCK_N = 128
POLICY = {"n_hashes": H, "seed": 0, "quant_bits": 0}


def _sigs(rng, n, alphabet=3):
    """Signatures over a small alphabet: many agreements, many ties."""
    return rng.integers(0, alphabet, size=(n, H), dtype=np.uint64).astype(
        np.uint32)


def _jax_store(path, sizes=(300, 1, 515, 128, 77), seed=0):
    """A store written by the JAX package, one shard a size, and its
    signatures in scan order (shards by id)."""
    rng = np.random.default_rng(seed)
    store = jstore.SignatureStore(str(path), POLICY)
    for i, n in enumerate(sizes):
        digests = jstore.row_digests(rng.integers(
            0, 1 << 32, size=(n, 4), dtype=np.uint64).astype(np.uint32)
            + np.uint32(i))
        store.append(digests, _sigs(rng, n))
    scan = np.concatenate([np.load(str(path / f"sig_{i:05d}.npy"))
                           for i in range(len(sizes))])
    return store, scan


@pytest.mark.parametrize("overlap", [True, False])
@pytest.mark.parametrize("chunk_rows,qn,k", [
    (128, 5, 7),      # many chunks, each shard's tail padded
    (200, 9, 128),    # rounded up to 256; k = K_PAD
    (16384, 3, 10),   # the default: one padded chunk a shard
])
def test_bulk_topk_store_matches_jax_and_host(tmp_path, overlap,
                                              chunk_rows, qn, k):
    jst, scan = _jax_store(tmp_path / "s")
    store = tstore.SignatureStore(str(tmp_path / "s"), POLICY)
    rng = np.random.default_rng(qn)
    queries = _sigs(rng, qn)
    queries[0] = scan[400]
    got = bulk_topk_store(store, queries, k, device="cpu", block_n=BLOCK_N,
                          chunk_rows=chunk_rows, overlap=overlap)
    want = jscore.bulk_topk_store(jst, queries, k, use_pallas="never",
                                  block_n=BLOCK_N, chunk_rows=chunk_rows,
                                  overlap=overlap)
    host = score_topk_host(queries, scan, k)
    for g, w, o in zip(got, want, host):
        assert g.dtype == np.int32 and g.shape == (qn, k)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)
    assert got[0][0, 0] == H and got[1][0, 0] <= 400
    loc = store_scan_locator(store, got[1][0])
    np.testing.assert_array_equal(loc, jscore.store_scan_locator(
        jst, got[1][0]))
    np.testing.assert_array_equal(
        store.load_signatures(loc[:, 0], loc[:, 1]), scan[got[1][0]])


def test_scan_launches_one_chunk_at_a_time_and_counts_none_on_the_cpu(
        tmp_path, monkeypatch):
    """One topk_chunk call a chunk (sum over shards of ceil(rows /
    chunk_rows)), each on a fixed [H, chunk_rows] chunk whose state is the
    previous call's; on the CPU no launch is counted."""
    _, scan = _jax_store(tmp_path / "s")
    store = tstore.SignatureStore(str(tmp_path / "s"), POLICY)
    calls = []
    real = ksc.topk_chunk

    def spy(q, s_t, rid, topc, topr, k):
        calls.append((tuple(s_t.shape), int((rid < ksc.ROW_INF).sum())))
        return real(q, s_t, rid, topc, topr, k)

    monkeypatch.setattr(ksc, "topk_chunk", spy)
    kernels.reset_launch_counts()
    bulk_topk_store(store, scan[:2], 5, device="cpu", block_n=BLOCK_N,
                    chunk_rows=128)
    sizes = (300, 1, 515, 128, 77)
    assert len(calls) == sum(-(-n // 128) for n in sizes)
    assert {c[0] for c in calls} == {(H, 128)}
    assert sum(c[1] for c in calls) == sum(sizes)
    assert kernels.launch_counts()["topk_chunk"] == 0


def test_empty_store_k_past_rows_and_no_queries(tmp_path):
    empty = tstore.SignatureStore(str(tmp_path / "e"), POLICY)
    q = np.zeros((3, H), np.uint32)
    for c, r in (bulk_topk_store(empty, q, 4, device="cpu"),
                 bulk_topk_store(empty, q[:0], 4, device="cpu"),
                 bulk_topk_store(empty, q, 0, device="cpu")):
        assert (c == -1).all() and (r == -1).all()
    assert bulk_topk_store(empty, q, 4, device="cpu")[0].shape == (3, 4)
    jst, scan = _jax_store(tmp_path / "s", sizes=(3, 2))
    store = tstore.SignatureStore(str(tmp_path / "s"), POLICY)
    got = bulk_topk_store(store, scan[:2], 9, device="cpu", block_n=BLOCK_N)
    want = jscore.bulk_topk_store(jst, scan[:2], 9, use_pallas="never",
                                  block_n=BLOCK_N)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert (got[0][:, 5:] == -1).all() and (got[1][:, :5] >= 0).all()


def test_scan_refuses_bad_shapes_and_int32_overflow(tmp_path):
    store = tstore.SignatureStore(str(tmp_path), POLICY)
    with pytest.raises(ValueError, match="outside"):
        bulk_topk_store(store, np.zeros((2, H), np.uint32), 129,
                        device="cpu")
    with pytest.raises(ValueError, match=r"\[Q, 16\]"):
        bulk_topk_store(store, np.zeros((2, 8), np.uint32), 2, device="cpu")

    class Huge:
        n_rows = 2**31
        policy = POLICY

    with pytest.raises(ValueError, match="int32"):
        bulk_topk_store(Huge(), np.zeros((2, H), np.uint32), 2,
                        device="cpu")


def test_scan_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = tstore.SignatureStore(str(tmp_path), POLICY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bulk_topk_store(store, np.zeros((2, H), np.uint32), 2)


def test_store_scan_locator_matches_jax(tmp_path):
    jst, _ = _jax_store(tmp_path / "s")
    store = tstore.SignatureStore(str(tmp_path / "s"), POLICY)
    rows = np.array([0, 299, 300, 301, 815, 816, 943, 1020, 1021, -1, 5000])
    got = store_scan_locator(store, rows)
    np.testing.assert_array_equal(got, jscore.store_scan_locator(jst, rows))
    assert got[:4].tolist() == [[0, 0], [0, 299], [1, 0], [2, 0]]
    assert got[-2:].tolist() == [[-1, -1], [-1, -1]]


@pytest.mark.parametrize("qn,n,k,block_rows", [
    (5, 1000, 7, 4096), (3, 513, 128, 100), (4, 0, 3, 4096),
    (0, 10, 2, 4096), (6, 3, 10, 2),
])
def test_score_topk_host_matches_jax(qn, n, k, block_rows):
    rng = np.random.default_rng(qn + n)
    q, s = _sigs(rng, qn), _sigs(rng, n)
    for g, w in zip(score_topk_host(q, s, k, block_rows),
                    jscore.score_topk_host(q, s, k, block_rows)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("overlap", [True, False])
def test_staging_yields_every_block_in_order(overlap):
    """The double-buffered staging hands each block over whole and in
    order, while the next one is staged into the other buffer."""
    rng = np.random.default_rng(4)
    blocks = [(_sigs(rng, n, 1 << 32), base)
              for n, base in ((7, 0), (7, 7), (3, 14), (7, 17), (1, 24))]
    seen = []
    for rows_d, base in ksc._staged(iter(blocks), 7, H,
                                    torch.device("cpu"), overlap):
        seen.append((rows_d.clone().numpy().view(np.uint32), base))
    assert [b for _, b in seen] == [b for _, b in blocks]
    for (got, _), (want, _) in zip(seen, blocks):
        np.testing.assert_array_equal(got, want)


def test_stage_block_lays_out_one_chunk():
    """``topk_agreement``'s chunk, filled STAGE_ROWS rows at a time:
    [H, n_cols] with zeros and ROW_INF ids past the rows."""
    rng = np.random.default_rng(5)
    n = ksc.STAGE_ROWS + 37
    sigs = _sigs(rng, n, 1 << 32)
    s_t, rid = ksc._stage_block(sigs, 11, n + 91, torch.device("cpu"))
    np.testing.assert_array_equal(s_t[:, :n].numpy().view(np.uint32),
                                  sigs.T)
    assert (s_t[:, n:] == 0).all()
    np.testing.assert_array_equal(rid[0, :n].numpy(), np.arange(11, n + 11))
    assert (rid[0, n:] == ksc.ROW_INF).all() and rid.shape == (1, n + 91)
