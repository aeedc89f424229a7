"""The reference against the program at small sizes on the CPU: the
generator, signatures and band keys under both schemes, labels, the
store's row order and the exact top k with ties.  The test imports both;
the reference itself imports nothing of the program."""

import numpy as np
import pytest
import torch

from benchmark.harness import cells
from benchmark.harness.synth import corpus, synth_session_sets
from benchmark.reference import lsh, signatures, topk

MASK = 0xFFFFFFFF
SEEDS = [0, 2**31 + 5]
SCHEMES = ["kminhash", "cminhash"]
CONFIG = {"kminhash": "kminhash-h128b16-1m", "cminhash": "cminhash-h128b16-1m"}


def _small(scheme: str, n: int) -> dict:
    cfg = cells.config(CONFIG[scheme])
    cfg["n_sessions"] = n
    return cfg


def _bits(sig: torch.Tensor) -> np.ndarray:
    return sig.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_generator_copy_equals_the_programs(seed):
    from tse1m_tpu_torch.data.synth import synth_session_sets as program

    a, la = synth_session_sets(3000, seed=seed)
    b, lb = program(3000, seed=seed)
    assert np.array_equal(a, b) and np.array_equal(la, lb)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_signatures_and_keys_equal_the_programs(scheme, seed):
    from tse1m_tpu_torch.cluster.minhash import band_keys
    from tse1m_tpu_torch.cluster.schemes import (make_params,
                                                 scheme_host_signatures)
    from tse1m_tpu_torch.device import u32_tensor

    items = corpus(_small(scheme, 700), seed)
    ref = signatures.signatures(items, scheme, 128, seed & MASK, "cpu")
    prog = scheme_host_signatures(items, make_params(scheme, 128,
                                                     seed & MASK))
    assert np.array_equal(_bits(ref), prog)
    keys = band_keys(u32_tensor(prog), 16).numpy().view(np.uint32)
    assert np.array_equal(_bits(signatures.band_keys(ref, 16)), keys)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_labels_equal_the_programs(scheme, seed):
    from tse1m_tpu_torch.cluster.pipeline import (ClusterParams,
                                                  cluster_sessions)

    cfg = _small(scheme, 4000)
    items = corpus(cfg, seed)
    prog = cluster_sessions(items, ClusterParams(
        scheme=scheme, seed=seed & MASK, prefilter="off"), device="cpu")
    ref = lsh.cluster_labels(items, cfg, seed & MASK, "cpu")
    assert np.array_equal(ref, prog)
    # Planted clusters were found: far fewer labels than sessions.
    assert np.unique(ref).size < 0.6 * items.shape[0]


def _store(tmp_path, items, sigs, seed):
    from tse1m_tpu_torch.cluster.store import SignatureStore, row_digests

    policy = {"n_hashes": 128, "seed": seed, "quant_bits": 0,
              "scheme": "cminhash"}
    SignatureStore(str(tmp_path), policy).append(row_digests(items), sigs)
    return SignatureStore(str(tmp_path), policy)


def test_stored_rows_follow_the_stores_order(tmp_path):
    from tse1m_tpu_torch.cluster.schemes import (make_params,
                                                 scheme_host_signatures)

    items = corpus(_small("cminhash", 3000), 11)
    items[2000:2100] = items[100:200]  # exact duplicates, kept once
    sigs = scheme_host_signatures(items, make_params("cminhash", 128, 11))
    store = _store(tmp_path, items, sigs, 11)
    kept = topk.stored_rows(items, "cpu")
    assert kept.size == store.n_rows < items.shape[0]
    stored = np.concatenate([store._sig_mmap(int(e["id"]))
                             for e in sorted(store.shards,
                                             key=lambda e: int(e["id"]))])
    assert np.array_equal(stored, sigs[kept])


@pytest.mark.parametrize("seed", SEEDS)
def test_topk_equals_the_programs_with_ties(tmp_path, seed):
    from tse1m_tpu_torch.cluster.kernels.score import bulk_topk_store

    cfg = _small("cminhash", 2500)
    items = corpus(cfg, seed)
    hs = seed & MASK
    sig = signatures.signatures(items, "cminhash", 128, hs, "cpu")
    store = _store(tmp_path, items, _bits(sig), hs)
    rng = np.random.default_rng(seed)
    qrows = rng.choice(items.shape[0], 40, replace=False)
    counts, rows = bulk_topk_store(store, _bits(sig)[qrows], 10,
                                   device="cpu", chunk_rows=1024)
    bits = ((sig ^ 0x80000000) - 0x80000000).to(torch.int32)
    kept = torch.from_numpy(topk.stored_rows(items, "cpu"))
    ref_c, ref_r = topk.topk(bits[qrows], bits[kept], 10)
    assert np.array_equal(counts, ref_c) and np.array_equal(rows, ref_r)
    # Ties were broken: equal counts side by side, rows ascending.
    tie = counts[:, 1:] == counts[:, :-1]
    assert tie.any() and (rows[:, 1:][tie] > rows[:, :-1][tie]).all()


def test_topk_pads_past_the_stored_rows():
    store = torch.tensor([[1, 2], [1, 3], [5, 6]], dtype=torch.int32)
    c, r = topk.topk(torch.tensor([[1, 3]], dtype=torch.int32), store, 5)
    assert c.tolist() == [[2, 1, 0, -1, -1]]
    assert r.tolist() == [[1, 0, 2, -1, -1]]
