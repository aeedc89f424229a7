"""A run with its timed path broken underneath comes out not correct.

Each test drives a whole run of a cell on the CPU at a small size (the
harness's look for a card is skipped) with one fault planted in the
program, and checks that ``correct`` is false: a step that returns its
state unchanged, half of the batch left out, and an answer altered where
it is produced.  A fourth kind of fault, the exchange between
chips left out, has no place here: both cells run on one card.
"""

import numpy as np
import torch

from benchmark.harness import runner

SEED = 2**31 + 3
CLUSTER = "cluster.kminhash.resident"
SCAN = "scan.cminhash.q32k"
SMALL = {CLUSTER: {"config": {"n_sessions": 3000}},
         SCAN: {"config": {"n_sessions": 2000},
                "params": {"queries": 128, "sample_per_pass": 8}}}


def _run(cell: str) -> dict:
    return runner.run_cell(cell, SEED, 0.3, False, device="cpu",
                           overrides=SMALL[cell])


def test_unbroken_runs_are_correct():
    for cell in SMALL:
        assert _run(cell)["correct"] is True


# -- the clustering cell ------------------------------------------------------

def test_cluster_labels_never_propagated(monkeypatch):
    from tse1m_tpu_torch.cluster import sharded

    def unchanged(reps, valid, n_iters=64, mesh=None):
        return torch.arange(reps.shape[0], dtype=torch.int32,
                            device=reps.device)

    monkeypatch.setattr(sharded, "propagate_labels", unchanged)
    res = _run(CLUSTER)
    assert res["correct"] is False and res["checks"]["rows_off"]["value"] > 0


def test_cluster_half_the_rows_left_out(monkeypatch):
    from tse1m_tpu_torch.cluster import pipeline

    real = pipeline.sharded_labels

    def half(rows, *args, **kwargs):
        n = rows.shape[0]
        first = real(rows[:n // 2].contiguous(), *args, **kwargs)
        rest = torch.arange(n // 2, n, dtype=first.dtype,
                            device=first.device)
        return torch.cat([first, rest])

    monkeypatch.setattr(pipeline, "sharded_labels", half)
    assert _run(CLUSTER)["correct"] is False


def test_cluster_one_label_altered(monkeypatch):
    from tse1m_tpu_torch.cluster import pipeline

    real = pipeline.sharded_labels

    def altered(*args, **kwargs):
        labels = real(*args, **kwargs).clone()
        row = int(torch.nonzero(labels != torch.arange(
            labels.shape[0], device=labels.device))[0])
        labels[row] = row
        return labels

    monkeypatch.setattr(pipeline, "sharded_labels", altered)
    res = _run(CLUSTER)
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] == 1
    assert res["failed"] == res["attempted"]


# -- the scan cell ----------------------------------------------------------

def test_scan_state_returned_unchanged(monkeypatch):
    from tse1m_tpu_torch.cluster.kernels import score

    monkeypatch.setattr(score, "topk_chunk",
                        lambda q, s_t, rowids, topc, topr, k: (topc, topr))
    assert _run(SCAN)["correct"] is False


def test_scan_half_the_store_left_out(monkeypatch):
    from tse1m_tpu_torch.cluster.kernels import score

    real = score._scan_chunks

    def half(store, chunk_rows):
        for rows, base in real(store, chunk_rows):
            yield rows[:max(1, rows.shape[0] // 2)], base

    monkeypatch.setattr(score, "_scan_chunks", half)
    assert _run(SCAN)["correct"] is False


def test_scan_answer_altered(monkeypatch):
    from tse1m_tpu_torch.cluster.kernels import score

    real = score._finalize

    def altered(*args):
        counts, rows = real(*args)
        rows = rows.copy()
        rows[:, -1] += 1
        return counts, rows

    monkeypatch.setattr(score, "_finalize", altered)
    res = _run(SCAN)
    assert res["correct"] is False and res["failed"] == res["attempted"]
    assert np.isfinite(res["checks"]["slots_off"]["value"])
