"""Traffic kind ``bulk_scan``: an exact top-k re-label of a corpus
against a signature store, one caller in a closed loop.

Set-up makes the stored corpus of the configuration's sizes from the seed,
signs it on the card with the program's ``minhash_novel_rows`` under the
configuration's scheme, appends the signatures to a ``SignatureStore`` in
the run's scratch directory (policy: the configuration's hashes and
scheme, the seed's hash constants, no quantization) and opens the store
anew, as a re-labelling job would.  The corpus to re-label has as many
sessions, drawn from the seed: ``novel_share`` of them fresh sessions of
the configuration's sizes, the rest copies of stored sessions with each
id replaced with probability ``mutate_prob`` (the next round of the same
fuzz targets); set-up signs it as it signs the store.  Pass i scores the
next ``queries`` of them, taken cyclically from row ``i * queries mod
N``, against every stored row with ``bulk_topk_store(store, queries,
k)``, which stages the store's shards from disk through pinned buffers to
the top-k kernel, and returns when the [Q, k] counts and rows are on the
host.  One warm pass belongs to set-up.

The check: ``sample_per_pass`` queries of every pass, drawn from the
seed, against the reference's exact top k (``reference/topk.py``) over
the store's rows as the reference works them out (the first occurrence
of each distinct session, signed again from the sessions; the queries
signed again from theirs).
``slots_off`` counts the sampled (query, slot) answers whose count or row
differs.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.harness.runner import Phases
from benchmark.harness.synth import corpus
from benchmark.reference.signatures import signatures
from benchmark.reference.topk import stored_rows, topk

CHECK_STREAM = 0x5CA9
QUERY_STREAM = 0x9E1A


def relabel_corpus(items: np.ndarray, config: dict, params: dict,
                   seed: int) -> np.ndarray:
    """[N, S] uint32 sessions to re-label against the stored ``items``:
    ``round(novel_share * N)`` fresh sessions at positions drawn from the
    seed, the others copies of stored sessions (drawn from the seed) with
    each id replaced with probability ``mutate_prob``.  Every seed gives
    the same number of each kind."""
    rng = np.random.default_rng([int(seed), QUERY_STREAM])
    n, s = items.shape
    universe = config["universe"]
    out = items[rng.integers(0, n, size=n)]
    mutate = rng.random((n, s)) < params["mutate_prob"]
    out[mutate] = rng.integers(0, universe, size=int(mutate.sum()),
                               dtype=np.uint32)
    novel = rng.permutation(n) < round(params["novel_share"] * n)
    out[novel] = rng.integers(0, universe, size=(int(novel.sum()), s),
                              dtype=np.uint32)
    return out


def _bits32(sig: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors of the same bits."""
    return ((sig ^ 0x80000000) - 0x80000000).to(torch.int32)


class Cell:
    def __init__(self, config: dict, params: dict, seed: int, device: str,
                 scratch: str) -> None:
        self.config, self.params = config, params
        self.seed, self.device, self.scratch = seed, device, scratch
        self.hash_seed = seed & 0xFFFFFFFF
        self.answers: list = []
        self.store = None
        self.phases = Phases()

    def make_inputs(self) -> None:
        self.items = corpus(self.config, self.seed, 0)
        self.queries = relabel_corpus(self.items, self.config, self.params,
                                      self.seed)

    def setup(self) -> None:
        from tse1m_tpu_torch.cluster.kernels.score import bulk_topk_store
        from tse1m_tpu_torch.cluster.pipeline import (ClusterParams,
                                                      minhash_novel_rows)
        from tse1m_tpu_torch.cluster.store import SignatureStore, row_digests

        cfg = self.config
        with self.phases("corpus"):
            self.make_inputs()
        self.bulk_topk_store = bulk_topk_store
        cparams = ClusterParams(n_hashes=cfg["n_hashes"],
                                n_bands=cfg["n_bands"], seed=self.hash_seed,
                                prefilter=cfg["prefilter"],
                                scheme=cfg["scheme"])
        with self.phases("sign"):
            sigs = minhash_novel_rows(self.items, cparams, 0,
                                      device=self.device, pad_pow2=False)
            self.query_sigs = minhash_novel_rows(self.queries, cparams, 0,
                                                 device=self.device,
                                                 pad_pow2=False)
        policy = {"n_hashes": cfg["n_hashes"], "seed": self.hash_seed,
                  "quant_bits": 0, "scheme": cfg["scheme"]}
        path = os.path.join(self.scratch, "store")
        with self.phases("digests"):
            digests = row_digests(self.items)
        with self.phases("append"):
            SignatureStore(path, policy).append(digests, sigs)
        del sigs
        with self.phases("open"):
            self.store = SignatureStore(path, policy)
        with self.phases("warm"):
            self._scan(0)
        # The program's launch counter, read in the notes after the window.
        from tse1m_tpu_torch.cluster.kernels import (launch_counts,
                                                     reset_launch_counts)

        self.launch_counts = launch_counts
        reset_launch_counts()

    def _scan(self, i: int) -> tuple:
        n, q = self.queries.shape[0], self.params["queries"]
        start = (i * q) % n
        rows = (start + np.arange(q)) % n
        counts, top = self.bulk_topk_store(self.store, self.query_sigs[rows],
                                           self.params["k"],
                                           device=self.device)
        return start, counts, top

    def call(self, i: int) -> None:
        self.answers.append(self._scan(i))

    def end_to_end(self, latencies: list, window_s: float) -> dict:
        pairs = self.params["queries"] * self.store.n_rows
        return {"scan_pairs_per_s": len(latencies) * pairs / window_s}

    def notes(self, latencies: list, window_s: float) -> list:
        return [self.phases.line(),
                f"scan passes in the window: {len(latencies)} of "
                f"{self.params['queries']} queries over "
                f"{self.store.n_rows} stored rows in {window_s:.6f} s",
                f"program: kernel launches in the window "
                f"{ {k: v for k, v in self.launch_counts().items() if v} }"]

    def shapes(self) -> dict:
        cfg = self.config
        return {"queries": self.params["queries"],
                "store_rows": self.store.n_rows,
                "n_hashes": cfg["n_hashes"]}

    def release(self) -> None:
        self.query_sigs = None

    # -- the check -----------------------------------------------------------

    def _sample(self, n_passes: int) -> list:
        """[(pass, positions)]: ``sample_per_pass`` query positions of
        each pass, drawn from the seed."""
        rng = np.random.default_rng([self.seed, CHECK_STREAM])
        q, m = self.params["queries"], self.params["sample_per_pass"]
        return [(i, np.sort(rng.choice(q, size=min(m, q), replace=False)))
                for i in range(n_passes)]

    def _reference_sigs(self, items: np.ndarray) -> torch.Tensor:
        """[N, H] signatures of ``items`` as int32 bit patterns on the
        device."""
        cfg = self.config
        return _bits32(signatures(items, cfg["scheme"], cfg["n_hashes"],
                                  self.hash_seed, self.device))

    def _judge(self, answers: list, low_bits: int | None = None) -> dict:
        """``answers``: (start, counts [Q, k], rows [Q, k]) a pass, judged
        on the sampled queries; with ``low_bits`` the answers are the
        reference's comparing that many low bits instead (the control)."""
        n, k = self.queries.shape[0], self.params["k"]
        kept = stored_rows(self.items, self.device)
        stored = self._reference_sigs(self.items[kept])
        sample = self._sample(len(answers))
        qrows = np.concatenate([(a[0] + pos) % n for a, (_, pos)
                                in zip(answers, sample)])
        uniq, inv = np.unique(qrows, return_inverse=True)
        qsig = self._reference_sigs(self.queries[uniq])
        ref_c, ref_r = topk(qsig, stored, k)
        if low_bits is not None:
            got_c, got_r = topk(qsig, stored, k, low_bits)
        off, failed, at = 0, 0, 0
        for (start, counts, rows), (_, pos) in zip(answers, sample):
            u = inv[at:at + pos.size]
            at += pos.size
            if low_bits is not None:
                c, r = got_c[u], got_r[u]
            else:
                c, r = counts[pos], rows[pos]
            bad = int(np.count_nonzero((c != ref_c[u]) | (r != ref_r[u])))
            off += bad
            failed += bad > 0
        return {"attempted": len(answers), "failed": failed,
                "numbers": {"slots_off": off}}

    def check(self) -> dict:
        verdict = self._judge(self.answers)
        self.answers = []
        return verdict

    def control(self) -> dict:
        """The reference comparing only ``params["control"]["low_bits"]``
        of each signature value, in the program's place, over the passes
        that cover the corpus to re-label once."""
        n, q = self.queries.shape[0], self.params["queries"]
        passes = [((i * q) % n, None, None) for i in range(-(-n // q))]
        return self._judge(passes, self.params["control"]["low_bits"])

    def close(self) -> None:
        self.store = None
        if self.device == "cuda":
            torch.cuda.synchronize()
