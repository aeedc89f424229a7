"""Traffic kind ``resident_cluster``: clustering sessions that are already
on the card, one caller in a closed loop.

Set-up makes ``corpora`` corpora of the configuration's sizes from the
seed, starts a world of one rank (NCCL on a card; a ``file://``
rendezvous in the run's scratch directory), puts each corpus on the
device through the mesh feed (``put_process_local_padded`` ->
``ShardedRows``), so that no call sees the input of the call before it,
and warms one call of each.  Call i clusters corpus ``i mod corpora``
with ``cluster_sessions(rows, params, mesh=mesh)`` and returns when its
[N] labels are on the host.

The check: every call's labels against the reference's labels of its
corpus (``reference/lsh.py``), worked out again from the same sessions
and seed.  ``rows_off`` is the most rows any call labels otherwise.  A
call's labels are compared on the spot with its corpus's warm-call
labels and dropped when equal (they are then judged through those), so
that the window does not hold hundreds of answers; a call whose labels
differ keeps them, to be judged on their own.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from benchmark.harness.runner import Phases, percentile
from benchmark.harness.synth import corpus
from benchmark.reference.lsh import cluster_labels


class Cell:
    def __init__(self, config: dict, params: dict, seed: int, device: str,
                 scratch: str) -> None:
        self.config, self.params = config, params
        self.seed, self.device, self.scratch = seed, device, scratch
        # The hash constants play the part of weights: drawn from the seed.
        self.hash_seed = seed & 0xFFFFFFFF
        self.items: list = []
        self.rows: list = []
        self.warm: list = []
        self.same: list = []
        self.odd: list = []
        self.world = False
        self.phases = Phases()

    def make_inputs(self) -> None:
        self.items = [corpus(self.config, self.seed, i)
                      for i in range(self.params["corpora"])]

    def setup(self) -> None:
        from tse1m_tpu_torch.cluster.pipeline import (ClusterParams,
                                                      cluster_sessions)
        from tse1m_tpu_torch.parallel import multihost
        from tse1m_tpu_torch.parallel.mesh import make_mesh

        cfg = self.config
        with self.phases("corpora"):
            self.make_inputs()
        self.cluster_sessions = cluster_sessions
        self.cparams = ClusterParams(
            n_hashes=cfg["n_hashes"], n_bands=cfg["n_bands"],
            threshold=cfg["threshold"], n_iters=cfg["n_iters"],
            seed=self.hash_seed, prefilter=cfg["prefilter"],
            scheme=cfg["scheme"])
        rendezvous = os.path.join(self.scratch, "rendezvous")
        with self.phases("world"):
            multihost.init_world(1, 0, f"file://{rendezvous}", self.device)
            self.world = True
            self.mesh = make_mesh()
        with self.phases("feed"):
            self.rows = [multihost.put_process_local_padded(
                x, x.shape[0], self.mesh)[0] for x in self.items]
        with self.phases("warm"):
            self.warm = [self._cluster(k) for k in range(len(self.rows))]
            self.same = [0] * len(self.rows)
        # The program's own counters, read in the notes after the window.
        from tse1m_tpu_torch.cluster import pipeline
        from tse1m_tpu_torch.cluster.kernels import (launch_counts,
                                                     reset_launch_counts)

        self.run_info, self.launch_counts = pipeline.last_run_info, \
            launch_counts
        reset_launch_counts()
        self.mesh.reset_stats()

    def _cluster(self, k: int) -> np.ndarray:
        out = self.cluster_sessions(self.rows[k], self.cparams,
                                    mesh=self.mesh, device=self.device)
        return out[:self.items[k].shape[0]]

    def call(self, i: int) -> None:
        k = i % len(self.rows)
        labels = self._cluster(k)
        if np.array_equal(labels, self.warm[k]):
            self.same[k] += 1
        else:
            self.odd.append((k, labels))

    def end_to_end(self, latencies: list, window_s: float) -> dict:
        n = self.config["n_sessions"]
        return {"cluster_rows_per_s": len(latencies) * n / window_s,
                "cluster_p95_ms": percentile(latencies, 95) * 1e3}

    def notes(self, latencies: list, window_s: float) -> list:
        launches = {k: v for k, v in self.launch_counts().items() if v}
        return [self.phases.line(),
                f"clustering calls in the window: {len(latencies)} "
                f"(cluster_p95_ms is the nearest-rank 95th percentile of "
                f"them) in {window_s:.6f} s",
                f"program: kernel launches in the window {launches}; the "
                f"last call's stages {self.run_info.get('stages')}",
                f"program: collectives in the window {self.mesh.stats} "
                f"(two pmin a propagation step)"]

    def shapes(self) -> dict:
        cfg = self.config
        return {"rows": cfg["n_sessions"], "set_size": cfg["set_size"],
                "n_hashes": cfg["n_hashes"], "n_bands": cfg["n_bands"],
                "scheme": cfg["scheme"]}

    def release(self) -> None:
        self.rows = []

    def _judge(self, answers: list, reference: list) -> dict:
        """``answers``: (corpus, labels, calls that gave them)."""
        off = [(int(np.count_nonzero(labels != reference[k])), n)
               for k, labels, n in answers if n]
        return {"attempted": sum(n for _, n in off),
                "failed": sum(n for o, n in off if o),
                "numbers": {"rows_off": max((o for o, _ in off),
                                            default=0)}}

    def reference(self, key_bits: int = 32) -> list:
        return [cluster_labels(x, self.config, self.hash_seed, self.device,
                               key_bits)
                for x in self.items]

    def check(self) -> dict:
        answers = [(k, labels, self.same[k])
                   for k, labels in enumerate(self.warm)]
        verdict = self._judge(answers + [(k, labels, 1)
                                         for k, labels in self.odd],
                              self.reference())
        self.warm, self.odd = [], []
        return verdict

    def control(self) -> dict:
        """The reference with the narrower band keys of
        ``params["control"]["key_bits"]`` in the program's place, judged
        as the program is: one call a corpus."""
        narrow = self.reference(self.params["control"]["key_bits"])
        return self._judge([(k, labels, 1) for k, labels in
                            enumerate(narrow)], self.reference())

    def close(self) -> None:
        self.rows = []
        if self.world:
            from tse1m_tpu_torch.parallel import multihost

            multihost.shutdown()
            self.world = False
        if self.device == "cuda":
            torch.cuda.synchronize()
