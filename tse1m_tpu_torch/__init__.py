"""tse1m_tpu_torch: the PyTorch/CUDA port of tse1m_tpu, for one NVIDIA H100.

This package runs the single-GPU session clustering of
``tse1m_tpu.cluster.cluster_sessions`` under its three signature schemes
(kminhash, cminhash, weighted), cold with the wire v3 levers (host
prefilter, base-delta lane, rANS lanes) or warm through the persistent
signature store (``SignatureStore``: accreted-tail merges and union
runs, ``minhash_novel_rows``), or from chunk checkpoints that survive a
kill (``cluster_sessions_resumable``), every stream under a degradation
ladder that survives out-of-memory, stalls and device errors on the card
(``cluster/ladder.py``), and exact top-k agreement scoring, single
shot (``topk_agreement``) or streamed over a store (``bulk_topk_store``).
Every TPU kernel of those paths (the two MinHash kernels, the
one-permutation bin-min, the rANS decode and the top-k scorer) is written
by hand in CUDA C++ for Hopper (``cluster/kernels/csrc/``).

It also runs the paper's RQ analysis: a study (``db/``: sqlite, or
Postgres through psycopg2 or libpq; written by ``data/synth.py``, loaded
from the collectors' CSVs by ``db/ingest.py`` or from the reference's
pg_dump by ``db/restore.py``) is extracted into per-project CSR arrays
(``data/columnar.py``, through the g++-built decoder of ``native/``) and
answered by ``TorchBackend`` (``backend/``,
torch ops in ``ops/segment.py``), all six research questions in one pass
on the card with ``rq_suite``; the six drivers under ``analysis/`` write
every RQ's artifacts, as the JAX package's drivers do.
It serves, too: ``serve.ServeDaemon`` keeps one signature store live,
ingesting batches (novel rows MinHashed on the card) and answering
cluster-membership and top-k queries over a JSON-over-TCP transport
(``serve.ServeServer``, ``serve.ServeClient``), with admission control,
watchdog budgets and the telemetry of ``observability``; and scales out on
one card: digest-range shard daemons under epoch leases behind a
``serve.ShardRouter``, read replicas (``serve.ServeReplica``) and
``backfill``.
Over several processes (one rank each, ``parallel/``: NCCL across cards,
gloo where ranks share one) the clustering runs band-sharded
(``cluster_sessions(items, mesh=make_mesh())``) and ``TorchBackend``
shards the RQ reductions over the world, every rank getting the
single-device result.
It imports ``torch`` and ``numpy`` and the standard library, and nothing of
the JAX package or pandas; matplotlib only inside the drivers' figure
functions, which are skipped where it does not import.

Entry points run on the card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions; without a card they raise.
Ids, hash constants, signatures and band keys are int32 tensors carrying
uint32 bits (``tse1m_tpu_torch.device``).

    python -m tse1m_tpu_torch cluster --n 1000000 [--sig-store DIR] \
        [--checkpoint-dir DIR]
    python -m tse1m_tpu_torch scrub DIR [--repair] [--verify-sigs]
    python -m tse1m_tpu_torch synth --db study.sqlite [--csv-dir DIR]
    python -m tse1m_tpu_torch ingest --csv-dir DIR --db study.sqlite
    python -m tse1m_tpu_torch restore backup_clean.sql --db study.sqlite
    python -m tse1m_tpu_torch stats --db study.sqlite
    python -m tse1m_tpu_torch all --db study.sqlite --result-dir out
    python -m tse1m_tpu_torch serve --sig-store DIR --port-file F
    python -m tse1m_tpu_torch serve --root R --range 0
    python -m tse1m_tpu_torch serve-router --root R --shards 4
    python -m tse1m_tpu_torch backfill --npy Q.npy --sig-store DIR
"""

from .backend import TorchBackend
from .cluster import (ClusterParams, SignatureStore, adjusted_rand_index,
                      bulk_topk_store, cluster_sessions,
                      cluster_sessions_resumable, host_cluster,
                      minhash_novel_rows, row_digests, score_topk_host,
                      store_scan_locator)
from .cluster.kernels.score import topk_agreement
from .cluster.schemes import expand_weighted
from .data import synth_session_hitcounts, synth_session_sets
from .device import as_u32_numpy, narrow, resolve_device, u32_tensor, widen
from .parallel import Mesh, make_mesh

__all__ = ["ClusterParams", "Mesh", "SignatureStore", "TorchBackend",
           "adjusted_rand_index", "as_u32_numpy", "bulk_topk_store",
           "cluster_sessions", "cluster_sessions_resumable",
           "expand_weighted", "host_cluster", "make_mesh",
           "minhash_novel_rows", "narrow", "resolve_device", "row_digests",
           "score_topk_host", "store_scan_locator", "synth_session_hitcounts",
           "synth_session_sets", "topk_agreement", "u32_tensor", "widen"]
