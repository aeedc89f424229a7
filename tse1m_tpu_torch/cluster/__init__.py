"""Session near-duplicate clustering: MinHash + banded LSH on one GPU, cold
or warm through a persistent signature store, resumable from chunk
checkpoints, across processes over a digest-range sharded store (the pod
path), and exact top-k scoring."""

from .host import host_cluster
from .kernels.score import bulk_topk_store, score_topk_host, store_scan_locator
from .metrics import adjusted_rand_index
from .pipeline import (ClusterParams, cluster_sessions, cluster_sessions_pod,
                       cluster_sessions_resumable, last_run_info,
                       minhash_novel_rows)
from .store import ShardedSignatureStore, SignatureStore, row_digests

__all__ = ["ClusterParams", "ShardedSignatureStore", "SignatureStore",
           "adjusted_rand_index", "bulk_topk_store", "cluster_sessions",
           "cluster_sessions_pod", "cluster_sessions_resumable",
           "host_cluster", "last_run_info", "minhash_novel_rows",
           "row_digests", "score_topk_host", "store_scan_locator"]
