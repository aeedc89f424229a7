"""Session near-duplicate clustering: MinHash + banded LSH on one GPU."""

from .metrics import adjusted_rand_index
from .pipeline import ClusterParams, cluster_sessions, last_run_info

__all__ = ["ClusterParams", "adjusted_rand_index", "cluster_sessions",
           "last_run_info"]
