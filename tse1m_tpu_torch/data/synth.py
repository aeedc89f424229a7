"""Planted near-duplicate session sets and their hit counts (numpy, seeded).

Copies of ``tse1m_tpu.data.synth.synth_session_sets`` and
``synth_session_hitcounts``: the same seed gives the same data in both
packages.
"""

from __future__ import annotations

import numpy as np


def synth_session_sets(
    n_sessions: int,
    set_size: int = 64,
    universe: int = 1 << 24,
    dup_fraction: float = 0.6,
    mean_cluster_size: float = 8.0,
    mutate_prob: float = 0.05,
    seed: int = 0,
    dtype=np.uint32,
) -> tuple[np.ndarray, np.ndarray]:
    """Planted near-duplicate session coverage sets.

    Returns (items [N, set_size] uint32, labels [N] int64).  ``dup_fraction``
    of sessions belong to multi-member clusters whose members share a base
    set with ~``mutate_prob`` of items replaced (expected Jaccard ~0.9);
    the rest are singletons.
    """
    rng = np.random.default_rng(seed)
    n_dup = int(n_sessions * dup_fraction)
    n_clusters = max(1, int(n_dup / mean_cluster_size))

    labels = np.empty(n_sessions, dtype=np.int64)
    labels[:n_dup] = rng.integers(0, n_clusters, size=n_dup)
    labels[n_dup:] = np.arange(n_clusters, n_clusters + (n_sessions - n_dup))

    base = rng.integers(0, universe, size=(n_clusters, set_size), dtype=dtype)
    items = np.empty((n_sessions, set_size), dtype=dtype)
    items[:n_dup] = base[labels[:n_dup]]
    items[n_dup:] = rng.integers(0, universe, size=(n_sessions - n_dup, set_size),
                                 dtype=dtype)

    # Mutate a small fraction of the duplicated rows' items.
    mutate_mask = rng.random((n_dup, set_size)) < mutate_prob
    n_mut = int(mutate_mask.sum())
    items[:n_dup][mutate_mask] = rng.integers(0, universe, size=n_mut, dtype=dtype)

    perm = rng.permutation(n_sessions)
    return items[perm], labels[perm]


def synth_session_hitcounts(
    items: np.ndarray,
    labels: np.ndarray,
    max_weight: int = 8,
    noise_prob: float = 0.05,
    seed: int = 0,
) -> np.ndarray:
    """Per-edge hit counts for the weighted workload (``--scheme
    weighted``): [N, S] uint32 in [1, max_weight].

    Members of a planted cluster share a per-cluster count profile (small
    counts common, hot edges rare), with ``noise_prob`` of positions
    re-rolled per row, so planted weighted Jaccard stays high within a
    cluster.  A count of 0 never occurs: membership implies a hit."""
    rng = np.random.default_rng(seed)
    items = np.asarray(items)
    labels = np.asarray(labels)
    uniq, inv = np.unique(labels, return_inverse=True)
    base = np.minimum(
        1 + rng.geometric(0.45, size=(uniq.size, items.shape[1])) - 1,
        int(max_weight)).astype(np.uint32)
    base = np.maximum(base, np.uint32(1))
    w = base[inv].copy()
    noise = rng.random(w.shape) < noise_prob
    w[noise] = rng.integers(1, int(max_weight) + 1,
                            size=int(noise.sum())).astype(np.uint32)
    return w
