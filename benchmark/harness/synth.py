"""The session generator: planted near-duplicate coverage sets (numpy).

A copy of the study's ``synth_session_sets`` generator, kept here so that
the benchmark's traffic does not move when the program changes: the same
parameters and seed give the same sessions.
"""

from __future__ import annotations

import numpy as np


def synth_session_sets(n_sessions: int, set_size: int = 64,
                       universe: int = 1 << 24, dup_fraction: float = 0.6,
                       mean_cluster_size: float = 8.0,
                       mutate_prob: float = 0.05, seed=0) -> tuple:
    """(items [N, set_size] uint32, planted labels [N] int64).

    ``dup_fraction`` of the sessions belong to planted clusters whose
    members share a base set with about ``mutate_prob`` of its ids
    replaced; the rest are singletons.  Rows come in a random order.
    ``seed``: an int or a sequence of ints (numpy's seed sequence)."""
    rng = np.random.default_rng(seed)
    n_dup = int(n_sessions * dup_fraction)
    n_clusters = max(1, int(n_dup / mean_cluster_size))

    labels = np.empty(n_sessions, dtype=np.int64)
    labels[:n_dup] = rng.integers(0, n_clusters, size=n_dup)
    labels[n_dup:] = np.arange(n_clusters, n_clusters + (n_sessions - n_dup))

    base = rng.integers(0, universe, size=(n_clusters, set_size),
                        dtype=np.uint32)
    items = np.empty((n_sessions, set_size), dtype=np.uint32)
    items[:n_dup] = base[labels[:n_dup]]
    items[n_dup:] = rng.integers(0, universe,
                                 size=(n_sessions - n_dup, set_size),
                                 dtype=np.uint32)

    mutate = rng.random((n_dup, set_size)) < mutate_prob
    items[:n_dup][mutate] = rng.integers(0, universe, size=int(mutate.sum()),
                                         dtype=np.uint32)

    perm = rng.permutation(n_sessions)
    return items[perm], labels[perm]


def corpus(config: dict, seed: int, index: int = 0) -> np.ndarray:
    """Corpus ``index`` of a run seeded ``seed``: [N, S] uint32 sessions of
    the configuration's sizes.  Every corpus of every seed has the same
    sizes; the seed changes only which ids they hold."""
    gen = config["generator"]
    items, _ = synth_session_sets(
        config["n_sessions"], config["set_size"], config["universe"],
        gen["dup_fraction"], gen["mean_cluster_size"], gen["mutate_prob"],
        seed=[int(seed), int(index)])
    return items
