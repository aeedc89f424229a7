"""Clustering quality metrics (host-side, numpy).

Adjusted Rand index from the pair-counting contingency form, sparse via
unique pair codes: O(N log N), fine for 1M labels.  A copy of
``tse1m_tpu/cluster/metrics.py``.
"""

from __future__ import annotations

import numpy as np


def _comb2(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float64)
    return x * (x - 1.0) / 2.0


def adjusted_rand_index(labels_a, labels_b) -> float:
    a = np.asarray(labels_a).ravel()
    b = np.asarray(labels_b).ravel()
    if a.shape != b.shape:
        raise ValueError(f"label shapes differ: {a.shape} vs {b.shape}")
    n = a.size
    if n < 2:
        return 1.0
    _, ai = np.unique(a, return_inverse=True)
    _, bi = np.unique(b, return_inverse=True)
    nb = int(bi.max()) + 1
    codes = ai.astype(np.int64) * nb + bi
    _, pair_counts = np.unique(codes, return_counts=True)
    _, a_counts = np.unique(ai, return_counts=True)
    _, b_counts = np.unique(bi, return_counts=True)

    sum_pairs = _comb2(pair_counts).sum()
    sum_a = _comb2(a_counts).sum()
    sum_b = _comb2(b_counts).sum()
    total = _comb2(np.array([n]))[0]

    expected = sum_a * sum_b / total
    max_index = (sum_a + sum_b) / 2.0
    if max_index == expected:
        return 1.0
    return float((sum_pairs - expected) / (max_index - expected))
