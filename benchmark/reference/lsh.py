"""Banded LSH clustering from its definition.

In each band the rows that share a key form a bucket, and the bucket's
hub is its lowest row index.  A row's edge to its hub in a band is kept
when the hub is another row and the fraction of signature rows on which
the two agree, a float32 count over H, is at least the threshold.  A
session's label is the lowest row index of its connected component in the
graph of kept edges (scipy's connected components, not a propagation).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from .signatures import band_keys, signatures

ROW_BITS = 31


def hubs(keys: torch.Tensor) -> torch.Tensor:
    """[N, B] int64 keys in [0, 2^32) -> [N, B] int64 hub row per band:
    each (key, row) pair is packed into one int64, so one sort orders a
    bucket's rows ascending and the first of each run is its hub."""
    n, n_bands = keys.shape
    rows = torch.arange(n, dtype=torch.int64, device=keys.device)
    pos = torch.arange(n, dtype=torch.int64, device=keys.device)
    out = torch.empty_like(keys)
    for j in range(n_bands):
        packed, _ = torch.sort((keys[:, j] << ROW_BITS) | rows)
        k_sorted = packed >> ROW_BITS
        r_sorted = packed & ((1 << ROW_BITS) - 1)
        starts = torch.ones(n, dtype=torch.bool, device=keys.device)
        starts[1:] = k_sorted[1:] != k_sorted[:-1]
        first = torch.cummax(torch.where(starts, pos, 0), 0).values
        out[r_sorted, j] = r_sorted[first]
    return out


def kept_edges(sig: torch.Tensor, hub: torch.Tensor,
               threshold: float) -> tuple:
    """(rows, hubs) int64 numpy arrays of every kept edge."""
    n, h = sig.shape
    rows = torch.arange(n, dtype=torch.int64, device=sig.device)
    src, dst = [], []
    for j in range(hub.shape[1]):
        agree = (sig[hub[:, j]] == sig).sum(1, dtype=torch.int32)
        est = agree.to(torch.float32) / float(h)
        keep = (est >= threshold) & (hub[:, j] != rows)
        src.append(rows[keep].cpu().numpy())
        dst.append(hub[keep, j].cpu().numpy())
    return np.concatenate(src), np.concatenate(dst)


def component_minima(n: int, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """[N] int64: the lowest row index of each row's connected component."""
    graph = coo_matrix((np.ones(src.shape[0], np.int8), (src, dst)),
                       shape=(n, n))
    _, comp = connected_components(graph, directed=False)
    low = np.full(comp.max() + 1, n, np.int64)
    np.minimum.at(low, comp, np.arange(n, dtype=np.int64))
    return low[comp]


def labels_from_signatures(sig: torch.Tensor, n_bands: int, threshold: float,
                           key_bits: int = 32) -> np.ndarray:
    """[N, H] int64 signatures -> [N] int64 labels.  ``key_bits`` below 32
    keeps only the keys' low bits (the control's narrower keys)."""
    keys = band_keys(sig, n_bands)
    if key_bits < 32:
        keys = keys & ((1 << key_bits) - 1)
    src, dst = kept_edges(sig, hubs(keys), threshold)
    return component_minima(sig.shape[0], src, dst)


def cluster_labels(items: np.ndarray, config: dict, seed: int, device,
                   key_bits: int = 32) -> np.ndarray:
    """A configuration's [N] labels of [N, S] uint32 sessions."""
    sig = signatures(items, config["scheme"], config["n_hashes"], seed,
                     device)
    return labels_from_signatures(sig, config["n_bands"],
                                  config["threshold"], key_bits)
