"""Host one-permutation b-bit LSH prefilter (wire v3's first lever).

A copy of ``tse1m_tpu/cluster/prefilter.py``.  A row that shares no
near-duplicate with any other row labels itself under the pipeline's
signature-agreement rule, so it never needs to cross the link.  Deciding
which rows can possibly collide is much cheaper than MinHash proper: hash
every element once (the "permutation"), then for each of
``N_BANDS * HASHES_PER_BAND`` multiplicative mixes take the lowest
``KEY_BITS`` bits of the row minimum (b-bit minwise hashing,
arXiv:1205.2958; one permutation as in C-MinHash, arXiv:2109.03337); a band
key packs ``HASHES_PER_BAND`` remnants into 32 bits.  A row that shares no
band key with any other row is dropped from the device batch.

The filter buckets the raw ids even when the wire quantizes: in a small
universe the buckets are dense, while raw-space isolation still implies no
verifiable device edge.

Labels must equal the unfiltered run's element for element.  A false keep
costs only wire; a false drop could split a cluster, so the bands are sized
for the regime the verifier accepts (est >= threshold ~ 0.5): a colliding
pair at Jaccard J is missed with probability ~(1 - J^2)^20.  With
threshold <= 0 the pipeline never filters (every proposed edge is accepted
and isolation proves nothing).

Host numpy only, as in the JAX package: the pipeline alone moves bytes.
"""

from __future__ import annotations

import numpy as np

from .schemes import get_scheme

N_BANDS = 20          # prefilter bands (keys per row)
HASHES_PER_BAND = 2   # b-bit minwise values packed per band key
KEY_BITS = 16         # b-bit minwise remnant per hash

# The one-permutation pass: a fixed odd multiply-add bijection over uint32,
# then per-hash odd multiplicative mixes.
_PERM_MULT = np.uint32(0x9E3779B1)
_PERM_ADD = np.uint32(0x7F4A7C15)
_ROW_CHUNK = 1 << 16  # bounds the [chunk, S] temporaries


def _mix_consts(seed: int, k: int) -> np.ndarray:
    """k odd uint32 multipliers, deterministic per seed; offset from the
    MinHash family's stream so the two stay independent."""
    rng = np.random.default_rng(seed ^ 0x5EEDB177)
    return (rng.integers(1, 1 << 32, size=k, dtype=np.uint32)
            | np.uint32(1))


def band_keys_host(items: np.ndarray, seed: int = 0) -> np.ndarray:
    """[N, S] uint32 feature sets -> [N, N_BANDS] uint32 band keys.

    One element-hash pass and K multiplicative mixes; each mix's row
    minimum gives its lowest ``KEY_BITS`` bits (the uniform part of a
    minimum that concentrates near 0), ``HASHES_PER_BAND`` of them packed
    into one 32-bit band key."""
    items = np.ascontiguousarray(items, dtype=np.uint32)
    n = items.shape[0]
    consts = _mix_consts(seed, N_BANDS * HASHES_PER_BAND)
    keys = np.zeros((n, N_BANDS), np.uint32)
    mask = np.uint32((1 << KEY_BITS) - 1)
    with np.errstate(over="ignore"):
        for lo in range(0, n, _ROW_CHUNK):
            blk = items[lo:lo + _ROW_CHUNK]
            perm = blk * _PERM_MULT + _PERM_ADD     # the one permutation
            for j in range(N_BANDS):
                key = np.zeros(blk.shape[0], np.uint32)
                for t in range(HASHES_PER_BAND):
                    c = consts[j * HASHES_PER_BAND + t]
                    mins = (perm * c).min(axis=1)
                    key = (key << np.uint32(KEY_BITS)) | (mins & mask)
                keys[lo:lo + _ROW_CHUNK, j] = key
    return keys


def collide_mask(items: np.ndarray, seed: int = 0,
                 scheme: str = "kminhash") -> np.ndarray:
    """[N] bool: True for rows sharing at least one band bucket with
    another row (the rows that can possibly collide on the device).  Rows
    with False are bucketed singleton in every band and skip the wire.

    ``scheme`` names the run's signature family and is validated here, as
    in the JAX package.  The mask is one for every scheme: each estimates
    plain Jaccard of the rows it is given, and ``weighted`` rows arrive
    replica-expanded, so isolation in replica space is weighted-Jaccard
    isolation."""
    get_scheme(scheme)
    n = items.shape[0]
    collide = np.zeros(n, bool)
    if n < 2:
        return collide
    keys = band_keys_host(items, seed)
    for j in range(N_BANDS):
        k = keys[:, j]
        uniq, counts = np.unique(k, return_counts=True)
        collide |= counts[np.searchsorted(uniq, k)] > 1
        if collide.all():
            break
    return collide


def prefilter_recall(keep: np.ndarray, truth: np.ndarray) -> float:
    """Self-check against planted truth: the fraction of rows of
    multi-member planted clusters that the filter kept (1.0 = no planted
    near-duplicate was dropped)."""
    truth = np.asarray(truth)
    uniq, counts = np.unique(truth, return_counts=True)
    multi = counts[np.searchsorted(uniq, truth)] > 1
    denom = int(multi.sum())
    if denom == 0:
        return 1.0
    return float(np.asarray(keep, bool)[multi].sum() / denom)
