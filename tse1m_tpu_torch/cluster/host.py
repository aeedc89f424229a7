"""Numpy host oracle of the clustering pipeline: a copy of
``tse1m_tpu/cluster/host.py``.

The same hash constants as the device path (``schemes.make_params``), so
signatures and band keys are bit-identical to the kernels', then a
union-find over verified bucket edges instead of label propagation.  The
warm merge folds the band keys of a short novel tail here
(``host_band_keys``), where the union run folds them on the card
(``minhash.band_keys``): the two must agree bit for bit, or merge and
union would give different labels.  ``host_cluster`` is the command
line's ``ari_vs_host_sample`` oracle.
"""

from __future__ import annotations

import numpy as np

from .minhash import _FNV_OFFSET, _FNV_PRIME

_UMAX = np.uint32(0xFFFFFFFF)


def host_signatures(items: np.ndarray, a: np.ndarray, b: np.ndarray,
                    chunk: int = 1024) -> np.ndarray:
    """[N, S] uint32 -> [N, H] uint32 kminhash signatures, identical to
    the kernel's: ``min_s (a * x + b) mod 2^32``.

    A running minimum over the S columns on [chunk, H] blocks that stay in
    cache, where the JAX package's copy materialises [chunk, S, H]; the
    serving plane signs here every query row a shard does not hold."""
    items = np.ascontiguousarray(items, dtype=np.uint32)
    a = np.ascontiguousarray(a, dtype=np.uint32)
    b = np.ascontiguousarray(b, dtype=np.uint32)
    n, s = items.shape
    h = a.shape[0]
    sig = np.empty((n, h), dtype=np.uint32)
    tmp = np.empty((min(chunk, n), h), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for lo in range(0, n, chunk):
            blk = items[lo:lo + chunk]  # [bn, S]
            acc = sig[lo:lo + chunk]
            t = tmp[:blk.shape[0]]
            np.multiply(blk[:, :1], a, out=acc)
            np.add(acc, b, out=acc)
            for j in range(1, s):
                np.multiply(blk[:, j:j + 1], a, out=t)
                np.add(t, b, out=t)
                np.minimum(acc, t, out=acc)
    return sig


def host_cminhash_signatures(items: np.ndarray, a0, b0, jmap: np.ndarray,
                             offs: np.ndarray,
                             chunk: int = 65536) -> np.ndarray:
    """[N, S] uint32 -> [N, H] uint32 one-permutation signatures,
    identical to ``minhash.cminhash_signatures``: one permutation pass,
    the bin-by-modulo minimum, the same densification schedule and the
    same circulant fallback, all in uint32 with wraparound."""
    items = np.ascontiguousarray(items, dtype=np.uint32)
    n, s = items.shape
    h = int(offs.shape[0])
    t_rounds = int(jmap.shape[0])
    out = np.empty((n, h), dtype=np.uint32)
    with np.errstate(over="ignore"):
        for lo in range(0, n, chunk):
            blk = items[lo:lo + chunk]
            bn = blk.shape[0]
            u = blk * a0 + b0
            bins = (u % np.uint32(h)).astype(np.intp)
            v = np.full((bn, h), _UMAX, dtype=np.uint32)
            rows = np.repeat(np.arange(bn, dtype=np.intp), blk.shape[1])
            np.minimum.at(v, (rows, bins.ravel()), u.ravel())
            for t in range(t_rounds):
                cand = v[:, jmap[t]]
                v = np.where((v == _UMAX) & (cand != _UMAX), cand, v)
            fb = u.min(axis=1)[:, None] + offs[None, :]
            out[lo:lo + chunk] = np.where(v == _UMAX, fb, v)
    return out


def host_band_keys(sig: np.ndarray, n_bands: int) -> np.ndarray:
    """[N, H] uint32 signatures -> [N, B] uint32 band keys, bit-identical
    to ``minhash.band_keys``: band k folds rows {k, k+B, k+2B, ...}."""
    n, h = sig.shape
    r = h // n_bands
    chunks = sig.reshape(n, r, n_bands)
    keys = np.broadcast_to(
        _FNV_OFFSET + np.arange(n_bands, dtype=np.uint32)[None, :],
        (n, n_bands)).copy()
    with np.errstate(over="ignore"):
        for j in range(r):
            keys = (keys ^ chunks[:, j, :]) * _FNV_PRIME
    return keys


class _UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        root = x
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, x: int, y: int) -> None:
        rx, ry = self.find(x), self.find(y)
        if rx != ry:
            if rx < ry:
                self.parent[ry] = rx
            else:
                self.parent[rx] = ry


def host_cluster(items: np.ndarray, n_hashes: int = 128, n_bands: int = 16,
                 threshold: float = 0.5, seed: int = 0,
                 scheme: str = "kminhash") -> np.ndarray:
    """End-to-end host clustering; returns [N] int64 min-index labels.

    ``scheme`` picks the signature family (``cluster/schemes.py``); for
    ``weighted`` the caller feeds the replica-expanded rows."""
    from .schemes import make_params, scheme_host_signatures

    sig = scheme_host_signatures(items, make_params(scheme, n_hashes, seed))
    keys = host_band_keys(sig, n_bands)
    n = items.shape[0]
    uf = _UnionFind(n)
    min_agree = threshold * n_hashes
    for band in range(n_bands):
        order = np.argsort(keys[:, band], kind="stable")
        ks = keys[order, band]
        boundaries = np.flatnonzero(np.concatenate(
            [[True], ks[1:] != ks[:-1], [True]]))
        for i in range(len(boundaries) - 1):
            lo, hi = boundaries[i], boundaries[i + 1]
            if hi - lo < 2:
                continue
            members = order[lo:hi]
            rep = members.min()
            for m in members:
                if m != rep and (sig[m] == sig[rep]).sum() >= min_agree:
                    uf.union(int(m), int(rep))
    return np.array([uf.find(i) for i in range(n)], dtype=np.int64)
