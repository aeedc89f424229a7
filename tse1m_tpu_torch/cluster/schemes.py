"""Signature-scheme registry: the dispatch point for signature kernels.

The three schemes of the JAX package, with the same constant streams, so
one parameter set gives the same signatures in both:

- ``kminhash``: the K-permutation multiply-add family (kernels/minhash.py).
- ``cminhash``: one permutation, a per-bin minimum (kernels/cminhash.py),
  then densification and the circulant fallback.
- ``weighted``: the cminhash kernel over replica-expanded rows
  (``expand_weighted``, host numpy): plain Jaccard of the replica sets is
  the weighted Jaccard of the clipped integer hit counts.  Its constants
  come from a stream of their own.

Hash constants are the only parameters of this system: they play the part
that weights play in a model.  ``params_from_numpy`` carries the JAX
package's ``HashParams.arrays`` into this package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import as_u32_numpy, u32_tensor
from .host import host_cminhash_signatures, host_signatures
from .kernels.cminhash import cminhash_and_keys
from .kernels.minhash import (combine_bytes, minhash_and_keys,
                              minhash_and_keys_packed)
from .minhash import make_hash_params

SCHEMES = ("kminhash", "cminhash", "weighted")

# Densification schedule length (cminhash): donor rounds.
_T_DENSIFY = 12
# Constant streams of the one-permutation schemes.
_STREAMS = {"cminhash": 0xC31F, "weighted": 0x3E16}

# Weighted expansion: hit counts clip to [1, MAX_WEIGHT]; replica r of id x
# is x * _REPLICA_MULT + r (mod 2^32).
MAX_WEIGHT = 8
_REPLICA_MULT = np.uint32(0x85EBCA6B)


@dataclass(frozen=True)
class HashParams:
    """One scheme's hash constants, derived from (scheme, n_hashes, seed).

    ``arrays``: (a, b), [H] int32 tensors carrying uint32 bits, for
    kminhash; (a0, b0, jmap, offs) for cminhash and weighted: [1] int32 a0
    and b0, [T, H] int64 donor maps, [H] int32 circulant offsets."""

    scheme: str
    n_hashes: int
    arrays: tuple

    def to(self, device: str | torch.device) -> "HashParams":
        """The same params with the arrays on ``device`` (once per run)."""
        return HashParams(self.scheme, self.n_hashes,
                          tuple(t.to(device) for t in self.arrays))  # graftlint: disable=wire-layer -- the scheme's hash constants (KiB) go to the device once a run; JAX's hp.device() stages them through jnp.asarray, unseen by the rule


def get_scheme(name: str) -> str:
    if name not in SCHEMES:
        raise ValueError(
            f"unknown signature scheme {name!r}; valid schemes: "
            f"{', '.join(SCHEMES)}")
    return name


def _one_perm_consts(n_hashes: int, seed: int, stream: int) -> tuple:
    """(a0, b0, jmap, offs) numpy constants of the one-permutation kernel:
    the JAX package's stream.  The donor maps are permutations, one a
    round, so every bin stays reachable."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, stream])
    a0 = np.array([int(rng.integers(1, 1 << 32)) | 1], np.uint32)
    b0 = np.array([int(rng.integers(0, 1 << 32))], np.uint32)
    jmap = np.stack([rng.permutation(n_hashes)
                     for _ in range(_T_DENSIFY)]).astype(np.int32)
    k = np.arange(n_hashes, dtype=np.uint64)
    cf = np.uint64(int(rng.integers(1, 1 << 32)) | 1)
    df = np.uint64(int(rng.integers(0, 1 << 32)))
    offs = ((cf * (k + np.uint64(1)) + df)
            & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (a0, b0, jmap, offs)


def params_from_numpy(scheme: str, n_hashes: int, arrays) -> HashParams:
    """HashParams from numpy constants, e.g. the JAX package's
    ``HashParams.arrays``: uint32 values as int32 bits, donor maps as
    int64 indices."""
    get_scheme(scheme)
    if scheme == "kminhash":
        return HashParams(scheme, n_hashes,
                          tuple(u32_tensor(x) for x in arrays))
    a0, b0, jmap, offs = arrays
    return HashParams(scheme, n_hashes, (
        u32_tensor(np.reshape(a0, 1)), u32_tensor(np.reshape(b0, 1)),
        torch.from_numpy(np.asarray(jmap, np.int64)), u32_tensor(offs)))


def make_params(scheme: str, n_hashes: int, seed: int = 0) -> HashParams:
    """Resolve a scheme's hash constants on the CPU (``.to`` moves them)."""
    get_scheme(scheme)
    if scheme == "kminhash":
        arrays = make_hash_params(n_hashes, seed)
    else:
        arrays = _one_perm_consts(n_hashes, seed, _STREAMS[scheme])
    return params_from_numpy(scheme, n_hashes, arrays)


def scheme_sig_and_keys(items: torch.Tensor, hp: HashParams, n_bands: int):
    """[N, S] int32 ids -> ([N, H] signatures, [N, B] band keys)."""
    if hp.scheme == "kminhash":
        return minhash_and_keys(items, *hp.arrays, n_bands)
    return cminhash_and_keys(items, *hp.arrays, n_bands)


def scheme_sig_and_keys_packed(payload: torch.Tensor, shape: tuple, k: int,
                               offset: int, hp: HashParams, n_bands: int):
    """``scheme_sig_and_keys`` over a byte-packed wire chunk.  kminhash
    has its fused-unpack kernel; the one-permutation schemes decode on the
    device first (``combine_bytes``), then hash, as in the JAX package."""
    if hp.scheme == "kminhash":
        return minhash_and_keys_packed(payload, shape, k, offset, *hp.arrays,
                                       n_bands)
    return cminhash_and_keys(combine_bytes(payload, shape, k, offset),
                             *hp.arrays, n_bands)


def scheme_host_signatures(items: np.ndarray, hp: HashParams) -> np.ndarray:
    """Numpy [N, S] -> [N, H] uint32 on the host, bit-identical to the
    kernels for the same scheme (the host oracle's signatures)."""
    if hp.scheme == "kminhash":
        return host_signatures(items, *(as_u32_numpy(t) for t in hp.arrays))
    a0, b0, jmap, offs = hp.arrays
    return host_cminhash_signatures(items, as_u32_numpy(a0),
                                    # graftlint: disable=wire-layer -- the host oracle reads the scheme's bin map (KiB) back from wherever the params live; JAX's np.asarray does it implicitly
                                    as_u32_numpy(b0), jmap.cpu().numpy(),
                                    as_u32_numpy(offs))


def expand_weighted(items: np.ndarray, weights: np.ndarray,
                    max_weight: int = MAX_WEIGHT) -> np.ndarray:
    """[N, S] ids + [N, S] integer hit counts -> [N, S'] replica ids (host
    numpy; a copy of the JAX package's).

    Id x with (clipped) weight w contributes replicas ``x * _REPLICA_MULT +
    r`` for r in [0, w).  Rows pad to the batch's widest expansion with
    their own first replica (weight >= 1, so the pad is a real member and
    never moves a minimum)."""
    items = np.ascontiguousarray(items, dtype=np.uint32)
    n, s = items.shape
    if n == 0:
        return np.empty((0, s), np.uint32)
    w = np.clip(weights, 1, int(max_weight)).astype(np.int64)
    totals = w.sum(axis=1)
    width = int(totals.max())
    reps = w.ravel()
    with np.errstate(over="ignore"):
        flat_ids = np.repeat(items.ravel(), reps)
        idx = np.arange(int(reps.sum()), dtype=np.int64)
        starts = np.repeat(np.cumsum(reps) - reps, reps)
        r = (idx - starts).astype(np.uint32)
        rep_ids = flat_ids * _REPLICA_MULT + r
        out = np.empty((n, width), np.uint32)
        out[:] = items[:, :1] * _REPLICA_MULT  # pad: own first replica
    row_starts = np.repeat(np.cumsum(totals) - totals, totals)
    row_of = np.repeat(np.arange(n, dtype=np.int64), totals)
    out[row_of, idx - row_starts] = rep_ids
    return out


__all__ = ["HashParams", "MAX_WEIGHT", "SCHEMES", "expand_weighted",
           "get_scheme", "make_params", "params_from_numpy",
           "scheme_host_signatures", "scheme_sig_and_keys",
           "scheme_sig_and_keys_packed"]
