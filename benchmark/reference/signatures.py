"""MinHash signatures and LSH band keys from their definitions.

All values are uint32 quantities held in int64 tensors in [0, 2^32).

- K-permutation MinHash: ``h_i(x) = a_i * x + b_i (mod 2^32)``, ``a_i``
  odd; a session's signature is the per-hash minimum over its ids.
- C-MinHash (one permutation): ``u = a0 * x + b0 (mod 2^32)`` lands in bin
  ``u mod H``, which keeps its minimum (2^32 - 1 marks an empty bin).  Each
  of ``DENSIFY_ROUNDS`` donor maps in turn fills an empty bin from its
  donor when that one is full; a bin still empty takes ``rowmin(u) +
  offs[k] (mod 2^32)``.
- Band keys: band k folds signature rows {k, k + B, k + 2B, ...}: the key
  starts at ``FNV_OFFSET + k`` and each row folds in as
  ``key = (key ^ sig) * FNV_PRIME (mod 2^32)``.

The constants are drawn from numpy's generator as the study's hash policy
defines them: (a, b) from ``default_rng(seed)``; the one-permutation
constants from ``default_rng([seed mod 2^32, 0xC31F])`` in the order a0,
b0, the donor maps, then the circulant multiplier and offset.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
EMPTY = 0xFFFFFFFF
FNV_PRIME = 16777619
FNV_OFFSET = 2166136261
DENSIFY_ROUNDS = 12
CMINHASH_STREAM = 0xC31F
# Rows a block of the signature loops holds at once.
BLOCK_ROWS = 1 << 17


def kminhash_constants(n_hashes: int, seed: int) -> tuple:
    """(a, b): [H] numpy uint32 multipliers (odd) and offsets."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 1 << 32, size=n_hashes, dtype=np.uint32) | np.uint32(1)
    b = rng.integers(0, 1 << 32, size=n_hashes, dtype=np.uint32)
    return a, b


def cminhash_constants(n_hashes: int, seed: int) -> tuple:
    """(a0, b0, jmap, offs): python ints a0 (odd) and b0, [T, H] int64
    donor maps (a permutation a round), [H] int64 circulant offsets."""
    rng = np.random.default_rng([int(seed) & MASK, CMINHASH_STREAM])
    a0 = int(rng.integers(1, 1 << 32)) | 1
    b0 = int(rng.integers(0, 1 << 32))
    jmap = np.stack([rng.permutation(n_hashes)
                     for _ in range(DENSIFY_ROUNDS)]).astype(np.int64)
    cf = int(rng.integers(1, 1 << 32)) | 1
    df = int(rng.integers(0, 1 << 32))
    offs = (cf * (np.arange(n_hashes, dtype=np.int64) + 1) + df) & MASK
    return a0, b0, jmap, offs


def mulmod32(x: torch.Tensor, a) -> torch.Tensor:
    """(x * a) mod 2^32 for int64 x and a in [0, 2^32), without overflow:
    a is split into 16-bit halves and the high partial product is cut to
    16 bits before it is shifted."""
    lo = x * (a & 0xFFFF)
    hi = ((x * (a >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def as_values(items, device) -> torch.Tensor:
    """uint32 numpy ids -> int64 values on ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(items, np.uint32).view(np.int32))
    return t.to(device).to(torch.int64) & MASK


def kminhash(items: np.ndarray, n_hashes: int, seed: int,
             device) -> torch.Tensor:
    """[N, S] uint32 ids -> [N, H] int64 signatures on ``device``."""
    a, b = kminhash_constants(n_hashes, seed)
    a = torch.from_numpy(a.astype(np.int64)).to(device)
    b = torch.from_numpy(b.astype(np.int64)).to(device)
    out = torch.empty((items.shape[0], n_hashes), dtype=torch.int64,
                      device=device)
    for lo in range(0, items.shape[0], BLOCK_ROWS):
        x = as_values(items[lo:lo + BLOCK_ROWS], device)
        acc = torch.full((x.shape[0], n_hashes), EMPTY, dtype=torch.int64,
                         device=device)
        for s in range(x.shape[1]):
            h = (mulmod32(x[:, s:s + 1], a) + b) & MASK
            acc = torch.minimum(acc, h)
        out[lo:lo + x.shape[0]] = acc
    return out


def cminhash(items: np.ndarray, n_hashes: int, seed: int,
             device) -> torch.Tensor:
    """[N, S] uint32 ids -> [N, H] int64 one-permutation signatures."""
    a0, b0, jmap, offs = cminhash_constants(n_hashes, seed)
    jmap = torch.from_numpy(jmap).to(device)
    offs = torch.from_numpy(offs).to(device)
    out = torch.empty((items.shape[0], n_hashes), dtype=torch.int64,
                      device=device)
    for lo in range(0, items.shape[0], BLOCK_ROWS):
        x = as_values(items[lo:lo + BLOCK_ROWS], device)
        u = (mulmod32(x, a0) + b0) & MASK
        v = torch.full((x.shape[0], n_hashes), EMPTY, dtype=torch.int64,
                       device=device)
        v.scatter_reduce_(1, u % n_hashes, u, "amin")
        for t in range(jmap.shape[0]):
            donor = v[:, jmap[t]]
            v = torch.where((v == EMPTY) & (donor != EMPTY), donor, v)
        fallback = (u.amin(1, keepdim=True) + offs) & MASK
        out[lo:lo + x.shape[0]] = torch.where(v == EMPTY, fallback, v)
    return out


SCHEMES = {"kminhash": kminhash, "cminhash": cminhash}


def signatures(items: np.ndarray, scheme: str, n_hashes: int, seed: int,
               device) -> torch.Tensor:
    return SCHEMES[scheme](items, n_hashes, seed, device)


def band_keys(sig: torch.Tensor, n_bands: int) -> torch.Tensor:
    """[N, H] int64 signatures -> [N, B] int64 band keys."""
    n, h = sig.shape
    keys = (FNV_OFFSET + torch.arange(n_bands, dtype=torch.int64,
                                      device=sig.device)).repeat(n, 1)
    for j in range(h // n_bands):
        keys = ((keys ^ sig[:, j * n_bands:(j + 1) * n_bands])
                * FNV_PRIME) & MASK
    return keys
