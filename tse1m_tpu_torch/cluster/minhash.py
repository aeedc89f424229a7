"""MinHash signatures and banded LSH keys, plain PyTorch.

Two signature families, as in the JAX package:

- **kminhash**: K independent multiply-add hashes over uint32 with natural
  wraparound, ``h_i(x) = a_i * x + b_i (mod 2^32)`` with odd ``a_i``; a
  row's signature is the per-hash minimum over its ids.
- **cminhash** (also ``weighted``, over replica-expanded rows): one
  permutation ``u = a0 * x + b0 (mod 2^32)``; each permuted value lands in
  bin ``u mod H`` and the bin keeps its minimum (``UMAX`` = empty).  Empty
  bins densify over a fixed schedule of donor maps, and any bin still
  empty takes the circulant value ``rowmin(u) + offs[k]``.

Band keys fold each band's signature rows with an FNV-1a-style mix salted
by the band index.  Bands are interleaved: band k folds signature rows
{k, k+B, k+2B, ...}.

These are the plain versions the CUDA kernels in kernels/ are held
against.  They compute in int64 (see ``tse1m_tpu_torch.device``): a product
of two uint32 values can reach 2^64, so the multiplier is split into 16-bit
halves and each partial product masked before it is shifted.  The hash
constants come from the same numpy stream as the JAX package's, so both
give the same signatures bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import U32_MASK, narrow, widen

UMAX = np.uint32(0xFFFFFFFF)
# FNV-1a-style mixing constants for band keys.
_FNV_PRIME = np.uint32(16777619)
_FNV_OFFSET = np.uint32(2166136261)
# Elements of int64 a block of ``minhash_signatures`` holds at once.
_BLOCK_ELEMS = 1 << 22


def make_hash_params(n_hashes: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic (a, b) numpy uint32 hash parameters, a forced odd."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 1 << 32, size=n_hashes, dtype=np.uint32) | np.uint32(1)
    b = rng.integers(0, 1 << 32, size=n_hashes, dtype=np.uint32)
    return a, b


def mul_u32(x: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """(x * a) mod 2^32 for int64 operands in [0, 2^32), every intermediate
    below 2^49: x*a_lo + ((x*a_hi mod 2^16) << 16)."""
    lo = x * (a & 0xFFFF)
    hi = ((x * (a >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32_MASK


def minhash_signatures(items: torch.Tensor, a: torch.Tensor,
                       b: torch.Tensor) -> torch.Tensor:
    """[N, S] int32 ids -> [N, H] int32 signatures (uint32 bits).

    sig[n, h] = min_s (a[h] * items[n, s] + b[h]) mod 2^32.  The set
    dimension goes in blocks of about ``_BLOCK_ELEMS / (N*H)`` columns:
    the peak stays O(N*H) at large N, and a small batch is a handful of
    ops (each op drops and retakes the GIL, which a busy thread beside it
    makes slow)."""
    x = widen(items)
    a64 = widen(a)
    b64 = widen(b)
    n, s = x.shape
    acc = torch.full((n, a64.shape[0]), int(UMAX), dtype=torch.int64,
                     device=x.device)
    step = max(1, _BLOCK_ELEMS // max(1, n * a64.shape[0]))
    for lo in range(0, s, step):
        h = (mul_u32(x[:, lo:lo + step, None], a64) + b64) & U32_MASK
        acc = torch.minimum(acc, h.amin(1) if step > 1 else h[:, 0])
    return narrow(acc)


def band_keys(sig: torch.Tensor, n_bands: int) -> torch.Tensor:
    """[N, H] int32 signatures -> [N, B] int32 LSH band keys (uint32 bits).

    key[n, k] starts at FNV_OFFSET + k; for each j < H/B,
    key = (key ^ sig[n, j*B + k]) * FNV_PRIME (mod 2^32)."""
    n, h = sig.shape
    if h % n_bands:
        raise ValueError(f"n_hashes {h} not divisible by n_bands {n_bands}")
    s64 = widen(sig)
    keys = (int(_FNV_OFFSET) + torch.arange(
        n_bands, dtype=torch.int64, device=sig.device)).expand(n, n_bands)
    for j in range(h // n_bands):
        keys = ((keys ^ s64[:, j * n_bands:(j + 1) * n_bands])
                * int(_FNV_PRIME)) & U32_MASK
    return narrow(keys)


def cminhash_binmin_plain(items: torch.Tensor, a0: torch.Tensor,
                          b0: torch.Tensor, n_hashes: int):
    """[N, S] int32 ids, [1] int32 a0 and b0 -> ([N, H] bin minima, [N] row
    minima), int32 carrying uint32 bits.

    u = (a0 * x + b0) mod 2^32, bin = u mod H (unsigned, any H); a bin no
    id reaches holds UMAX, as does a bin whose only value is a genuine UMAX.
    Widened to int64 first: int32 ``amin`` would be a signed min."""
    n = items.shape[0]
    u = (mul_u32(widen(items), widen(a0)) + widen(b0)) & U32_MASK
    binmin = torch.full((n, n_hashes), int(UMAX), dtype=torch.int64,
                        device=items.device)
    binmin.scatter_reduce_(1, u % n_hashes, u, "amin")
    return narrow(binmin), narrow(u.amin(1))


def cminhash_densify(v: torch.Tensor, rowmin: torch.Tensor,
                     jmap: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """Densification and circulant fallback over [N, H] bin minima (UMAX =
    empty; -1 as int32 bits): each donor round fills an empty bin from its
    donor ``jmap[t]`` when that one is full, chained round after round;
    bins still empty take ``rowmin + offs`` (mod 2^32)."""
    empty = -1  # UMAX as int32 bits
    for t in range(jmap.shape[0]):
        cand = v.index_select(1, jmap[t])
        v = torch.where((v == empty) & (cand != empty), cand, v)
    fb = narrow((widen(rowmin)[:, None] + widen(offs)[None, :]) & U32_MASK)
    return torch.where(v == empty, fb, v)


def cminhash_signatures(items: torch.Tensor, a0: torch.Tensor,
                        b0: torch.Tensor, jmap: torch.Tensor,
                        offs: torch.Tensor) -> torch.Tensor:
    """[N, S] int32 ids -> [N, H] int32 one-permutation signatures (uint32
    bits): bin minima, then densification.  ``jmap``: [T, H] int64 donor
    maps; ``offs``: [H] circulant offsets."""
    binmin, rowmin = cminhash_binmin_plain(items, a0, b0, offs.shape[0])
    return cminhash_densify(binmin, rowmin, jmap, offs)
