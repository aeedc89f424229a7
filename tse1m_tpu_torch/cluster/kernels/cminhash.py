"""One-permutation (C-MinHash) bin-min kernel: wrapper and plain version.

Ports the TPU kernel of ``tse1m_tpu/cluster/minhash_pallas.py``:

- ``cminhash_binmin`` <- ``_cminhash_binmin_pallas``
  (``_cminhash_binmin_kernel``): [N, S] ids -> ([N, H] per-bin minima of
  the one permutation, UMAX = empty; [N] row minima).  One CUDA kernel
  (``csrc/cminhash.cu``).
- ``cminhash_binmin_plain``: the same in int64 torch ops
  (``cluster/minhash.py``).

``cminhash_and_keys`` runs the bin-min, then the densification and the
band fold as torch ops on the same device, as the JAX package runs them as
jnp outside its Pallas kernel: they are O(N*H) gathers, and the kernel's
output is what is held against the Pallas kernel.  It carries both the
``cminhash`` and the ``weighted`` scheme (the latter over replica-expanded
rows).

The wrapper given CUDA tensors launches the kernel on the current stream
(it checks device, dtype, shape and contiguity, allocates the outputs and
never synchronises) or raises; given CPU tensors it runs the plain version.
``cminhash_binmin.launches`` counts its kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from ..minhash import (band_keys, cminhash_binmin_plain, cminhash_densify,
                       cminhash_signatures)
from ._build import MAX_SMEM, load_extension
from ._count import count_launch

# csrc/cminhash.cu: one warp a row, kRowsPerBlock rows' bins in shared
# memory.
_ROWS_PER_BLOCK = 8


def _check(items: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor,
           n_hashes: int) -> None:
    if items.dtype != torch.int32 or items.dim() != 2:
        raise ValueError(f"items must be a 2-D int32 tensor, got "
                         f"{items.dtype} {tuple(items.shape)}")
    if items.shape[1] < 1:
        raise ValueError("items need at least one id a row")
    for name, t in (("a0", a0), ("b0", b0)):
        if t.dtype != torch.int32 or t.shape != (1,):
            raise ValueError(f"{name} must be a [1] int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != items.device:
            raise ValueError(f"{name} is on {t.device}, ids on "
                             f"{items.device}")
    if n_hashes < 1:
        raise ValueError(f"n_hashes must be >= 1, got {n_hashes}")
    if items.device.type == "cuda":
        if not items.is_contiguous():
            raise ValueError("items must be contiguous")
        if 4 * _ROWS_PER_BLOCK * n_hashes > MAX_SMEM:
            raise ValueError(f"H={n_hashes} needs more than {MAX_SMEM} "
                             "bytes of shared memory a block")
    elif items.device.type != "cpu":
        raise ValueError(f"unsupported device {items.device}")


def cminhash_binmin(items: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor,
                    n_hashes: int):
    """[N, S] int32 ids, [1] int32 a0 and b0 -> ([N, H] bin minima, [N] row
    minima), all int32 carrying uint32 bits."""
    _check(items, a0, b0, n_hashes)
    if items.device.type == "cpu":
        return cminhash_binmin_plain(items, a0, b0, n_hashes)
    n = items.shape[0]
    binmin = torch.empty((n, n_hashes), dtype=torch.int32,
                         device=items.device)
    rowmin = torch.empty(n, dtype=torch.int32, device=items.device)
    if n:
        load_extension().cminhash_binmin(items, a0, b0, binmin, rowmin)
        count_launch(cminhash_binmin)
    return binmin, rowmin


cminhash_binmin.launches = 0


def cminhash_and_keys(items: torch.Tensor, a0: torch.Tensor,
                      b0: torch.Tensor, jmap: torch.Tensor,
                      offs: torch.Tensor, n_bands: int):
    """[N, S] int32 ids -> ([N, H] signatures, [N, B] band keys) under the
    one-permutation schemes: the bin-min kernel, then densification and
    the band fold.  ``jmap``: [T, H] int64 donor maps, ``offs``: [H] int32."""
    h = offs.shape[0]
    if jmap.dim() != 2 or jmap.shape[1] != h or n_bands < 1 or h % n_bands:
        raise ValueError(f"need jmap [T, H] and H divisible by n_bands; got "
                         f"jmap {tuple(jmap.shape)}, H={h}, B={n_bands}")
    binmin, rowmin = cminhash_binmin(items, a0, b0, h)
    sig = cminhash_densify(binmin, rowmin, jmap, offs)
    return sig, band_keys(sig, n_bands)


def cminhash_and_keys_plain(items: torch.Tensor, a0: torch.Tensor,
                            b0: torch.Tensor, jmap: torch.Tensor,
                            offs: torch.Tensor, n_bands: int):
    """Plain version of ``cminhash_and_keys``: signatures, then band keys."""
    sig = cminhash_signatures(items, a0, b0, jmap, offs)
    return sig, band_keys(sig, n_bands)


__all__ = ["cminhash_and_keys", "cminhash_and_keys_plain", "cminhash_binmin",
           "cminhash_binmin_plain"]
