"""Fused MinHash + band-key kernels: wrappers and their plain versions.

Ports the TPU kernels of ``tse1m_tpu/cluster/minhash_pallas.py``:

- ``minhash_and_keys`` <- ``minhash_and_keys_pallas`` (``_kernel``): [N, S]
  ids -> ([N, H] signatures, [N, B] band keys) in one pass.
- ``minhash_and_keys_packed`` <- ``_minhash_packed_pallas``
  (``_kernel_packed``): the same over a wire chunk of k little-endian bytes
  per id plus the chunk's offset, so decoded ids never reach device memory.

Both run one CUDA template (``csrc/minhash.cu``).  A wrapper given CUDA
tensors launches its kernel on the current stream (it checks device,
dtype, shape and contiguity, allocates the outputs and never synchronises)
or raises; given CPU tensors it runs the plain PyTorch version beside it.
There is no other switch.  ``<wrapper>.launches`` counts the wrapper's
kernel launches and nothing else.

All values are int32 tensors carrying uint32 bits (``tse1m_tpu_torch.device``).
"""

from __future__ import annotations

import torch

from ...device import U32_MASK, narrow
from ..minhash import band_keys, minhash_signatures
from ._build import MAX_SMEM, load_extension
from ._count import count_launch

# Carve-up of a block's shared memory (csrc/minhash.cu minhash_smem).
_UNIT_ROWS = 8
_STAGES = 2
_WARPS = (4, 2, 1)


def _align16(v: int) -> int:
    return (v + 15) & ~15


def block_smem(s: int, h: int, k: int) -> tuple:
    """(warps a block, dynamic shared memory of a block in bytes) of the
    kernel at S ids a row, H hashes and k bytes an id in device memory (4
    for uint32 ids), as ``minhash_warps`` and ``minhash_smem`` in
    csrc/minhash.cu pick them: a and b, then per warp a ring of stages
    (each an mbarrier and its unit number, 16 bytes, and an 8-row unit's
    bytes from their 16-byte floor) and an id buffer of 8 rows of S
    rounded up to 4 (+4 where that is a multiple of 8).  The most warps of
    4, 2, 1 that fit in ``MAX_SMEM``; warps 0, and the bytes of 1, if none
    do."""
    s4 = -(-s // 4) * 4
    stride = s4 + (4 if s4 % 8 == 0 else 0)
    per_warp = (_STAGES * (16 + _align16(_UNIT_ROWS * s * k + 15))
                + 4 * _UNIT_ROWS * stride)
    for warps in _WARPS:
        smem = _align16(8 * h) + warps * per_warp
        if smem <= MAX_SMEM:
            return warps, smem
    return 0, smem


def check_fits(s: int, h: int, k: int) -> None:
    """Raise ValueError where not even one warp's stages of S ids a row fit
    in a block's shared memory (the kernel would refuse the launch)."""
    warps, smem = block_smem(s, h, k)
    if not warps:
        raise ValueError(f"S={s}, H={h}, {k} bytes an id need {smem} bytes "
                         f"of shared memory per block, more than {MAX_SMEM}")


def _unit_counter(device: torch.device) -> torch.Tensor:
    """One int32 of scratch: the kernel's counter of 8-row units, which the
    launch zeroes on the stream before the kernel runs."""
    return torch.empty(1, dtype=torch.int32, device=device)


def minhash_and_keys_plain(items: torch.Tensor, a: torch.Tensor,
                           b: torch.Tensor, n_bands: int):
    """Plain version of the fused kernel: signatures, then band keys."""
    sig = minhash_signatures(items, a, b)
    return sig, band_keys(sig, n_bands)


def combine_bytes(payload: torch.Tensor, shape: tuple, k: int,
                  offset: int) -> torch.Tensor:
    """[rows*S*k] uint8 little-endian wire bytes -> [rows, S] int32 ids
    (+ offset, mod 2^32).  Oracle of the packed kernel's byte reader."""
    rows, s = shape
    p = payload[:rows * s * k].reshape(rows, s, k).to(torch.int64)
    x = p[..., 0]
    for t in range(1, k):
        x = x | (p[..., t] << (8 * t))
    return narrow((x + int(offset)) & U32_MASK)


def minhash_and_keys_packed_plain(payload: torch.Tensor, shape: tuple, k: int,
                                  offset: int, a: torch.Tensor,
                                  b: torch.Tensor, n_bands: int):
    """Plain version of the packed kernel: decode, then hash."""
    return minhash_and_keys_plain(combine_bytes(payload, shape, k, offset),
                                  a, b, n_bands)


def _check_consts(a: torch.Tensor, b: torch.Tensor, n_bands: int,
                  device: torch.device, s: int, k: int) -> int:
    """Validate the hash constants against the ids (S a row, k bytes an
    id); returns H."""
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be a 1-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, ids on {device}")
    h = a.shape[0]
    if b.shape[0] != h or n_bands < 1 or h % n_bands:
        raise ValueError(f"need a, b of one length H divisible by n_bands; "
                         f"got {a.shape[0]}, {b.shape[0]}, B={n_bands}")
    if device.type == "cuda":
        if not (a.is_contiguous() and b.is_contiguous()):
            raise ValueError("a and b must be contiguous")
        check_fits(s, h, k)
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return h


def minhash_and_keys(items: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                     n_bands: int):
    """[N, S] int32 ids, [H] int32 a and b -> ([N, H] signatures, [N, B]
    band keys), all int32 carrying uint32 bits."""
    if items.dtype != torch.int32 or items.dim() != 2:
        raise ValueError(f"items must be a 2-D int32 tensor, got "
                         f"{items.dtype} {tuple(items.shape)}")
    n, s = items.shape
    h = _check_consts(a, b, n_bands, items.device, s, 4)
    if items.device.type == "cpu":
        return minhash_and_keys_plain(items, a, b, n_bands)
    if not items.is_contiguous():
        raise ValueError("items must be contiguous")
    sig = torch.empty((n, h), dtype=torch.int32, device=items.device)
    keys = torch.empty((n, n_bands), dtype=torch.int32, device=items.device)
    if n:
        load_extension().minhash_u32(items, a, b, sig, keys,
                                     _unit_counter(items.device))
        count_launch(minhash_and_keys)
    return sig, keys


minhash_and_keys.launches = 0


def minhash_and_keys_packed(payload: torch.Tensor, shape: tuple, k: int,
                            offset: int, a: torch.Tensor, b: torch.Tensor,
                            n_bands: int):
    """``minhash_and_keys`` over a byte-packed wire chunk.

    ``payload``: flat uint8 bytes, ``shape`` = (rows, S) decoded shape,
    ``k`` = bytes per id (1..4), ``offset`` = the chunk's subtracted min.
    Bit-identical to decoding first (``combine_bytes``) and hashing."""
    rows, s = shape
    if payload.dtype != torch.uint8 or payload.dim() != 1:
        raise ValueError(f"payload must be a flat uint8 tensor, got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    if not 1 <= k <= 4 or payload.numel() < rows * s * k:
        raise ValueError(f"payload of {payload.numel()} bytes cannot hold "
                         f"{rows}x{s} ids of {k} bytes")
    if not 0 <= int(offset) <= U32_MASK:
        raise ValueError(f"offset {offset} is not a uint32")
    h = _check_consts(a, b, n_bands, payload.device, s, k)
    if payload.device.type == "cpu":
        return minhash_and_keys_packed_plain(payload, shape, k, offset, a, b,
                                             n_bands)
    if not payload.is_contiguous():
        raise ValueError("payload must be contiguous")
    sig = torch.empty((rows, h), dtype=torch.int32, device=payload.device)
    keys = torch.empty((rows, n_bands), dtype=torch.int32,
                       device=payload.device)
    if rows:
        load_extension().minhash_packed(payload, rows, s, k, int(offset), a, b,
                                        sig, keys,
                                        _unit_counter(payload.device))
        count_launch(minhash_and_keys_packed)
    return sig, keys


minhash_and_keys_packed.launches = 0


__all__ = ["block_smem", "check_fits", "combine_bytes", "minhash_and_keys",
           "minhash_and_keys_packed", "minhash_and_keys_packed_plain",
           "minhash_and_keys_plain"]
