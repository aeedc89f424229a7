"""Interleaved rANS decode of wire v3's coded lanes: wrapper and plain version.

Ports the TPU kernel of ``tse1m_tpu/cluster/kernels/rans.py``:

- ``rans_decode`` <- ``_rans_decode_pallas`` (``_rans_kernel``), with the
  decode tables of ``_decode_tables`` built inside the kernel from the
  shipped frequencies.  One call decodes one coded lane: its planes (one
  for a direct lane, one per byte above 12 bits) OR-ed at ``shift`` bits a
  plane.  The CUDA kernel (``csrc/rans.cu``) runs one warp per plane.
- ``rans_decode_plain`` <- ``_rans_decode_jnp``: the same loop over the
  planes side by side, in int64 torch ops.

The host codec (``cluster/entropy.py``) deals symbols round-robin across
``N_STREAMS`` rANS states and interleaves the renormalization words in
decode order, so each step advances all streams with one table read and
the streams that need a word take them in stream order from one pointer.

A plane is a triple of tensors: words [W] int16 and freqs [A] int16 (both
carrying uint16 bits) and states x0 [32] int32 (uint32 bits).  The wrapper
given CUDA tensors launches the kernel on the current stream or raises;
given CPU tensors it runs the plain version.  ``rans_decode.launches``
counts its kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from ...device import U32_MASK, narrow, widen
from ..entropy import _DIRECT_BITS_MAX, _M, N_STREAMS, PROB_BITS, RANS_L, \
    EntropyLane
from ._build import load_extension

_MAX_PLANES = 4


def _u16(t: torch.Tensor) -> torch.Tensor:
    """int16 bit patterns -> int64 values in [0, 2^16)."""
    return t.to(torch.int64) & 0xFFFF


def rans_decode_plain(planes, n: int, shift: int) -> torch.Tensor:
    """Plain version of the kernel: [n] int32 (uint32 bits), plane p OR-ed
    in at ``shift * p`` bits.  Every plane steps through the loop of
    ``_rans_decode_jnp``: states widened to int64 and masked to 32 bits."""
    dev = planes[0][0].device
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    k = N_STREAMS
    steps = -(-n // k)
    fr = torch.stack([_u16(f) for _, _, f in planes])         # [P, A]
    cumi = torch.cumsum(fr, 1)
    cume = cumi - fr
    slots = torch.arange(_M, device=dev).expand(len(planes), _M).contiguous()
    slot_sym = torch.searchsorted(cumi, slots, right=True).clamp_(
        max=fr.shape[1] - 1)
    x = torch.stack([widen(x0) for _, x0, _ in planes])       # [P, 32]
    # One pad word past the longest stream: a clamped read of an exhausted
    # pointer stays in bounds (and is masked out by `need`).
    wlim = max(w.numel() for w, _, _ in planes)
    wpad = torch.zeros((len(planes), wlim + 1), dtype=torch.int64,
                       device=dev)
    for p, (w, _, _) in enumerate(planes):
        wpad[p, :w.numel()] = _u16(w)
    ks = torch.arange(k, device=dev)
    ptr = torch.zeros((len(planes), 1), dtype=torch.int64, device=dev)
    out = torch.empty((len(planes), steps, k), dtype=torch.int64, device=dev)
    for t in range(steps):
        act = (t * k + ks) < n
        slot = x & (_M - 1)
        s = slot_sym.gather(1, slot)
        xn = (fr.gather(1, s) * (x >> PROB_BITS) + slot
              - cume.gather(1, s)) & U32_MASK
        x = torch.where(act, xn, x)
        need = (act & (x < RANS_L)).to(torch.int64)
        off = torch.cumsum(need, 1) - need
        w = wpad.gather(1, (ptr + off).clamp(max=wlim))
        x = torch.where(need.bool(), ((x << 16) | w) & U32_MASK, x)
        ptr = ptr + need.sum(1, keepdim=True)
        out[:, t] = s
    out = out.reshape(len(planes), -1)[:, :n]
    combined = out[0]
    for p in range(1, len(planes)):
        combined = combined | (out[p] << (shift * p))
    return narrow(combined)


def _check_planes(planes, n: int, shift: int) -> torch.device:
    """Validate one lane's planes; returns their device."""
    if not 1 <= len(planes) <= _MAX_PLANES:
        raise ValueError(f"need 1..{_MAX_PLANES} planes, got {len(planes)}")
    if n < 0 or n >= 1 << 31:
        raise ValueError(f"symbol count {n} out of range")
    if shift < 0 or shift * (len(planes) - 1) >= 32:
        raise ValueError(f"shift {shift} puts a plane past bit 31")
    device = planes[0][0].device
    alphabet = planes[0][2].numel()
    if not 1 <= alphabet <= _M:
        raise ValueError(f"alphabet {alphabet} not in 1..{_M}")
    for words, x0, freqs in planes:
        for name, t, dtype in (("words", words, torch.int16),
                               ("x0", x0, torch.int32),
                               ("freqs", freqs, torch.int16)):
            if t.dtype != dtype or t.dim() != 1:
                raise ValueError(f"{name} must be a 1-D {dtype} tensor, got "
                                 f"{t.dtype} {tuple(t.shape)}")
            if t.device != device:
                raise ValueError(f"{name} is on {t.device}, not {device}")
            if device.type == "cuda" and not t.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
        if x0.numel() != N_STREAMS or freqs.numel() != alphabet:
            raise ValueError(f"need x0 of {N_STREAMS} states and freqs of "
                             f"one alphabet; got {x0.numel()}, "
                             f"{freqs.numel()} (alphabet {alphabet})")
        if device.type == "cuda" and words.data_ptr() % 8:
            raise ValueError("words must be 8-byte aligned on the card")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def rans_decode(planes, n: int, shift: int) -> torch.Tensor:
    """Decode one coded lane -> [n] int32 carrying uint32 bits.

    ``planes``: a sequence of (words, x0, freqs) tensor triples, at most 4,
    all of one alphabet; plane p is OR-ed in at ``shift * p`` bits."""
    planes = [tuple(p) for p in planes]
    device = _check_planes(planes, n, shift)
    if device.type == "cpu":
        return rans_decode_plain(planes, n, shift)
    out = torch.zeros(n, dtype=torch.int32, device=device)
    if n:
        load_extension().rans_decode([p[0] for p in planes],
                                     [p[1] for p in planes],
                                     [p[2] for p in planes], n, shift, out)
        rans_decode.launches += 1
    return out


rans_decode.launches = 0


def decode_lane_device(lane: EntropyLane, arrays) -> torch.Tensor:
    """Decode an entropy-coded lane from the device copies of
    ``lane.wire_arrays()`` (same order: words, x0, freqs per plane)."""
    arrays = list(arrays)
    if len(arrays) != 3 * len(lane.planes):
        raise ValueError(f"{len(arrays)} arrays for {len(lane.planes)} "
                         "planes")
    planes = [arrays[3 * p:3 * p + 3] for p in range(len(lane.planes))]
    return rans_decode(planes, lane.n,
                       8 if lane.bits > _DIRECT_BITS_MAX else 0)


__all__ = ["decode_lane_device", "rans_decode", "rans_decode_plain"]
