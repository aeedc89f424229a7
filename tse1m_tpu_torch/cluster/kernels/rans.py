"""Interleaved rANS decode of wire v3's coded lanes: wrapper and plain version.

Ports the TPU kernel of ``tse1m_tpu/cluster/kernels/rans.py``:

- ``rans_decode_lanes`` <- ``_rans_decode_pallas`` (``_rans_kernel``), with
  the decode tables of ``_decode_tables`` built inside the kernel from the
  shipped frequencies.  One call decodes several coded lanes in one launch
  (one block a lane, one warp a plane; ``csrc/rans.cu``); a lane's planes
  (one for a direct lane, one per byte above 12 bits) are OR-ed at
  ``shift`` bits a plane.  ``rans_decode`` decodes one lane.
- ``rans_decode_plain`` <- ``_rans_decode_jnp``: the same loop over the
  planes side by side, in int64 torch ops; ``rans_decode_lanes_plain``
  loops it over lanes.
- ``fused_decode_table_plain``: the kernel's one-entry-a-slot table, built
  from ``_decode_tables``' arrays, so the CPU tests can hold its layout to
  JAX's.

The host codec (``cluster/entropy.py``) deals symbols round-robin across
``N_STREAMS`` rANS states and interleaves the renormalization words in
decode order, so each step advances all streams with one table read and
the streams that need a word take them in stream order from one pointer.

A plane is a triple of tensors: words [W] int16 and freqs [A] int16 (both
carrying uint16 bits) and states x0 [32] int32 (uint32 bits).  The
wrapper given CUDA tensors launches the kernel on the current stream or
raises; given CPU tensors it runs the plain version.  On the card a lane
of several planes must be byte planes (``shift`` 8, at most 256 symbols),
as every frame of ``entropy.encode_lane`` is, and each plane's frequencies
must sum to 2^12: ``decode_lane_device`` and ``decode_lanes_device`` check
that on the host copy of the frame.  ``rans_decode.launches`` counts the
kernel's launches (not lanes) and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import U32_MASK, narrow, widen
from ..entropy import _DIRECT_BITS_MAX, _M, N_STREAMS, PROB_BITS, RANS_L, \
    EntropyLane
from ._build import load_extension
from ._count import count_launch

_MAX_PLANES = 4
_MAX_LANES = 8  # lanes a launch (csrc/rans.cu kMaxLanes)


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


def rans_decode_lanes_plain(lanes) -> list:
    """Plain version of the batched kernel: ``rans_decode_plain`` of each
    (planes, n, shift) lane."""
    return [rans_decode_plain(list(planes), n, shift)
            for planes, n, shift in lanes]


def fused_decode_table_plain(freqs: torch.Tensor) -> torch.Tensor:
    """The kernel's decode table of one plane: [4096] int64 entries, slot ->
    low word ``(f - 1) | k << 12 | s << 24`` and high word ``last_q``
    (an alphabet of at most 256 symbols) or low word ``(f - 1) | k << 12``
    and high word ``last_q | s << 16`` (a wider one), where ``s`` is the
    slot's symbol, ``f`` its frequency, ``k = slot - cum[s]`` (``cum`` the
    exclusive cumulative frequencies) and ``last_q = (2^16 - 1 - k) // f``,
    the largest ``x >> 12`` whose update ``f * (x >> 12) + k`` stays below
    2^16 (needs a word).  For a normalized table (sum 2^12) ``f - 1`` and
    ``k`` fit in 12 bits and ``last_q`` in 16."""
    fr = _u16(freqs)
    cumi = torch.cumsum(fr, 0)
    slots = torch.arange(_M, device=fr.device)
    sym = torch.searchsorted(cumi, slots, right=True).clamp_(
        max=fr.numel() - 1)
    f = fr[sym]
    k = slots - (cumi - fr)[sym]
    last_q = torch.div(0xFFFF - k, f, rounding_mode="floor")
    lo = (f - 1) | (k << 12)
    if fr.numel() <= 256:
        return lo | (sym << 24) | (last_q << 32)
    return lo | (last_q << 32) | (sym << 48)


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
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def _check_lane_for_card(planes, shift: int) -> None:
    """What the kernel takes beyond ``_check_planes``: several planes only
    as byte planes at shift 8 (a plane writes its byte of the output)."""
    if len(planes) > 1 and (shift != 8 or planes[0][2].numel() > 256):
        raise ValueError(f"on the card a lane of {len(planes)} planes must "
                         f"be byte planes at shift 8 (<= 256 symbols); got "
                         f"shift {shift}, alphabet {planes[0][2].numel()}")


def rans_decode_lanes(lanes) -> list:
    """Decode coded lanes -> one [n] int32 tensor (uint32 bits) a lane.

    ``lanes``: a sequence of (planes, n, shift), ``planes`` as for
    ``rans_decode``.  On the card every lane with symbols goes into one
    launch (up to 8 lanes a launch), its planes' chains side by side."""
    lanes = [([tuple(p) for p in planes], int(n), int(shift))
             for planes, n, shift in lanes]
    devices = {_check_planes(planes, n, shift) for planes, n, shift in lanes}
    if len(devices) > 1:
        raise ValueError(f"lanes lie on several devices: {devices}")
    if not lanes:
        return []
    device = devices.pop()
    if device.type == "cpu":
        return rans_decode_lanes_plain(lanes)
    for planes, _, shift in lanes:
        _check_lane_for_card(planes, shift)
    # One zeroed buffer for every lane: byte planes write their bytes only.
    sizes = [n for _, n, _ in lanes]
    flat = torch.zeros(sum(sizes), dtype=torch.int32, device=device)
    outs = list(flat.split(sizes))
    todo = [(lane, out) for lane, out in zip(lanes, outs) if lane[1]]
    ext = load_extension() if todo else None
    for lo in range(0, len(todo), _MAX_LANES):
        group = todo[lo:lo + _MAX_LANES]
        ext.rans_decode_lanes(
            [[p[0] for p in planes] for (planes, _, _), _ in group],
            [[p[1] for p in planes] for (planes, _, _), _ in group],
            [[p[2] for p in planes] for (planes, _, _), _ in group],
            [n for (_, n, _), _ in group],
            [out for _, out in group])
        count_launch(rans_decode)
    return outs


def rans_decode(planes, n: int, shift: int) -> torch.Tensor:
    """Decode one coded lane -> [n] int32 carrying uint32 bits.

    ``planes``: a sequence of (words, x0, freqs) tensor triples, at most 4,
    all of one alphabet; plane p is OR-ed in at ``shift * p`` bits."""
    return rans_decode_lanes([(planes, n, shift)])[0]


rans_decode.launches = 0


def _lane_args(lane: EntropyLane, arrays) -> tuple:
    """(planes, n, shift) of a coded lane from the device copies of
    ``lane.wire_arrays()`` (same order: words, x0, freqs per plane); the
    host frame's tables must be normalized, as the kernel requires."""
    arrays = list(arrays)
    if len(arrays) != 3 * len(lane.planes):
        raise ValueError(f"{len(arrays)} arrays for {len(lane.planes)} "
                         "planes")
    for pc in lane.planes:
        if int(pc.freqs.sum(dtype=np.int64)) != _M:
            raise ValueError(f"a plane's frequencies sum to "
                             f"{int(pc.freqs.sum(dtype=np.int64))}, not {_M}")
    planes = [arrays[3 * p:3 * p + 3] for p in range(len(lane.planes))]
    return planes, lane.n, 8 if lane.bits > _DIRECT_BITS_MAX else 0


def decode_lane_device(lane: EntropyLane, arrays) -> torch.Tensor:
    """Decode an entropy-coded lane from the device copies of
    ``lane.wire_arrays()`` (same order: words, x0, freqs per plane)."""
    return rans_decode(*_lane_args(lane, arrays))


def decode_lanes_device(lanes, arrays) -> list:
    """Decode several entropy-coded lanes in one launch: ``lanes`` and the
    device copies of each one's ``wire_arrays()``, pairwise."""
    return rans_decode_lanes([_lane_args(lane, a)
                              for lane, a in zip(lanes, arrays, strict=True)])


__all__ = ["decode_lane_device", "decode_lanes_device",
           "fused_decode_table_plain", "rans_decode", "rans_decode_lanes",
           "rans_decode_lanes_plain", "rans_decode_plain"]
