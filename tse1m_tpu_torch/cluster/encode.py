"""Adaptive bit-width wire packing for the cluster pipeline (host, numpy).

A copy of the plain-lane part of ``tse1m_tpu/cluster/encode.py``: every
chunk picks its own width from its actual value range (min subtracted, so a
narrow band high in the id space still packs tight).  Byte-multiple widths
(8/16/24/32) travel as byte views, which the packed MinHash kernel reads
directly; sub-byte and odd widths travel as a little-endian bit stream,
which ``pipeline._unpack_bits`` decodes on the device.  Ids may first be
quantized into a 2^b universe (``quantize_ids``, b-bit minwise hashing,
arXiv:1205.2958), which leaves set resemblance, the only thing MinHash
reads, nearly intact.

The delta lane and the rANS entropy lanes are not ported yet (ROADMAP.md
Queue 1 item 6); ``pipeline._validate_encoding`` refuses them.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# Encoding and quantization engage automatically at or above this raw size.
_AUTO_MIN_BYTES = 64 * 1024 * 1024

_QUANT_MULT = np.uint32(0x9E3779B1)  # Fibonacci hashing: top bits well-mixed
_AUTO_QUANT_BITS = 10

# Chunks holding ids at or above this ship raw uint32.
_PACK_LIMIT = 1 << 24


def quantize_ids(items: np.ndarray, bits: int) -> np.ndarray:
    """Hash uint32 ids into a 2^bits universe (top `bits` of a
    multiply-shift).  Deterministic per value: equal sets stay equal."""
    if not 1 <= bits <= 32:
        raise ValueError(f"quantization bits must be in [1, 32], got {bits}")
    if bits == 32:
        return items
    return ((items * _QUANT_MULT) >> np.uint32(32 - bits)).astype(np.uint32)


def width_bits(max_value: int) -> int:
    """Minimal bit width holding max_value (>= 1 so empty/zero lanes still
    have a well-formed stream)."""
    return max(1, int(max_value).bit_length())


def snap_byte_width(bits: int) -> int:
    """Round a bit width up to the nearest byte multiple (8/16/24/32)."""
    return min(32, ((bits + 7) // 8) * 8)


def pack_bits_host(vals: np.ndarray, bits: int) -> np.ndarray:
    """Pack `vals` (values < 2^bits after uint32 cast) into a little-endian
    uint8 bit stream of ceil(size*bits/8) bytes; value i occupies stream
    bits [i*bits, (i+1)*bits).  Byte-multiple widths take a byte-view path;
    other widths go through packbits in cache-sized, 8-value-aligned
    slices."""
    v = np.ascontiguousarray(vals, dtype="<u4").reshape(-1)
    if bits % 8 == 0:
        k = bits // 8
        return np.ascontiguousarray(
            v[:, None].view(np.uint8)[:, :k]).reshape(-1)
    dt = np.uint16 if bits <= 16 else np.uint32
    vv = v.astype(dt, copy=False)
    shifts = np.arange(bits, dtype=dt)
    step = 1 << 20
    out = []
    for i in range(0, v.size, step):
        bitmat = ((vv[i:i + step, None] >> shifts) & 1).astype(np.uint8)
        out.append(np.packbits(bitmat.reshape(-1), bitorder="little"))
    if not out:
        return np.zeros(0, np.uint8)
    return out[0] if len(out) == 1 else np.concatenate(out)


def unpack_bits_host(packed: np.ndarray, n: int, bits: int) -> np.ndarray:
    """Inverse of :func:`pack_bits_host`; returns [n] uint32."""
    if n == 0:
        return np.empty(0, np.uint32)
    if bits % 8 == 0:
        k = bits // 8
        b = packed[:n * k].reshape(n, k).astype(np.uint32)
        out = b[:, 0]
        for j in range(1, k):
            out = out | (b[:, j] << np.uint32(8 * j))
        return out
    bitmat = np.unpackbits(packed, bitorder="little")[:n * bits]
    weights = (np.uint32(1) << np.arange(bits, dtype=np.uint32))
    return (bitmat.reshape(n, bits).astype(np.uint32) * weights).sum(
        axis=1, dtype=np.uint32)


@dataclass(frozen=True)
class ChunkWire:
    """One chunk's wire form: a packed uint8 payload and the header the
    device needs to decode it (bits, offset bias, logical shape)."""

    payload: np.ndarray      # uint8 bit/byte stream
    n_values: int            # logical value count (rows * set_size)
    bits: int                # wire width per value
    offset: int              # subtracted min; the device adds it back
    shape: tuple             # logical decoded shape

    @property
    def nbytes(self) -> int:
        return int(self.payload.nbytes)


def chunk_wire_bits(chunk: np.ndarray) -> tuple[int, int]:
    """(bits, offset) for one chunk: subtract the chunk min, take the
    minimal width of the remaining range, and snap widths > 16 up to a byte
    multiple.  Chunks holding ids >= ``_PACK_LIMIT`` ship raw uint32."""
    if chunk.size == 0:
        return 8, 0
    mx = int(chunk.max())
    if mx >= _PACK_LIMIT:
        return 32, 0
    offset = int(chunk.min())
    bits = width_bits(mx - offset)
    if bits > 16:
        bits = snap_byte_width(bits)
    if bits >= 32:
        offset = 0
        bits = 32
    return bits, offset


def pack_chunk(chunk: np.ndarray) -> ChunkWire:
    """Adaptive-width wire form of a uint32 chunk (any shape)."""
    bits, offset = chunk_wire_bits(chunk)
    vals = chunk if offset == 0 else chunk - np.uint32(offset)
    return ChunkWire(payload=pack_bits_host(vals, bits),
                     n_values=int(chunk.size), bits=bits, offset=offset,
                     shape=tuple(chunk.shape))


def unpack_chunk_host(wire: ChunkWire) -> np.ndarray:
    """Reference decoder for :func:`pack_chunk`."""
    vals = unpack_bits_host(wire.payload, wire.n_values, wire.bits)
    if wire.offset:
        vals = vals + np.uint32(wire.offset)
    return vals.reshape(wire.shape)
