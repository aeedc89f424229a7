"""Host wire encodings for the cluster pipeline (numpy).

A copy of ``tse1m_tpu/cluster/encode.py``:

- **Adaptive bit-width packing.**  Every chunk picks its own width from its
  actual value range (min subtracted, so a narrow band high in the id space
  still packs tight).  Byte-multiple widths (8/16/24/32) travel as byte
  views, which the packed MinHash kernel reads directly; sub-byte and odd
  widths travel as a little-endian bit stream, which
  ``pipeline._unpack_bits`` decodes on the device.  Ids may first be
  quantized into a 2^b universe (``quantize_ids``, b-bit minwise hashing,
  arXiv:1205.2958), which leaves set resemblance, the only thing MinHash
  reads, nearly intact.
- **The base-delta lane** (``encode_delta``).  A cheap host sketch groups
  probable near-duplicate rows; each group's first row ships whole in the
  full lane and every other member ships as (base row, changed positions,
  new values).  Every pair is verified by exact comparison before it is
  encoded, so decode reproduces the input bit for bit whatever the
  sketch's quality.  A 1-bit-per-row mask maps lane ranks back to rows.
  The grouping pass runs in C++ (``native/encode.cc``) when that library
  builds, else in numpy (``_group_rows``); both give the same ``rep_of``.
- **Wire v3 lanes.**  Each chunk and each delta metadata lane is offered to
  the rANS codec (``cluster/entropy.py``) and ships coded when the frame
  beats the bit-packed form (``pack_chunk``, ``pack_lane``,
  ``pack_delta_meta``); ``kernels/rans.py`` decodes it on the card.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .. import native
from . import entropy as ent_mod

# Encoding and quantization engage automatically at or above this raw size.
_AUTO_MIN_BYTES = 64 * 1024 * 1024
# ...and the delta lane only when at least this fraction of rows lands in
# it (under 5% the bookkeeping lanes eat the win).
_AUTO_MIN_DELTA_FRACTION = 0.05

# One multiply-add hash pass per probe; (min, max) of the hashed row is the
# group key.
_PROBES = ((0x9E3779B1, 0x85EBCA77), (0xC2B2AE3D, 0x27D4EB2F),
           (0x165667B1, 0x9E3779B9), (0x85EBCA6B, 0xC2B2AE35))

_QUANT_MULT = np.uint32(0x9E3779B1)  # Fibonacci hashing: top bits well-mixed
_AUTO_QUANT_BITS = 10

# Chunks holding ids at or above this ship raw uint32.
_PACK_LIMIT = 1 << 24


@dataclass(frozen=True)
class DeltaEncoding:
    """Host product of :func:`encode_delta`: the exact wire layout.

    Lanes keep original row order within themselves; ``mask_bits``
    (little-endian packbits of the 1 = delta membership bit per row) is all
    the device needs to map lane ranks back to original indices."""

    n: int                  # original row count
    set_size: int
    mask_bits: np.ndarray   # [ceil(n/8)] uint8, little bit order
    full_rows: np.ndarray   # [F, S] uint32: rows that travel whole
    rep_in_full: np.ndarray  # [D] int32: full-lane rank of each base
    counts: np.ndarray      # [D] uint8: changed positions per delta row
    pos_flat: np.ndarray    # [T] uint8: changed positions, row-major
    val_flat: np.ndarray    # [T] uint32: replacement values

    @property
    def n_delta(self) -> int:
        return int(self.rep_in_full.shape[0])

    @property
    def n_full(self) -> int:
        return int(self.full_rows.shape[0])


def sketch_keys(rows: np.ndarray, probe: int) -> np.ndarray:
    """[K, S] uint32 rows -> [K] uint64 group keys ((min, max) of one
    multiply-add hash pass)."""
    a, b = _PROBES[probe]
    h = rows * np.uint32(a) + np.uint32(b)
    return ((h.min(axis=1).astype(np.uint64) << np.uint64(32))
            | h.max(axis=1).astype(np.uint64))


def _group_rows(items: np.ndarray, max_diffs: int, n_probes: int,
                ) -> np.ndarray:
    """[N] int64 rep_of: original index of each row's verified base row,
    -1 for full-lane rows.  No chains: a row with children is pinned to the
    full lane, and later probes keep pinned rows in the pool as grouping
    targets only."""
    n = items.shape[0]
    rep_of = np.full(n, -1, np.int64)
    pinned = np.zeros(n, bool)
    pool = np.arange(n)
    for p in range(min(n_probes, len(_PROBES))):
        if pool.size < 2:
            break
        keys = sketch_keys(items[pool], p)
        # Stable sort by (key, pinned first): a pinned row heads its group
        # whenever one is present, so stragglers attach to existing bases.
        order = np.lexsort((~pinned[pool], keys))
        ks = keys[order]
        first = np.empty(ks.shape, bool)
        first[0] = True
        np.not_equal(ks[1:], ks[:-1], out=first[1:])
        rep_sorted = order[np.flatnonzero(first)][np.cumsum(first) - 1]
        cand = (rep_sorted != order) & ~pinned[pool[order]]
        cand_rows = pool[order[cand]]
        cand_reps = pool[rep_sorted[cand]]
        if cand_rows.size == 0:
            continue
        # Exact verification: the sketch only proposes; rows over the cap
        # stay in the pool for the next probe.
        nd = (items[cand_rows] != items[cand_reps]).sum(axis=1)
        good = nd <= max_diffs
        rep_of[cand_rows[good]] = cand_reps[good]
        pinned[cand_reps[good]] = True
        pool = pool[rep_of[pool] < 0]
    return rep_of


def encode_delta(items: np.ndarray, *, max_diffs: int = 16,
                 n_probes: int = 3,
                 min_delta_fraction: float = 0.0) -> DeltaEncoding | None:
    """Encode [N, S] uint32 rows, or None when not worthwhile (fewer than
    ``min_delta_fraction`` of the rows, or none, land in the delta lane)."""
    items = np.ascontiguousarray(items, dtype=np.uint32)
    n, s = items.shape if items.ndim == 2 else (0, 0)
    if n < 2 or s == 0 or s > 255 or max_diffs > 255:
        return None
    # Break-even clamp: a delta row must beat a full row on the wire even
    # at 24 bits an id (4 B base + 1 B count + nd*(1 B pos + 3 B value)
    # < 3*s B).  Sets of <= 3 elements can never break even.
    break_even = (3 * s - 6) // 4
    if break_even < 1:
        return None
    max_diffs = min(max_diffs, break_even)
    rep_of = native.group_delta(items, max_diffs, n_probes)
    if rep_of is None:
        rep_of = _group_rows(items, max_diffs, n_probes)
    is_delta = rep_of >= 0
    d = int(is_delta.sum())
    if d < max(1, int(min_delta_fraction * n)):
        return None
    delta_idx = np.flatnonzero(is_delta)
    full_rank = np.cumsum(~is_delta) - 1
    delta_rows = items[delta_idx]
    neq = delta_rows != items[rep_of[delta_idx]]
    counts = neq.sum(axis=1, dtype=np.int64)
    _, pos = np.nonzero(neq)
    return DeltaEncoding(
        n=n, set_size=s,
        mask_bits=np.packbits(is_delta, bitorder="little"),
        full_rows=np.ascontiguousarray(items[~is_delta]),
        rep_in_full=full_rank[rep_of[delta_idx]].astype(np.int32),
        counts=counts.astype(np.uint8),
        pos_flat=pos.astype(np.uint8),
        val_flat=delta_rows[neq],
    )


def decode_host(enc: DeltaEncoding) -> np.ndarray:
    """Reference decoder of :func:`encode_delta`."""
    is_delta = np.unpackbits(enc.mask_bits, bitorder="little")[:enc.n]
    out = np.empty((enc.n, enc.set_size), np.uint32)
    out[~is_delta.astype(bool)] = enc.full_rows
    base = enc.full_rows[enc.rep_in_full].copy()
    rows = np.repeat(np.arange(enc.n_delta), enc.counts)
    base[rows, enc.pos_flat] = enc.val_flat
    out[is_delta.astype(bool)] = base
    return out


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
    device needs to decode it (bits, offset bias, logical shape).

    Wire v3: when a static entropy table beats the fixed width, ``ent``
    holds the rANS frame and ``payload`` is empty.  ``bits`` and ``offset``
    keep their meaning (the coded symbols are the offset-subtracted
    values), so decode is entropy decode plus offset."""

    payload: np.ndarray      # uint8 bit/byte stream (empty when ent)
    n_values: int            # logical value count (rows * set_size)
    bits: int                # wire width per value
    offset: int              # subtracted min; the device adds it back
    shape: tuple             # logical decoded shape
    ent: ent_mod.EntropyLane | None = None

    @property
    def nbytes(self) -> int:
        if self.ent is not None:
            return int(self.ent.nbytes)
        return int(self.payload.nbytes)

    def wire_arrays(self) -> list:
        """The host arrays this chunk copies to the card: the packed
        stream, or the entropy frame's (words, x0, freqs) per plane."""
        if self.ent is not None:
            return self.ent.wire_arrays()
        return [self.payload]


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


def pack_chunk(chunk: np.ndarray, entropy: str = "off",
               stats: dict | None = None) -> ChunkWire:
    """Adaptive-width wire form of a uint32 chunk (any shape).

    ``entropy``: 'off' ships the bit-packed stream; 'auto' offers the chunk
    to the rANS codec and ships whichever is smaller; 'force' entropy-codes
    regardless.  ``stats`` (a mutable dict) accrues the codec's seconds and
    bytes saved."""
    bits, offset = chunk_wire_bits(chunk)
    vals = chunk if offset == 0 else chunk - np.uint32(offset)
    ent = _try_entropy(vals, bits, entropy, stats)
    if ent is not None:
        return ChunkWire(payload=np.zeros(0, np.uint8),
                         n_values=int(chunk.size), bits=bits,
                         offset=offset, shape=tuple(chunk.shape), ent=ent)
    return ChunkWire(payload=pack_bits_host(vals, bits),
                     n_values=int(chunk.size), bits=bits, offset=offset,
                     shape=tuple(chunk.shape))


def _try_entropy(vals: np.ndarray, bits: int, entropy: str,
                 stats: dict | None):
    """The per-lane codec gate: an EntropyLane when it wins (or is forced),
    else None; accounting lands in ``stats``."""
    if entropy == "off":
        return None
    t0 = time.perf_counter()
    lane = ent_mod.encode_lane(vals, bits, force=(entropy == "force"))
    if stats is not None:
        stats["entropy_s"] = (stats.get("entropy_s", 0.0)
                              + time.perf_counter() - t0)
        if lane is not None:
            stats["entropy_saved_bytes"] = (
                stats.get("entropy_saved_bytes", 0)
                + ent_mod.packed_nbytes(int(vals.size), bits)
                - lane.nbytes)
    return lane


def unpack_chunk_host(wire: ChunkWire) -> np.ndarray:
    """Reference decoder for :func:`pack_chunk`."""
    vals = unpack_bits_host(wire.payload, wire.n_values, wire.bits)
    if wire.offset:
        vals = vals + np.uint32(wire.offset)
    return vals.reshape(wire.shape)


@dataclass(frozen=True)
class LaneWire:
    """One metadata lane's wire form: a minimal-width bit stream, or (wire
    v3) a rANS frame when the lane's skew beats the fixed width."""

    n: int                   # value count
    bits: int                # logical value width
    packed: np.ndarray | None = None   # uint8 bit stream
    ent: ent_mod.EntropyLane | None = None

    @property
    def nbytes(self) -> int:
        if self.ent is not None:
            return int(self.ent.nbytes)
        return int(self.packed.nbytes)

    def wire_arrays(self) -> list:
        if self.ent is not None:
            return self.ent.wire_arrays()
        return [self.packed]


def pack_lane(vals: np.ndarray, bits: int, entropy: str = "off",
              stats: dict | None = None) -> LaneWire:
    """Wire form of one metadata lane under the v3 per-lane choice."""
    ent = _try_entropy(vals, bits, entropy, stats)
    if ent is not None:
        return LaneWire(n=int(vals.size), bits=bits, ent=ent)
    return LaneWire(n=int(vals.size), bits=bits,
                    packed=pack_bits_host(vals, bits))


@dataclass(frozen=True)
class DeltaMetaWire:
    """Wire form of a DeltaEncoding's metadata lanes: each lane packs at its
    minimal width (6-bit positions for 64-element sets, ~5-bit counts,
    ~18-bit base references at 1M rows) or, under wire v3, ships a rANS
    frame when that is smaller.  The value lane reuses the chunk packer.
    The pipeline copies all of it, with the mask, in one staged copy
    (``pipeline._put_delta_meta``)."""

    rep: LaneWire
    counts: LaneWire
    pos: LaneWire
    val: ChunkWire

    @property
    def nbytes(self) -> int:
        return int(self.rep.nbytes + self.counts.nbytes + self.pos.nbytes
                   + self.val.nbytes)

    def lanes(self) -> tuple:
        return (self.rep, self.counts, self.pos)


def pack_delta_meta(enc: DeltaEncoding, entropy: str = "off",
                    stats: dict | None = None) -> DeltaMetaWire:
    """Pack a DeltaEncoding's rep/counts/pos/val lanes for the wire."""
    rep_bits = width_bits(max(enc.n_full - 1, 1))
    counts_bits = width_bits(int(enc.counts.max()) if enc.n_delta else 1)
    pos_bits = width_bits(max(enc.set_size - 1, 1))
    return DeltaMetaWire(
        rep=pack_lane(enc.rep_in_full, rep_bits, entropy, stats),
        counts=pack_lane(enc.counts, counts_bits, entropy, stats),
        pos=pack_lane(enc.pos_flat, pos_bits, entropy, stats),
        val=pack_chunk(enc.val_flat, entropy, stats))
