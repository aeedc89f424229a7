"""Static-table interleaved-rANS entropy codec for the wire's lanes (host).

A copy of ``tse1m_tpu/cluster/entropy.py``.  Bit-packing ships every lane
at the minimal fixed width its value range needs, but the delta lanes are
skewed within that range (counts, base references), so a fixed width
leaves the gap to the lane's order-0 entropy on the table.  Here per-lane
frequency tables are measured on the host, normalized to a 2^12 grid and
shipped with the lane; symbols stream through ``N_STREAMS`` interleaved
rANS states, one per lane of a warp on the card
(``kernels/rans.py``, ``kernels/csrc/rans.cu``), and the frame is
CRC-checked right before it is copied to the card.

The codec is honest: :func:`encode_lane` estimates the coded size from the
measured entropy and returns ``None`` unless tables and payload beat the
bit-packed form by a margin (then re-checks the measured size), so uniform
lanes such as quantized ids ship bit-packed and wire v3 never grows the
transfer.  :func:`decode_lane_host` is the numpy oracle of the decoders.

rANS invariants (32-bit state, 16-bit renormalization, 12-bit
frequencies): the state lives in ``[2^16, 2^32)``; encoding symbol ``s``
of frequency ``f`` needs ``x < ((L >> 12) << 16) * f``, so at most one
16-bit word is emitted per symbol and decode consumes at most one.

The frame's CRC is zlib's CRC-32: the frame never leaves the process, so
the JAX package's optional CRC-32C gives nothing more here.
"""

from __future__ import annotations

from dataclasses import dataclass
from zlib import crc32

import numpy as np

PROB_BITS = 12                 # frequency grid: tables normalize to 2^12
_M = 1 << PROB_BITS
RANS_L = 1 << 16               # state lower bound; words are 16-bit
N_STREAMS = 32                 # interleaved states = one warp's lanes
# Direct symbol coding up to this width (table = 2^bits entries); wider
# values split into 8-bit byte planes, each its own 256-symbol stream.
_DIRECT_BITS_MAX = 12
# The coded frame (payload + tables + states) must beat the bit-packed
# lane by at least this many bytes, or the caller ships the plain pack.
WIN_MIN_SAVE_BYTES = 64


class EntropyFrameError(ValueError):
    """A coded lane's CRC frame does not match its arrays (memory
    corruption between encode and the copy to the card)."""


@dataclass(frozen=True)
class PlaneCode:
    """One symbol stream's coded form: the arrays that cross the wire."""

    words: np.ndarray   # [W] uint16: interleaved renormalization words
    x0: np.ndarray      # [N_STREAMS] uint32: initial decoder states
    freqs: np.ndarray   # [alphabet] uint16: normalized frequency table

    @property
    def nbytes(self) -> int:
        return int(self.words.nbytes + self.x0.nbytes + self.freqs.nbytes)


@dataclass(frozen=True)
class EntropyLane:
    """A lane's coded frame: per-plane streams and a CRC.

    ``bits`` is the logical value width (the bit-packed alternative's);
    values are the little-endian combination of the planes.  ``n`` is the
    value count."""

    n: int
    bits: int
    planes: tuple          # tuple[PlaneCode, ...]
    crc: int

    @property
    def nbytes(self) -> int:
        return int(sum(p.nbytes for p in self.planes))

    def wire_arrays(self) -> list:
        """The arrays copied to the card, in the order the decoders read
        them: (words, x0, freqs) per plane."""
        out: list = []
        for p in self.planes:
            out += [p.words, p.x0, p.freqs]
        return out


def packed_nbytes(n: int, bits: int) -> int:
    """Size of the bit-packed alternative (encode.pack_bits_host)."""
    return (n * bits + 7) // 8


def _lane_crc(n: int, bits: int, planes: tuple) -> int:
    crc = crc32(np.asarray([n, bits], np.int64).tobytes(), 0)
    for p in planes:
        crc = crc32(np.ascontiguousarray(p.words).tobytes(), crc)
        crc = crc32(np.ascontiguousarray(p.x0).tobytes(), crc)
        crc = crc32(np.ascontiguousarray(p.freqs).tobytes(), crc)
    return int(crc) & 0xFFFFFFFF


def verify_frame(lane: EntropyLane) -> None:
    """Re-check the frame right before its arrays are copied: a byte
    flipped between encode and the copy must refuse, not decode garbage."""
    have = _lane_crc(lane.n, lane.bits, lane.planes)
    if have != lane.crc:
        raise EntropyFrameError(
            f"entropy lane frame mismatch: crc {have:#010x} != recorded "
            f"{lane.crc:#010x} (n={lane.n}, bits={lane.bits}): buffer "
            "corrupted between encode and copy")


def normalize_freqs(counts: np.ndarray) -> np.ndarray:
    """Scale integer symbol counts to a table summing exactly to 2^12,
    every present symbol >= 1.  Deterministic."""
    counts = np.asarray(counts, np.int64)
    total = int(counts.sum())
    if total <= 0:
        raise ValueError("normalize_freqs needs at least one symbol")
    f = (counts * _M // total).astype(np.int64)
    f[(counts > 0) & (f == 0)] = 1
    err = int(f.sum()) - _M
    if err != 0:
        # Settle the rounding debt against the largest entries (never
        # below 1): bounded and deterministic.
        order = np.argsort(-f, kind="stable")
        i = 0
        while err != 0:
            j = order[i % order.size]
            if err > 0 and f[j] > 1:
                f[j] -= 1
                err -= 1
            elif err < 0 and f[j] > 0:
                f[j] += 1
                err += 1
            i += 1
    return f.astype(np.uint16)


def _cumcount(a: np.ndarray, k: int) -> np.ndarray:
    """For each element, how many earlier elements share its value."""
    order = np.argsort(a, kind="stable")
    counts = np.bincount(a, minlength=k)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ranks = np.empty(a.size, np.int64)
    ranks[order] = np.arange(a.size) - np.repeat(starts, counts)
    return ranks


def rans_encode(sym: np.ndarray, freqs: np.ndarray,
                ) -> tuple[np.ndarray, np.ndarray]:
    """Encode ``sym`` (uint32, < alphabet) -> (words uint16, x0 uint32).

    Symbol i belongs to stream i % K at step i // K; each stream encodes
    its symbols in reverse, and the emitted words interleave into one flat
    array in the order the forward-running decoder consumes them, so the
    decoder needs one shared pointer and no per-stream offsets."""
    k = N_STREAMS
    n = int(sym.size)
    if n == 0:
        return (np.zeros(0, np.uint16),
                np.full(k, RANS_L, np.uint32))
    steps = -(-n // k)
    cum = np.zeros(freqs.shape[0] + 1, np.uint64)
    cum[1:] = np.cumsum(freqs.astype(np.uint64))
    f64 = freqs.astype(np.uint64)
    sym = np.ascontiguousarray(sym, np.uint32)
    x = np.full(k, RANS_L, np.uint64)
    flags = np.zeros((steps, k), bool)
    buf = np.zeros((k, steps + 1), np.uint16)
    wc = np.zeros(k, np.int64)
    ks = np.arange(k)
    for t in range(steps - 1, -1, -1):
        idx = t * k + ks
        act = idx < n
        s = sym[np.minimum(idx, n - 1)]
        f = f64[s]
        xmax = np.uint64((RANS_L >> PROB_BITS) << 16) * f
        emit = act & (x >= xmax)
        if emit.any():
            rows = ks[emit]
            buf[rows, wc[rows]] = (x[emit] & np.uint64(0xFFFF)).astype(
                np.uint16)
            wc[rows] += 1
            x[emit] >>= np.uint64(16)
            flags[t, emit] = True
        with np.errstate(divide="ignore"):
            xn = ((x // np.maximum(f, 1)) << np.uint64(PROB_BITS)) \
                + (x % np.maximum(f, 1)) + cum[s]
        x = np.where(act, xn, x)
    # Decode consumes at step t for stream k1 iff flags[t, k1]; a stream's
    # words in consumption order are its emitted words reversed.
    pos = np.flatnonzero(flags.ravel())          # ascending (t, stream)
    stream = (pos % k).astype(np.int64)
    occ = _cumcount(stream, k)                   # consumption rank
    cnt = np.bincount(stream, minlength=k)
    words = buf[stream, cnt[stream] - 1 - occ]
    return np.ascontiguousarray(words, np.uint16), x.astype(np.uint32)


def rans_decode_host(words: np.ndarray, x0: np.ndarray, freqs: np.ndarray,
                     n: int) -> np.ndarray:
    """Numpy oracle of the decoders; inverse of rans_encode."""
    k = N_STREAMS
    if n == 0:
        return np.zeros(0, np.uint32)
    steps = -(-n // k)
    cumi = np.cumsum(freqs.astype(np.uint64))
    cume = np.concatenate([[np.uint64(0)], cumi[:-1]])
    slot_sym = np.searchsorted(cumi, np.arange(_M), side="right").astype(
        np.int64)
    f64 = freqs.astype(np.uint64)
    x = x0.astype(np.uint64).copy()
    ks = np.arange(k)
    out = np.empty((steps, k), np.uint32)
    ptr = 0
    words = np.asarray(words, np.uint64)
    for t in range(steps):
        act = (t * k + ks) < n
        slot = x & np.uint64(_M - 1)
        s = slot_sym[slot.astype(np.int64)]
        out[t] = s
        xn = f64[s] * (x >> np.uint64(PROB_BITS)) + slot - cume[s]
        x = np.where(act, xn, x)
        need = act & (x < RANS_L)
        rows = np.flatnonzero(need)
        if rows.size:
            w = words[ptr:ptr + rows.size]
            x[rows] = (x[rows] << np.uint64(16)) | w
            ptr += rows.size
    return out.reshape(-1)[:n]


def _plane_symbols(vals: np.ndarray, bits: int) -> list[tuple[np.ndarray,
                                                              int]]:
    """Split values into per-plane symbol streams: direct symbols up to
    _DIRECT_BITS_MAX, little-endian byte planes above."""
    v = np.ascontiguousarray(vals, np.uint32).reshape(-1)
    if bits <= _DIRECT_BITS_MAX:
        return [(v, 1 << bits)]
    nb = (bits + 7) // 8
    return [(((v >> np.uint32(8 * p)) & np.uint32(0xFF)), 256)
            for p in range(nb)]


def _entropy_bits(counts: np.ndarray) -> float:
    """Order-0 entropy (bits/symbol) of a count vector."""
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts[counts > 0] / total
    return float(-(p * np.log2(p)).sum())


def encode_lane(vals: np.ndarray, bits: int,
                force: bool = False) -> EntropyLane | None:
    """Entropy-code a lane of ``bits``-wide values, or None when the frame
    would not beat the bit-packed form (``force`` codes regardless).

    Two gates: a cheap entropy estimate skips the encoder for
    near-uniform lanes, then the measured frame size is re-checked."""
    v = np.ascontiguousarray(vals, np.uint32).reshape(-1)
    n = int(v.size)
    if bits < 1 or bits > 32:
        raise ValueError(f"lane width must be in [1, 32], got {bits}")
    if n == 0:
        if not force:
            return None
        planes = []
        for _, alphabet in _plane_symbols(v, bits):
            freqs = np.zeros(alphabet, np.uint16)
            freqs[0] = _M
            planes.append(PlaneCode(words=np.zeros(0, np.uint16),
                                    x0=np.full(N_STREAMS, RANS_L,
                                               np.uint32),
                                    freqs=freqs))
        planes = tuple(planes)
        return EntropyLane(n=0, bits=bits, planes=planes,
                           crc=_lane_crc(0, bits, planes))
    packed = packed_nbytes(n, bits)
    specs = _plane_symbols(v, bits)
    counts = [np.bincount(s, minlength=a) for s, a in specs]
    if not force:
        est = sum(n * _entropy_bits(c) / 8 for c in counts)
        header = sum(2 * a + 4 * N_STREAMS for _, a in specs)
        if est + header + WIN_MIN_SAVE_BYTES >= packed:
            return None
    planes = []
    for (s, _alphabet), c in zip(specs, counts):
        freqs = normalize_freqs(c)
        words, x0 = rans_encode(s, freqs)
        planes.append(PlaneCode(words=words, x0=x0, freqs=freqs))
    planes = tuple(planes)
    lane = EntropyLane(n=n, bits=bits, planes=planes,
                       crc=_lane_crc(n, bits, planes))
    if not force and lane.nbytes + WIN_MIN_SAVE_BYTES >= packed:
        return None  # the estimate was too low (table overhead)
    return lane


def decode_lane_host(lane: EntropyLane) -> np.ndarray:
    """Reference decoder: the device decoders' numpy oracle."""
    verify_frame(lane)
    out = np.zeros(lane.n, np.uint32)
    for p, pc in enumerate(lane.planes):
        plane = rans_decode_host(pc.words, pc.x0, pc.freqs, lane.n)
        out |= plane << np.uint32(8 * p if lane.bits > _DIRECT_BITS_MAX
                                  else 0)
    return out
