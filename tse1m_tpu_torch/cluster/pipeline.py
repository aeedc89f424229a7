"""End-to-end session clustering on one GPU: the cold, storeless path.

Items [N, S] -> host prefilter (drops rows that can collide with nothing)
-> wire plan (quantization, the base-delta lane) -> adaptive-width or
rANS-coded wire chunks -> signatures and band keys of the run's scheme
(kminhash, cminhash or weighted; the CUDA kernels) -> bucket reps ->
verified edges -> propagated labels.  A port of
the single-host wire v3 flow of ``tse1m_tpu/cluster/pipeline.py``: the same
``ClusterParams`` and defaults, the same wire plan and chunk cuts, and
labels equal to the JAX package's element for element.

Chunks stream double-buffered: a producer thread packs chunk k+1 into
pinned host memory and copies it to the card on a side stream while the
main thread computes on chunk k.  The producer waits for the copy's event
before it hands the chunk over, as the JAX pipeline's producer blocks on
its ``device_put``: the wait gives the h2d stage its wall and holds the
producer to one chunk ahead.  Byte-width chunks of the plain lane go to
the packed kernel, which reads the wire bytes directly (the one-permutation
schemes decode them first); sub-byte chunks are decoded by
``_unpack_bits`` and rANS-coded chunks by the rANS kernel, and go to the
uint32 kernel (kminhash) or the bin-min kernel (cminhash, weighted).

On the encoded path the full lane streams as above and stays decoded on
the card; the delta lane's metadata (mask, base references, counts,
positions, values) follows in one staged copy, is decoded on the card
(``_decode_delta_meta``) and hashed, and the labels come back in original
row order (``_cluster_encoded_labels``).

Levers of ``ClusterParams`` this port does not carry yet raise
``NotImplementedError`` naming their ROADMAP.md item; the watchdog, the OOM
ladder, the CPU failover and the calibrated quantization floor of the JAX
pipeline are not ported (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import U32_MASK, narrow, resolve_device, widen
from .encode import (_AUTO_MIN_BYTES, _AUTO_MIN_DELTA_FRACTION,
                     _AUTO_QUANT_BITS, ChunkWire, chunk_wire_bits,
                     encode_delta, pack_chunk, pack_delta_meta, quantize_ids,
                     width_bits)
from .entropy import verify_frame
from .kernels.rans import decode_lane_device, decode_lanes_device
from .lsh import bucket_representatives, estimated_jaccard, propagate_labels
from .observability import StageRecorder
from .prefilter import N_BANDS as PREFILTER_BANDS
from .prefilter import collide_mask
from .schemes import (get_scheme, make_params, scheme_sig_and_keys,
                      scheme_sig_and_keys_packed)


@dataclass(frozen=True)
class ClusterParams:
    """The JAX package's ClusterParams, field for field and with the same
    defaults, less ``use_pallas`` (dispatch here follows the device)."""

    n_hashes: int = 128
    n_bands: int = 16
    threshold: float = 0.5       # min estimated Jaccard to accept an edge
    n_iters: int = 12            # label-propagation safety cap
    seed: int = 0
    block_n: int = 512           # chunk cuts land on multiples of this
    h2d_chunks: int = 0          # 0 = auto (one per _CHUNK_BYTES), 1 = off
    overlap: bool = True         # producer-thread double buffering
    encoding: str = "auto"       # auto | delta | pack24 (plain lane)
    wire_quant_bits: int = 0     # 0 = auto, -1 = never, 1..32 = forced
    sig_store: str | None = None
    merge_max_novel: float = 0.05
    prefilter: str = "auto"      # auto | off | on
    entropy: str = "auto"        # auto | off | force
    scheme: str = "kminhash"


# Stats of the last cluster_sessions call (encoding, lane sizes, wire
# quantization, chunk widths, wire bytes, prefilter and wire v3 savings,
# per-stage walls under "stages").  A plain dict, overwritten per call.
last_run_info: dict = {}

# One chunk per _CHUNK_BYTES of items, capped at _MAX_CHUNKS.
_CHUNK_BYTES = 48 * 1024 * 1024
_MAX_CHUNKS = 4

# numpy wire dtypes -> the torch dtype carrying the same bits on the card.
_WIRE_DTYPES = {np.dtype(np.uint8): torch.uint8,
                np.dtype(np.uint16): torch.int16,
                np.dtype(np.uint32): torch.int32}
_ALIGN = 16  # byte alignment of each array in a staged copy


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tse1m_tpu_torch yet (ROADMAP.md Queue 1 "
        f"item {item})")


def _validate_encoding(params: ClusterParams) -> None:
    """Reject unknown lever values and invalid combinations (ValueError, as
    the JAX package), then the levers this port does not carry
    (NotImplementedError)."""
    get_scheme(params.scheme)
    if params.encoding not in ("auto", "delta", "pack24"):
        raise ValueError(f"unknown encoding {params.encoding!r}; "
                         "expected auto | delta | pack24")
    if params.entropy not in ("auto", "off", "force"):
        raise ValueError(f"unknown entropy mode {params.entropy!r}; "
                         "expected auto | off | force")
    if params.prefilter not in ("auto", "off", "on"):
        raise ValueError(f"unknown prefilter mode {params.prefilter!r}; "
                         "expected auto | off | on")
    if params.prefilter == "on" and params.sig_store:
        raise ValueError(
            "ClusterParams.prefilter='on' is storeless-only: the store "
            "must cache a signature for every row, and prefiltered rows "
            "never compute one. Use prefilter='auto' (which disables "
            "itself under a sig_store) or drop the store.")
    if params.prefilter == "on" and params.threshold <= 0:
        raise ValueError(
            "ClusterParams.prefilter='on' needs threshold > 0: with no "
            "signature verification every proposed edge is accepted, so "
            "bucket isolation proves nothing about labels.")
    if params.sig_store:
        raise _not_ported("sig_store (the warm path)", "9")


def _quant_bits(items: np.ndarray, params: ClusterParams) -> int:
    """Effective wire_quant_bits under the policy; 0 = off or no gain."""
    b = params.wire_quant_bits
    if b < 0 or items.size == 0:
        return 0
    if b == 0:
        b = _AUTO_QUANT_BITS if items.nbytes >= _AUTO_MIN_BYTES else 0
    if b and width_bits(int(items.max())) <= b:
        b = 0  # already at or below the target universe
    return b


def _maybe_encode(items: np.ndarray, params: ClusterParams):
    """Apply the ClusterParams.encoding policy; None = ship plain lanes."""
    if params.encoding == "pack24":
        return None
    if params.encoding == "auto" and items.nbytes < _AUTO_MIN_BYTES:
        return None
    frac = _AUTO_MIN_DELTA_FRACTION if params.encoding == "auto" else 0.0
    return encode_delta(items, min_delta_fraction=frac)


def _plan_wire(items: np.ndarray, params: ClusterParams,
               qbits_override: int | None = None):
    """(items, enc, qbits): the single-host wire plan.

    ``qbits_override``: the quantization decided over the full row set, so
    prefiltered rows ship in the universe the unfiltered run would use.
    The delta sketch groups the raw ids (a quantized universe collapses its
    hash keys); quantization then applies to whatever ships (the full and
    value lanes, or the plain chunks).  quantize_ids is per-value
    deterministic, so delta decode gives exactly ``quantize_ids(items)``."""
    enc = _maybe_encode(items, params)
    qbits = (qbits_override if qbits_override is not None
             else _quant_bits(items, params))
    if qbits:
        if enc is not None:
            enc = replace(enc,
                          full_rows=quantize_ids(enc.full_rows, qbits),
                          val_flat=quantize_ids(enc.val_flat, qbits))
        else:
            items = quantize_ids(items, qbits)
    return items, enc, qbits


def _stream_plan(items: np.ndarray, params: ClusterParams) -> int:
    """Chunk step in rows.  step >= n means one shot; chunks land on
    block_n boundaries."""
    n = items.shape[0]
    n_chunks = params.h2d_chunks
    if n_chunks == 0:
        n_chunks = int(min(_MAX_CHUNKS, max(1, items.nbytes // _CHUNK_BYTES)))
    if n_chunks <= 1 or n < 2 * params.block_n:
        return max(n, 1)
    step = -(-n // n_chunks)
    return -(-step // params.block_n) * params.block_n


def _row_chunks(rows: np.ndarray, step: int) -> list:
    return [rows[i:i + step] for i in range(0, max(rows.shape[0], 1), step)]


def _unpack_bits(packed: torch.Tensor, n: int, bits: int,
                 offset: int) -> torch.Tensor:
    """uint8 bit stream -> [n] int32 ids (uint32 bits): value i at stream
    bits [i*bits, (i+1)*bits), little-endian, plus the offset mod 2^32.
    Inverse of encode.pack_bits_host.  Byte-multiple widths combine bytes;
    other widths gather the 5 bytes a value's window can span (index-
    clamped at the tail; the clamped bytes fall above the width mask)."""
    if n == 0:
        return torch.zeros(0, dtype=torch.int32, device=packed.device)
    if bits % 8 == 0:
        k = bits // 8
        b = packed[:n * k].reshape(n, k).to(torch.int64)
        out = b[:, 0]
        for j in range(1, k):
            out = out | (b[:, j] << (8 * j))
    else:
        start = torch.arange(n, dtype=torch.int64, device=packed.device) * bits
        byte0 = start >> 3
        last = packed.shape[0] - 1
        word = torch.zeros(n, dtype=torch.int64, device=packed.device)
        for j in range(5):
            idx = torch.clamp(byte0 + j, max=last)
            word |= packed[idx].to(torch.int64) << (8 * j)
        out = (word >> (start & 7)) & ((1 << bits) - 1)
    return narrow((out + int(offset)) & U32_MASK)


def _offset_ids(flat: torch.Tensor, wire: ChunkWire) -> torch.Tensor:
    """A coded chunk's decoded symbols -> its ids: plus the offset mod 2^32,
    in wire.shape."""
    if wire.offset:
        flat = narrow((widen(flat) + wire.offset) & U32_MASK)
    return flat.reshape(wire.shape)


def _decode_wire(arrays_d: tuple, wire: ChunkWire) -> torch.Tensor:
    """Device copies of ``wire.wire_arrays()`` + header -> decoded int32
    ids of wire.shape.  rANS-coded chunks decode through the rANS kernel,
    then the offset is added; bit streams through _unpack_bits."""
    if wire.ent is not None:
        return _offset_ids(decode_lane_device(wire.ent, arrays_d), wire)
    return _unpack_bits(arrays_d[0], wire.n_values, wire.bits,
                        wire.offset).reshape(wire.shape)


def _put(arrays: list, device: torch.device,
         copy_stream: torch.cuda.Stream | None) -> tuple:
    """Device tensors of host wire arrays, in one staged copy: the arrays
    are laid out 16-byte aligned in one host buffer (pinned on the card),
    copied with non_blocking on the side stream, and viewed back per array
    (uint16 as int16, uint32 as int32 bits).  On the card this (producer)
    thread waits for the copy's event, so the pinned buffer is never reused
    before its copy is done and the data is on the card when the compute
    stream reads it."""
    offsets, total = [], 0
    for a in arrays:
        offsets.append(total)
        total += -(-a.nbytes // _ALIGN) * _ALIGN
    host = torch.empty(total, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    staged = host.numpy()
    for a, off in zip(arrays, offsets):
        staged[off:off + a.nbytes] = np.ascontiguousarray(a).reshape(
            -1).view(np.uint8)
    if device.type == "cpu":
        buf = host
    else:
        with torch.cuda.stream(copy_stream):
            buf = torch.empty(total, dtype=torch.uint8, device=device)
            buf.copy_(host, non_blocking=True)
            done = torch.cuda.Event()
            done.record(copy_stream)
        done.synchronize()
    return tuple(buf[off:off + a.nbytes].view(_WIRE_DTYPES[a.dtype])
                 for a, off in zip(arrays, offsets))


def _produce_chunk(chunk: np.ndarray, rec: StageRecorder,
                   device: torch.device,
                   copy_stream: torch.cuda.Stream | None, entropy: str):
    """Host half of one chunk: adaptive pack or rANS code (encode stage;
    the codec's seconds also under entropy) and the copy to the device
    (h2d stage).  A coded frame's CRC is checked right before the copy."""
    t0 = time.perf_counter()
    stats: dict = {}
    wire = pack_chunk(chunk, entropy=entropy, stats=stats)
    if wire.ent is not None:
        verify_frame(wire.ent)
    rec.add("encode", time.perf_counter() - t0, wire.nbytes)
    if stats.get("entropy_s"):
        # The entropy stage's bytes count bytes saved against the
        # bit-packed alternative.
        rec.add("entropy", stats["entropy_s"],
                stats.get("entropy_saved_bytes", 0))
    t0 = time.perf_counter()
    arrays_d = _put(wire.wire_arrays(), device, copy_stream)
    rec.add("h2d", time.perf_counter() - t0, wire.nbytes)
    return arrays_d, wire


def _iter_streamed(chunks: list, rec: StageRecorder, overlap: bool,
                   device: torch.device,
                   copy_stream: torch.cuda.Stream | None, entropy: str):
    """Yield (device arrays, ChunkWire) per chunk.  With overlap on and
    more than one chunk, chunk k+1 is packed and copied on a single producer
    thread while the caller computes on chunk k."""
    if not overlap or len(chunks) <= 1:
        for c in chunks:
            yield _produce_chunk(c, rec, device, copy_stream, entropy)
        return
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tse1m-h2d")
    try:
        fut = ex.submit(_produce_chunk, chunks[0], rec, device, copy_stream,
                        entropy)
        for k in range(len(chunks)):
            cur = fut.result()
            if k + 1 < len(chunks):
                fut = ex.submit(_produce_chunk, chunks[k + 1], rec, device,
                                copy_stream, entropy)
            yield cur
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _mark_used(arrays_d: tuple, device: torch.device) -> None:
    """Arrays allocated on the copy stream are read on this one."""
    if device.type == "cuda":
        for t in arrays_d:
            t.record_stream(torch.cuda.current_stream(device))


def _chunk_minhash(arrays_d: tuple, wire: ChunkWire, hp,
                   params: ClusterParams, rec: StageRecorder,
                   device: torch.device, want_decoded: bool):
    """One chunk's device half (compute stage): byte-width bit-packed
    chunks go to the packed kernel unless ``want_decoded`` (the encoded
    path keeps the decoded full-lane rows on the card for the delta
    decode); the rest are decoded and go to the uint32 kernel.  Returns
    (sig, keys, decoded ids or None)."""
    with rec.stage("compute"):
        _mark_used(arrays_d, device)
        decoded = None
        if wire.ent is not None or want_decoded or wire.bits % 8 != 0:
            decoded = _decode_wire(arrays_d, wire)
            sig, keys = scheme_sig_and_keys(decoded, hp, params.n_bands)
        else:
            sig, keys = scheme_sig_and_keys_packed(
                arrays_d[0], wire.shape, wire.bits // 8, wire.offset, hp,
                params.n_bands)
        _sync(device)
    return sig, keys, decoded


def _minhash_streamed(rows: np.ndarray, hp, params: ClusterParams,
                      rec: StageRecorder, device: torch.device,
                      want_decoded: bool):
    """rows -> (per-chunk (sig, keys), decoded chunks or None, per-chunk
    wire bits), encode and H2D of the next chunk overlapping compute on
    this one.  MinHash is row-independent, so the chunking never changes
    the result."""
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    parts, decoded, wire_bits = [], [], []
    for arrays_d, wire in _iter_streamed(
            _row_chunks(rows, _stream_plan(rows, params)), rec,
            params.overlap, device, copy_stream, params.entropy):
        sig, keys, dec = _chunk_minhash(arrays_d, wire, hp, params, rec,
                                        device, want_decoded)
        parts.append((sig, keys))
        if want_decoded:
            decoded.append(dec)
        wire_bits.append(wire.bits)
    return parts, (decoded if want_decoded else None), wire_bits


def _cat(parts: list) -> torch.Tensor:
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _cluster_from_sig(sig: torch.Tensor, keys: torch.Tensor,
                      threshold: float, n_iters: int) -> torch.Tensor:
    """Signatures and band keys -> [N] int32 labels on their device."""
    reps = bucket_representatives(keys)
    est = estimated_jaccard(sig, reps)
    self_idx = torch.arange(sig.shape[0], device=sig.device)[:, None]
    valid = (est >= threshold) & (reps != self_idx)
    return propagate_labels(reps, valid, n_iters=n_iters)


def _decode_delta_raw(full_d: torch.Tensor, rep: torch.Tensor,
                      counts: torch.Tensor, pos: torch.Tensor,
                      vals: torch.Tensor) -> torch.Tensor:
    """Delta lane -> [D, S] int32 rows on the device: gather each delta
    row's base from the decoded full lane, then write its (position,
    value) diffs.  The flat diff stream is CSR: per-row counts cumsum to
    offsets, and each diff finds its row by searchsorted."""
    offsets = torch.cumsum(counts.to(torch.int64), 0)
    t = torch.arange(pos.shape[0], dtype=torch.int64, device=pos.device)
    row = torch.searchsorted(offsets, t, right=True)
    base = full_d[rep.to(torch.int64)]
    base.index_put_((row, pos.to(torch.int64)), vals)
    return base


def _cluster_encoded_labels(sig: torch.Tensor, keys: torch.Tensor,
                            mask_bytes: torch.Tensor, n: int,
                            threshold: float, n_iters: int):
    """Cluster rows that sit in lane order; returns (labels in original
    order, lane_of), the labels equal to the unencoded path's.

    ``mask_bytes`` is the encoder's 1-bit-per-row membership mask
    (little-endian); cumsums of it give both permutations.  Hub election by
    original index keeps the verified edges, and so the components and
    their min-original-index labels, those of a run without the encoder."""
    shifts = torch.arange(8, device=mask_bytes.device)
    bits = ((mask_bytes.to(torch.int64)[:, None] >> shifts) & 1).reshape(
        -1)[:n]                                    # 1 = delta lane
    n_full = n - bits.sum()
    dr = torch.cumsum(bits, 0) - bits              # exclusive: delta rank
    fr = torch.cumsum(1 - bits, 0) - (1 - bits)
    lane_of = torch.where(bits == 1, n_full + dr, fr)
    orig_of = torch.empty_like(lane_of)
    orig_of[lane_of] = torch.arange(n, device=lane_of.device)
    reps = bucket_representatives(keys, orig=orig_of, lane_of=lane_of)
    est = estimated_jaccard(sig, reps)
    self_idx = torch.arange(n, device=sig.device)[:, None]
    valid = (est >= threshold) & (reps != self_idx)
    lab = propagate_labels(reps, valid, n_iters=n_iters).to(torch.int64)
    cmin = torch.full((n,), n, dtype=torch.int64, device=sig.device)
    cmin.scatter_reduce_(0, lab, orig_of, "amin")
    return cmin[lab][lane_of].to(torch.int32), lane_of


def _put_delta_meta(enc, rec: StageRecorder, entropy: str,
                    device: torch.device):
    """Pack the delta lanes (encode stage; the codec's seconds also under
    entropy) and copy the mask and the rep, counts, pos and val lanes in
    one staged copy (h2d stage; the mask bytes count).  Returns (meta,
    mask_d, rep_d, counts_d, pos_d, val_d), each lane a tuple of device
    arrays in ``wire_arrays()`` order."""
    t0 = time.perf_counter()
    stats: dict = {}
    meta = pack_delta_meta(enc, entropy=entropy, stats=stats)
    lanes = (*meta.lanes(), meta.val)
    for lane in lanes:
        if lane.ent is not None:
            verify_frame(lane.ent)
    nbytes = meta.nbytes + enc.mask_bits.nbytes
    rec.add("encode", time.perf_counter() - t0, nbytes)
    if stats.get("entropy_s"):
        rec.add("entropy", stats["entropy_s"],
                stats.get("entropy_saved_bytes", 0))
    groups = [[enc.mask_bits]] + [lane.wire_arrays() for lane in lanes]
    t0 = time.perf_counter()
    flat = _put([a for g in groups for a in g], device,
                torch.cuda.current_stream(device)
                if device.type == "cuda" else None)
    rec.add("h2d", time.perf_counter() - t0, nbytes)
    out, i = [], 0
    for g in groups:
        out.append(flat[i:i + len(g)])
        i += len(g)
    return (meta, out[0][0], *out[1:])


def _decode_delta_meta(meta, full_d: torch.Tensor, rep_d: tuple,
                       counts_d: tuple, pos_d: tuple,
                       val_d: tuple) -> torch.Tensor:
    """Decode the delta lanes on the device and rebuild the delta rows
    against the resident full lane.  Every coded lane (rep, counts, pos and
    a coded val frame) goes into one launch of the rANS kernel, so their
    chains run side by side; bit streams go through _unpack_bits."""
    lanes = ((meta.rep, rep_d), (meta.counts, counts_d), (meta.pos, pos_d),
             (meta.val, val_d))
    coded = [(lane.ent, arrays) for lane, arrays in lanes
             if lane.ent is not None]
    decoded = iter(decode_lanes_device([c[0] for c in coded],
                                       [c[1] for c in coded]))
    rep, counts, pos = (
        next(decoded) if lane.ent is not None
        else _unpack_bits(arrays[0], lane.n, lane.bits, 0)
        for lane, arrays in lanes[:3])
    vals = (_offset_ids(next(decoded), meta.val) if meta.val.ent is not None
            else _decode_wire(val_d, meta.val)).reshape(-1)
    return _decode_delta_raw(full_d, rep, counts, pos, vals)


def _cluster_encoded(enc, hp, params: ClusterParams, rec: StageRecorder,
                     device: torch.device):
    """Single-host encoded path: stream the full lane chunked and double-
    buffered (keeping the decoded rows on the card), decode the delta lane
    against it, MinHash both, cluster with original-order labels.  Returns
    (labels as numpy int32, sig, keys), sig and keys in row order."""
    parts, chunks_d, wire_bits = _minhash_streamed(
        enc.full_rows, hp, params, rec, device, want_decoded=True)
    full_d = _cat(chunks_d)
    meta, mask_d, rep_d, counts_d, pos_d, val_d = _put_delta_meta(
        enc, rec, params.entropy, device)
    with rec.stage("compute"):
        delta_items = _decode_delta_meta(meta, full_d, rep_d, counts_d,
                                         pos_d, val_d)
        dsig, dkeys = scheme_sig_and_keys(delta_items, hp, params.n_bands)
        sig = torch.cat([p[0] for p in parts] + [dsig])
        keys = torch.cat([p[1] for p in parts] + [dkeys])
        # Nothing before the concatenation is kept through the LSH tail.
        del parts, chunks_d, full_d, delta_items, dsig, dkeys
        labels, lane_of = _cluster_encoded_labels(
            sig, keys, mask_d, enc.n, params.threshold, params.n_iters)
        _sync(device)
    last_run_info["chunk_bits"] = wire_bits
    with rec.stage("d2h", nbytes=labels.numel() * 4):
        out = labels.cpu().numpy()
    return out, sig[lane_of], keys[lane_of]


def _cluster_single_host(items: np.ndarray, hp, params: ClusterParams,
                         rec: StageRecorder, device: torch.device,
                         qbits_override: int | None = None):
    """The storeless single-host pipeline over (possibly prefiltered) rows:
    plan the wire, stream + MinHash + cluster; returns (labels in row order
    as numpy int32, signatures, band keys)."""
    t0 = time.perf_counter()
    items, enc, qbits = _plan_wire(items, params, qbits_override)
    rec.add("encode", time.perf_counter() - t0)
    last_run_info.update(wire_quant_bits=qbits)
    if enc is not None:
        last_run_info.update(
            encoding="delta", encode_s=round(time.perf_counter() - t0, 4),
            n_full=enc.n_full, n_delta=enc.n_delta)
        return _cluster_encoded(enc, hp, params, rec, device)
    last_run_info.update(encoding="plain")
    parts, _, wire_bits = _minhash_streamed(items, hp, params, rec, device,
                                            want_decoded=False)
    last_run_info["chunk_bits"] = wire_bits
    sig = _cat([p[0] for p in parts])
    keys = _cat([p[1] for p in parts])
    del parts  # the per-chunk copies are not kept through the LSH tail
    with rec.stage("compute"):
        labels = _cluster_from_sig(sig, keys, params.threshold,
                                   params.n_iters)
        _sync(device)
    with rec.stage("d2h", nbytes=labels.numel() * 4):
        out = labels.cpu().numpy()
    return out, sig, keys


def _prefilter_mask(items: np.ndarray,
                    params: ClusterParams) -> np.ndarray | None:
    """The prefilter's engagement decision and mask: None = filter off
    (mode, threshold or the auto size gate), else the keep mask over the
    raw rows."""
    if params.prefilter == "off" or params.threshold <= 0:
        return None
    if params.prefilter == "auto" and items.nbytes < _AUTO_MIN_BYTES:
        return None
    return collide_mask(items, params.seed, scheme=params.scheme)


def _prefilter_keep(items: np.ndarray, params: ClusterParams,
                    rec: StageRecorder) -> np.ndarray | None:
    """``_prefilter_mask`` and its telemetry: a keep mask when the filter
    engaged and dropped something, else None."""
    last_run_info.update(prefilter_hit_rate=0.0, prefilter_rows_dropped=0)
    t0 = time.perf_counter()
    keep = _prefilter_mask(items, params)
    if keep is None:
        return None
    rec.add("prefilter", time.perf_counter() - t0)
    n = items.shape[0]
    dropped = int(n - keep.sum())
    last_run_info.update(
        prefilter_hit_rate=round(dropped / max(n, 1), 4),
        prefilter_rows_dropped=dropped, prefilter_bands=PREFILTER_BANDS)
    if dropped == 0:
        return None
    return keep


def _scatter_prefiltered(full_n: int, keep: np.ndarray,
                         out: np.ndarray) -> np.ndarray:
    """Map subset labels back to the full row set: dropped rows label
    themselves (no verified edge can reach them), and kept components'
    minimum index maps back through the sorted kept-index table, so the
    result equals the unfiltered run's min-original-index labels."""
    keep_idx = np.flatnonzero(keep)
    full = np.arange(full_n, dtype=np.int32)
    full[keep_idx] = keep_idx[out].astype(np.int32)
    return full


def _record_wire_v3(items: np.ndarray, qbits: int, keep: np.ndarray | None,
                    rec: StageRecorder) -> None:
    """Wire v3 savings: the entropy column is measured (codec bytes against
    the bit-packed alternative, accrued on the entropy stage); the
    prefilter column is an estimate, dropped rows costed at the run's
    packed width."""
    ent_saved = int(rec.nbytes.get("entropy", 0))
    pf_saved = 0
    if keep is not None and items.size:
        w = qbits or chunk_wire_bits(items)[0]
        dropped = int(items.shape[0] - keep.sum())
        pf_saved = dropped * int(items.shape[1]) * w // 8
    last_run_info.update(
        wire_version=3,
        entropy_saved_mb=round(ent_saved / 2**20, 3),
        prefilter_saved_mb=round(pf_saved / 2**20, 3),
        wire_v3_saved_mb=round((ent_saved + pf_saved) / 2**20, 3))


def cluster_sessions(items, params: ClusterParams | None = None,
                     mesh=None, *, device: str | torch.device = "cuda",
                     return_signatures: bool = False):
    """Cluster [N, S] uint32 session feature sets -> [N] int32 labels.

    Runs on ``device``, the card unless the caller asks for ``"cpu"`` (the
    plain PyTorch versions of the kernels); raises without a card.  With
    ``return_signatures`` it returns ``(labels, sig, keys)``: the [M, H]
    signatures and [M, B] band keys, int32 tensors of uint32 bits on the
    device, of the M rows the prefilter kept (all rows when it dropped
    none), in their row order.  ``mesh`` is accepted for the JAX signature
    and refused."""
    params = params or ClusterParams()
    dev = resolve_device(device)
    _validate_encoding(params)
    if mesh is not None:
        raise _not_ported("a mesh (multi-GPU clustering)", "11")
    items = np.ascontiguousarray(items, dtype=np.uint32)
    hp = make_params(params.scheme, params.n_hashes, params.seed).to(dev)
    rec = StageRecorder()
    t_all = time.perf_counter()
    last_run_info.clear()
    # The prefilter reads the raw ids; the quantization is decided over
    # the full row set, so the kept rows ship in the universe the
    # unfiltered run would use.
    qbits_full = _quant_bits(items, params)
    keep = _prefilter_keep(items, params, rec)
    work = items if keep is None else items[keep]
    out, sig, keys = _cluster_single_host(work, hp, params, rec, dev,
                                          qbits_full)
    if keep is not None:
        out = _scatter_prefiltered(items.shape[0], keep, out)
    last_run_info["wire_mb"] = round(rec.nbytes.get("h2d", 0) / 2**20, 2)
    last_run_info["wire_bytes"] = int(rec.nbytes.get("h2d", 0))
    _record_wire_v3(items, qbits_full, keep, rec)
    rec.set_total(time.perf_counter() - t_all)
    last_run_info["stages"] = rec.as_dict()
    return (out, sig, keys) if return_signatures else out
