"""End-to-end session clustering on one GPU, or over a mesh of ranks: the
cold path and the warm path through a persistent signature store.

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

With ``ClusterParams.sig_store`` a run probes the store
(``cluster/store.py``) for every row by content digest and MinHashes only
the rows it misses.  When the input is the last stored run plus a tail of
at most ``merge_max_novel`` of it, labels merge through the stored band
tables on the host ("merge", ``cluster/incremental.py``); otherwise the
cached signatures go up in one copy, the missed rows stream through the
plain lane, and the banded LSH runs on the card over both in [hit...,
miss...] lane order ("union").  Both give the labels of a cold run, element
for element, and commit what the next run needs.

Every streaming path (the plain lane, the encoded run's full lane, a
store run's missed rows, ``minhash_novel_rows``) goes through the
degradation ladder of ``cluster/ladder.py``, as the JAX package's goes
through ``_stream_minhash_degraded``: an out-of-memory first drops the
storeless wire one step down the b-bit ladder (10, then 8 bits), then
halves the chunk, and the surviving width and chunk size go to the machine
calibration (``utils/calibration.py``), where the next run starts; a stall
of the staged copy (``pipeline.h2d``) or of the compute wait
(``pipeline.compute``) is cancelled by the stage watchdog and retried.
Nothing moves to the CPU: a card that keeps failing is retried a bounded
number of times, then the error is raised, and a sticky CUDA error is
raised at once.  ``cluster_sessions_resumable`` adds chunk checkpoints
(``cluster/checkpoint.py``): a killed run resumes at its first unfinished
chunk.  Storeless runs clamp to the calibrated quantization floor and
chunk size as the JAX pipeline does; store runs never drop or clamp the
width, since the store's policy key carries it.

The device work carries ``torch.profiler`` regions
(``observability.tracing.region``), so a device trace
(``observability.profiling.device_trace``) splits it by stage:
``tse1m.decode`` (unpacking, the rANS decode, the delta rebuild),
``tse1m.minhash`` (signatures and band keys), ``tse1m.lsh`` (the LSH tail)
and ``tse1m.fetch`` (the labels', or a merge's novel signatures', copy
back).  A mesh call adds ``tse1m.consts`` (the hash constants' copy),
``tse1m.sync`` (the wait before the fetch) and the tail's and the mesh's
own (``cluster/lsh.py``, ``parallel/mesh.py``); it records the
propagation's step count, half its ``pmin`` calls, as
``last_run_info["propagate_steps"]``.  Outside a profile a region is one
flag check.

Under a mesh (``cluster_sessions(mesh=)``, ``parallel/``) every rank
hashes its own block of rows, fed as raw ids or the 24-bit byte pack,
and the LSH tail runs band-sharded across the ranks
(``cluster/sharded.py``); every rank gets the labels.

Across processes with a signature store (``cluster_sessions_pod``) no
world starts: each process probes its own rows against the digest-range
sharded store, MinHashes its novel tail on its card, swaps the tails
through files under the store root and runs the single-device LSH tail
over every row on its card.
"""

from __future__ import annotations

import hashlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import U32_MASK, as_u32_numpy, narrow, resolve_device, widen
from ..observability import record_degradation
from ..observability.tracing import region
from ..parallel.mesh import Mesh, pad_to_devices
from ..parallel import multihost
from ..parallel.multihost import ShardedRows
from ..resilience.faults import fault_point
from ..resilience.watchdog import (StageWatchdog, run_with_deadline,
                                   watchdog_enabled)
from ..utils.calibration import (calibration_path, load_calibration,
                                 update_calibration)
from . import incremental as inc
from . import ladder
from .checkpoint import ClusterCheckpoint
from .encode import (_AUTO_MIN_BYTES, _AUTO_MIN_DELTA_FRACTION,
                     _AUTO_QUANT_BITS, ChunkWire, chunk_wire_bits,
                     encode_delta, pack_chunk, pack_delta_meta, quantize_ids,
                     width_bits)
from .entropy import verify_frame
from .host import host_band_keys
from .kernels.rans import decode_lane_device, decode_lanes_device
from .lsh import bucket_representatives, estimated_jaccard, propagate_labels
from .minhash import band_keys
from .observability import StageRecorder
from .prefilter import N_BANDS as PREFILTER_BANDS
from .prefilter import collide_mask
from .schemes import (get_scheme, make_params, scheme_sig_and_keys,
                      scheme_sig_and_keys_packed)
from .sharded import sharded_labels
from .store import (ShardedSignatureStore, SignatureStore, is_sharded_root,
                    row_digests)


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
# The mesh feed packs ids below this into 3 bytes; others ship raw.
_PACK_LIMIT = 1 << 24


def _validate_encoding(params: ClusterParams) -> None:
    """Reject unknown lever values and invalid combinations (ValueError, as
    the JAX package)."""
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


def _quant_bits(items: np.ndarray, params: ClusterParams) -> int:
    """Effective wire_quant_bits under the policy; 0 = off or no gain.

    Storeless runs with ``wire_quant_bits >= 0`` also clamp to the degraded
    floor that an earlier run's quant drop (of either package) persisted to
    the machine calibration (``utils/calibration.py``), so both packages
    ship the same wire on that machine.  Store runs never clamp: the width is part of the
    store's policy key, and a drifting width would refuse the store."""
    b = params.wire_quant_bits
    if b < 0 or items.size == 0:
        return 0
    if b == 0:
        b = _AUTO_QUANT_BITS if items.nbytes >= _AUTO_MIN_BYTES else 0
    width = width_bits(int(items.max()))
    if b and width <= b:
        b = 0  # already at or below the target universe
    if params.sig_store:
        return b
    floor = _degraded_quant_floor()
    if floor and (b == 0 or floor < b) and width > floor:
        return floor
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
    """Chunk step in rows, shared by the streamed and resumable paths so
    their chunks align.  step >= n means one shot; chunks land on block_n
    boundaries; a chunk size that survived an earlier run's out-of-memory
    halving (the machine calibration) clamps the step."""
    n = items.shape[0]
    n_chunks = params.h2d_chunks
    if n_chunks == 0:
        n_chunks = int(min(_MAX_CHUNKS, max(1, items.nbytes // _CHUNK_BYTES)))
    if n_chunks <= 1 or n < 2 * params.block_n:
        step = max(n, 1)
    else:
        step = -(-n // n_chunks)
        step = -(-step // params.block_n) * params.block_n
    return _apply_calibrated_step(step, items, params)


def _apply_calibrated_step(step: int, items: np.ndarray,
                           params: ClusterParams) -> int:
    """Clamp the planned step to the calibrated surviving chunk size."""
    if items.size == 0:
        return step
    cal_bytes = load_calibration(calibration_path())["wire"].get(
        "chunk_bytes")
    if not cal_bytes:
        return step
    row_bytes = int(items.shape[1]) * items.itemsize
    cal_step = max(1, int(cal_bytes) // max(row_bytes, 1))
    if cal_step >= step:
        return step
    if cal_step >= 2 * params.block_n:
        cal_step = (cal_step // params.block_n) * params.block_n
    return max(cal_step, 1)


# -- the degradation ladder's rungs (the ladder itself: ladder.py) ----------

def _halved_step(step: int, params: ClusterParams) -> int | None:
    """The next rung down the chunk-size ladder; None when out of rungs."""
    if step <= 16:
        return None
    new = -(-step // 2)
    if new >= 2 * params.block_n:
        new = (new // params.block_n) * params.block_n
    return new if new < step else None


def _persist_chunk_bytes(step: int, items: np.ndarray) -> None:
    """Record the surviving chunk size, so the next run's _stream_plan
    starts below the observed memory ceiling."""
    if items.size == 0:
        return
    row_bytes = int(items.shape[1]) * items.itemsize
    update_calibration(calibration_path(),
                       wire={"chunk_bytes": int(step) * row_bytes})


# The quant rung, tried before halving on storeless streams: one step down
# the b-bit-minwise ladder (8-10 bits keep the clustering's accuracy).
_QUANT_RUNGS = (10, 8)


def _next_quant_rung(bits: int) -> int | None:
    """One step down the quantization ladder; None when out of rungs.
    ``bits <= 0`` (quantization off) engages the first rung."""
    for rung in _QUANT_RUNGS:
        if bits <= 0 or rung < bits:
            return rung
    return None


def _degraded_quant_floor() -> int:
    """The persisted degraded wire width (0 = none)."""
    v = load_calibration(calibration_path())["wire"].get("quant_bits")
    return int(v) if v else 0


def _persist_quant_bits(bits: int) -> None:
    update_calibration(calibration_path(), wire={"quant_bits": int(bits)})


def _restore_quant_bits() -> None:
    """The device healed: clear the degraded floor, so the next run ships
    full-fidelity ids again."""
    update_calibration(calibration_path(), wire={"quant_bits": None})


def _make_watchdog() -> StageWatchdog:
    """A run's stage watchdog, its H2D budget seeded from the calibrated
    link rate (``wire.h2d_MBps``) when there is one."""
    seed = {}
    mbps = load_calibration(calibration_path())["wire"].get("h2d_MBps")
    if mbps:
        seed["h2d"] = float(mbps) * 1e6
    return StageWatchdog(seed_rates=seed)


def _compute_budget_s() -> float:
    """Deadline of one chunk's compute wait (a hung kernel); 0 disables."""
    if not watchdog_enabled():
        return 0.0
    return float(os.environ.get("TSE1M_WATCHDOG_COMPUTE_BUDGET_S", 600.0))


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
                   copy_stream: torch.cuda.Stream | None, entropy: str,
                   wd: StageWatchdog | None = None):
    """Host half of one chunk: adaptive pack or rANS code (encode stage;
    the codec's seconds also under entropy) and the copy to the device
    (h2d stage).  A coded frame's CRC is checked right before the copy.
    With a watchdog the copy runs under the adaptive H2D deadline (the
    ``pipeline.h2d`` seat): a stalled attempt is abandoned and retried.
    Each attempt stages into a buffer of its own, so an abandoned copy
    never shares one with its retry; the h2d wall and bytes record once a
    chunk."""
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

    def put():
        fault_point("pipeline.h2d")
        return _put(wire.wire_arrays(), device, copy_stream)

    t0 = time.perf_counter()
    arrays_d = (wd.guarded_call("h2d", put, nbytes=wire.nbytes,
                                site="pipeline.h2d")
                if wd is not None else put())
    rec.add("h2d", time.perf_counter() - t0, wire.nbytes)
    return arrays_d, wire


def _iter_streamed(chunks: list, rec: StageRecorder, overlap: bool,
                   device: torch.device,
                   copy_stream: torch.cuda.Stream | None, entropy: str,
                   wd: StageWatchdog | None = None):
    """Yield (device arrays, ChunkWire) per chunk.  With overlap on and
    more than one chunk, chunk k+1 is packed and copied on a single producer
    thread while the caller computes on chunk k.  Closing the generator
    waits for the producer, so a chunk it staged is dropped with it."""
    if not overlap or len(chunks) <= 1:
        for c in chunks:
            yield _produce_chunk(c, rec, device, copy_stream, entropy, wd)
        return
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tse1m-h2d")
    try:
        fut = ex.submit(_produce_chunk, chunks[0], rec, device, copy_stream,
                        entropy, wd)
        for k in range(len(chunks)):
            cur = fut.result()
            if k + 1 < len(chunks):
                fut = ex.submit(_produce_chunk, chunks[k + 1], rec, device,
                                copy_stream, entropy, wd)
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
    decode); the rest are decoded and go to the uint32 kernel.  The
    completion wait runs under the compute deadline (the
    ``pipeline.compute`` seat): a hung kernel surfaces as a StallError the
    ladder retries.  The wait is on an event recorded on this thread's
    stream, so the worker thread waits for this stream's work.  Returns
    (sig, keys, decoded ids or None)."""
    with rec.stage("compute"):
        _mark_used(arrays_d, device)
        decoded = None
        if wire.ent is not None or want_decoded or wire.bits % 8 != 0:
            with region("tse1m.decode"):
                decoded = _decode_wire(arrays_d, wire)
            with region("tse1m.minhash"):
                sig, keys = scheme_sig_and_keys(decoded, hp, params.n_bands)
        else:
            with region("tse1m.minhash"):
                sig, keys = scheme_sig_and_keys_packed(
                    arrays_d[0], wire.shape, wire.bits // 8, wire.offset,
                    hp, params.n_bands)
        done = None
        if device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(device))

        def wait():
            fault_point("pipeline.compute")
            if done is not None:
                done.synchronize()

        run_with_deadline(wait, _compute_budget_s(), "pipeline.compute")
    return sig, keys, decoded


def _minhash_streamed(rows: np.ndarray, hp, params: ClusterParams,
                      rec: StageRecorder, device: torch.device,
                      want_decoded: bool, lad: dict,
                      wd: StageWatchdog | None = None,
                      quant_ctx: dict | None = None):
    """rows -> (per-chunk (sig, keys), decoded chunks or None, per-chunk
    wire bits) through the degradation ladder, encode and H2D of the next
    chunk overlapping compute on this one.  MinHash is row-independent, so
    neither the chunking nor a halving or a retry changes the result; the
    ladder's counters go to ``lad``."""
    return ladder._stream_minhash_degraded(
        rows, hp, params, rec, device, want_decoded, lad, wd=wd,
        quant_ctx=quant_ctx)


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
                     device: torch.device, lad: dict):
    """Single-host encoded path: stream the full lane chunked and double-
    buffered (keeping the decoded rows on the card), decode the delta lane
    against it, MinHash both, cluster with original-order labels.  Returns
    (labels as numpy int32, sig, keys), sig and keys in row order."""
    parts, chunks_d, wire_bits = _minhash_streamed(
        enc.full_rows, hp, params, rec, device, True, lad)
    full_d = _cat(chunks_d)
    meta, mask_d, rep_d, counts_d, pos_d, val_d = _put_delta_meta(
        enc, rec, params.entropy, device)
    with rec.stage("compute"):
        with region("tse1m.decode"):
            delta_items = _decode_delta_meta(meta, full_d, rep_d, counts_d,
                                             pos_d, val_d)
        with region("tse1m.minhash"):
            dsig, dkeys = scheme_sig_and_keys(delta_items, hp,
                                              params.n_bands)
        with region("tse1m.lsh"):
            sig = torch.cat([p[0] for p in parts] + [dsig])
            keys = torch.cat([p[1] for p in parts] + [dkeys])
            # Nothing before the concatenation is kept through the LSH tail.
            del parts, chunks_d, full_d, delta_items, dsig, dkeys
            labels, lane_of = _cluster_encoded_labels(
                sig, keys, mask_d, enc.n, params.threshold, params.n_iters)
            _sync(device)
    last_run_info["chunk_bits"] = wire_bits
    with rec.stage("d2h", nbytes=labels.numel() * 4), \
            region("tse1m.fetch"):
        out = labels.cpu().numpy()
    return out, sig[lane_of], keys[lane_of]


def _cluster_single_host(items: np.ndarray, hp, params: ClusterParams,
                         rec: StageRecorder, device: torch.device, lad: dict,
                         qbits_override: int | None = None):
    """The storeless single-host pipeline over (possibly prefiltered) rows:
    plan the wire, stream + MinHash + cluster; returns (labels in row order
    as numpy int32, signatures, band keys).  The plain lane arms the quant
    rung (storeless, and not under ``wire_quant_bits=-1``); a clean run at
    the calibrated floor clears the floor (the device healed)."""
    raw_items = items  # the quant rung re-quantizes from here
    t0 = time.perf_counter()
    items, enc, qbits = _plan_wire(items, params, qbits_override)
    rec.add("encode", time.perf_counter() - t0)
    last_run_info.update(wire_quant_bits=qbits)
    clamped = (params.wire_quant_bits == 0 and qbits
               and qbits == _degraded_quant_floor())
    if enc is not None:
        last_run_info.update(
            encoding="delta", encode_s=round(time.perf_counter() - t0, 4),
            n_full=enc.n_full, n_delta=enc.n_delta)
        return _cluster_encoded(enc, hp, params, rec, device, lad)
    last_run_info.update(encoding="plain")
    quant_ctx = ({"raw": raw_items, "bits": qbits}
                 if params.wire_quant_bits >= 0 else None)
    parts, _, wire_bits = _minhash_streamed(items, hp, params, rec, device,
                                            False, lad, quant_ctx=quant_ctx)
    last_run_info["chunk_bits"] = wire_bits
    with region("tse1m.lsh"):
        sig = _cat([p[0] for p in parts])
        keys = _cat([p[1] for p in parts])
        del parts  # the per-chunk copies are not kept through the LSH tail
        with rec.stage("compute"):
            labels = _cluster_from_sig(sig, keys, params.threshold,
                                       params.n_iters)
            _sync(device)
    with rec.stage("d2h", nbytes=labels.numel() * 4), \
            region("tse1m.fetch"):
        out = labels.cpu().numpy()
    if clamped and not lad.get("quant_drops") \
            and not lad.get("chunk_halvings"):
        record_degradation("quant_restore", site="pipeline.stream",
                           detail={"from_bits": int(qbits)})
        _restore_quant_bits()
    return out, sig, keys


def _to_device_u32(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host uint32 (a loaded shard) -> an int32 tensor of its bits."""
    return torch.from_numpy(
        np.ascontiguousarray(a, np.uint32).view(np.int32)).to(device)


def _load_done_shards(ckpt: ClusterCheckpoint, rows: np.ndarray, step: int,
                      rec: StageRecorder, device: torch.device, parts: dict):
    """Shards already on disk go up into ``parts``; returns the pending
    (index, rows) chunks.  A torn shard reads as not done and recomputes."""
    pending = []
    for idx, i in enumerate(range(0, rows.shape[0], step)):
        shard = (ckpt.load_chunk_or_none(idx)
                 if ckpt.chunk_done(idx) else None)
        if shard is not None:
            with rec.stage("h2d", nbytes=shard[0].nbytes + shard[1].nbytes):
                parts[idx] = (_to_device_u32(shard[0], device),
                              _to_device_u32(shard[1], device))
            continue
        pending.append((idx, rows[i:i + step]))
    return pending


def cluster_sessions_resumable(items, params: ClusterParams | None = None,
                               checkpoint_dir: str | None = None,
                               cleanup: bool = True, *,
                               device: str | torch.device = "cuda"):
    """``cluster_sessions`` with per-chunk checkpoints and resume.

    Each streamed chunk's (signatures, band keys) shard persists under
    ``checkpoint_dir`` as it completes (``cluster/checkpoint.py``); a
    killed run re-invoked with the same directory recomputes only the
    unfinished chunks, then runs the LSH tail.  Pending chunks stream
    through the ladder; an out-of-memory halves only inside a chunk, whose
    sub-chunks concatenate into the same shard, so the manifest's step and
    chunk count never change mid-run.  The encoded layout holds a shard a
    full-lane chunk and one for the delta lane; a resume that finds the
    full lane done re-ships and decodes it, without hashing, for the delta
    decode.  Under the auto width a resume adopts the width the shards
    hold.  With a store, a run the store can merge goes through it; any
    other runs checkpointed, then populates the store.  ``cleanup``
    removes the shards after a successful run.  With no directory this is
    ``cluster_sessions``.  Runs on ``device``, the card unless the caller
    asks for ``"cpu"``; raises without a card."""
    params = params or ClusterParams()
    dev = resolve_device(device)
    _validate_encoding(params)
    if checkpoint_dir is None:
        return cluster_sessions(items, params, device=dev)
    items = np.ascontiguousarray(items, dtype=np.uint32)
    n = items.shape[0]
    if n == 0:
        return np.empty(0, np.int32)
    prior_meta = ClusterCheckpoint.peek_meta(checkpoint_dir)
    if (prior_meta is not None and params.wire_quant_bits == 0
            and params.sig_store is None):
        # The shards hold signatures of the width the previous attempt
        # used; an auto re-plan that resolved otherwise would refuse.
        prior_bits = int(prior_meta.get("wire_quant_bits", 0) or 0)
        params = replace(params,
                         wire_quant_bits=prior_bits if prior_bits else -1)
    digests = None
    if params.sig_store:
        out = _cluster_with_store(items, params, dev, merge_only=True)
        if out is not None:
            return out
        digests = row_digests(items)  # of the raw ids
    hp = make_params(params.scheme, params.n_hashes, params.seed).to(dev)
    rec = StageRecorder()
    t_all = time.perf_counter()
    last_run_info.clear()
    lad: dict = {}
    full_items = items
    qbits_full = _quant_bits(items, params)
    keep = None
    if digests is None:
        keep = _prefilter_keep(items, params, rec)
    if keep is not None:
        items = items[keep]
        n = items.shape[0]
    t0 = time.perf_counter()
    items, enc, qbits = _plan_wire(items, params, qbits_full)
    rec.add("encode", time.perf_counter() - t0)
    last_run_info.update(wire_quant_bits=qbits)
    extra: dict = {}
    if enc is None:
        last_run_info.update(encoding="plain")
        step = _resume_step(_stream_plan(items, params), prior_meta)
        if qbits:
            extra["wire_quant_bits"] = qbits
        if keep is not None:
            extra["prefilter_kept"] = int(n)
        ckpt = ClusterCheckpoint(checkpoint_dir, items, params, step,
                                 extra=extra or None)
        parts: dict = {}
        pending = _load_done_shards(ckpt, items, step, rec, dev, parts)
        ladder._checkpointed_chunks(pending, hp, params, rec, dev, ckpt,
                                    parts, lad)
        with rec.stage("compute"):
            sig = _cat([parts[i][0] for i in sorted(parts)])
            keys = _cat([parts[i][1] for i in sorted(parts)])
            del parts
            labels = _cluster_from_sig(sig, keys, params.threshold,
                                       params.n_iters)
            _sync(dev)
        with rec.stage("d2h", nbytes=labels.numel() * 4):
            out = labels.cpu().numpy()
    else:
        # The lane split decides what each shard holds, so it is part of
        # the manifest: a resume whose encoder drew other lanes refuses.
        last_run_info.update(encoding="delta", n_full=enc.n_full,
                             n_delta=enc.n_delta)
        full = enc.full_rows
        step = _resume_step(_stream_plan(full, params), prior_meta)
        n_full_chunks = max(1, -(-full.shape[0] // step))
        extra = {"encoding": "delta", "lane_fingerprint": hashlib.blake2b(
            enc.mask_bits.tobytes() + enc.counts.tobytes(),
            digest_size=16).hexdigest()}
        if qbits:
            extra["wire_quant_bits"] = qbits
        if keep is not None:
            extra["prefilter_kept"] = int(n)
        ckpt = ClusterCheckpoint(checkpoint_dir, items, params, step,
                                 extra=extra, n_chunks=n_full_chunks + 1)
        parts = {}
        chunks_d: list = [None] * n_full_chunks
        pending = _load_done_shards(ckpt, full, step, rec, dev, parts)
        ladder._checkpointed_chunks(pending, hp, params, rec, dev, ckpt,
                                    parts, lad, want_decoded=True,
                                    chunks_d=chunks_d)
        dpart = _resume_delta_shard(ckpt, n_full_chunks, enc, full, step,
                                    chunks_d, hp, params, rec, dev)
        del chunks_d
        with rec.stage("compute"):
            sig = torch.cat([parts[i][0] for i in sorted(parts)]
                            + [dpart[0]])
            keys = torch.cat([parts[i][1] for i in sorted(parts)]
                             + [dpart[1]])
            del parts, dpart
            mask_d = torch.from_numpy(enc.mask_bits).to(dev)
            labels, _ = _cluster_encoded_labels(
                sig, keys, mask_d, n, params.threshold, params.n_iters)
            _sync(dev)
        with rec.stage("d2h", nbytes=labels.numel() * 4):
            out = labels.cpu().numpy()
    if digests is not None:
        _store_populate_from_run(params, qbits, digests, sig, keys, out, enc,
                                 rec)
    if cleanup:
        ckpt.cleanup()
    if keep is not None:
        out = _scatter_prefiltered(full_items.shape[0], keep, out)
    _record_wire(rec)
    _record_wire_v3(full_items, qbits_full, keep, rec)
    _finish_run(rec, t_all, lad)
    return out


def _resume_step(step: int, prior_meta: dict | None) -> int:
    """The step of the checkpoint being resumed, else ``step``.  A run
    halved by an out-of-memory persists the surviving chunk size, which
    clamps the next plan; the resume keeps the step its shards were cut
    at (a chunk too large for the card halves inside itself).  The JAX
    package re-plans here and refuses its own checkpoint."""
    if prior_meta is not None and int(prior_meta.get("step", 0) or 0) > 0:
        return int(prior_meta["step"])
    return step


def _resume_delta_shard(ckpt: ClusterCheckpoint, didx: int, enc,
                        full: np.ndarray, step: int, chunks_d: list, hp,
                        params: ClusterParams, rec: StageRecorder,
                        device: torch.device) -> tuple:
    """The delta lane's (sig, keys): from its shard when it is done, else
    decoded against the full lane and hashed, then saved.  Full-lane
    chunks whose shards were loaded from disk never shipped their rows
    this run: they are shipped and decoded now, not hashed."""
    dshard = ckpt.load_chunk_or_none(didx) if ckpt.chunk_done(didx) else None
    if dshard is not None:
        with rec.stage("h2d", nbytes=dshard[0].nbytes + dshard[1].nbytes):
            return (_to_device_u32(dshard[0], device),
                    _to_device_u32(dshard[1], device))
    copy_stream = (torch.cuda.current_stream(device)
                   if device.type == "cuda" else None)
    for idx, i in enumerate(range(0, full.shape[0], step)):
        if chunks_d[idx] is None:
            arrays_d, wire = _produce_chunk(full[i:i + step], rec, device,
                                            copy_stream, params.entropy)
            with rec.stage("compute"):
                chunks_d[idx] = _decode_wire(arrays_d, wire)
    full_d = _cat(chunks_d)
    meta, _, rep_d, counts_d, pos_d, val_d = _put_delta_meta(
        enc, rec, params.entropy, device)
    with rec.stage("compute"):
        delta_items = _decode_delta_meta(meta, full_d, rep_d, counts_d,
                                         pos_d, val_d)
        del full_d
        dsig, dkeys = scheme_sig_and_keys(delta_items, hp, params.n_bands)
        del delta_items
    with rec.stage("d2h", nbytes=(dsig.numel() + dkeys.numel()) * 4):
        dsig_h, dkeys_h = as_u32_numpy(dsig), as_u32_numpy(dkeys)
    ckpt.save_chunk(didx, dsig_h, dkeys_h)
    return dsig, dkeys


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


def _record_wire(rec: StageRecorder) -> None:
    """The run's H2D bytes, exact and in MiB."""
    last_run_info["wire_mb"] = round(rec.nbytes.get("h2d", 0) / 2**20, 2)
    last_run_info["wire_bytes"] = int(rec.nbytes.get("h2d", 0))


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


def _finish_run(rec: StageRecorder, t0: float, lad: dict) -> None:
    """The run's ladder counters (``chunk_halvings`` present, 0 on a run
    that never degraded, as JAX's), total wall and stage walls."""
    last_run_info.update(lad)
    last_run_info.setdefault("chunk_halvings", 0)
    rec.set_total(time.perf_counter() - t0)
    last_run_info["stages"] = rec.as_dict()


def cluster_sessions(items, params: ClusterParams | None = None,
                     mesh=None, *, device: str | torch.device = "cuda",
                     return_signatures: bool = False):
    """Cluster [N, S] uint32 session feature sets -> [N] int32 labels.

    Runs on ``device``, the card unless the caller asks for ``"cpu"`` (the
    plain PyTorch versions of the kernels); raises without a card.  With
    ``params.sig_store`` the run goes through the signature store (the
    warm path, see the module docstring).  With ``return_signatures`` a
    storeless run returns ``(labels, sig, keys)``: the [M, H] signatures
    and [M, B] band keys, int32 tensors of uint32 bits on the device, of
    the M rows the prefilter kept (all rows when it dropped none), in their
    row order.

    With ``mesh`` (``parallel.Mesh``) every rank of the mesh calls this
    with the same host ``items``, or with its own block as a
    ``parallel.multihost.ShardedRows`` padded to a multiple of the mesh
    size, and every rank returns the same labels: the band-sharded run of
    ``cluster/sharded.py`` on the mesh's devices, equal element for
    element to the single-device run over the same ids.  As in the JAX
    package, the mesh feed ships raw ids or the 24-bit byte pack: the host
    prefilter, the base-delta and rANS lanes and the automatic
    quantization stay off (an explicit ``wire_quant_bits`` applies), and
    ``device`` must name the mesh's kind of device."""
    params = params or ClusterParams()
    _validate_encoding(params)
    if mesh is not None:
        return _cluster_mesh(items, params, mesh, device, return_signatures)
    dev = resolve_device(device)
    items = np.ascontiguousarray(items, dtype=np.uint32)
    if params.sig_store:
        if return_signatures:
            raise ValueError("return_signatures is storeless-only: a merge "
                             "run computes no signature for its cached "
                             "rows on the device")
        return _cluster_with_store(items, params, dev)
    hp = make_params(params.scheme, params.n_hashes, params.seed).to(dev)
    rec = StageRecorder()
    t_all = time.perf_counter()
    last_run_info.clear()
    lad: dict = {}
    # The prefilter reads the raw ids; the quantization is decided over
    # the full row set, so the kept rows ship in the universe the
    # unfiltered run would use.
    qbits_full = _quant_bits(items, params)
    keep = _prefilter_keep(items, params, rec)
    work = items if keep is None else items[keep]
    out, sig, keys = _cluster_single_host(work, hp, params, rec, dev, lad,
                                          qbits_full)
    if keep is not None:
        out = _scatter_prefiltered(items.shape[0], keep, out)
    _record_wire(rec)
    _record_wire_v3(items, qbits_full, keep, rec)
    _finish_run(rec, t_all, lad)
    return (out, sig, keys) if return_signatures else out


def _pack24_host(chunk: np.ndarray) -> np.ndarray:
    """[n, S] uint32 (< 2^24) -> contiguous [n, S, 3] uint8 little-endian
    bytes: the mesh feed's pack, the packed kernel's wire at k = 3."""
    if chunk.dtype.byteorder == ">":
        chunk = chunk.astype("<u4")
    return np.ascontiguousarray(chunk[..., None].view(np.uint8)[..., :3])


def should_pack24(items: np.ndarray) -> bool:
    """True when every id fits the 24-bit universe: the mesh feed's pack
    decision."""
    return bool(items.size) and bool(items.max() < _PACK_LIMIT)


def _cluster_mesh(items, params: ClusterParams, mesh, device,
                  return_signatures: bool) -> np.ndarray:
    """``cluster_sessions`` under a mesh; refusals in the JAX package's
    order and words."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a tse1m_tpu_torch.parallel.Mesh, got "
                        f"{type(mesh).__name__}")
    if params.prefilter == "on":
        raise ValueError(
            "ClusterParams.prefilter='on' is a single-host wire lever: "
            "the mesh feed has no per-host keep mask to apply. Drop "
            "prefilter (auto disables itself under a mesh) or run "
            "single-host.")
    if params.sig_store:
        raise ValueError(
            "--sig-store (ClusterParams.sig_store) is not supported on "
            "cluster_sessions under a mesh: the signature store shards "
            "per host by digest range. Feed each process's host-resident "
            "local rows through cluster_sessions_pod (cli cluster routes "
            "there automatically under a mesh), or drop sig_store for a "
            "cold mesh run.")
    if return_signatures:
        raise ValueError("return_signatures is single-device only")
    dev = resolve_device(device)
    if dev.type != mesh.device.type:
        raise ValueError(f"device {dev} does not match the mesh's "
                         f"{mesh.device}")
    dev = mesh.device
    with region("tse1m.consts"):
        hp = make_params(params.scheme, params.n_hashes, params.seed).to(dev)
    rec = StageRecorder()
    t_all = time.perf_counter()
    last_run_info.clear()
    packed_shape = None
    if isinstance(items, ShardedRows):
        if items.n_rows % mesh.size:
            raise ValueError(
                "pre-sharded items must be padded to a multiple of the "
                "mesh size — feed through parallel/multihost."
                "put_process_local_padded and slice the labels back to "
                "the logical row count")
        n = items.n_rows
        rows = items.rows
        last_run_info.update(encoding="mesh-presharded")
    else:
        items = np.ascontiguousarray(items, dtype=np.uint32)
        if params.wire_quant_bits > 0:  # explicit only, as in JAX
            qb = _quant_bits(items, params)
            if qb:
                items = quantize_ids(items, qb)
            last_run_info.update(wire_quant_bits=qb)
        n = items.shape[0]
        items, _ = pad_to_devices(items, mesh)
        packed = should_pack24(items)
        block = mesh.block(items)
        with rec.stage("encode"):
            payload = _pack24_host(block) if packed else block
        with rec.stage("h2d", nbytes=payload.nbytes):
            if packed:
                rows = torch.from_numpy(payload.reshape(-1)).to(dev)
                packed_shape = block.shape
            else:
                rows = torch.from_numpy(payload.view(np.int32)).to(dev)
            _sync(dev)
        # The whole payload's size, as the JAX package records it.
        last_run_info.update(
            encoding="mesh-pack24" if packed else "mesh-raw",
            wire_mb=round(payload.nbytes * mesh.size / 2**20, 2))
    def pmins() -> int:
        return mesh.stats.get("pmin", {}).get("calls", 0)

    pmins0 = pmins()
    with rec.stage("compute"):
        labels = sharded_labels(rows, hp, mesh, params.n_bands,
                                params.threshold, params.n_iters,
                                packed_shape)
        with region("tse1m.sync"):
            _sync(dev)
    # A propagation step reduces its pull and its push: two pmin.
    last_run_info["propagate_steps"] = (pmins() - pmins0) // 2
    with rec.stage("d2h"), region("tse1m.fetch"):
        out = labels.cpu().numpy()[:n]
    _finish_run(rec, t_all, {})
    return out


# -- the warm path: persistent signature store ------------------------------
#
# store.py and incremental.py are host numpy; every device transfer of a
# store run is here.


def _store_policy(params: ClusterParams, qbits: int) -> dict:
    return {"n_hashes": params.n_hashes, "seed": params.seed,
            "quant_bits": qbits, "scheme": params.scheme}


def _streamed_sig(rows: np.ndarray, params: ClusterParams,
                  rec: StageRecorder, device: torch.device, lad: dict,
                  wd: StageWatchdog | None = None):
    """rows (already in the policy's universe) -> (per-chunk (sig, keys),
    per-chunk wire bits) through the plain lane's stream, under the
    ladder without its quant rung: a store's policy pins the width."""
    hp = make_params(params.scheme, params.n_hashes, params.seed).to(device)
    parts, _, wire_bits = _minhash_streamed(rows, hp, params, rec, device,
                                            False, lad, wd=wd)
    return parts, wire_bits


def minhash_novel_rows(rows: np.ndarray, params: ClusterParams, qbits: int,
                       rec: StageRecorder | None = None,
                       wd: StageWatchdog | None = None, *,
                       device: str | torch.device = "cuda",
                       pad_pow2: bool = True) -> np.ndarray:
    """Host [K, S] raw rows -> host [K, H] uint32 signatures: the rows
    quantized to the store policy's universe, streamed through the plain
    lane under the degradation ladder (halving and retries; no quant rung,
    the store pins the width) to the scheme's kernel on ``device``, fetched
    back.  The ladder's events are recorded; ``last_run_info`` is not
    touched, so a daemon's ingest thread can call this beside a batch run.
    ``wd``: the caller's stage watchdog (a daemon keeps one, so its link
    rate carries across batches).  ``pad_pow2`` pads K to the next power of
    two with copies of row 0 (MinHash is row-independent; the pad is sliced
    off), so a long-lived caller launches O(log K) row counts, as the JAX
    package's compiles O(log K) shapes."""
    rec = rec or StageRecorder()
    dev = resolve_device(device)
    k = int(rows.shape[0])
    if k == 0:
        return np.empty((0, params.n_hashes), np.uint32)
    sub = quantize_ids(rows, qbits) if qbits else rows
    if pad_pow2:
        padded = 1 << (k - 1).bit_length()
        if padded > k:
            sub = np.concatenate(
                [sub, np.broadcast_to(sub[:1], (padded - k, sub.shape[1]))])
    parts, _ = _streamed_sig(sub, params, rec, dev, {}, wd=wd)
    sig_d = _cat([p[0] for p in parts])
    with rec.stage("d2h", nbytes=sig_d.numel() * 4):
        sig = as_u32_numpy(sig_d)
    return np.ascontiguousarray(sig[:k], np.uint32)


def _cluster_with_store(items: np.ndarray, params: ClusterParams,
                        device: torch.device, merge_only: bool = False):
    """Store-enabled clustering; returns [N] int32 labels.  With
    ``merge_only`` (the resumable caller) a run the store cannot merge
    returns None instead of running the union, so the caller runs its
    checkpointed cold pipeline and populates the store after it."""
    if is_sharded_root(params.sig_store):
        # A pod root probed by a single process (the resumed-after-loss
        # shape): the pod path, this process inheriting every range.
        return cluster_sessions_pod(items, items.shape[0], params,
                                    solo=multihost._world()[0] > 1,
                                    device=device)
    rec = StageRecorder()
    t_all = time.perf_counter()
    last_run_info.clear()
    lad: dict = {}
    n = items.shape[0]
    if n == 0:
        return np.empty(0, np.int32)
    qbits = _quant_bits(items, params)
    store = SignatureStore(params.sig_store, _store_policy(params, qbits))
    if store.quarantined_at_open:
        last_run_info["store_quarantined"] = list(store.quarantined_at_open)
    with rec.stage("probe"):
        digests = row_digests(items)
        hit, shard, row = store.bulk_probe(digests)
    state = store.load_state(params.n_bands, params.threshold)
    last_run_info.update(encoding="store", wire_quant_bits=qbits,
                         cache_hit_rate=round(float(hit.mean()), 4),
                         cache_store_rows=store.n_rows)
    merge_ok = (state is not None and state.n_rows <= n
                and (n - state.n_rows) <= params.merge_max_novel * n
                and state.matches_prefix(digests))
    if merge_ok:
        labels = _store_warm_merge(items, digests, hit, shard, row, state,
                                   store, params, qbits, rec, device, lad)
        last_run_info["cache_mode"] = "merge"
    elif merge_only:
        return None
    else:
        labels = _store_union(items, digests, hit, shard, row, store,
                              params, qbits, rec, device, lad)
        last_run_info["cache_mode"] = "union"
    _record_wire(rec)
    _finish_run(rec, t_all, lad)
    return labels


def _store_warm_merge(items, digests, hit, shard, row, state, store,
                      params: ClusterParams, qbits: int, rec: StageRecorder,
                      device: torch.device, lad: dict) -> np.ndarray:
    """The accreted-tail run: the card MinHashes only the tail's missed
    rows; stored signatures serve the rest; band keys are folded and
    labels merged on the host (``LiveClusterIndex.absorb``)."""
    n = items.shape[0]
    n_old = state.n_rows
    k_new = n - n_old
    if k_new == 0:
        last_run_info["cache_novel_rows"] = 0
        return state.labels.astype(np.int32, copy=True)
    h = params.n_hashes
    tail_hit = hit[n_old:]
    miss = ~tail_hit
    new_sig = np.empty((k_new, h), np.uint32)
    if tail_hit.any():
        with rec.stage("load", nbytes=int(tail_hit.sum()) * h * 4):
            new_sig[tail_hit] = store.load_signatures(
                shard[n_old:][tail_hit], row[n_old:][tail_hit])
    if miss.any():
        sub = items[n_old:][miss]
        if qbits:
            sub = quantize_ids(sub, qbits)
        parts, wire_bits = _streamed_sig(sub, params, rec, device, lad)
        last_run_info["chunk_bits"] = wire_bits
        sig_d = _cat([p[0] for p in parts])
        with rec.stage("d2h", nbytes=sig_d.numel() * 4), \
                region("tse1m.fetch"):
            new_sig[miss] = as_u32_numpy(sig_d)
    with rec.stage("compute"):
        # The short tail's band keys on the host: bit-identical to the
        # card's fold (tests/test_torch_host.py).
        new_keys = host_band_keys(new_sig, params.n_bands)

        def gather_old(uniq: np.ndarray) -> np.ndarray:
            loc = state.locator[uniq]
            out = store.load_signatures(loc[:, 0], loc[:, 1])
            rec.add("load", 0.0, out.nbytes)
            return out

        index = inc.LiveClusterIndex.from_state(state).absorb(
            new_keys, new_sig, gather_old, h, params.threshold)
        labels = index.labels
    # Commit: append the novel signatures, extend (never rebuild) the band
    # tables, advance the state to cover all n rows.
    if miss.any():
        store.append(digests[n_old:][miss], new_sig[miss])
    _, sh2, rw2 = store.bulk_probe(digests[n_old:])
    locator = np.concatenate([state.locator, np.stack([sh2, rw2], axis=1)])
    store.save_state(labels, locator, index.band_tables(), digests,
                     params.n_bands, params.threshold)
    last_run_info["cache_novel_rows"] = int(miss.sum())
    return labels


def _store_union(items, digests, hit, shard, row, store,
                 params: ClusterParams, qbits: int, rec: StageRecorder,
                 device: torch.device, lad: dict) -> np.ndarray:
    """The full store run: cached signatures go up in one copy (their band
    keys folded on the card), missed rows stream through the plain lane,
    and the LSH tail runs over both in [hit..., miss...] lane order; the
    labels come back in row order, those of a storeless run."""
    n = items.shape[0]
    miss = ~hit
    hit_idx = np.flatnonzero(hit)
    miss_idx = np.flatnonzero(miss)
    sig_parts, key_parts = [], []
    if hit_idx.size:
        with rec.stage("load", nbytes=int(hit_idx.size) * params.n_hashes
                       * 4):
            sig_hit = store.load_signatures(shard[hit], row[hit])
        with rec.stage("h2d", nbytes=sig_hit.nbytes):
            sig_hit_d = torch.from_numpy(sig_hit.view(np.int32)).to(device)
            _sync(device)
        with rec.stage("compute"):
            sig_parts.append(sig_hit_d)
            key_parts.append(band_keys(sig_hit_d, params.n_bands))
            _sync(device)
    if miss_idx.size:
        sub = items[miss_idx]
        if qbits:
            sub = quantize_ids(sub, qbits)
        parts, wire_bits = _streamed_sig(sub, params, rec, device, lad)
        last_run_info["chunk_bits"] = wire_bits
        sig_parts += [p[0] for p in parts]
        key_parts += [p[1] for p in parts]
    mask_bits = np.packbits(miss, bitorder="little")
    with rec.stage("h2d", nbytes=mask_bits.nbytes):
        mask_d = torch.from_numpy(mask_bits).to(device)
        _sync(device)
    with rec.stage("compute"):
        sig = _cat(sig_parts)
        keys = _cat(key_parts)
        del sig_parts, key_parts
        labels_d, lane_of = _cluster_encoded_labels(
            sig, keys, mask_d, n, params.threshold, params.n_iters)
        _sync(device)
    with rec.stage("d2h", nbytes=n * 4):
        labels = labels_d.cpu().numpy()
    with rec.stage("d2h", nbytes=(sig.numel() + keys.numel()) * 4):
        sig_orig = as_u32_numpy(sig[lane_of])
        keys_orig = as_u32_numpy(keys[lane_of])
    del sig, keys
    _store_commit(store, digests, miss, sig_orig, keys_orig, labels, params,
                  rec)
    last_run_info["cache_novel_rows"] = int(miss_idx.size)
    return labels


def _store_commit(store, digests, miss_mask, sig_orig, keys_orig, labels,
                  params: ClusterParams, rec: StageRecorder) -> None:
    """Append the novel signatures and commit the run's LSH state
    (labels, band tables, locator) for the next accreted run's merge."""
    store.append(digests[miss_mask], sig_orig[miss_mask])
    _, sh2, rw2 = store.bulk_probe(digests)
    locator = np.stack([sh2, rw2], axis=1)
    with rec.stage("compute"):
        tables = inc.build_band_tables(keys_orig)
    store.save_state(labels, locator, tables, digests, params.n_bands,
                     params.threshold)


def _store_populate_from_run(params: ClusterParams, qbits: int, digests,
                             sig_d: torch.Tensor, keys_d: torch.Tensor,
                             labels: np.ndarray, enc,
                             rec: StageRecorder) -> None:
    """Populate the store from a completed resumable run: fetch the
    signatures and keys, undo the encoder's lane order, append the misses
    and commit the state."""
    store = SignatureStore(params.sig_store, _store_policy(params, qbits))
    with rec.stage("probe"):
        hit, _, _ = store.bulk_probe(digests)
    with rec.stage("d2h", nbytes=(sig_d.numel() + keys_d.numel()) * 4):
        sig_lane = as_u32_numpy(sig_d)
        keys_lane = as_u32_numpy(keys_d)
    if enc is not None:
        is_delta = np.unpackbits(
            enc.mask_bits, bitorder="little")[:digests.shape[0]].astype(bool)
        orig_of = np.concatenate(
            [np.flatnonzero(~is_delta), np.flatnonzero(is_delta)])
        sig_orig = np.empty_like(sig_lane)
        sig_orig[orig_of] = sig_lane
        keys_orig = np.empty_like(keys_lane)
        keys_orig[orig_of] = keys_lane
    else:
        sig_orig, keys_orig = sig_lane, keys_lane
    _store_commit(store, digests, ~hit, sig_orig, keys_orig, labels, params,
                  rec)
    last_run_info.update(cache_hit_rate=round(float(hit.mean()), 4),
                         cache_mode="populate",
                         cache_novel_rows=int((~hit).sum()))


# -- the pod path: ``--sig-store`` across processes --------------------------
#
# Each process probes only its own row range against the digest-range
# sharded store (every range readable by every process, writable by its
# owner) and MinHashes only its novel tail on its card, through the
# degradation ladder.  The novel (digest, signature) tails swap as atomic
# files under the shared store root (``multihost.fs_exchange``), so each
# owner appends its ranges' rows, and each process assembles the full
# signature matrix (its rows, peers' novel tails, peers' cached rows
# gathered from the store) and runs the single-device LSH tail on its
# card.  No process joins a torch.distributed world: every wait across
# processes polls the heartbeat monitor instead of a collective that could
# hang on a dead peer.  Labels equal a cold run's over the same rows.
#
# ``solo=True`` skips the exchange: a failover survivor re-executing the
# whole partition after peers were declared lost.  The membership ledger
# re-deals the lost processes' ranges to it under fresh epoch leases, and
# their un-appended rows probe as misses and recompute.


def cluster_sessions_pod(local_items, n_rows: int,
                         params: ClusterParams | None = None, mesh=None, *,
                         device: str | torch.device = "cuda",
                         supervisor=None, exchange_dir: str | None = None,
                         solo: bool = False, membership: dict | None = None,
                         n_processes: int | None = None,
                         process_id: int | None = None) -> np.ndarray:
    """Store-enabled clustering across pod processes; returns the full
    [n_rows] int32 labels on every process.

    ``local_items``: this process's rows, the ``multihost.pod_row_range(
    n_rows, nproc, pid)`` slice (every row when single-process or
    ``solo``).  ``device``: this process's card (``"cpu"`` for the plain
    versions).  ``supervisor`` (``PodSupervisor``) makes every wait across
    processes raise ``HostLostError`` on a dead peer; ``exchange_dir`` is
    the run's negotiated exchange directory and ``membership`` its epoch
    record (``MembershipLedger``), which decides range ownership and arms
    the lease fence; both are required across processes (a local-only
    call bootstraps a one-member ledger under the store's ``pod/``).
    ``n_processes``/``process_id`` carry the pod identity
    (``multihost.pod_process_env``); they default to the started world's,
    which the pod plane never joins.  ``mesh`` is refused: a port mesh
    spans a ``torch.distributed`` world, and the pod plane starts none."""
    params = params or ClusterParams()
    _validate_encoding(params)
    if mesh is not None:
        raise ValueError(
            "cluster_sessions_pod takes no mesh in tse1m_tpu_torch: a Mesh "
            "spans a torch.distributed world, which the pod plane never "
            "starts (a dead peer would hang its collectives); each process "
            "runs the LSH tail on its own device= instead")
    if not params.sig_store:
        raise ValueError("cluster_sessions_pod requires params.sig_store "
                         "(the pod path IS the store path; use "
                         "cluster_sessions for cold runs)")
    dev = resolve_device(device)
    world_n, world_pid = multihost._world()
    nproc = (int(n_processes) if n_processes is not None
             else (1 if solo else world_n))
    pid = (int(process_id) if process_id is not None
           else (0 if solo else world_pid))
    local_only = solo or nproc == 1
    if not local_only and exchange_dir is None:
        raise ValueError("multi-process cluster_sessions_pod needs the "
                         "run's exchange_dir (negotiate it via "
                         "resilience.coordinator — cli.run_pod_cluster "
                         "does)")
    if membership is None and local_only:
        from ..resilience.coordinator import MembershipLedger

        ledger = MembershipLedger(
            os.path.join(params.sig_store, "pod"),
            ShardedSignatureStore.root_n_ranges(params.sig_store,
                                                default=max(nproc, 1)))
        membership = ledger.bootstrap([pid], os.urandom(8).hex())
    if membership is None:
        raise ValueError("multi-process cluster_sessions_pod needs the "
                         "run's membership record (the epoch deal from "
                         "resilience.coordinator.MembershipLedger — "
                         "cli.run_pod_cluster negotiates it)")
    monitor = supervisor.monitor if supervisor is not None else None

    rec = StageRecorder()
    t_all = time.perf_counter()
    last_run_info.clear()
    lad: dict = {}
    local_items = np.ascontiguousarray(local_items, dtype=np.uint32)
    lo, hi = ((0, n_rows) if local_only
              else multihost.pod_row_range(n_rows, nproc, pid))
    k_local = hi - lo
    if local_items.shape[0] != k_local:
        raise ValueError(
            f"process {pid} must feed rows [{lo}, {hi}) of the logical "
            f"array ({k_local} rows), got {local_items.shape[0]}")
    # Automatic quantization stays off: it keys off the whole row set,
    # which no process holds.  Explicit bits apply and join the policy.
    qbits = params.wire_quant_bits if params.wire_quant_bits > 0 else 0
    h = params.n_hashes
    with rec.stage("probe"):
        digests = row_digests(local_items)  # raw ids, before quantization
        store = ShardedSignatureStore(params.sig_store,
                                      _store_policy(params, qbits),
                                      n_processes=1 if local_only else nproc,
                                      process_id=pid,
                                      membership=membership)
        hit, loc = store.probe(digests)
    sig_local = np.zeros((k_local, h), np.uint32)
    if hit.any():
        with rec.stage("load", nbytes=int(hit.sum()) * h * 4):
            sig_local[hit] = store.load_signatures(loc[hit])
    miss = ~hit
    if miss.any():
        # Only this process's novel rows reach its card.
        sub = local_items[miss]
        if qbits:
            sub = quantize_ids(sub, qbits)
        parts, wire_bits = _streamed_sig(sub, params, rec, dev, lad)
        last_run_info["chunk_bits"] = wire_bits
        sig_d = _cat([p[0] for p in parts])
        del parts
        with rec.stage("d2h", nbytes=sig_d.numel() * 4), \
                region("tse1m.fetch"):
            sig_local[miss] = as_u32_numpy(sig_d)
        del sig_d
    payload = {"digests": digests, "miss": miss,
               "novel_sigs": sig_local[miss]}
    with rec.stage("exchange"):
        payloads = ([payload] if local_only else multihost.fs_exchange(
            exchange_dir, "novel", payload, monitor=monitor,
            n_processes=nproc, process_id=pid))
    # Each range's owner appends its rows; content hashed by two processes
    # dedups in the append.
    with rec.stage("append"):
        all_nd = np.concatenate([p["digests"][p["miss"].astype(bool)]
                                 for p in payloads])
        all_ns = np.concatenate([p["novel_sigs"] for p in payloads])
        mine = store.owned_mask(all_nd)
        appended = store.append(all_nd[mine], all_ns[mine])
    total_rows = sum(int(p["digests"].shape[0]) for p in payloads)
    total_hits = sum(int((~p["miss"].astype(bool)).sum())
                     for p in payloads)
    # The full matrix in process order, which is row order: peers' novel
    # tails from the exchange, their cached rows from the store (committed
    # before this run, so the read races no append of it).
    parts_full: list[np.ndarray] = []
    my_slot = 0 if local_only else pid
    with rec.stage("load", nbytes=(total_rows - k_local) * h * 4):
        for p, pay in enumerate(payloads):
            if p == my_slot:
                parts_full.append(sig_local)
                continue
            pmiss = pay["miss"].astype(bool)
            psig = np.zeros((pay["digests"].shape[0], h), np.uint32)
            psig[pmiss] = pay["novel_sigs"]
            if (~pmiss).any():
                chit, cloc = store.probe(pay["digests"][~pmiss])
                if not chit.all():
                    raise RuntimeError(
                        f"pod: {int((~chit).sum())} row(s) process {p} "
                        "reported cached are no longer in the store "
                        "(eviction or quarantine raced the run); rerun — "
                        "the rows will probe as misses and recompute")
                psig[~pmiss] = store.load_signatures(cloc)
            parts_full.append(psig)
    sig_full = (parts_full[0] if len(parts_full) == 1
                else np.concatenate(parts_full))
    del parts_full
    hit_rate = float(total_hits) / max(total_rows, 1)
    last_run_info.update(
        encoding="pod-store", cache_mode="pod",
        cache_hit_rate=round(hit_rate, 4),
        cache_novel_rows=int(total_rows - total_hits),
        cache_store_rows=int(store.n_rows), wire_quant_bits=qbits,
        pod_processes=nproc, pod_n_ranges=store.n_ranges,
        pod_owned_ranges=list(store.owned),
        pod_reassigned_ranges=list(store.reassigned_ranges),
        pod_appended_rows=int(appended),
        pod_epoch=int(membership["epoch"]),
        pod_members=list(membership.get("members", [])))
    # The LSH tail on this process's card over every row (the h2d bytes
    # count as wire, as the JAX package's put of the matrix does).
    t0 = time.perf_counter()
    with region("tse1m.lsh"):
        sig_t = _to_device_u32(sig_full, dev)
        rec.add("h2d", 0.0, sig_full.nbytes)
        labels_d = _cluster_from_sig(sig_t, band_keys(sig_t, params.n_bands),
                                     params.threshold, params.n_iters)
        del sig_t
    with region("tse1m.fetch"):
        labels = labels_d.cpu().numpy()
    rec.add("tail", time.perf_counter() - t0, n_rows * 4)
    _record_wire(rec)
    _finish_run(rec, t_all, lad)
    return labels
