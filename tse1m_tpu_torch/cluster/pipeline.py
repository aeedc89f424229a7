"""End-to-end session clustering on one GPU: the cold, storeless path.

Items [N, S] -> (optionally quantized) adaptive-width wire chunks ->
MinHash signatures and band keys (the CUDA kernels) -> bucket reps ->
verified edges -> propagated labels.  A port of the plain-wire part of
``tse1m_tpu/cluster/pipeline.py``: the same ``ClusterParams``, the same wire
plan and chunk cuts, and labels equal to the JAX package's element for
element.

Chunks stream double-buffered: a producer thread packs chunk k+1 into
pinned host memory and copies it to the card on a side stream while the
main thread computes on chunk k.  The producer waits for the copy's event
before it hands the chunk over, as the JAX pipeline's producer blocks on
its ``device_put``: the wait gives the h2d stage its wall and holds the
producer to one chunk ahead.  Byte-width chunks go to the packed
kernel, which reads the wire bytes directly; sub-byte chunks are decoded
by ``_unpack_bits`` and go to the uint32 kernel.

Levers of ``ClusterParams`` this port does not carry yet raise
``NotImplementedError`` naming their ROADMAP.md item when they would
switch on; the watchdog, the OOM ladder and the CPU failover of the JAX
pipeline are not ported (ROADMAP.md Queue 1 item 7).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..device import U32_MASK, narrow, resolve_device
from .encode import (_AUTO_MIN_BYTES, _AUTO_QUANT_BITS, ChunkWire, pack_chunk,
                     quantize_ids, width_bits)
from .lsh import bucket_representatives, estimated_jaccard, propagate_labels
from .observability import StageRecorder
from .schemes import (get_scheme, make_params, scheme_sig_and_keys,
                      scheme_sig_and_keys_packed)


@dataclass(frozen=True)
class ClusterParams:
    """The JAX package's ClusterParams, field for field and with the same
    defaults, less ``use_pallas`` (dispatch here follows the device).
    ``encoding``, ``prefilter`` and ``entropy`` default to ``auto`` as there;
    runs of this port pass ``encoding="pack24", entropy="off",
    prefilter="off"``."""

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


# Stats of the last cluster_sessions call (wire quantization, chunk widths,
# wire bytes, per-stage walls under "stages").  A plain dict, overwritten
# per call.
last_run_info: dict = {}

# One chunk per _CHUNK_BYTES of items, capped at _MAX_CHUNKS.
_CHUNK_BYTES = 48 * 1024 * 1024
_MAX_CHUNKS = 4


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to tse1m_tpu_torch yet (ROADMAP.md Queue 1 "
        f"item {item})")


def _validate_encoding(params: ClusterParams) -> None:
    """Reject unknown lever values (ValueError) and the levers this port
    does not carry whatever the input size (NotImplementedError)."""
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
    if params.encoding == "delta":
        raise _not_ported("encoding='delta' (the base-delta wire lane)", "6")
    if params.entropy != "off":
        raise _not_ported(f"entropy={params.entropy!r} (the rANS wire lanes)",
                          "6")
    if params.prefilter == "on":
        raise _not_ported("prefilter='on' (the host LSH prefilter)", "6")
    if params.sig_store:
        raise _not_ported("sig_store (the warm path)", "9")


def _validate_auto_levers(items: np.ndarray, params: ClusterParams) -> None:
    """The ``auto`` levers that switch on at _AUTO_MIN_BYTES in the JAX
    pipeline (its _maybe_encode and _prefilter_mask)."""
    if items.nbytes < _AUTO_MIN_BYTES:
        return
    if params.encoding == "auto":
        raise _not_ported(
            f"encoding='auto' on {items.nbytes} bytes of items (engages the "
            "base-delta wire lane; pass encoding='pack24')", "6")
    if params.prefilter == "auto" and params.threshold > 0:
        raise _not_ported(
            f"prefilter='auto' on {items.nbytes} bytes of items (engages the "
            "host LSH prefilter; pass prefilter='off')", "6")


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


def _maybe_quantize(items: np.ndarray,
                    params: ClusterParams) -> tuple[np.ndarray, int]:
    """Apply the wire_quant_bits policy; returns (items, effective bits)."""
    b = _quant_bits(items, params)
    return (quantize_ids(items, b) if b else items), b


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


def _decode_wire(payload_d: torch.Tensor, wire: ChunkWire) -> torch.Tensor:
    """Device payload + header -> decoded int32 ids of wire.shape."""
    return _unpack_bits(payload_d, wire.n_values, wire.bits,
                        wire.offset).reshape(wire.shape)


def _put(payload: np.ndarray, device: torch.device,
         copy_stream: torch.cuda.Stream | None) -> torch.Tensor:
    """The device tensor of one wire payload.  On the card: stage into
    pinned memory, copy with non_blocking on the side stream, record an
    event there, and wait for it on this (producer) thread, so the pinned
    buffer is never reused before its copy is done and the chunk is on the
    card when the compute stream reads it."""
    host = torch.from_numpy(payload)
    if device.type == "cpu":
        return host
    pinned = torch.empty(host.shape, dtype=torch.uint8, pin_memory=True)
    pinned.copy_(host)
    with torch.cuda.stream(copy_stream):
        payload_d = torch.empty(host.shape, dtype=torch.uint8, device=device)
        payload_d.copy_(pinned, non_blocking=True)
        done = torch.cuda.Event()
        done.record(copy_stream)
    done.synchronize()
    return payload_d


def _produce_chunk(chunk: np.ndarray, rec: StageRecorder,
                   device: torch.device,
                   copy_stream: torch.cuda.Stream | None):
    """Host half of one chunk: adaptive pack (encode stage) and the copy to
    the device (h2d stage)."""
    t0 = time.perf_counter()
    wire = pack_chunk(chunk)
    rec.add("encode", time.perf_counter() - t0, wire.nbytes)
    t0 = time.perf_counter()
    payload_d = _put(wire.payload, device, copy_stream)
    rec.add("h2d", time.perf_counter() - t0, wire.nbytes)
    return payload_d, wire


def _iter_streamed(chunks: list, rec: StageRecorder, overlap: bool,
                   device: torch.device,
                   copy_stream: torch.cuda.Stream | None):
    """Yield (device payload, ChunkWire) per chunk.  With overlap on and
    more than one chunk, chunk k+1 is packed and copied on a single producer
    thread while the caller computes on chunk k."""
    if not overlap or len(chunks) <= 1:
        for c in chunks:
            yield _produce_chunk(c, rec, device, copy_stream)
        return
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tse1m-h2d")
    try:
        fut = ex.submit(_produce_chunk, chunks[0], rec, device, copy_stream)
        for k in range(len(chunks)):
            cur = fut.result()
            if k + 1 < len(chunks):
                fut = ex.submit(_produce_chunk, chunks[k + 1], rec, device,
                                copy_stream)
            yield cur
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def _chunk_minhash(payload_d: torch.Tensor, wire: ChunkWire, hp,
                   params: ClusterParams, rec: StageRecorder,
                   device: torch.device):
    """One chunk's device half (compute stage): byte-width chunks go to the
    packed kernel, sub-byte chunks are decoded and go to the uint32 one."""
    with rec.stage("compute"):
        if device.type == "cuda":
            # Allocated on the copy stream, read on this one.
            payload_d.record_stream(torch.cuda.current_stream(device))
        if wire.bits % 8 != 0:
            sig, keys = scheme_sig_and_keys(_decode_wire(payload_d, wire), hp,
                                            params.n_bands)
        else:
            sig, keys = scheme_sig_and_keys_packed(
                payload_d, wire.shape, wire.bits // 8, wire.offset, hp,
                params.n_bands)
        _sync(device)
    return sig, keys


def _minhash_streamed(items: np.ndarray, hp, params: ClusterParams,
                      rec: StageRecorder, device: torch.device):
    """items -> (signatures, band keys) on ``device``, encode and H2D of
    the next chunk overlapping compute on this one.  MinHash is
    row-independent, so the chunking never changes the result."""
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    parts, wire_bits = [], []
    for payload_d, wire in _iter_streamed(
            _row_chunks(items, _stream_plan(items, params)), rec,
            params.overlap, device, copy_stream):
        parts.append(_chunk_minhash(payload_d, wire, hp, params, rec,
                                    device))
        wire_bits.append(wire.bits)
    last_run_info["chunk_bits"] = wire_bits
    if len(parts) == 1:
        return parts[0]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _cluster_from_sig(sig: torch.Tensor, keys: torch.Tensor,
                      threshold: float, n_iters: int) -> torch.Tensor:
    """Signatures and band keys -> [N] int32 labels on their device."""
    reps = bucket_representatives(keys)
    est = estimated_jaccard(sig, reps)
    self_idx = torch.arange(sig.shape[0], device=sig.device)[:, None]
    valid = (est >= threshold) & (reps != self_idx)
    return propagate_labels(reps, valid, n_iters=n_iters)


def _cluster_single_host(items: np.ndarray, hp, params: ClusterParams,
                         rec: StageRecorder, device: torch.device):
    """Plan the wire, stream + MinHash + cluster; returns (labels in row
    order as numpy int32, signatures, band keys)."""
    t0 = time.perf_counter()
    items, qbits = _maybe_quantize(items, params)
    rec.add("encode", time.perf_counter() - t0)
    last_run_info.update(wire_quant_bits=qbits, encoding="plain")
    sig, keys = _minhash_streamed(items, hp, params, rec, device)
    with rec.stage("compute"):
        labels = _cluster_from_sig(sig, keys, params.threshold,
                                   params.n_iters)
        _sync(device)
    with rec.stage("d2h", nbytes=labels.numel() * 4):
        out = labels.cpu().numpy()
    return out, sig, keys


def cluster_sessions(items, params: ClusterParams | None = None,
                     mesh=None, *, device: str | torch.device = "cuda",
                     return_signatures: bool = False):
    """Cluster [N, S] uint32 session feature sets -> [N] int32 labels.

    Runs on ``device``, the card unless the caller asks for ``"cpu"`` (the
    plain PyTorch versions of the kernels); raises without a card.  With
    ``return_signatures`` it returns ``(labels, sig, keys)``, the [N, H]
    signatures and [N, B] band keys as int32 tensors of uint32 bits on the
    device.  ``mesh`` is accepted for the JAX signature and refused."""
    params = params or ClusterParams()
    dev = resolve_device(device)
    _validate_encoding(params)
    if mesh is not None:
        raise _not_ported("a mesh (multi-GPU clustering)", "11")
    items = np.ascontiguousarray(items, dtype=np.uint32)
    _validate_auto_levers(items, params)
    hp = make_params(params.scheme, params.n_hashes, params.seed).to(dev)
    rec = StageRecorder()
    t_all = time.perf_counter()
    last_run_info.clear()
    out, sig, keys = _cluster_single_host(items, hp, params, rec, dev)
    last_run_info["wire_mb"] = round(rec.nbytes.get("h2d", 0) / 2**20, 2)
    last_run_info["wire_bytes"] = int(rec.nbytes.get("h2d", 0))
    rec.set_total(time.perf_counter() - t_all)
    last_run_info["stages"] = rec.as_dict()
    return (out, sig, keys) if return_signatures else out
