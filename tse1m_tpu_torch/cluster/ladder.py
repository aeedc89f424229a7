"""The degradation ladder: a port of ``tse1m_tpu/cluster/pipeline.py``'s
``_DeviceSupervisor``, ``_stream_minhash_degraded`` and
``_checkpointed_chunks`` (``:471-509, 676-842``).

Every streaming path of ``cluster/pipeline.py`` feeds its chunks through
:func:`_stream_minhash_degraded`, and the resumable path through
:func:`_checkpointed_chunks`.  They answer the failures of a long run:

- **Out of memory** (``torch.cuda.OutOfMemoryError``, or an injected
  ``RESOURCE_EXHAUSTED``): on a storeless plain lane, first one step down
  the b-bit quant ladder (10, then 8 bits; the stream restarts in the
  smaller universe, since all chunks must share one), then halving the
  chunk and going on from the first unfinished row.  The surviving width
  and chunk size go to the machine calibration.  The resumable path only
  halves, inside one chunk, so its shards keep their layout.
- **Stalls** (a hung copy or compute wait, cancelled by the watchdog)
  and **device loss**: retried on the same card, at most
  ``_DeviceSupervisor._MAX_RETRIES`` times in a run, then raised.  Unlike
  the JAX package's supervisor there is no failover: nothing carries on on
  the CPU.
- **A sticky CUDA error** (the context is unusable): raised at once, naming
  the checkpoint directory to resume from where there is one.

Each rung records a degradation event (``observability``), which the step
runner puts in ``run_manifest.json``.  The counters (``chunk_halvings``,
``quant_drops``, ``wire_quant_bits``) go to the caller's per-call dict,
never to a module global, so the serving daemon's ingest thread can run
the ladder beside a batch run.  Labels never change: halving and retries
are row-independent, and a quant drop equals a run at the lower width.

Completed chunks are kept.  The failed attempt's tensors go before the
retry allocates: the stream generator is closed (its producer thread
joined, dropping the chunk it staged) and the handler's traceback is left
before a rung acts.  ``torch.cuda.empty_cache()`` is not called: the
caching allocator frees its cached blocks and retries before it raises an
out-of-memory, and the memory of the failed attempt goes back to its cache,
where the smaller retry reuses it; emptying the cache would only make the
retry pay ``cudaMalloc`` again.

This module is the one place a device failure is caught; every handler
here retries on the same device or raises.
"""

from __future__ import annotations

import contextlib
import logging

import numpy as np
import torch

from ..device import as_u32_numpy
from ..observability import record_degradation
from ..resilience.watchdog import (StageWatchdog, is_device_loss,
                                   is_resource_exhausted,
                                   is_sticky_cuda_error,
                                   terminal_device_error)
from . import pipeline as pl
from .encode import quantize_ids, width_bits

log = logging.getLogger("tse1m_tpu_torch.ladder")


def _error_text(e: BaseException) -> str:
    return f"{type(e).__name__}: {e}"[:200]


class _DeviceSupervisor:
    """A run's device-failure ledger: every stall or device-loss failure
    records a ``device_retry`` event, and the run retries on the same card
    until ``_MAX_RETRIES`` failures (the JAX package's budget), then
    raises.  No ``device_failover``: the JAX package's CPU fallback is not
    ported, by design."""

    _MAX_RETRIES = 5   # total failures before the run gives up

    def __init__(self) -> None:
        self.failures = 0

    def note_failure(self, site: str, error: str) -> bool:
        """Record one device failure; True = retry, False = out of budget
        (the caller re-raises)."""
        self.failures += 1
        record_degradation("device_retry", site=site,
                           detail={"error": error,
                                   "failures": self.failures})
        return self.failures <= self._MAX_RETRIES


def _rung(e: BaseException, site: str, sup: _DeviceSupervisor,
          checkpoint_dir: str | None = None) -> str | None:
    """Which rung answers ``e``: "oom", "retry", or None (re-raise).  A
    sticky CUDA error raises the terminal error here."""
    if is_sticky_cuda_error(e):
        raise terminal_device_error(e, checkpoint_dir) from e
    if is_resource_exhausted(e):
        return "oom"
    if is_device_loss(e) and sup.note_failure(site, _error_text(e)):
        return "retry"
    return None


def _stream_minhash_degraded(rows: np.ndarray, hp, params, rec,
                             device: torch.device, want_decoded: bool,
                             lad: dict,
                             sup: _DeviceSupervisor | None = None,
                             wd: StageWatchdog | None = None,
                             initial_step: int | None = None,
                             quant_ctx: dict | None = None):
    """Stream ``rows`` chunk by chunk (double-buffered when
    ``params.overlap``) under the ladder.  ``quant_ctx`` (``{"raw": the
    rows before quantization, "bits": the current width}``, storeless
    plain lanes only) arms the quant rung ahead of halving.  Returns
    (parts [(sig, keys) a chunk], decoded chunks when ``want_decoded``
    else None, per-chunk wire bits)."""
    step = initial_step or pl._stream_plan(rows, params)
    wd = wd or pl._make_watchdog()
    sup = sup or _DeviceSupervisor()
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    parts: list = []
    decoded: list = []
    wire_bits: list = []
    pos = 0
    while True:
        chunks = pl._row_chunks(rows[pos:], step)
        done = 0
        try:
            with contextlib.closing(pl._iter_streamed(
                    chunks, rec, params.overlap, device, copy_stream,
                    params.entropy, wd)) as stream:
                for arrays_d, wire in stream:
                    sig, keys, cd = pl._chunk_minhash(
                        arrays_d, wire, hp, params, rec, device,
                        want_decoded)
                    parts.append((sig, keys))
                    wire_bits.append(wire.bits)
                    if want_decoded:
                        decoded.append(cd)
                    done += 1
                    del arrays_d, sig, keys, cd
            break
        except Exception as e:  # a rung answers it, or it is re-raised
            # Completed chunks are all full-step: only the last is short.
            pos += done * step
            rung = _rung(e, "pipeline.stream", sup)
            if rung is None:
                raise
            error = _error_text(e)
            nxt = None
            if rung == "oom" and quant_ctx is not None:
                nxt = _quant_drop_target(quant_ctx)
            if rung == "oom" and nxt is None:
                new_step = pl._halved_step(step, params)
                if new_step is None:
                    raise
        if rung == "retry":
            continue
        if nxt is not None:
            record_degradation(
                "quant_drop", site="pipeline.stream",
                detail={"from_bits": int(quant_ctx.get("bits", 0)),
                        "to_bits": int(nxt), "error": error})
            log.warning("pipeline.stream: out of memory; dropping "
                        "wire_quant_bits %s -> %d and restarting the stream",
                        quant_ctx.get("bits", 0) or "off", nxt)
            quant_ctx["bits"] = int(nxt)
            rows = quantize_ids(quant_ctx["raw"], nxt)
            lad["wire_quant_bits"] = int(nxt)
            lad["quant_drops"] = lad.get("quant_drops", 0) + 1
            pl._persist_quant_bits(nxt)
            parts.clear()
            decoded.clear()
            wire_bits.clear()
            pos = 0
            continue
        record_degradation("chunk_halving", site="pipeline.stream",
                           detail={"from_rows": int(step),
                                   "to_rows": int(new_step), "error": error})
        lad["chunk_halvings"] = lad.get("chunk_halvings", 0) + 1
        log.warning("pipeline.stream: out of memory; halving the chunk "
                    "step %d -> %d rows and resuming from row %d", step,
                    new_step, pos)
        step = new_step
        pl._persist_chunk_bytes(step, rows)
    return parts, (decoded if want_decoded else None), wire_bits


def _quant_drop_target(quant_ctx: dict) -> int | None:
    """The width the quant rung drops to, or None when it has no rung left
    or the raw ids already fit it."""
    nxt = pl._next_quant_rung(int(quant_ctx.get("bits", 0)))
    raw = quant_ctx.get("raw")
    if (nxt is not None and raw is not None and raw.size
            and width_bits(int(raw.max())) > nxt):
        return nxt
    return None


def _checkpointed_chunks(pending: list, hp, params, rec,
                         device: torch.device, ckpt, parts: dict, lad: dict,
                         want_decoded: bool = False,
                         chunks_d: list | None = None) -> None:
    """Run the pending (index, rows) checkpoint chunks under the ladder.

    Stalls and device loss retry on the same card; a chunk that runs out
    of memory recomputes in halved sub-chunks (through
    :func:`_stream_minhash_degraded`) whose results concatenate into the
    same shard, so the manifest's layout never changes mid-run.  Each
    finished chunk's (sig, keys) comes to the host and is saved before the
    next one commits; ``parts[idx]`` keeps the device copies (and
    ``chunks_d[idx]`` the decoded rows, for the encoded layout)."""
    wd = pl._make_watchdog()
    sup = _DeviceSupervisor()
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    remaining = list(pending)
    while remaining:
        done = 0
        try:
            with contextlib.closing(pl._iter_streamed(
                    [c for _, c in remaining], rec, params.overlap, device,
                    copy_stream, params.entropy, wd)) as stream:
                for (idx, _), (arrays_d, wire) in zip(remaining, stream):
                    sig, keys, cd = pl._chunk_minhash(
                        arrays_d, wire, hp, params, rec, device,
                        want_decoded)
                    _commit_chunk(ckpt, idx, sig, keys, cd, parts, chunks_d,
                                  rec)
                    done += 1
                    del arrays_d, sig, keys, cd
            break
        except Exception as e:  # a rung answers it, or it is re-raised
            remaining = remaining[done:]
            rung = _rung(e, "pipeline.resumable", sup, ckpt.directory)
            if rung is None:
                raise
            idx, chunk = remaining[0]
            half = None
            if rung == "oom":
                half = pl._halved_step(chunk.shape[0], params)
                if half is None:
                    raise
        if rung == "retry":
            continue
        record_degradation("chunk_halving", site="pipeline.resumable",
                           detail={"chunk": int(idx), "to_rows": int(half)})
        lad["chunk_halvings"] = lad.get("chunk_halvings", 0) + 1
        pl._persist_chunk_bytes(half, chunk)
        sub_parts, sub_dec, _ = _stream_minhash_degraded(
            chunk, hp, params, rec, device, want_decoded, lad, sup=sup,
            wd=wd, initial_step=half)
        sig = pl._cat([p[0] for p in sub_parts])
        keys = pl._cat([p[1] for p in sub_parts])
        cd = pl._cat(sub_dec) if want_decoded else None
        del sub_parts, sub_dec
        _commit_chunk(ckpt, idx, sig, keys, cd, parts, chunks_d, rec)
        remaining = remaining[1:]


def _commit_chunk(ckpt, idx: int, sig: torch.Tensor, keys: torch.Tensor,
                  cd, parts: dict, chunks_d: list | None, rec) -> None:
    """Save one finished chunk's shard (the D2H copy is the resume
    state), then keep its device results."""
    with rec.stage("d2h", nbytes=(sig.numel() + keys.numel()) * 4):
        sig_h, keys_h = as_u32_numpy(sig), as_u32_numpy(keys)
    ckpt.save_chunk(idx, sig_h, keys_h)
    parts[idx] = (sig, keys)
    if chunks_d is not None:
        chunks_d[idx] = cd


__all__ = ["_DeviceSupervisor", "_checkpointed_chunks",
           "_stream_minhash_degraded"]
