"""Exact signature-agreement top-k scoring: wrapper, plain version, entries.

Ports the TPU kernel of ``tse1m_tpu/cluster/kernels/score.py``:

- ``topk_chunk`` <- ``_topk_chunk_pallas`` (``_score_topk_kernel``): score
  a [Qp, H] query block against one transposed store chunk [H, Np] by exact
  agreement count (``sum_h q[h] == s[h]``) and merge the chunk's rows into
  the running [Qp, K_PAD] top-k state.  One CUDA source (``csrc/score.cu``,
  a count pass that reads the chunk once per 64 queries and a select
  pass).
- ``topk_chunk_plain`` <- ``_topk_chunk_jnp`` and ``_merge_topk``: the same
  tile by tile, ``k`` selection steps a tile, in torch ops.
- ``score_topk_host``: the numpy oracle, a copy of the JAX package's.
- ``topk_agreement``: the single-shot entry over an in-memory [N, H]
  signature block (rows 0..N-1), numpy in and out, the JAX package's
  contract: one chunk of N rows padded to a multiple of ``block_n``.
- ``bulk_topk_store``: every row of a signature store
  (``cluster/store.py``), shard by shard in sorted id order, as fixed
  ``chunk_rows``-column chunks (the tail padded with ``ROW_INF`` columns)
  through one launch a chunk, the [Qp, K_PAD] state carried from launch
  to launch; ``store_scan_locator`` maps its scan-global rows back to
  (shard, row).

Staging (``_staged``): a producer thread copies each block of rows into
one of two pinned host buffers and from there, on a side stream, into one
of two preallocated device buffers; before it reuses a buffer it waits for
that buffer's previous copy (host side) and for the main stream's last read
of it (device side).  The main stream waits for the copy, transposes the
rows into the chunk's [H, Np] layout and launches.  ``topk_agreement``
fills its one chunk through the same staging, 16,384 rows at a time.
Under a profiler a scan opens five regions: ``tse1m.scan.prepare`` (the
queries padded and uploaded, the state and the chunk's scratch
allocated), ``tse1m.scan.stage_setup`` (the first block read and handed
to the producer, which starts its thread), ``tse1m.scan.wait`` (the main
thread blocked on the producer), ``tse1m.scan.chunk`` a chunk (the
transpose copy and the launch) and ``tse1m.scan.finalize`` (the answers'
fetch).  The producer thread opens none: a profiler that follows only
the thread that started it would not record it.

Determinism contract, as in the JAX package: rank by (-agreement count,
ascending row); slots past the valid rows hold ``(-1, -1)`` once finalized.
The state is normalised: a slot with a negative count holds exactly (-1,
``ROW_INF``), in the kernel and in the plain version alike (the JAX merge
leaves exhausted slots with negative counts and arbitrary rows, which its
finalize step maps to (-1, -1)).

The wrapper given CUDA tensors launches the kernel on the current stream
(it checks device, dtype, shape and contiguity, allocates the outputs and
the scratch and never synchronises) or raises; given CPU tensors it runs
the plain version.  The count pass copies the chunk by 16-byte rows, so
on the card a chunk whose column count is not a multiple of 4 is padded
with ``ROW_INF`` columns first (a copy; ``topk_agreement``'s chunks, a
multiple of ``block_n`` columns, never need it).  ``topk_chunk.launches``
counts its kernel launches (one a call: both passes) and nothing else.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ...device import resolve_device, u32_tensor
from ...observability.tracing import region
from ._build import load_extension
from ._count import count_launch

# Top-k state width: one state tile a query.  ``k`` beyond it raises.
K_PAD = 128

# Sentinel row of empty and padding slots: loses every (count desc, row
# asc) tie to a real row, and survives int32 round-trips.
ROW_INF = 2**31 - 1
# Rows of one staging buffer: the scan's default chunk, and the pieces
# topk_agreement's one chunk is filled in.
STAGE_ROWS = 16384


def _require_k(k: int) -> int:
    k = int(k)
    if not 0 <= k <= K_PAD:
        raise ValueError(f"topk k={k} outside [0, {K_PAD}] (one state tile "
                         "per query)")
    return k


def score_topk_host(query_sigs: np.ndarray, store_sigs: np.ndarray,
                    k: int, block_rows: int = 4096
                    ) -> tuple[np.ndarray, np.ndarray]:
    """[Q, H] x [N, H] uint32 -> (counts [Q, k] int32, rows [Q, k]
    int32), ranked by (-agreement, ascending row); ``-1`` pads both past
    ``min(k, N)``.  The numpy oracle: the [Q, N] count matrix filled
    ``block_rows`` store rows at a time, then a stable argsort."""
    k = _require_k(k)
    q = np.ascontiguousarray(query_sigs, np.uint32)
    s = np.ascontiguousarray(store_sigs, np.uint32)
    nq, n = int(q.shape[0]), int(s.shape[0])
    counts_out = np.full((nq, k), -1, np.int32)
    rows_out = np.full((nq, k), -1, np.int32)
    if nq == 0 or n == 0 or k == 0:
        return counts_out, rows_out
    counts = np.empty((nq, n), np.int32)
    for lo in range(0, n, block_rows):
        blk = s[lo:lo + block_rows]
        counts[:, lo:lo + blk.shape[0]] = (
            q[:, None, :] == blk[None, :, :]).sum(axis=2, dtype=np.int32)
    # Stable argsort on negated counts: ties resolve to the ascending
    # row, the kernel's selection order.
    order = np.argsort(-counts, axis=1, kind="stable")[:, :k]
    m = min(k, n)
    rows_out[:, :m] = order[:, :m].astype(np.int32)
    counts_out[:, :m] = np.take_along_axis(counts, order, axis=1)[:, :m]
    return counts_out, rows_out


def _normalize(topc: torch.Tensor, topr: torch.Tensor):
    """Every slot with a negative count becomes (-1, ROW_INF)."""
    empty = topc < 0
    return (torch.where(empty, -1, topc),
            torch.where(empty, ROW_INF, topr))


def _merge_topk(topc, topr, counts, rows, k: int):
    """Merge a [Qp, BN] tile of (count, row) candidates into the [Qp, K_PAD]
    state: ``k`` selection steps, each the max count over both sources, the
    min row among the maxima, written to slot t, the winner retired (-2)."""
    c = torch.cat([counts, topc], 1)
    r = torch.cat([rows, topr], 1)
    newc = torch.full_like(topc, -1)
    newr = torch.full_like(topr, ROW_INF)
    for t in range(k):
        best = c.amax(1, keepdim=True)
        brow = torch.where(c == best, r, ROW_INF).amin(1, keepdim=True)
        newc[:, t] = best[:, 0]
        newr[:, t] = brow[:, 0]
        c = torch.where((c == best) & (r == brow), -2, c)
    return newc, newr


def topk_chunk_plain(q: torch.Tensor, s_t: torch.Tensor,
                     rowids: torch.Tensor, topc: torch.Tensor,
                     topr: torch.Tensor, k: int, block_n: int = 512):
    """Plain version of the kernel: the chunk's [H, block_n] tiles in
    order, each counted and merged into the state, then normalised.  A
    chunk of no columns still merges once (the incoming state's top k)."""
    rid = rowids.reshape(1, -1)
    for lo in range(0, max(s_t.shape[1], 1), block_n):
        tile = s_t[:, lo:lo + block_n]
        counts = (q[:, :, None] == tile[None]).sum(1, dtype=torch.int32)
        rows = rid[:, lo:lo + block_n].expand_as(counts)
        counts = torch.where(rows < ROW_INF, counts, -1)
        topc, topr = _merge_topk(topc, topr, counts, rows, k)
    return _normalize(topc, topr)


def _check(q, s_t, rowids, topc, topr, k: int) -> None:
    _require_k(k)
    for name, t in (("q", q), ("s_t", s_t), ("rowids", rowids),
                    ("topc", topc), ("topr", topr)):
        if t.dtype != torch.int32 or t.dim() != 2:
            raise ValueError(f"{name} must be a 2-D int32 tensor, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if q.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    qp, h = q.shape
    if qp < 1 or not 1 <= h < 2**15 - 1:
        raise ValueError(f"q must be [Qp >= 1, 1 <= H < 32767], got "
                         f"{tuple(q.shape)}")
    if s_t.shape[0] != h or rowids.shape != (1, s_t.shape[1]):
        raise ValueError(f"need s_t [H, Np] and rowids [1, Np] for H={h}; "
                         f"got {tuple(s_t.shape)}, {tuple(rowids.shape)}")
    if topc.shape != (qp, K_PAD) or topr.shape != (qp, K_PAD):
        raise ValueError(f"state must be [{qp}, {K_PAD}], got "
                         f"{tuple(topc.shape)}, {tuple(topr.shape)}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {q.device}")


def topk_chunk(q: torch.Tensor, s_t: torch.Tensor, rowids: torch.Tensor,
               topc: torch.Tensor, topr: torch.Tensor, k: int):
    """Queries [Qp, H] and one chunk s_t [H, Np] (int32 carrying uint32
    bits), rowids [1, Np] int32 (ascending along the chunk, ``ROW_INF`` on
    padding), state [Qp, K_PAD] int32 pair -> the merged, normalised state.
    """
    _check(q, s_t, rowids, topc, topr, k)
    if q.device.type == "cpu":
        return topk_chunk_plain(q, s_t, rowids, topc, topr, k)
    qp, h = q.shape
    if not k:
        return _init_state(qp, q.device)
    if s_t.shape[1] % 4 or s_t.data_ptr() % 16:
        pad = -s_t.shape[1] % 4
        s_t = torch.nn.functional.pad(s_t, (0, pad))
        rowids = torch.nn.functional.pad(rowids, (0, pad), value=ROW_INF)
    # The select pass writes every slot of the outputs.
    outc = torch.empty((qp, K_PAD), dtype=torch.int32, device=q.device)
    outr = torch.empty((qp, K_PAD), dtype=torch.int32, device=q.device)
    counts = torch.empty((qp, s_t.shape[1]), dtype=torch.int16,
                         device=q.device)
    hist = torch.zeros((qp, h + 1), dtype=torch.int32, device=q.device)
    load_extension().topk_chunk(q, s_t, rowids, topc, topr, k, counts, hist,
                                outc, outr, 3)
    count_launch(topk_chunk)
    return outc, outr


topk_chunk.launches = 0


def _pad_queries(query_sigs: np.ndarray) -> np.ndarray:
    """pow2 row padding, min 8, as in the JAX package."""
    nq = int(query_sigs.shape[0])
    padded = max(8, 1 << max(0, nq - 1).bit_length())
    if padded == nq:
        return query_sigs
    out = np.zeros((padded, query_sigs.shape[1]), np.uint32)
    out[:nq] = query_sigs
    return out


def _init_state(qp: int, device: torch.device):
    return (torch.full((qp, K_PAD), -1, dtype=torch.int32, device=device),
            torch.full((qp, K_PAD), ROW_INF, dtype=torch.int32,
                       device=device))


def _staged(blocks, rows: int, h: int, device: torch.device,
            overlap: bool):
    """Stage ``(block, base)`` pairs of [c <= rows, H] uint32 rows on
    ``device``; yields ``(rows_d, base)``, rows_d a [c, H] int32 view of a
    device buffer that the current stream may read once it has been
    yielded, and that is reused after the caller asks for the next block
    (so the caller enqueues its reads of it before then).

    Two pinned host buffers and two device buffers, used in turn.  With
    ``overlap`` block k+1 is staged on a producer thread while the caller
    works on block k.  On the CPU the host buffers serve as the device
    buffers and no stream is involved."""
    cuda = device.type == "cuda"
    host = [torch.empty((rows, h), dtype=torch.int32, pin_memory=cuda)
            for _ in range(2)]
    if cuda:
        dbuf = [torch.empty((rows, h), dtype=torch.int32, device=device)
                for _ in range(2)]
        side = torch.cuda.Stream(device)
        copied = [torch.cuda.Event() for _ in range(2)]
        read = [torch.cuda.Event() for _ in range(2)]
        main = torch.cuda.current_stream(device)
    else:
        dbuf = host

    def produce(i: int, blk: np.ndarray, base: int):
        c = int(blk.shape[0])
        if cuda:
            copied[i].synchronize()     # the pinned buffer's last copy
        host[i].numpy()[:c] = np.ascontiguousarray(blk, np.uint32).view(
            np.int32)
        if cuda:
            with torch.cuda.stream(side):
                side.wait_event(read[i])    # the main stream's last read
                dbuf[i][:c].copy_(host[i][:c], non_blocking=True)
                copied[i].record(side)
        return i, c, base

    def take(i: int, c: int, base: int):
        if cuda:
            main.wait_event(copied[i])
        return dbuf[i][:c], base

    def release(i: int) -> None:
        if cuda:
            read[i].record(main)

    blocks = iter(blocks)
    if not overlap:
        for k, (blk, base) in enumerate(blocks):
            yield take(*produce(k % 2, blk, base))
            release(k % 2)
        return
    ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tse1m-scan")
    try:
        with region("tse1m.scan.stage_setup"):
            nxt = next(blocks, None)
            fut = None if nxt is None else ex.submit(produce, 0, *nxt)
        k = 0
        while fut is not None:
            with region("tse1m.scan.wait"):
                i, c, base = fut.result()
            nxt = next(blocks, None)
            fut = (None if nxt is None
                   else ex.submit(produce, (k + 1) % 2, *nxt))
            yield take(i, c, base)
            release(i)
            k += 1
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def _row_ids(n_cols: int, n: int, base: int, device: torch.device):
    """[1, n_cols] int32: ``base + i`` for the first n columns, ROW_INF on
    padding (whose columns score -1 and lose every selection)."""
    cols = torch.arange(n_cols, dtype=torch.int32, device=device)
    return torch.where(cols < n, cols + base, ROW_INF).reshape(1, n_cols)


def _stage_block(sigs: np.ndarray, base_row: int, n_cols: int,
                 device: torch.device):
    """One chunk of [n, H] rows in the kernel's layout on ``device``: the
    rows staged STAGE_ROWS at a time and transposed into [H, n_cols]
    (zeros past n), row ids ``base_row + i`` (ROW_INF past n)."""
    n, h = sigs.shape
    s_t = torch.empty((h, n_cols), dtype=torch.int32, device=device)
    s_t[:, n:].zero_()
    pieces = ((sigs[lo:lo + STAGE_ROWS], lo) for lo in range(0, n,
                                                            STAGE_ROWS))
    for rows_d, lo in _staged(pieces, max(1, min(STAGE_ROWS, n)), h, device,
                              overlap=True):
        s_t[:, lo:lo + rows_d.shape[0]].copy_(rows_d.t())
    return s_t, _row_ids(n_cols, n, base_row, device)


def _finalize(topc: torch.Tensor, topr: torch.Tensor, nq: int, k: int):
    counts = topc[:nq, :k].cpu().numpy().astype(np.int32, copy=True)
    rows = topr[:nq, :k].cpu().numpy().astype(np.int32, copy=True)
    empty = counts < 0
    counts[empty] = -1
    rows[empty] = -1
    return counts, rows


def topk_agreement(query_sigs: np.ndarray, store_sigs: np.ndarray, k: int,
                   *, device: str | torch.device = "cuda",
                   block_n: int = 512) -> tuple[np.ndarray, np.ndarray]:
    """[Q, H] x [N, H] uint32 signatures -> (counts [Q, k] int32, rows
    [Q, k] int32), ranked by (-agreement, ascending row); ``-1`` pads both
    past ``min(k, N)``.  Runs on ``device``, the card unless the caller
    asks for the CPU; raises without a card.  One chunk of N rows padded to
    a multiple of ``block_n``."""
    k = _require_k(k)
    dev = resolve_device(device)
    q = np.ascontiguousarray(query_sigs, np.uint32)
    s = np.ascontiguousarray(store_sigs, np.uint32)
    if q.ndim != 2 or s.ndim != 2 or q.shape[1] != s.shape[1]:
        raise ValueError(f"need [Q, H] queries and [N, H] signatures; got "
                         f"{q.shape}, {s.shape}")
    nq, n = int(q.shape[0]), int(s.shape[0])
    if nq == 0 or k == 0 or n == 0:
        return np.full((nq, k), -1, np.int32), np.full((nq, k), -1, np.int32)
    qp = _pad_queries(q)
    s_t, rid = _stage_block(s, 0, -(-n // block_n) * block_n, dev)
    topc, topr = _init_state(qp.shape[0], dev)
    topc, topr = topk_chunk(u32_tensor(qp, dev), s_t, rid, topc, topr, k)
    return _finalize(topc, topr, nq, k)


def _scan_chunks(store, chunk_rows: int):
    """Yield (signature rows [c, H], scan-global base row) over the
    store's shards in sorted-id order: the scan's row space (see
    ``store_scan_locator``).  The rows are views of the shard's mmap; the
    staging thread reads them from disk."""
    base = 0
    for entry in sorted(store.shards, key=lambda e: int(e["id"])):
        sid, rows = int(entry["id"]), int(entry["rows"])
        mm = store._sig_mmap(sid)
        for lo in range(0, rows, chunk_rows):
            yield np.asarray(mm[lo:min(lo + chunk_rows, rows)]), base + lo
        base += rows


def store_scan_locator(store, rows: np.ndarray) -> np.ndarray:
    """Scan-global row ids -> [K, 2] int32 (shard, row) locators under
    the sorted-shard-id scan order; ``-1`` rows map to ``(-1, -1)``."""
    rows = np.asarray(rows, np.int64)
    loc = np.full((rows.shape[0], 2), -1, np.int32)
    base = 0
    for entry in sorted(store.shards, key=lambda e: int(e["id"])):
        sid, n = int(entry["id"]), int(entry["rows"])
        sel = (rows >= base) & (rows < base + n)
        loc[sel, 0] = sid
        loc[sel, 1] = (rows[sel] - base).astype(np.int32)
        base += n
    return loc


def bulk_topk_store(store, query_sigs: np.ndarray, k: int, *,
                    device: str | torch.device = "cuda", block_n: int = 512,
                    chunk_rows: int = STAGE_ROWS, overlap: bool = True
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Score [Q, H] query signatures against every committed row of
    ``store``; returns (counts [Q, k], rows [Q, k]) int32 over the
    scan-global row space (``store_scan_locator`` maps back to (shard,
    row)), equal to ``score_topk_host`` over the shards concatenated in
    scan order.  Runs on ``device``, the card unless the caller asks for
    the CPU.

    Every chunk is ``chunk_rows`` columns (rounded up to ``block_n``; the
    tail of a shard padded), one ``topk_chunk`` launch each; with
    ``overlap`` chunk k+1 is staged while chunk k is scored.  Row ids are
    int32, as in the JAX package: a store of 2^31 rows or more raises."""
    k = _require_k(k)
    dev = resolve_device(device)
    q = np.ascontiguousarray(query_sigs, np.uint32)
    nq, n_rows = int(q.shape[0]), int(store.n_rows)
    if n_rows >= 2**31:
        raise ValueError(f"store of {n_rows} rows: scan row ids are int32, "
                         f"so a scan covers fewer than 2^31 rows")
    h = int(store.policy["n_hashes"])
    if q.ndim != 2 or (nq and q.shape[1] != h):
        raise ValueError(f"need [Q, {h}] queries for this store; got "
                         f"{q.shape}")
    if nq == 0 or k == 0 or n_rows == 0:
        return np.full((nq, k), -1, np.int32), np.full((nq, k), -1, np.int32)
    chunk_rows = max(block_n, -(-int(chunk_rows) // block_n) * block_n)
    with region("tse1m.scan.prepare"):
        qp = _pad_queries(q)
        q_d = u32_tensor(qp, dev)
        topc, topr = _init_state(qp.shape[0], dev)
        s_t = torch.empty((h, chunk_rows), dtype=torch.int32, device=dev)
    for rows_d, base in _staged(_scan_chunks(store, chunk_rows), chunk_rows,
                                h, dev, overlap):
        with region("tse1m.scan.chunk"):
            c = rows_d.shape[0]
            s_t[:, :c].copy_(rows_d.t())
            s_t[:, c:].zero_()
            topc, topr = topk_chunk(q_d, s_t,
                                    _row_ids(chunk_rows, c, base, dev),
                                    topc, topr, k)
    with region("tse1m.scan.finalize"):
        return _finalize(topc, topr, nq, k)


__all__ = ["K_PAD", "ROW_INF", "bulk_topk_store", "score_topk_host",
           "store_scan_locator", "topk_agreement", "topk_chunk",
           "topk_chunk_plain"]
