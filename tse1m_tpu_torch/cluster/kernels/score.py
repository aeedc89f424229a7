"""Exact signature-agreement top-k scoring: wrapper, plain version, entry.

Ports the TPU kernel of ``tse1m_tpu/cluster/kernels/score.py``:

- ``topk_chunk`` <- ``_topk_chunk_pallas`` (``_score_topk_kernel``): score
  a [Qp, H] query block against one transposed store chunk [H, Np] by exact
  agreement count (``sum_h q[h] == s[h]``) and merge the chunk's rows into
  the running [Qp, K_PAD] top-k state.  One CUDA source (``csrc/score.cu``,
  a count pass and a select pass).
- ``topk_chunk_plain`` <- ``_topk_chunk_jnp`` and ``_merge_topk``: the same
  tile by tile, ``k`` selection steps a tile, in torch ops.
- ``topk_agreement``: the single-shot entry over an in-memory [N, H]
  signature block (rows 0..N-1), numpy in and out, the JAX package's
  contract.  The store-streamed form (``bulk_topk_store``) waits for the
  signature store.

Determinism contract, as in the JAX package: rank by (-agreement count,
ascending row); slots past the valid rows hold ``(-1, -1)`` once finalized.
The state is normalised: a slot with a negative count holds exactly (-1,
``ROW_INF``), in the kernel and in the plain version alike (the JAX merge
leaves exhausted slots with negative counts and arbitrary rows, which its
finalize step maps to (-1, -1)).

The wrapper given CUDA tensors launches the kernel on the current stream
(it checks device, dtype, shape and contiguity, allocates the outputs and
the scratch and never synchronises) or raises; given CPU tensors it runs
the plain version.  ``topk_chunk.launches`` counts its kernel launches
(one a call: both passes) and nothing else.
"""

from __future__ import annotations

import numpy as np
import torch

from ...device import resolve_device, u32_tensor
from ._build import MAX_SMEM, load_extension

# Top-k state width: one state tile a query.  ``k`` beyond it raises.
K_PAD = 128

# Sentinel row of empty and padding slots: loses every (count desc, row
# asc) tie to a real row, and survives int32 round-trips.
ROW_INF = 2**31 - 1

_QG = 16  # queries a count block (csrc/score.cu kQG)


def _require_k(k: int) -> int:
    k = int(k)
    if not 0 <= k <= K_PAD:
        raise ValueError(f"topk k={k} outside [0, {K_PAD}] (one state tile "
                         "per query)")
    return k


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
    if q.device.type == "cuda":
        if 4 * _QG * (2 * h + 1) > MAX_SMEM:
            raise ValueError(f"H={h} needs more than {MAX_SMEM} bytes of "
                             "shared memory a count block")
    elif q.device.type != "cpu":
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
    # The select pass writes every slot of the outputs.
    outc = torch.empty((qp, K_PAD), dtype=torch.int32, device=q.device)
    outr = torch.empty((qp, K_PAD), dtype=torch.int32, device=q.device)
    counts = torch.empty((qp, s_t.shape[1]), dtype=torch.int16,
                         device=q.device)
    hist = torch.zeros((qp, h + 1), dtype=torch.int32, device=q.device)
    load_extension().topk_chunk(q, s_t, rowids, topc, topr, k, counts, hist,
                                outc, outr)
    topk_chunk.launches += 1
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


def _stage_chunk(sig_rows: np.ndarray, base_row: int, chunk_rows: int,
                 device: torch.device):
    """One chunk in the kernel's layout on ``device``: the [c, H] rows
    padded with zeros to ``chunk_rows`` and transposed to [H, chunk_rows]
    (on the device), row ids ``base_row + i``, ``ROW_INF`` on padding (so
    padding columns score -1 and lose every selection)."""
    c, h = sig_rows.shape
    s = torch.zeros((chunk_rows, h), dtype=torch.int32, device=device)
    s[:c] = u32_tensor(sig_rows, device)
    rid = torch.full((1, chunk_rows), ROW_INF, dtype=torch.int32,
                     device=device)
    rid[0, :c] = torch.arange(base_row, base_row + c, dtype=torch.int32,
                              device=device)
    return s.t().contiguous(), rid


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
    chunk_rows = -(-n // block_n) * block_n
    s_t, rid = _stage_chunk(s, 0, chunk_rows, dev)
    topc, topr = _init_state(qp.shape[0], dev)
    topc, topr = topk_chunk(u32_tensor(qp, dev), s_t, rid, topc, topr, k)
    return _finalize(topc, topr, nq, k)


__all__ = ["K_PAD", "ROW_INF", "topk_agreement", "topk_chunk",
           "topk_chunk_plain"]
