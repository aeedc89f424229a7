"""The exact top-k scan and the signature store's row space, from their
definitions.

A query's score against a stored row is the number of signature rows on
which the two agree.  Its top k are ranked by score, highest first, and
equal scores by ascending stored row.  The store keeps the first
occurrence of each distinct session, in the order the sessions were
appended, so stored row r is the r-th distinct session.
"""

from __future__ import annotations

import numpy as np
import torch

ROW_BITS = 31
# Stored rows a block of the count loop compares at once.
STORE_BLOCK = 32768


def stored_rows(items: np.ndarray, device) -> np.ndarray:
    """[M] int64 indices of the sessions the store keeps, ascending: the
    first occurrence of each distinct [S] row."""
    x = torch.from_numpy(np.ascontiguousarray(items, np.uint32).view(
        np.int32)).to(device)
    _, inverse = torch.unique(x, dim=0, return_inverse=True)
    n = x.shape[0]
    first = torch.full((int(inverse.max()) + 1,), n, dtype=torch.int64,
                       device=device)
    first.scatter_reduce_(0, inverse, torch.arange(n, device=device), "amin")
    return torch.sort(first).values.cpu().numpy()


def topk(queries: torch.Tensor, store: torch.Tensor, k: int,
         low_bits: int = 32, query_block: int = 32) -> tuple:
    """[Q, H] and [M, H] signatures (int32 bit patterns) -> (counts [Q, k],
    rows [Q, k]) int64 numpy.  ``low_bits`` below 32 compares only each
    value's low bits (the control's narrower signatures).  Score and row
    go into one int64, so one ``topk`` ranks by (score desc, row asc).
    Slots past the M stored rows hold (-1, -1)."""
    if low_bits < 32:
        mask = (1 << low_bits) - 1
        queries, store = queries & mask, store & mask
    m = store.shape[0]
    inv_rows = ((1 << ROW_BITS) - 1) - torch.arange(
        m, dtype=torch.int64, device=store.device)
    counts_out, rows_out = [], []
    for qlo in range(0, queries.shape[0], query_block):
        q = queries[qlo:qlo + query_block]
        counts = torch.empty((q.shape[0], m), dtype=torch.int64,
                             device=store.device)
        for lo in range(0, m, STORE_BLOCK):
            blk = store[lo:lo + STORE_BLOCK]
            counts[:, lo:lo + blk.shape[0]] = (
                q[:, None, :] == blk[None, :, :]).sum(2)
        best = torch.topk((counts << ROW_BITS) | inv_rows, min(k, m),
                          dim=1).values
        c = np.full((q.shape[0], k), -1, np.int64)
        r = np.full((q.shape[0], k), -1, np.int64)
        c[:, :best.shape[1]] = (best >> ROW_BITS).cpu().numpy()
        r[:, :best.shape[1]] = (((1 << ROW_BITS) - 1)
                                - (best & ((1 << ROW_BITS) - 1))).cpu().numpy()
        counts_out.append(c)
        rows_out.append(r)
    return np.concatenate(counts_out), np.concatenate(rows_out)
