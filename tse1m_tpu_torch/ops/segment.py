"""Segment primitives of the RQ path, as torch ops on any device.

Torch versions of the six functions of ``tse1m_tpu/ops/segment.py``,
each on tensors of one device (the card, or the CPU in the tests):

- ``segment_searchsorted``: per-segment binary search over a CSR array
  ("iteration of an event = number of builds strictly before it",
  rq1_detection_rate.py:226-227), with a fixed trip count of
  ``ceil(log2 N) + 1``.  Times are one int64 nanosecond lane: the JAX
  package splits them into two int32 lanes (``ns_to_device_pair``) by floor
  division and modulo, whose lexicographic order is the int64 order.
- ``counts_to_survival``: #segments with >= k elements, k = 1..max_k.
- ``unique_pairs_count_per_iteration``: unique segments hitting each
  iteration (a boolean grid, out-of-range iterations dropped into a
  scratch column).
- ``masked_mean``, ``masked_spearman`` and ``masked_percentile`` over
  padded ragged rows, in float32 as the JAX package.

No op reads a value back to the host, so a chain of them queues on the
card without a synchronisation.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_BIG = float(np.finfo(np.float32).max)


def segment_searchsorted(values: torch.Tensor, offsets: torch.Tensor,
                         queries: torch.Tensor, query_segments: torch.Tensor,
                         side: str = "left") -> torch.Tensor:
    """[Q] int32 insertion positions of ``queries`` relative to each
    query's segment start in ``values`` (sorted ascending within each
    segment of the [P+1] int64 ``offsets``).  side 'left': the count of
    elements strictly below the query; 'right': the count at or below."""
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', not {side!r}")
    n = values.shape[0]
    if n == 0:
        return torch.zeros(queries.shape, dtype=torch.int32,
                           device=queries.device)
    lo = offsets[query_segments]
    hi = offsets[query_segments + 1]
    start = lo
    for _ in range(max(1, int(math.ceil(math.log2(max(n, 2)))) + 1)):
        active = lo < hi
        mid = torch.clamp((lo + hi) // 2, 0, n - 1)
        v = values[mid]
        go_right = (v < queries) if side == "left" else (v <= queries)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return (lo - start).to(torch.int32)


def counts_to_survival(counts: torch.Tensor, max_k: int) -> torch.Tensor:
    """[max_k] int32: out[k-1] = #segments with count >= k."""
    hist = torch.zeros(max_k + 1, dtype=torch.int64, device=counts.device)
    hist.index_add_(0, torch.clamp(counts.to(torch.int64), 0, max_k),
                    torch.ones_like(counts, dtype=torch.int64))
    return (counts.shape[0] - torch.cumsum(hist, 0)[:-1]).to(torch.int32)


def unique_pairs_count_per_iteration(segments: torch.Tensor,
                                     iterations: torch.Tensor,
                                     n_segments: int,
                                     max_k: int) -> torch.Tensor:
    """[max_k] int32: out[k-1] = #unique segments with an event at 1-based
    iteration k; iterations outside 1..max_k are ignored."""
    valid = (iterations >= 1) & (iterations <= max_k)
    col = torch.where(valid, iterations, 0).to(torch.int64)
    grid = torch.zeros((n_segments, max_k + 1), dtype=torch.bool,
                       device=segments.device)
    grid[segments.to(torch.int64), col] = True
    return grid[:, 1:].sum(dim=0, dtype=torch.int32)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """float32 mean of each row's valid entries; NaN where none."""
    x = x.to(torch.float32)
    n = mask.sum(dim=-1)
    s = torch.where(mask, x, 0.0).sum(dim=-1)
    return torch.where(n > 0, s / n, torch.nan)


def masked_spearman(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Spearman correlation of each padded row against its session index
    (rq2_coverage_count.py:316-320): average ranks over ties, Pearson on
    the ranks, float32.  Rows with < 2 valid entries or zero variance give
    NaN.  The rank of a tie group is its positions' sum over its size;
    both are integer counts (index_add_ of int64), so exact."""
    x = x.to(torch.float32)
    R, C = x.shape
    if C == 0:
        return torch.full((R,), torch.nan, dtype=torch.float32,
                          device=x.device)
    filled = torch.where(mask, x, _BIG)
    order = torch.argsort(filled, dim=-1, stable=True)  # valid first
    sorted_vals = torch.gather(filled, 1, order)
    new_grp = torch.ones((R, C), dtype=torch.bool, device=x.device)
    new_grp[:, 1:] = sorted_vals[:, 1:] != sorted_vals[:, :-1]
    gid = torch.cumsum(new_grp.to(torch.int64), dim=1) - 1
    flat = (gid + torch.arange(R, device=x.device)[:, None] * C).reshape(-1)
    pos = torch.arange(C, device=x.device).expand(R, C).reshape(-1)
    gsum = torch.zeros(R * C, dtype=torch.int64, device=x.device)
    gsum.index_add_(0, flat, pos)
    gcnt = torch.zeros(R * C, dtype=torch.int64, device=x.device)
    gcnt.index_add_(0, flat, torch.ones_like(pos))
    avg_pos = (gsum.to(torch.float32)
               / torch.clamp(gcnt, min=1).to(torch.float32)).view(R, C)
    ranks_sorted = torch.gather(avg_pos, 1, gid) + 1.0  # 1-based
    ranks = torch.zeros((R, C), dtype=torch.float32, device=x.device)
    ranks.scatter_(1, order, ranks_sorted)
    # Index ranks: 1..n over the valid entries in their original order.
    mf = mask.to(torch.float32)
    ry = torch.cumsum(mf, dim=1) * mf
    n = mf.sum(dim=1)
    rx = torch.where(mask, ranks, 0.0)
    sx, sy = rx.sum(dim=1), ry.sum(dim=1)
    sxx, syy, sxy = (rx * rx).sum(dim=1), (ry * ry).sum(dim=1), \
        (rx * ry).sum(dim=1)
    nn = torch.clamp(n, min=1.0)
    cov = sxy - sx * sy / nn
    vx = sxx - sx * sx / nn
    vy = syy - sy * sy / nn
    denom = torch.sqrt(vx * vy)
    return torch.where((n >= 2) & (denom > 0), cov / denom, torch.nan)


def masked_percentile(x: torch.Tensor, mask: torch.Tensor, q):
    """Percentiles of each padded row's valid entries, linear
    interpolation as np.percentile, float32: [K, R] for a sequence q,
    [R] for a scalar; NaN for rows with no valid entry."""
    scalar_q = np.ndim(q) == 0
    x = x.to(torch.float32)
    R, C = x.shape
    qs = torch.as_tensor(np.atleast_1d(np.asarray(q, dtype=np.float32)),
                         device=x.device)
    if C == 0:
        out = torch.full((qs.shape[0], R), torch.nan, dtype=torch.float32,
                         device=x.device)
        return out[0] if scalar_q else out
    s = torch.sort(torch.where(mask, x, _BIG), dim=-1).values
    n_valid = mask.sum(dim=-1)
    pos = (n_valid.to(torch.float32)[None, :] - 1.0) * qs[:, None] / 100.0
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, C - 1)
    hi = torch.clamp(lo + 1, 0, C - 1)
    frac = pos - lo.to(torch.float32)
    vlo = torch.gather(s, 1, lo.T).T
    vhi = torch.gather(s, 1, hi.T).T
    hi_valid = (lo + 1) <= (n_valid[None, :] - 1)
    out = vlo + torch.where(hi_valid, frac * (vhi - vlo), 0.0)
    out = torch.where(n_valid[None, :] > 0, out, torch.nan)
    return out[0] if scalar_q else out


__all__ = ["counts_to_survival", "masked_mean", "masked_percentile",
           "masked_spearman", "segment_searchsorted",
           "unique_pairs_count_per_iteration"]
