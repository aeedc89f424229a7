"""Banded-LSH bucket structure and verified min-label propagation.

Each LSH bucket elects its minimum item index as representative (sort by
band key, segment-min), candidate edges (item -> rep) are verified by
estimated Jaccard (fraction of agreeing MinHash rows), and cluster labels
converge by min-label propagation with pointer jumping over the accepted
star edges.  Plain PyTorch ops on the device: no hand kernel, as the JAX
package leaves these to XLA.  Labels are the same as the JAX package's
element for element (held in tests/test_torch_lsh.py).
"""

from __future__ import annotations

import torch


def band_hub_election(k: torch.Tensor, vals: torch.Tensor,
                      lane_of: torch.Tensor | None = None) -> torch.Tensor:
    """One band's hub election: [N] keys -> [N] rep row index (int64).

    Sort the keys, mark where runs of equal keys start, segment-min the
    election values ``vals`` (original indices) within runs, map the winner
    into row order through ``lane_of`` when given, scatter back.  Keys are
    int32 bit patterns; equal-key runs do not depend on whether the sort
    reads them signed or unsigned."""
    n = k.shape[0]
    ks, order = torch.sort(k)
    new_run = torch.ones(n, dtype=torch.bool, device=k.device)
    new_run[1:] = ks[1:] != ks[:-1]
    seg = torch.cumsum(new_run, 0) - 1
    run_min = torch.full((n,), n, dtype=vals.dtype, device=k.device)
    run_min.scatter_reduce_(0, seg, vals[order], "amin")
    rep_sorted = run_min[seg]
    if lane_of is not None:
        rep_sorted = lane_of[rep_sorted]
    rep = torch.empty_like(vals)
    rep[order] = rep_sorted
    return rep


def bucket_representatives(keys: torch.Tensor,
                           orig: torch.Tensor | None = None,
                           lane_of: torch.Tensor | None = None,
                           ) -> torch.Tensor:
    """[N, B] band keys -> [N, B] int64 reps: min item index sharing the
    key in that band.  Items in singleton buckets get themselves.

    ``orig`` / ``lane_of`` (both [N] int64, inverse permutations) make the
    election independent of row order when rows arrive in the delta
    encoder's lane order: the hub is the member with the minimum original
    index (``orig``: row -> original index), mapped back into row order by
    ``lane_of``.  Buckets are sets, so the hub, the verified edges and the
    labels are those of the unencoded run."""
    n, n_bands = keys.shape
    vals = (torch.arange(n, dtype=torch.int64, device=keys.device)
            if orig is None else orig)
    return torch.stack([band_hub_election(keys[:, j], vals, lane_of)
                        for j in range(n_bands)], dim=1)


def estimated_jaccard(sig: torch.Tensor, reps: torch.Tensor) -> torch.Tensor:
    """[N, H] signatures, [N, B] rep indices -> [N, B] float32 estimated
    Jaccard = fraction of MinHash rows agreeing with the rep's row.

    Looped over bands so nothing of shape [N, B, H] is built; the division
    is float32 count / float32 H, exactly as the JAX package computes it."""
    n, h = sig.shape
    out = torch.empty(reps.shape, dtype=torch.float32, device=sig.device)
    for j in range(reps.shape[1]):
        agree = (sig[reps[:, j]] == sig).sum(dim=1)
        out[:, j] = agree.to(torch.float32) / float(h)
    return out


def propagate_labels(reps: torch.Tensor, valid: torch.Tensor,
                     n_iters: int = 64) -> torch.Tensor:
    """Min-label propagation over verified star edges, to convergence.

    reps: [N, B] rep item index per band; valid: [N, B] accepted edges.
    Returns [N] int32 labels = min item index reachable in each component.
    Each step pulls (my label drops to my reps' labels), pushes (my reps'
    labels drop to mine, a scatter-min) and pointer-jumps; the loop stops one
    step after labels stop changing, or after ``n_iters`` steps."""
    n = reps.shape[0]
    self_idx = torch.arange(n, dtype=torch.int64, device=reps.device)
    reps = torch.where(valid, reps.to(torch.int64), self_idx[:, None])
    flat = reps.reshape(-1)
    labels = self_idx
    for _ in range(n_iters):
        new = torch.minimum(labels, labels[reps].amin(dim=1))
        pushed = new.scatter_reduce(0, flat, new[:, None].expand_as(reps)
                                    .reshape(-1), "amin")
        new = torch.minimum(new, pushed)
        new = torch.minimum(new, new[new])
        changed = bool((new != labels).any())
        labels = new
        if not changed:
            break
    return labels.to(torch.int32)
