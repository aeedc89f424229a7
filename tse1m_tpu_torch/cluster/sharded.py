"""Band-sharded clustering over a mesh: a port of ``_band_sharded_tail``
and ``_sharded_cluster_kernel`` (``tse1m_tpu/cluster/sharded.py:44-125``).

The SPMD contract: every rank of the mesh calls ``sharded_labels`` at the
same point with its own block of rows (rank r holds global rows
[r * nl, (r + 1) * nl), every block nl rows), and every rank returns the
same replicated [N] int32 labels, equal element for element to the
single-device run over the N rows.

- Signatures and band keys are row-local: each rank computes its block's
  through the scheme dispatch (``schemes.py``), so the MinHash kernels
  run (kernel 3 on the 24-bit pack, kernel 1 on raw ids, kernel 2 under
  cminhash and weighted), where JAX's mesh hashes in plain jnp because
  Pallas does not trace inside its ``shard_map`` body.
- ``all_to_all_cols`` re-shards the keys [N/d, B] -> [N, B/d]: each rank
  owns every row of B/d bands and sorts only those.  Where d does not
  divide B, dummy bands keyed by the global row id pad the key matrix:
  each dummy bucket is a singleton, its rep is the row itself, and it adds
  no edge.
- Hub election stays by global row id (the received row blocks arrive in
  rank order), so the verified edges, and the labels, are the
  single-device path's.
- ``all_gather_rows`` replicates the signatures for the edge check (the
  one O(N * H) exchange: 512 MB at 1M x 128).
- Label propagation keeps labels replicated and reduces each pull and
  push with ``pmin`` (``lsh.propagate_labels(mesh=)``).

Under a profiler the signature stage is the region ``tse1m.minhash`` and
the tail ``tse1m.lsh``, around the mesh's and the tail's own regions.
"""

from __future__ import annotations

import torch

from ..observability.tracing import region
from .lsh import bucket_representatives, estimated_jaccard, propagate_labels
from .schemes import scheme_sig_and_keys, scheme_sig_and_keys_packed


def _band_sharded_tail(sig_loc: torch.Tensor, keys_loc: torch.Tensor, mesh,
                       pad_bands: int, threshold: float,
                       n_iters: int) -> torch.Tensor:
    """This rank's (signatures, band keys) blocks -> replicated labels."""
    if pad_bands:
        nl = keys_loc.shape[0]
        gid = (mesh.rank * nl + torch.arange(nl, device=keys_loc.device)
               ).to(torch.int32)
        keys_loc = torch.cat([keys_loc, gid[:, None].expand(nl, pad_bands)],
                             dim=1)
    kt = mesh.all_to_all_cols(keys_loc)                # [N, B/d]
    sig = mesh.all_gather_rows(sig_loc)                # [N, H]
    n = sig.shape[0]
    reps_t = bucket_representatives(kt)                # [N, B/d]
    est_t = estimated_jaccard(sig, reps_t)
    self_idx = torch.arange(n, device=sig.device)[:, None]
    valid_t = (est_t >= threshold) & (reps_t != self_idx)
    return propagate_labels(reps_t, valid_t, n_iters=n_iters, mesh=mesh)


def sharded_labels(rows: torch.Tensor, hp, mesh, n_bands: int,
                   threshold: float, n_iters: int,
                   packed_shape: tuple | None = None) -> torch.Tensor:
    """[N] int32 labels on the rank's device from its block of rows.

    ``rows``: [nl, S] int32 ids (uint32 bits), or, with ``packed_shape`` =
    (nl, S), the flat uint8 bytes of the 24-bit pack ([nl, S, 3]
    little-endian, the packed kernel's wire at k = 3, offset 0)."""
    with region("tse1m.minhash"):
        if packed_shape is None:
            sig_loc, keys_loc = scheme_sig_and_keys(rows, hp, n_bands)
        else:
            sig_loc, keys_loc = scheme_sig_and_keys_packed(
                rows, packed_shape, 3, 0, hp, n_bands)
    pad_bands = (-n_bands) % mesh.size
    with region("tse1m.lsh"):
        return _band_sharded_tail(sig_loc, keys_loc, mesh, pad_bands,
                                  threshold, n_iters)


__all__ = ["sharded_labels"]
