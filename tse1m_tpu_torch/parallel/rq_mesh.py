"""The RQ reductions over a mesh: a port of
``tse1m_tpu/parallel/rq_mesh.py``, every public function with its name and
signature, over this package's ``Mesh``.

SPMD: every rank passes the identical full host arrays, takes its block of
the sharded axis (padded to a multiple of the mesh size as ``_pad_rows``
pads), computes it on its device, and gets the same host result back.
Float reductions stay within a rank; only integer partials are summed
across ranks (``psum``), and per-row or per-column results are gathered
(``all_gather_rows``).  So each result equals the single-device one bit
for bit (``tests/test_torch_mesh_rq.py``).

- RQ1 (rq1_detection_rate.py:189-268): the issue axis is sharded; the
  ranks' boolean (project, iteration) detection grids merge by an integer
  ``psum``: set union is exact under addition and a threshold.
- RQ2 trends (rq2_coverage_count.py:330-435): per-session percentiles and
  means shard the session axis; per-session project counts shard the
  project axis and ``psum`` the partial counts; per-project Spearman
  shards the project axis.
- RQ4b (rq4b_coverage.py:910-1015): per-session group percentiles sort
  and select in float64 on the ranks, sharded by session; the two-point
  interpolation runs on the host with numpy's ``_lerp`` formula, so the
  result equals ``np.nanpercentile`` bit for bit.
- RQ3 and RQ4a: the per-issue binary searches shard the query axis.

Times arrive as the JAX package's two int32 lanes (seconds, nanosecond
remainder; ``ns_to_device_pair``), or as one int64 lane with the low lane
None (this package's ``TorchBackend``): the lanes are joined into one
int64 key of the same lexicographic order before the search.
"""

# graftlint: disable-file=wire-layer -- the mesh RQ plane's placement seat: each rank's block of the study arrays goes to its device and results gather back here; JAX's _placed stages them through jnp.asarray / make_array_from_process_local_data, which the rule does not see
from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..ops.segment import (masked_mean, masked_spearman, segment_searchsorted)
from .mesh import Mesh, make_mesh

AXIS = "data"

_F64_EXACT: dict = {}


def _device_f64_exact(device: torch.device) -> bool:
    """True iff a float64 host -> device -> host round trip is lossless
    on ``device`` (true on the CPU and on the card; JAX's TPU has no
    native float64)."""
    key = str(torch.device(device).type)
    if key not in _F64_EXACT:
        canary = np.array([1.0 + 2.0 ** -50, np.pi, 1e300], dtype=np.float64)
        # graftlint: disable=wire-layer -- 4-byte mesh-liveness canary, not a data transfer
        back = torch.from_numpy(canary).to(device).cpu().numpy()
        _F64_EXACT[key] = bool(np.array_equal(canary, back))
    return _F64_EXACT[key]


def auto_mesh() -> Mesh | None:
    """A mesh over the initialized world when it has more than one rank,
    else None."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        return make_mesh()
    return None


def _pad_rows(x: np.ndarray, n_dev: int, fill) -> np.ndarray:
    pad = (-x.shape[0]) % n_dev
    if not pad:
        return x
    block = np.full((pad,) + x.shape[1:], fill, dtype=x.dtype)
    return np.concatenate([x, block], axis=0)


def _local(mesh: Mesh, x: np.ndarray) -> torch.Tensor:
    """This rank's block of rows of a padded host array, on its device."""
    return torch.from_numpy(np.ascontiguousarray(mesh.block(x))).to(
        mesh.device)


def _full(mesh: Mesh, x) -> torch.Tensor:
    """A replicated host array on this rank's device."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)


def _gather(mesh: Mesh, t: torch.Tensor) -> np.ndarray:
    """The ranks' row blocks, in rank order, on the host."""
    return mesh.all_gather_rows(t).cpu().numpy()


def _key(hi, lo) -> np.ndarray:
    """Two int32 lanes -> one int64 key of the same lexicographic order
    (signed high lane, signed low lane); ``lo`` None: ``hi`` is the key."""
    hi = np.asarray(hi).astype(np.int64)
    if lo is None:
        return hi
    return hi * (1 << 32) + (np.asarray(lo).astype(np.int64) + (1 << 31))


# ---------------------------------------------------------------------------
# RQ1: sharded issue axis + psum'd detection grid
# ---------------------------------------------------------------------------

def rq1_kernel_mesh(mesh: Mesh, fuzz_s, fuzz_ns, fuzz_offsets,
                    ok_s, ok_ns, ok_offsets, ok_orig_idx,
                    issue_s, issue_ns, issue_seg,
                    n_projects: int, max_iter: int):
    """Sharded RQ1: issues split over the mesh, build arrays replicated,
    the detected-projects grid merged with an integer ``psum``.  Returns
    host int32 arrays (iteration_of_issue, link_idx, detected)."""
    n_dev = mesh.size
    q = int(np.asarray(issue_s).shape[0])
    issue_k = _pad_rows(_key(issue_s, issue_ns), n_dev, 0)
    seg = _pad_rows(np.asarray(issue_seg, dtype=np.int64), n_dev, 0)
    valid = _pad_rows(np.ones(q, dtype=bool), n_dev, False)
    ok_idx = np.asarray(ok_orig_idx, dtype=np.int64)

    is_, seg_d, ok_mask = (_local(mesh, issue_k), _local(mesh, seg),
                           _local(mesh, valid))
    f_off = _full(mesh, np.asarray(fuzz_offsets, dtype=np.int64))
    ok_off = _full(mesh, np.asarray(ok_offsets, dtype=np.int64))
    it = segment_searchsorted(_full(mesh, _key(fuzz_s, fuzz_ns)), f_off,
                              is_, seg_d, "left")
    pos = segment_searchsorted(_full(mesh, _key(ok_s, ok_ns)), ok_off, is_,
                               seg_d, "left")
    has_link = pos > 0
    if ok_idx.shape[0]:
        ok_idx_d = _full(mesh, ok_idx)
        gather = torch.clamp(ok_off[seg_d] + pos - 1, 0, ok_idx.shape[0] - 1)
        link = torch.where(has_link, ok_idx_d[gather], -1).to(torch.int32)
    else:
        link = torch.full(seg_d.shape, -1, dtype=torch.int32,
                          device=mesh.device)
    det_iter = torch.where(has_link & ok_mask, it, 0).to(torch.int64)
    col = torch.where(det_iter <= max_iter, det_iter, 0)
    grid = torch.zeros((n_projects, max_iter + 1), dtype=torch.bool,
                       device=mesh.device)
    grid[seg_d, col] = True
    merged = mesh.psum(grid.to(torch.int32))
    detected = (merged[:, 1:] > 0).sum(dim=0, dtype=torch.int32)
    return (_gather(mesh, it)[:q], _gather(mesh, link)[:q],
            detected.cpu().numpy())


# ---------------------------------------------------------------------------
# RQ2 trends: session-sharded percentiles/means, project-psum counts
# ---------------------------------------------------------------------------

def percentile_by_session_mesh(cols, colmask, q, mesh: Mesh):
    """masked_percentile over [S, P] with the session axis sharded.

    The ranks do only the rounding-free work (the per-session sort and
    the two order-statistic gathers); the host replays the eager float32
    index and lerp sequence op for op, as the JAX package's mesh path
    does, so the result equals ``masked_percentile`` bit for bit."""
    n_dev = mesh.size
    s = cols.shape[0]
    cols = _pad_rows(np.asarray(cols, dtype=np.float32), n_dev, 0.0)
    colmask = _pad_rows(np.asarray(colmask, dtype=bool), n_dev, False)
    qv = np.atleast_1d(np.asarray(q, dtype=np.float32))
    width = cols.shape[1]
    if width == 0:
        return np.full((qv.shape[0], s), np.nan)
    n_valid = colmask.sum(axis=1).astype(np.int32)                # [S']
    pos = (n_valid.astype(np.float32) - np.float32(1.0)) \
        * qv[:, None] / np.float32(100.0)                         # [K, S']
    lo = np.clip(np.floor(pos).astype(np.int32), 0, width - 1)
    hi = np.clip(lo + 1, 0, width - 1)
    frac = pos - lo.astype(np.float32)

    x, m = _local(mesh, cols), _local(mesh, colmask)
    srt = torch.sort(torch.where(m, x, float(np.finfo(np.float32).max)),
                     dim=-1).values
    # [S'/d, K] blocks, so the gather concatenates along sessions.
    vlo = torch.gather(srt, 1, _local(mesh, np.ascontiguousarray(
        lo.T).astype(np.int64)))
    vhi = torch.gather(srt, 1, _local(mesh, np.ascontiguousarray(
        hi.T).astype(np.int64)))
    vlo = _gather(mesh, vlo).T.astype(np.float32)
    vhi = _gather(mesh, vhi).T.astype(np.float32)
    hi_valid = (lo + 1) <= (n_valid[None, :] - 1)
    out = vlo + np.where(hi_valid, frac * (vhi - vlo), np.float32(0.0))
    out = np.where(n_valid[None, :] > 0, out, np.float32(np.nan))
    return out.astype(np.float64)[:, :s]


def mean_by_session_mesh(cols, colmask, mesh: Mesh):
    """masked_mean over [S, P] with the session axis sharded (its sums
    are ``tree_sum``'s, in the same order on a row block as on the whole
    matrix)."""
    n_dev = mesh.size
    s = cols.shape[0]
    cols = _pad_rows(np.asarray(cols, dtype=np.float32), n_dev, 0.0)
    colmask = _pad_rows(np.asarray(colmask, dtype=bool), n_dev, False)
    mean = masked_mean(_local(mesh, cols), _local(mesh, colmask))
    return _gather(mesh, mean).astype(np.float64)[:s]


def counts_by_project_psum(mask, mesh: Mesh) -> np.ndarray:
    """Per-session valid-project counts of a [P, S] mask as a ``psum``
    over the project-sharded mesh (integer, so exact)."""
    mask = _pad_rows(np.asarray(mask, dtype=bool), mesh.size, False)
    part = _local(mesh, mask).sum(dim=0, dtype=torch.int32)
    return mesh.psum(part).cpu().numpy().astype(np.int64)


def spearman_by_project_mesh(matrix, mask, mesh: Mesh):
    """masked_spearman over [P, S] with the project axis sharded (each row
    reduces on one rank)."""
    n_dev = mesh.size
    p = matrix.shape[0]
    matrix = _pad_rows(np.asarray(matrix, dtype=np.float32), n_dev, 0.0)
    mask = _pad_rows(np.asarray(mask, dtype=bool), n_dev, False)
    rho = masked_spearman(_local(mesh, matrix), _local(mesh, mask))
    return _gather(mesh, rho).astype(np.float64)[:p]


# ---------------------------------------------------------------------------
# RQ4b: float64 per-session group percentiles, session-sharded
# ---------------------------------------------------------------------------

def nanpercentile_by_session_mesh(sub: np.ndarray, q, mesh: Mesh) -> np.ndarray:
    """``np.nanpercentile(sub, q, axis=0)`` bit for bit, the per-session
    float64 sort and order-statistic selection sharded over the mesh.

    The ranks return, per (percentile, session), the two bracketing order
    statistics; the host applies numpy's ``_lerp`` (with its
    ``gamma >= 0.5`` re-association) in float64.  ``sub`` is [G, S]
    float64 with NaN = missing.  Inputs holding +inf (which collides with
    the sort's fill), or a device without lossless float64, go to the
    host's ``np.nanpercentile``: the same values."""
    g, s = sub.shape
    qf = np.atleast_1d(np.asarray(q, dtype=np.float64)) / 100.0
    if g == 0 or s == 0:
        return np.full((qf.shape[0], s), np.nan)
    if np.isposinf(sub).any() or not _device_f64_exact(mesh.device):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            return np.nanpercentile(sub, np.atleast_1d(q), axis=0)
    cols = _pad_rows(np.ascontiguousarray(sub.T), mesh.size, np.nan)  # [S', G]
    x = _local(mesh, cols.astype(np.float64))
    m = ~torch.isnan(x)
    n = m.sum(dim=-1)                                  # [s_shard]
    srt = torch.sort(torch.where(m, x, torch.inf), dim=-1).values
    qf_d = torch.from_numpy(qf).to(mesh.device)
    pos = (n - 1).to(torch.float64)[:, None] * qf_d[None, :]   # [s, K]
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, max(g - 1, 0))
    hi = torch.minimum(lo + 1, torch.clamp(n - 1, min=0)[:, None])
    vlo = _gather(mesh, torch.gather(srt, 1, lo)).T[:, :s]
    vhi = _gather(mesh, torch.gather(srt, 1, hi)).T[:, :s]
    n = _gather(mesh, n).astype(np.int64)[:s]
    pos = (n - 1).astype(np.float64) * qf[:, None]
    gamma = pos - np.floor(pos)
    with np.errstate(invalid="ignore"):
        diff = vhi - vlo
        out = vlo + diff * gamma
        fix = gamma >= 0.5
        out[fix] = (vhi - diff * (1.0 - gamma))[fix]
    out[:, n == 0] = np.nan
    return out


# ---------------------------------------------------------------------------
# RQ3/RQ4a: per-segment searchsorted with the query axis sharded
# ---------------------------------------------------------------------------

def segment_searchsorted_mesh(mesh: Mesh, values_s, offsets, queries_s,
                              query_seg, side: str,
                              values_lo, queries_lo) -> np.ndarray:
    """``ops.segment.segment_searchsorted`` with the query axis split over
    the mesh and the CSR values replicated.  Every query's search is
    independent, so no collective but the final gather is needed."""
    q = int(np.asarray(queries_s).shape[0])
    if q == 0 or int(np.asarray(values_s).shape[0]) == 0:
        return np.zeros(q, dtype=np.int32)
    n_dev = mesh.size
    qk = _pad_rows(_key(queries_s, queries_lo), n_dev, 0)
    seg = _pad_rows(np.asarray(query_seg, dtype=np.int64), n_dev, 0)
    out = segment_searchsorted(
        _full(mesh, _key(values_s, values_lo)),
        _full(mesh, np.asarray(offsets, dtype=np.int64)),
        _local(mesh, qk), _local(mesh, seg), side)
    return _gather(mesh, out)[:q]


__all__ = ["auto_mesh", "counts_by_project_psum", "mean_by_session_mesh",
           "nanpercentile_by_session_mesh", "percentile_by_session_mesh",
           "rq1_kernel_mesh", "segment_searchsorted_mesh",
           "spearman_by_project_mesh"]
