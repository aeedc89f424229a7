"""The RQ backend on the card: a port of ``tse1m_tpu/backend/
jax_backend.py`` (single-device path) to torch ops.

RQ1's two hot loops (rq1_detection_rate.py:361,367) and the per-issue
scans of RQ3 and RQ4a become per-segment binary searches over CSR arrays
(``ops/segment.py``), a survival curve of per-project build counts and a
boolean scatter of unique detected projects.  Timestamps ride as one int64
nanosecond lane; the JAX package's two int32 lanes order the same way.

Dispatch: the study's CSR arrays go to the card once per (study, cutoff,
device) and stay cached on the StudyArrays instance (``_study_cache``);
each RQ runs its body as a chain of torch ops that queue on the card
without a synchronisation, and returns through ONE packed int32 buffer
and one device-to-host copy.  ``rq_suite`` runs all six RQs' device work
in one pass and one copy, with RQ4b's host float64 percentiles computed
while the card works.  The host tails (``_*_post``) stay in numpy float64
so that results equal the JAX package's and the pandas backend's.

There is no mesh here: multi-GPU is ROADMAP.md Queue 1, "Multi-GPU".
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..data.columnar import StudyArrays, masked_csr
from ..device import resolve_device
from ..ops.segment import (counts_to_survival, masked_mean, masked_spearman,
                           segment_searchsorted,
                           unique_pairs_count_per_iteration)
from .base import (Backend, RQ1Result, RQ2ChangePointsResult, RQ2TrendsResult,
                   RQ3Result, RQ4aTrendResult, RQ4bTrendsResult)

# Copied from tse1m_tpu/backend/pandas_backend.py:18-26.
DAY_NS = 86_400_000_000_000
HOUR_NS = 3_600_000_000_000


def floor_day_ns(ns: np.ndarray) -> np.ndarray:
    """Timestamp -> midnight of its day (the reference's .dt.date join
    key, rq2_coverage_and_added.py:124)."""
    return (np.asarray(ns) // DAY_NS) * DAY_NS


_BIG = float(np.finfo(np.float32).max)


# ---------------------------------------------------------------------------
# Device-resident study cache
# ---------------------------------------------------------------------------

def _study_cache(arrays: StudyArrays, device: torch.device) -> dict:
    """The per-StudyArrays cache of one device.

    All six RQs read the same CSR arrays, so they go to the card once per
    study instead of once per call.  Cutoff-dependent entries carry the
    cutoff in their key (``...:{limit}``), so a cutoff sweep re-derives
    only those.  The fingerprint of table tokens guards a shallow copy
    that swaps a table out: it gets a fresh cache of its own."""
    fp = tuple(_table_token(t) for t in
               (arrays.fuzz, arrays.covb, arrays.issues, arrays.cov))
    root = getattr(arrays, "_torch_dev_cache", None)
    if root is None or root["fp"] != fp:
        root = arrays._torch_dev_cache = {"fp": fp, "devices": {}}
    return root["devices"].setdefault(str(device), {})


_table_tokens = iter(range(1 << 62))


def _table_token(table) -> int:
    """Monotonic identity token per Segmented (set on first use); unlike
    id(), never reused after a table dies."""
    tok = getattr(table, "_cache_token", None)
    if tok is None:
        tok = table._cache_token = next(_table_tokens)
    return tok


def _cached(cache: dict, key: str, build):
    if key not in cache:
        cache[key] = build()
    return cache[key]


# Distinct cutoffs whose masked views stay resident; beyond this the
# oldest cutoff's entries go (the cutoff-independent arrays stay).
_MAX_CUTOFFS = 2


def _touch_limit(cache: dict, limit_date_ns: int) -> None:
    """Record cutoff use order and evict the oldest cutoff's
    ``...:{limit}`` entries once more than _MAX_CUTOFFS are resident."""
    limits = cache.setdefault("_limits", [])
    if limit_date_ns in limits:
        limits.remove(limit_date_ns)
    limits.append(limit_date_ns)
    while len(limits) > _MAX_CUTOFFS:
        suffix = f":{limits.pop(0)}"
        for k in [k for k in cache if k.endswith(suffix)]:
            del cache[k]


def _put(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _dev_fuzz(arrays, cache, dev):
    """(t_d, off_d): every fuzz build's time and the CSR offsets."""
    return _cached(cache, "fuzz", lambda: (
        _put(arrays.fuzz.columns["time_ns"], dev),
        _put(arrays.fuzz.offsets, dev)))


def _host_fuzz_ok(arrays, cache, limit_date_ns):
    """Host (pos, offsets) of the ok pre-cutoff fuzz builds: RQ1's link
    side and RQ3's last-successful-build scan (rq3:269)."""
    def build():
        t = arrays.fuzz.columns["time_ns"]
        return masked_csr(arrays.fuzz.offsets,
                          arrays.fuzz.columns["ok"] & (t < limit_date_ns))
    return _cached(cache, f"fuzz_ok_host:{limit_date_ns}", build)


def _dev_fuzz_ok(arrays, cache, limit_date_ns, dev):
    """(t_d, off_d, pos_d) of the ok pre-cutoff fuzz builds; times are
    gathered on the card from the cached full lane."""
    def build():
        pos, off = _host_fuzz_ok(arrays, cache, limit_date_ns)
        t_d, _ = _dev_fuzz(arrays, cache, dev)
        pos_d = _put(pos, dev)
        return t_d[pos_d], _put(off, dev), pos_d
    return _cached(cache, f"fuzz_ok:{limit_date_ns}", build)


def _dev_issues(arrays, cache, dev):
    """(t_d, seg_d): issue report times and their project segments, the
    query side of every RQ search."""
    def build():
        seg = np.repeat(np.arange(arrays.n_projects),
                        arrays.issues.counts())
        return (_put(arrays.issues.columns["time_ns"], dev),
                _put(seg.astype(np.int64), dev))
    return _cached(cache, "issues", build)


def _host_covb_cut(arrays, cache, limit_date_ns):
    """Host (pos, offsets) of coverage builds before cutoff + 1 day (RQ3's
    first-coverage-build scan reads to the boundary day, rq3:263)."""
    def build():
        t = arrays.covb.columns["time_ns"]
        return masked_csr(arrays.covb.offsets, t < limit_date_ns + DAY_NS)
    return _cached(cache, f"covb_cut_host:{limit_date_ns}", build)


def _dev_covb_cut(arrays, cache, limit_date_ns, dev):
    def build():
        pos, off = _host_covb_cut(arrays, cache, limit_date_ns)
        return (_put(arrays.covb.columns["time_ns"][pos], dev),
                _put(off, dev))
    return _cached(cache, f"covb_cut:{limit_date_ns}", build)


def _host_cov_valid(arrays, cache):
    """Host (pos, offsets) of non-null daily-coverage rows (RQ3's
    day-after join side, rq3:287-293)."""
    return _cached(cache, "cov_valid_host", lambda: masked_csr(
        arrays.cov.offsets, ~np.isnan(arrays.cov.columns["covered"])))


def _dev_cov_valid(arrays, cache, dev):
    def build():
        pos, off = _host_cov_valid(arrays, cache)
        return _put(arrays.cov.columns["date_ns"][pos], dev), _put(off, dev)
    return _cached(cache, "cov_valid", build)


def _host_cov_cut(arrays, cache, limit_date_ns):
    """Host (pos, offsets) of pre-cutoff daily-coverage rows (RQ2's
    same-day join side)."""
    return _cached(cache, f"cov_cut_host:{limit_date_ns}", lambda: masked_csr(
        arrays.cov.offsets, arrays.cov.columns["date_ns"] < limit_date_ns))


def _dev_cov_cut(arrays, cache, limit_date_ns, dev):
    def build():
        pos, off = _host_cov_cut(arrays, cache, limit_date_ns)
        return _put(arrays.cov.columns["date_ns"][pos], dev), _put(off, dev)
    return _cached(cache, f"cov_cut:{limit_date_ns}", build)


def _host_fuzz_cut(arrays, cache, limit_date_ns):
    """Host (pos, offsets) of every pre-cutoff fuzz build whatever its
    result: RQ4a counts them all (rq4a_bug.py:128-134)."""
    return _cached(cache, f"fuzz_cut_host:{limit_date_ns}", lambda: masked_csr(
        arrays.fuzz.offsets, arrays.fuzz.columns["time_ns"] < limit_date_ns))


def _dev_fuzz_cut(arrays, cache, limit_date_ns, dev):
    def build():
        pos, off = _host_fuzz_cut(arrays, cache, limit_date_ns)
        t_d, _ = _dev_fuzz(arrays, cache, dev)
        return t_d[_put(pos, dev)], _put(off, dev)
    return _cached(cache, f"fuzz_cut:{limit_date_ns}", build)


def _dev_rq3_targets(arrays, cache, dev):
    """Day-after-report midnights, the RQ3 day join key."""
    return _cached(cache, "rq3_targets", lambda: _put(
        floor_day_ns(arrays.issues.columns["time_ns"]) + DAY_NS, dev))


def _rq2cp_bounds(arrays, cache, limit_date_ns, dev):
    """Host group-boundary structure of RQ2's change points (the
    reference's shift/cumsum grouping, rq2_coverage_and_added.py:129-149)
    and the staged query lanes of the date join; None when there is no
    change point."""
    def build():
        covb_t = arrays.covb.columns["time_ns"]
        ghash = arrays.covb.columns["grouphash"]
        seg_all = np.repeat(np.arange(arrays.n_projects),
                            arrays.covb.counts())
        _, cov_offsets = _host_cov_cut(arrays, cache, limit_date_ns)
        has_cov = np.diff(cov_offsets) > 0
        keep = ((covb_t < limit_date_ns) & arrays.covb.columns["ok"]
                & has_cov[seg_all])
        rows = np.flatnonzero(keep)
        if rows.size == 0:
            return None
        seg = seg_all[rows]
        g = ghash[rows]
        new_group = np.concatenate(
            [[True], (g[1:] != g[:-1]) | (seg[1:] != seg[:-1])])
        start_pos = np.flatnonzero(new_group)
        starts = rows[start_pos]
        ends = rows[np.concatenate([start_pos[1:] - 1, [rows.size - 1]])]
        gseg = seg[start_pos]
        pair = np.flatnonzero(gseg[:-1] == gseg[1:])
        end_i = ends[pair]
        start_ip1 = starts[pair + 1]
        proj = gseg[pair]
        if end_i.size == 0:
            return None
        q_days = np.concatenate([floor_day_ns(covb_t[end_i]),
                                 floor_day_ns(covb_t[start_ip1])])
        q_seg = np.concatenate([proj, proj]).astype(np.int64)
        return {"end_i": end_i, "start_ip1": start_ip1, "proj": proj,
                "q_days": q_days, "q_seg": q_seg,
                "q_d": _put(q_days, dev), "qseg_d": _put(q_seg, dev)}
    return _cached(cache, f"rq2cp_bounds:{limit_date_ns}", build)


def _trend_matrix(arrays: StudyArrays, sel: np.ndarray, values: np.ndarray):
    """Scatter selected coverage rows into a padded [P, S] matrix + mask
    (rq2_coverage_count.py:330-333's ragged per-session lists)."""
    P = arrays.n_projects
    seg_all = np.repeat(np.arange(P), arrays.cov.counts())
    lens = np.bincount(seg_all[sel], minlength=P)
    S = int(lens.max()) if lens.size else 0
    matrix = np.full((P, S), np.nan)
    mask = np.zeros((P, S), dtype=bool)
    if S:
        kept_seg = seg_all[sel]
        pos_in_proj = np.arange(int(sel.sum())) - np.repeat(
            np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
        matrix[kept_seg, pos_in_proj] = values[sel]
        mask[kept_seg, pos_in_proj] = True
    return matrix, mask


def _rq2tr_prep(arrays, cache, limit_date_ns):
    """RQ2 trends' host prep per (study, cutoff): the padded trend matrix
    and the percentile order-statistic plan (lo, hi, frac)."""
    def build():
        P = arrays.n_projects
        cov = arrays.cov
        coverage = cov.columns["coverage"]
        covered = cov.columns["covered"]
        total = cov.columns["total"]
        sel = ((~np.isnan(coverage)) & (coverage != 0) & (total != 0)
               & ~np.isnan(total) & ~np.isnan(covered)
               & (cov.columns["date_ns"] < limit_date_ns))
        with np.errstate(invalid="ignore", divide="ignore"):
            vals = covered / total * 100.0
        matrix, mask = _trend_matrix(arrays, sel, vals)
        q = np.array(RQ2TrendsResult.PCTS, dtype=np.float32)
        n_valid = mask.sum(axis=0).astype(np.int32)
        pos = (n_valid.astype(np.float32) - np.float32(1.0)) \
            * q[:, None] / np.float32(100.0)
        lo = np.clip(np.floor(pos).astype(np.int32), 0, max(P - 1, 0))
        hi = np.clip(lo + 1, 0, max(P - 1, 0))
        frac = pos - lo.astype(np.float32)
        return {"matrix": matrix, "mask": mask, "n_valid": n_valid,
                "lo": lo, "hi": hi, "frac": frac, "S": matrix.shape[1]}
    return _cached(cache, f"rq2tr_prep:{limit_date_ns}", build)


def _rq2tr_dev(arrays, cache, limit_date_ns, dev):
    """Card copies of the trend matrix, its mask and the index plan."""
    def build():
        prep = _rq2tr_prep(arrays, cache, limit_date_ns)
        return (_put(prep["matrix"].astype(np.float32), dev),
                _put(prep["mask"], dev),
                _put(prep["lo"].astype(np.int64), dev),
                _put(prep["hi"].astype(np.int64), dev))
    return _cached(cache, f"rq2tr_dev:{limit_date_ns}", build)


def _rq4b_matrix(arrays, cache, limit_date_ns):
    """RQ4b's padded coverage matrix per (study, cutoff)."""
    def build():
        coverage = arrays.cov.columns["coverage"]
        sel = ((~np.isnan(coverage)) & (coverage > 0)
               & (arrays.cov.columns["date_ns"] < limit_date_ns))
        return _trend_matrix(arrays, sel, coverage)
    return _cached(cache, f"rq4b_matrix:{limit_date_ns}", build)


# ---------------------------------------------------------------------------
# Device bodies (torch ops; one packed fetch per RQ call)
# ---------------------------------------------------------------------------

def _rq1_body(fuzz_t, fuzz_off, ok_t, ok_off, ok_pos, issue_t, issue_seg,
              n_projects: int, max_iter: int):
    # Iteration of each issue: #builds (any result) strictly before it.
    iteration_of_issue = segment_searchsorted(fuzz_t, fuzz_off, issue_t,
                                              issue_seg, "left")
    # Link: the latest ok pre-cutoff build strictly before the report.
    pos = segment_searchsorted(ok_t, ok_off, issue_t, issue_seg, "left")
    has_link = pos > 0
    if ok_pos.shape[0]:
        gather = torch.clamp(ok_off[issue_seg] + pos - 1, 0,
                             ok_pos.shape[0] - 1)
        link_idx = torch.where(has_link, ok_pos[gather], -1)
    else:
        link_idx = torch.full(issue_seg.shape, -1, dtype=torch.int64,
                              device=issue_seg.device)
    totals = counts_to_survival(fuzz_off[1:] - fuzz_off[:-1], max_iter)
    det_iter = torch.where(has_link, iteration_of_issue, 0)
    detected = unique_pairs_count_per_iteration(issue_seg, det_iter,
                                                n_projects, max_iter)
    return iteration_of_issue, link_idx, totals, detected


def _rq1_packed(*args, n_projects: int, max_iter: int) -> torch.Tensor:
    """[it(Q), link(Q), totals(max_iter), detected(max_iter)] int32."""
    it, li, totals, detected = _rq1_body(*args, n_projects, max_iter)
    return torch.cat([it.to(torch.int32), li.to(torch.int32), totals,
                      detected])


def _rq3_body(ft, f_off, ct, c_off, dt, v_off, it, seg, qt):
    """RQ3's three per-issue scans (rq3:269,273,287-293): the last ok fuzz
    build before the report, the first coverage build after it, and the
    day-after coverage row; [3, Q] int32."""
    return torch.stack([
        segment_searchsorted(ft, f_off, it, seg, "left"),
        segment_searchsorted(ct, c_off, it, seg, "right"),
        segment_searchsorted(dt, v_off, qt, seg, "left")])


def _rq4a_body(ft, f_off, it, seg, gid, sel1, sel2, n_projects: int,
               max_iter: int):
    """RQ4a's G1/G2 loop (rq4a_bug.py:324-346): one search maps every
    grouped issue to its iteration; per-group survival curves come from a
    weighted histogram (weight = group membership), detected-project
    counts from the boolean scatter.  [ks(Q), g1_tot, g1_det, g2_tot,
    g2_det] int32."""
    ks = segment_searchsorted(ft, f_off, it, seg, "left")
    clipped = torch.clamp(f_off[1:] - f_off[:-1], 0, max_iter)

    def group(sel, g):
        w = sel.to(torch.int64)
        # #group projects with >= k builds: zero-count rows appear in
        # every cumsum term and cancel against w.sum().
        hist = torch.zeros(max_iter + 1, dtype=torch.int64, device=w.device)
        hist.index_add_(0, clipped, w)
        tot = (w.sum() - torch.cumsum(hist, 0)[:-1]).to(torch.int32)
        det = unique_pairs_count_per_iteration(
            seg, torch.where(gid == g, ks, 0), n_projects, max_iter)
        return tot, det

    t1, d1 = group(sel1, 1)
    t2, d2 = group(sel2, 2)
    return torch.cat([ks, t1, d1, t2, d2])


def _rq2tr_body(mj, kj, lo, hi):
    """RQ2 trends' device work: per-project Spearman, the per-session sort
    and its two order-statistic gathers (the float32 lerp replays on the
    host in the JAX kernel's op order), and the per-session mean.
    float32 [spear(P), vlo(K*S), vhi(K*S), mean(S)]."""
    spear = masked_spearman(mj, kj)
    cols, colmask = mj.T, kj.T
    srt = torch.sort(torch.where(colmask, cols, _BIG), dim=-1).values
    vlo = torch.gather(srt, 1, lo.T).T
    vhi = torch.gather(srt, 1, hi.T).T
    mean = masked_mean(cols, colmask)
    return torch.cat([spear, vlo.reshape(-1), vhi.reshape(-1), mean])


def _pack_cp_lane(cp_pos: torch.Tensor, cp16: bool) -> torch.Tensor:
    """RQ2's boundary-join lane, two int16 positions an int32 when every
    coverage segment is shorter than 2^15 rows (caller-checked)."""
    if not cp16:
        return cp_pos.to(torch.int32)
    cp = cp_pos.to(torch.int16)
    if cp.shape[0] % 2:
        cp = torch.cat([cp, cp.new_zeros(1)])
    return cp.view(torch.int32)


def _unpack_cp_lane(lane: np.ndarray, nb: int, cp16: bool) -> np.ndarray:
    if not cp16:
        return lane
    return lane.view(np.int16)[:nb].astype(np.int64)


def _rq_suite_body(fuzz, fuzz_ok, issues, covb_cut, cov_valid, targets,
                   fuzz_cut, rq4a_q, sel1, sel2, cov_cut, cp_q, trend, *,
                   n_projects: int, max_iter1: int, max_iter4: int,
                   cp16: bool) -> torch.Tensor:
    """All six RQs' device work over the cached CSR arrays, into ONE
    packed int32 buffer: [rq1: it(Q) link(Q) totals(M1) det(M1) | rq3: 3Q
    | rq4a: Q4 + 4*M4 | rq2cp: NB (or NB/2 packed) | rq2tr (float32
    bits): P + 2KS + S].  The same bodies as the single calls, so the
    results are the same."""
    (ft, f_off), (okt, okoff, okpos), (it, seg) = fuzz, fuzz_ok, issues
    it1, li, totals, detected = _rq1_body(ft, f_off, okt, okoff, okpos, it,
                                          seg, n_projects, max_iter1)
    rq3 = _rq3_body(okt, okoff, *covb_cut, *cov_valid, it, seg, targets)
    rq4a = _rq4a_body(*fuzz_cut, *rq4a_q, sel1, sel2, n_projects, max_iter4)
    cp_pos = segment_searchsorted(*cov_cut, *cp_q, "left")
    tr = _rq2tr_body(*trend)
    return torch.cat([it1.to(torch.int32), li.to(torch.int32), totals,
                      detected, rq3.reshape(-1), rq4a,
                      _pack_cp_lane(cp_pos, cp16), tr.view(torch.int32)])


# ---------------------------------------------------------------------------
# Host tails (numpy), shared by the single calls and the suite
# ---------------------------------------------------------------------------

def _rq1_post(it, li, totals, detected, min_projects: int) -> RQ1Result:
    """RQ1's >= min_projects filter (rq1:232-239)."""
    totals = np.asarray(totals, dtype=np.int64)
    detected = np.asarray(detected, dtype=np.int64)
    keep = totals >= min_projects
    return RQ1Result(
        iterations=np.flatnonzero(keep) + 1,
        total_projects=totals[keep],
        detected_counts=detected[keep],
        iteration_of_issue=np.asarray(it, dtype=np.int64),
        link_idx=np.asarray(li, dtype=np.int64),
    )


def _rq4a_post(g1_tot, g1_det, g2_tot, g2_det,
               min_projects: int) -> RQ4aTrendResult:
    """RQ4a's both-groups >= min_projects filter (rq4a_bug.py:171-179)."""
    keep = np.flatnonzero((g1_tot >= min_projects)
                          & (g2_tot >= min_projects))
    return RQ4aTrendResult(
        iterations=keep + 1,
        g1_total=g1_tot[keep], g1_detected=g1_det[keep],
        g2_total=g2_tot[keep], g2_detected=g2_det[keep],
    )


def _rq2cp_post(arrays, cache, limit_date_ns, bounds,
                pos) -> RQ2ChangePointsResult:
    """Gather the joined coverage rows (float64, exact vs pandas)."""
    cov_pos, cov_offsets = _host_cov_cut(arrays, cache, limit_date_ns)
    cov_days = arrays.cov.columns["date_ns"][cov_pos]
    cov_covered = arrays.cov.columns["covered"][cov_pos]
    cov_total = arrays.cov.columns["total"][cov_pos]
    q_seg, q_days = bounds["q_seg"], bounds["q_days"]
    gidx = cov_offsets[q_seg] + pos
    in_seg = gidx < cov_offsets[q_seg + 1]
    safe = np.clip(gidx, 0, max(cov_pos.size - 1, 0))
    matched = in_seg & (cov_days[safe] == q_days)
    covered = np.where(matched, cov_covered[safe], np.nan)
    total = np.where(matched, cov_total[safe], np.nan)
    n = bounds["end_i"].size
    return RQ2ChangePointsResult(
        project_idx=bounds["proj"].astype(np.int64),
        end_i=bounds["end_i"].astype(np.int64),
        start_ip1=bounds["start_ip1"].astype(np.int64),
        covered_i=covered[:n], total_i=total[:n],
        covered_ip1=covered[n:], total_ip1=total[n:],
    )


def _rq3_post(arrays, cache, limit_date_ns, pos_f, pos_c,
              pos_d) -> RQ3Result:
    """RQ3's candidate gates (rq3:266-302) and the non-detected day pairs
    (rq3:246-257), float64 on the host."""
    P = arrays.n_projects
    issue_t = arrays.issues.columns["time_ns"]
    n_issues = issue_t.size
    fuzz_t = arrays.fuzz.columns["time_ns"]
    covb_t = arrays.covb.columns["time_ns"]
    f_pos, f_off = _host_fuzz_ok(arrays, cache, limit_date_ns)
    c_pos, c_off = _host_covb_cut(arrays, cache, limit_date_ns)
    v_pos, v_off = _host_cov_valid(arrays, cache)
    days = arrays.cov.columns["date_ns"][v_pos]
    covered = arrays.cov.columns["covered"][v_pos]
    total = arrays.cov.columns["total"][v_pos]
    issue_seg = np.repeat(np.arange(P), arrays.issues.counts())
    target = floor_day_ns(issue_t) + DAY_NS
    # Projects must have all three inputs (rq3:266).
    has_all = ((np.diff(f_off) > 0) & (np.diff(c_off) > 0)
               & (np.diff(v_off) > 0))
    can_detect = bool(n_issues and f_pos.size and c_pos.size and v_pos.size)

    if can_detect:
        cand = (has_all[issue_seg] & (pos_f > 0)
                & (pos_c < np.diff(c_off)[issue_seg]))
        k_glob = np.where(cand, f_off[issue_seg] + pos_f - 1, 0)
        m_glob = np.where(cand, c_off[issue_seg] + pos_c, 0)
        m_glob = np.clip(m_glob, 0, c_pos.size - 1)
        cand &= arrays.covb.columns["ok"][c_pos[m_glob]]
        cand &= (covb_t[c_pos[m_glob]]
                 - fuzz_t[f_pos[k_glob]]) <= 24 * HOUR_NS
        if cand.any():
            rev_eq = np.zeros(n_issues, dtype=bool)
            ci = np.flatnonzero(cand)
            rev_eq[ci] = (arrays.fuzz_revhash_at(f_pos[k_glob[ci]])
                          == arrays.covb_revhash_at(c_pos[m_glob[ci]]))
            cand &= rev_eq
        i_glob = np.where(cand, v_off[issue_seg] + pos_d, 0)
        in_seg = pos_d < np.diff(v_off)[issue_seg]
        safe = np.clip(i_glob, 0, max(days.size - 1, 0))
        cand &= (in_seg & (i_glob > v_off[issue_seg])
                 & (days[safe] == target) & (covered[safe] != 0)
                 & (total[np.maximum(safe - 1, 0)] > 0) & (total[safe] > 0))
        di = np.flatnonzero(cand)
        gi = i_glob[di]
    else:
        di = np.empty(0, np.int64)
        gi = np.empty(0, np.int64)
    det_pct = ((covered[gi] / total[gi]
                - covered[gi - 1] / total[gi - 1]) * 100.0)

    # Non-detected: every other consecutive coverage-day pair of projects
    # with >= 1 fixed issue (rq3:246-257), less pairs whose current date
    # equals a detected issue's report date.
    has_issues = arrays.issues.counts() > 0
    row_seg = np.repeat(np.arange(P), np.diff(v_off))
    not_start = np.ones(days.size, dtype=bool)
    not_start[v_off[:-1][v_off[:-1] < days.size]] = False
    pair_i = np.flatnonzero(not_start)
    pair_seg = row_seg[pair_i]
    keep = (has_issues[pair_seg] & (total[pair_i - 1] > 0)
            & (total[pair_i] > 0))
    if di.size:
        det_key = (issue_seg[di].astype(np.int64) << 32) | (
            floor_day_ns(issue_t[di]) // DAY_NS)
        pair_key = (pair_seg.astype(np.int64) << 32) | (
            days[pair_i] // DAY_NS)
        keep &= ~np.isin(pair_key, det_key)
    ni = pair_i[keep]
    nd_pct = ((covered[ni] / total[ni]
               - covered[ni - 1] / total[ni - 1]) * 100.0)

    return RQ3Result(
        det_diff_percent=det_pct,
        det_diff_covered=covered[gi] - covered[gi - 1],
        det_diff_total=total[gi] - total[gi - 1],
        det_project_idx=issue_seg[di].astype(np.int64),
        det_issue_idx=di.astype(np.int64),
        det_issue_time_ns=issue_t[di],
        nondet_diff_percent=nd_pct,
        nondet_diff_covered=covered[ni] - covered[ni - 1],
        nondet_diff_total=total[ni] - total[ni - 1],
        nondet_project_idx=pair_seg[keep].astype(np.int64),
    )


def _rq2tr_post(prep: dict, packed: np.ndarray) -> RQ2TrendsResult:
    """The float32 lerp of the percentiles, in the JAX kernel's op order
    (so equal to it bit for bit), from the fetched order statistics."""
    matrix, mask = prep["matrix"], prep["mask"]
    P, S = matrix.shape
    K = len(RQ2TrendsResult.PCTS)
    n_valid, lo, frac = prep["n_valid"], prep["lo"], prep["frac"]
    spear = packed[:P].astype(np.float64)
    vlo = packed[P:P + K * S].reshape(K, S)
    vhi = packed[P + K * S:P + 2 * K * S].reshape(K, S)
    hi_valid = (lo + 1) <= (n_valid[None, :] - 1)
    pcts = vlo + np.where(hi_valid, frac * (vhi - vlo), np.float32(0.0))
    pcts = np.where(n_valid[None, :] > 0, pcts,
                    np.float32(np.nan)).astype(np.float64)
    mean = packed[P + 2 * K * S:].astype(np.float64)
    return RQ2TrendsResult(matrix=matrix, mask=mask, spearman=spear,
                           percentiles=pcts, mean=mean,
                           counts=n_valid.astype(np.int64))


def _group_ids(P: int, g1_idx, g2_idx) -> np.ndarray:
    """[P] int8: 1 for G1, 2 for G2, 0 for neither."""
    in_g = np.zeros(P, dtype=np.int8)
    in_g[np.asarray(g1_idx, dtype=np.int64)] = 1
    in_g[np.asarray(g2_idx, dtype=np.int64)] = 2
    return in_g


class TorchBackend(Backend):
    """The six RQs on one device: the card by default, the CPU when asked
    (the tests).  Raises without a card unless ``device="cpu"``."""

    name = "torch_cuda"

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)

    def _cache(self, arrays: StudyArrays, limit_date_ns: int) -> dict:
        cache = _study_cache(arrays, self.device)
        _touch_limit(cache, limit_date_ns)
        return cache

    @staticmethod
    def _fetch(t: torch.Tensor) -> np.ndarray:
        """The one device-to-host copy of an RQ call."""
        return t.cpu().numpy()

    def rq1_detection(self, arrays: StudyArrays, limit_date_ns: int,
                      min_projects: int) -> RQ1Result:
        dev = self.device
        P = arrays.n_projects
        n_issues = len(arrays.issues)
        max_iter = int(arrays.fuzz.counts().max()) if len(arrays.fuzz) else 0
        if max_iter == 0:
            return RQ1Result(np.empty(0, np.int64), np.empty(0, np.int64),
                             np.empty(0, np.int64),
                             np.zeros(n_issues, np.int64),
                             np.full(n_issues, -1, np.int64))
        cache = self._cache(arrays, limit_date_ns)
        packed = self._fetch(_rq1_packed(
            *_dev_fuzz(arrays, cache, dev),
            *_dev_fuzz_ok(arrays, cache, limit_date_ns, dev),
            *_dev_issues(arrays, cache, dev),
            n_projects=P, max_iter=max_iter))
        q = n_issues
        return _rq1_post(packed[:q], packed[q:2 * q],
                         packed[2 * q:2 * q + max_iter],
                         packed[2 * q + max_iter:], min_projects)

    def rq2_change_points(self, arrays: StudyArrays,
                          limit_date_ns: int) -> RQ2ChangePointsResult:
        """Group boundaries on the host (irregular, cheap); the date join
        as one search on the card; the float64 gathers on the host."""
        dev = self.device
        cache = self._cache(arrays, limit_date_ns)
        bounds = _rq2cp_bounds(arrays, cache, limit_date_ns, dev)
        if bounds is None:
            e = np.empty(0, np.int64)
            f = np.empty(0, np.float64)
            return RQ2ChangePointsResult(e, e, e, f, f, f, f)
        _, cov_off_h = _host_cov_cut(arrays, cache, limit_date_ns)
        cp16 = bool(np.diff(cov_off_h).max(initial=0) < (1 << 15))
        pos_d = segment_searchsorted(
            *_dev_cov_cut(arrays, cache, limit_date_ns, dev),
            bounds["q_d"], bounds["qseg_d"], "left")
        pos = _unpack_cp_lane(self._fetch(_pack_cp_lane(pos_d, cp16)),
                              bounds["q_seg"].size, cp16)
        return _rq2cp_post(arrays, cache, limit_date_ns, bounds, pos)

    def rq2_trends(self, arrays: StudyArrays,
                   limit_date_ns: int) -> RQ2TrendsResult:
        P = arrays.n_projects
        cache = self._cache(arrays, limit_date_ns)
        prep = _rq2tr_prep(arrays, cache, limit_date_ns)
        S = prep["S"]
        if S == 0 or P == 0:
            # Empty study: the zero-width device work is ill-formed.
            return RQ2TrendsResult(
                matrix=prep["matrix"], mask=prep["mask"],
                spearman=np.full(P, np.nan),
                percentiles=np.full((len(RQ2TrendsResult.PCTS), S), np.nan),
                mean=np.full(S, np.nan),
                counts=np.zeros(S, dtype=np.int64))
        packed = self._fetch(_rq2tr_body(
            *_rq2tr_dev(arrays, cache, limit_date_ns, self.device)))
        return _rq2tr_post(prep, packed)

    def rq3_coverage_at_detection(self, arrays: StudyArrays,
                                  limit_date_ns: int) -> RQ3Result:
        """The three per-issue scans of rq3:241-302 on the card over the
        cached masked CSR arrays; the float64 deltas on the host."""
        dev = self.device
        cache = self._cache(arrays, limit_date_ns)
        okt, okoff, _ = _dev_fuzz_ok(arrays, cache, limit_date_ns, dev)
        pos3 = self._fetch(_rq3_body(
            okt, okoff, *_dev_covb_cut(arrays, cache, limit_date_ns, dev),
            *_dev_cov_valid(arrays, cache, dev),
            *_dev_issues(arrays, cache, dev),
            _dev_rq3_targets(arrays, cache, dev)))
        return _rq3_post(arrays, cache, limit_date_ns, *pos3)

    def _rq4a_queries(self, arrays: StudyArrays, in_g: np.ndarray):
        """(issue times, segments, group ids) of the grouped projects'
        issues, on the card."""
        issue_seg = np.repeat(np.arange(arrays.n_projects),
                              arrays.issues.counts())
        qi = np.flatnonzero(in_g[issue_seg] > 0)
        return (_put(arrays.issues.columns["time_ns"][qi], self.device),
                _put(issue_seg[qi].astype(np.int64), self.device),
                _put(in_g[issue_seg[qi]].astype(np.int64), self.device))

    def rq4a_detection_trend(self, arrays: StudyArrays, limit_date_ns: int,
                             g1_idx: np.ndarray, g2_idx: np.ndarray,
                             min_projects: int) -> RQ4aTrendResult:
        """rq4a_bug.py:324-346 on the card: RQ1's kernel shapes over every
        pre-cutoff build (no result filter, rq4a:128-134)."""
        P = arrays.n_projects
        cache = self._cache(arrays, limit_date_ns)
        _, f_off = _host_fuzz_cut(arrays, cache, limit_date_ns)
        counts = np.diff(f_off)
        in_g = _group_ids(P, g1_idx, g2_idx)
        max_iter = int(counts[in_g > 0].max()) if (in_g > 0).any() else 0
        if max_iter == 0:
            e = np.empty(0, np.int64)
            return RQ4aTrendResult(e, e, e, e, e)
        queries = self._rq4a_queries(arrays, in_g)
        q = queries[0].shape[0]
        packed = self._fetch(_rq4a_body(
            *_dev_fuzz_cut(arrays, cache, limit_date_ns, self.device),
            *queries, _put(in_g == 1, self.device),
            _put(in_g == 2, self.device), P, max_iter)).astype(np.int64)
        m = max_iter
        return _rq4a_post(packed[q:q + m], packed[q + m:q + 2 * m],
                          packed[q + 2 * m:q + 3 * m], packed[q + 3 * m:],
                          min_projects)

    def rq4b_group_trends(self, arrays: StudyArrays, limit_date_ns: int,
                          g1_idx: np.ndarray, g2_idx: np.ndarray,
                          percentiles: tuple = (25, 50, 75)
                          ) -> RQ4bTrendsResult:
        """rq4b_coverage.py:914-976: the padded trend matrix and float64
        nanpercentile columns on the host, so that win counts downstream
        equal the pandas backend's (a float32 reduction differs at ~1e-5
        relative, enough to flip them)."""
        cache = self._cache(arrays, limit_date_ns)
        matrix, mask = _rq4b_matrix(arrays, cache, limit_date_ns)
        S = matrix.shape[1]
        q = np.array(percentiles, dtype=np.float64)
        out = {}
        for key, idx in (("g1", np.asarray(g1_idx, dtype=np.int64)),
                         ("g2", np.asarray(g2_idx, dtype=np.int64))):
            if S == 0 or idx.size == 0:
                out[key] = (np.full((len(percentiles), S), np.nan),
                            np.zeros(S, dtype=np.int64))
                continue
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                pcts = np.nanpercentile(matrix[idx], q, axis=0)
            out[key] = (pcts, mask[idx].sum(axis=0))
        return RQ4bTrendsResult(
            percentiles=tuple(percentiles), matrix=matrix, mask=mask,
            g1_percentiles=out["g1"][0], g1_counts=out["g1"][1],
            g2_percentiles=out["g2"][0], g2_counts=out["g2"][1],
        )

    def rq_suite(self, arrays: StudyArrays, limit_date_ns: int,
                 min_projects: int, g1_idx: np.ndarray, g2_idx: np.ndarray,
                 percentiles: tuple = (25, 50, 75)) -> dict:
        """All six RQs in one pass on the card and one packed fetch, with
        RQ4b's host percentiles computed while the card works.  Degenerate
        shapes (an empty study, no issue, no change point, no trend, no
        grouped build) go to the six single calls, whose guards apply."""
        dev = self.device
        P = arrays.n_projects
        n_issues = len(arrays.issues)
        max_iter1 = int(arrays.fuzz.counts().max()) if len(arrays.fuzz) else 0
        if max_iter1 == 0 or n_issues == 0:
            return super().rq_suite(arrays, limit_date_ns, min_projects,
                                    g1_idx, g2_idx, percentiles)
        cache = self._cache(arrays, limit_date_ns)
        bounds = _rq2cp_bounds(arrays, cache, limit_date_ns, dev)
        prep2 = _rq2tr_prep(arrays, cache, limit_date_ns)
        _, f_off4 = _host_fuzz_cut(arrays, cache, limit_date_ns)
        counts4 = np.diff(f_off4)
        in_g = _group_ids(P, g1_idx, g2_idx)
        max_iter4 = int(counts4[in_g > 0].max()) if (in_g > 0).any() else 0
        if bounds is None or prep2["S"] == 0 or max_iter4 == 0:
            return super().rq_suite(arrays, limit_date_ns, min_projects,
                                    g1_idx, g2_idx, percentiles)
        rq4a_q = self._rq4a_queries(arrays, in_g)
        _, cov_off_h = _host_cov_cut(arrays, cache, limit_date_ns)
        cp16 = bool(np.diff(cov_off_h).max(initial=0) < (1 << 15))
        packed_d = _rq_suite_body(
            _dev_fuzz(arrays, cache, dev),
            _dev_fuzz_ok(arrays, cache, limit_date_ns, dev),
            _dev_issues(arrays, cache, dev),
            _dev_covb_cut(arrays, cache, limit_date_ns, dev),
            _dev_cov_valid(arrays, cache, dev),
            _dev_rq3_targets(arrays, cache, dev),
            _dev_fuzz_cut(arrays, cache, limit_date_ns, dev),
            rq4a_q, _put(in_g == 1, dev), _put(in_g == 2, dev),
            _dev_cov_cut(arrays, cache, limit_date_ns, dev),
            (bounds["q_d"], bounds["qseg_d"]),
            _rq2tr_dev(arrays, cache, limit_date_ns, dev),
            n_projects=P, max_iter1=max_iter1, max_iter4=max_iter4,
            cp16=cp16)
        # The card's work is queued: RQ4b's host percentiles run meanwhile.
        rq4b = self.rq4b_group_trends(arrays, limit_date_ns, g1_idx, g2_idx,
                                      percentiles)
        packed = self._fetch(packed_d)

        q, m1, q4, m4 = n_issues, max_iter1, rq4a_q[0].shape[0], max_iter4
        nb = bounds["q_seg"].size
        o = 0

        def take(k):
            nonlocal o
            out = packed[o:o + k]
            o += k
            return out

        it, li = take(q), take(q)
        totals, detected = take(m1), take(m1)
        pos_f, pos_c, pos_d = take(q), take(q), take(q)
        take(q4)  # rq4a's per-issue iteration lane; unused downstream
        g1_tot, g1_det = take(m4).astype(np.int64), take(m4).astype(np.int64)
        g2_tot, g2_det = take(m4).astype(np.int64), take(m4).astype(np.int64)
        cp_pos = _unpack_cp_lane(take((nb + 1) // 2 if cp16 else nb), nb,
                                 cp16)
        tr = packed[o:].view(np.float32)
        return {
            "rq1": _rq1_post(it, li, totals, detected, min_projects),
            "rq2cp": _rq2cp_post(arrays, cache, limit_date_ns, bounds,
                                 cp_pos),
            "rq2tr": _rq2tr_post(prep2, tr),
            "rq3": _rq3_post(arrays, cache, limit_date_ns, pos_f, pos_c,
                             pos_d),
            "rq4a": _rq4a_post(g1_tot, g1_det, g2_tot, g2_det, min_projects),
            "rq4b": rq4b,
        }


__all__ = ["DAY_NS", "HOUR_NS", "TorchBackend", "floor_day_ns"]
