"""RQ2 change points, the coverage around each revision change: a port of
``tse1m_tpu/analysis/rq2_changepoints.py:38-106`` over ``TorchBackend``.

Artifacts, as the JAX package writes them (under the *rq3* result
directory, as the reference does, rq2_coverage_and_added.py:14-15):

- ``rq3/change_analysis/<project>.csv``: one change row per (group i ->
  group i+1) revision change of the project (rq2:96-102 header);
- ``rq3/all_coverage_change_analysis.csv``: every project's rows merged
  (rq2:232-238), written only when there is a change.

This driver draws no figure, as the JAX package's draws none.
"""

from __future__ import annotations

import csv
import logging
import os

import numpy as np
import torch

from ..config import Config
from ..db.ingest import parse_array, pg_array_literal
from ..utils.atomic import atomic_write
from ..utils.manifest import RunManifest
from ..utils.timing import PhaseTimer
from .common import StudyContext, fmt_ts_ns, limit_date_ns

log = logging.getLogger(__name__)

HEADER = [
    "project", "timecreated_i", "modules_i", "revisions_i",
    "timecreated_i+1", "modules_i+1", "revisions_i+1",
    "covered_line_i", "total_line_i",
    "covered_line_i+1", "total_line_i+1",
    "diff_total_line", "diff_coverage",
]


def change_rows(ctx: StudyContext, result) -> dict[str, list[list]]:
    """Per-project lists of CSV rows in the reference's column order."""
    covb = ctx.arrays.covb
    t = covb.columns["time_ns"]
    # Raw DB text, parsed at the boundary rows only.
    mods_raw = covb.columns["modules_raw"]
    revs_raw = covb.columns["revisions_raw"]
    diff_total = result.diff_total_line
    diff_cov = result.diff_coverage
    per_project: dict[str, list[list]] = {}
    for k in range(len(result.project_idx)):
        p = int(result.project_idx[k])
        e, s1 = int(result.end_i[k]), int(result.start_ip1[k])
        row = [
            ctx.projects[p],
            fmt_ts_ns(int(t[e])),
            pg_array_literal(parse_array(mods_raw[e])),
            pg_array_literal(parse_array(revs_raw[e])),
            fmt_ts_ns(int(t[s1])),
            pg_array_literal(parse_array(mods_raw[s1])),
            pg_array_literal(parse_array(revs_raw[s1])),
            result.covered_i[k], result.total_i[k],
            result.covered_ip1[k], result.total_ip1[k],
            diff_total[k], diff_cov[k],
        ]
        per_project.setdefault(ctx.projects[p], []).append(row)
    return per_project


def run_rq2_changepoints(cfg: Config | None = None, db=None,
                         device: str | torch.device = "cuda") -> dict:
    timer = PhaseTimer()
    with timer.phase("extract"):
        ctx = StudyContext.open(cfg, db=db, announce=False, device=device)
    manifest = RunManifest("rq2_changepoints", ctx.backend.name,
                           str(ctx.backend.device))

    with timer.phase("changepoint_kernel"):
        result = ctx.backend.rq2_change_points(ctx.arrays,
                                               limit_date_ns(ctx.cfg))

    n_changes = len(result.project_idx)
    log.info("found %d change points across %d projects", n_changes,
             len(np.unique(result.project_idx)))

    out_dir = ctx.out_dir("rq3")  # the reference writes rq2a under rq3
    change_dir = os.path.join(out_dir, "change_analysis")
    os.makedirs(change_dir, exist_ok=True)

    with timer.phase("artifacts"):
        per_project = change_rows(ctx, result)
        all_rows = []
        for project, rows in per_project.items():
            path = os.path.join(change_dir, f"{project}.csv")
            with atomic_write(path, newline="") as f:
                w = csv.writer(f)
                w.writerow(HEADER)
                w.writerows(rows)
            all_rows.extend(rows)
        merged = os.path.join(out_dir, "all_coverage_change_analysis.csv")
        if all_rows:
            with atomic_write(merged, newline="") as f:
                w = csv.writer(f)
                w.writerow(HEADER)
                w.writerows(all_rows)
            manifest.add_artifact(merged)

    manifest.record(n_changes=n_changes, n_projects=len(per_project))
    manifest.save(out_dir, timer.as_dict())
    return {"result": result, "merged_csv": merged if all_rows else None}


__all__ = ["HEADER", "change_rows", "run_rq2_changepoints"]
