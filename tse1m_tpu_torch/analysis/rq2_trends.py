"""RQ2 coverage trends: a port of ``tse1m_tpu/analysis/rq2_trends.py:47-60,
196-289`` over ``TorchBackend``.

Artifact, as the JAX package writes it: ``rq2/coverage_by_session_index.csv``,
ragged rows, row i = every project's coverage % at its i-th session
(rq2_coverage_count.py:347-352).

The statistics stay on the host in scipy over the already-reduced vectors:
Shapiro-Wilk normality per project and on the median trend, and the
median trend's Spearman correlation (rq2:305-314, 437-458).  The PDFs
(the correlation histogram, the session boxplot, the mean/median line,
the percentile bands and the per-project charts) need matplotlib, which
this package does not import (ROADMAP.md Queue 1, "RQ figures").
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from ..config import Config
from ..utils.atomic import atomic_write
from ..utils.manifest import RunManifest
from ..utils.timing import PhaseTimer
from .common import StudyContext, limit_date_ns


def save_ragged_csv(result, path: str) -> int:
    """Row i = coverage values of every project alive at session i."""
    S = result.matrix.shape[1]
    with atomic_write(path, newline="") as f:
        w = csv.writer(f)
        if S == 0:
            w.writerow([])
            return 0
        for s in range(S):
            col = result.matrix[result.mask[:, s], s]
            w.writerow([float(v) for v in col])
    return S


def run_rq2_trends(cfg: Config | None = None, db=None,
                   device: str | torch.device = "cuda") -> dict:
    from scipy.stats import shapiro, spearmanr

    timer = PhaseTimer()
    with timer.phase("extract"):
        ctx = StudyContext.open(cfg, db=db, announce=False, device=device)
    manifest = RunManifest("rq2_trends", ctx.backend.name,
                           str(ctx.backend.device))

    with timer.phase("trend_kernel"):
        result = ctx.backend.rq2_trends(ctx.arrays, limit_date_ns(ctx.cfg))

    # Shapiro-Wilk normality per project (rq2:305-314).
    tested = normal = 0
    with timer.phase("stats"):
        for p in range(ctx.arrays.n_projects):
            trend = result.matrix[p, result.mask[p]]
            if len(trend) >= 3:
                tested += 1
                try:
                    _, sw_p = shapiro(trend)
                    if sw_p > 0.05:
                        normal += 1
                except ValueError:  # shapiro rejects degenerate trends
                    pass
    if tested:
        print(f"Projects tested for normality (N >= 3 sessions): {tested}")
        print(f"Projects whose coverage trend follows normal distribution "
              f"(p > 0.05): {normal}")
        print(f"Percentage of normally distributed projects: "
              f"{normal / tested * 100:.2f}%")

    valid = result.spearman[~np.isnan(result.spearman)]
    print(f"Total projects processed: {len(result.spearman)}")
    print(f"Number of projects with valid correlation: {len(valid)}")
    if len(valid):
        print(f"Average correlation: {np.mean(valid):.4f}, "
              f"Median correlation: {np.median(valid):.4f}")

    out_dir = ctx.out_dir("rq2")
    with timer.phase("artifacts"):
        csv_path = os.path.join(out_dir, "coverage_by_session_index.csv")
        save_ragged_csv(result, csv_path)
        manifest.add_artifact(csv_path)

    # Median-trend stats (rq2:437-458).
    enough = result.counts >= ctx.min_projects
    median_trend = result.percentiles[2][enough]
    stats = {}
    with timer.phase("stats"):
        if len(median_trend) > 1:
            rho, pval = spearmanr(range(len(median_trend)), median_trend)
            stats["median_trend_spearman"] = (float(rho), float(pval))
            print("Spearman correlation (Session Index vs. Median):",
                  (float(rho), float(pval)))
        if len(median_trend) >= 3:
            _, sw_p = shapiro(median_trend)
            stats["median_trend_shapiro_p"] = float(sw_p)
            print(f"Shapiro-Wilk test for 'median_trend' "
                  f"(N={len(median_trend)}): p-value = {sw_p:.4f}")

    manifest.record(
        n_projects=len(result.spearman),
        n_sessions=int(result.matrix.shape[1]),
        n_sessions_min_projects=int(enough.sum()),
        normality={"tested": tested, "normal": normal},
        **stats,
    )
    manifest.save(out_dir, timer.as_dict())
    return {"result": result, "stats": stats, "csv": csv_path}


__all__ = ["run_rq2_trends", "save_ragged_csv"]
