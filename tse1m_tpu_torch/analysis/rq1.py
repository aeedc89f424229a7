"""RQ1, the vulnerability detection rate over fuzzing iterations: a port
of ``tse1m_tpu/analysis/rq1.py:33-180`` over ``TorchBackend``.

Artifacts, byte for byte as the JAX package writes them:

- ``rq1_detection_rate_stats.csv``: ``Iteration,Total_Projects,
  Detected_Projects_Count`` (rq1:330-335);
- ``rq1_raw_issues_for_analysis.csv``: the linked issues with their
  matched build, under a generic ``issue_i`` header (rq1:23-43);
- ``rq1_detection_rate.pdf``: Figure 6, the dual-axis plot (rq1:46-98),
  where matplotlib imports (``common.Figures``).
"""

from __future__ import annotations

import csv
import os

import numpy as np
import torch

from ..config import Config
from ..db import queries
from ..db.ingest import parse_array, pg_array_literal
from ..utils.atomic import atomic_write
from ..utils.manifest import RunManifest
from ..utils.timing import PhaseTimer
from .common import Figures, StudyContext, fmt_ts_ns, limit_date_ns, pyplot


def save_raw_issues_csv(ctx: StudyContext, result, path: str) -> int:
    """Linked issues with their matched build, ordered by (project,
    rts); returns the row count (no file without a linked issue)."""
    issues = ctx.arrays.issues
    fuzz = ctx.arrays.fuzz
    rows = []
    for p in range(ctx.arrays.n_projects):
        for j in range(issues.offsets[p], issues.offsets[p + 1]):
            bi = result.link_idx[j]
            if bi < 0:
                continue
            rows.append([
                issues.columns["number"][j],
                ctx.projects[p],
                fmt_ts_ns(int(issues.columns["time_ns"][j])),
                fmt_ts_ns(int(fuzz.columns["time_ns"][bi])),
                "Fuzzing",
                fuzz.columns["result"][bi],
                fuzz.columns["name"][bi],
                pg_array_literal(parse_array(fuzz.columns["modules_raw"][bi])),
                pg_array_literal(parse_array(
                    fuzz.columns["revisions_raw"][bi])),
            ])
    if not rows:
        return 0
    with atomic_write(path, newline="") as f:
        w = csv.writer(f)
        w.writerow([f"issue_{i}" for i in range(len(rows[0]))])
        w.writerows(rows)
    return len(rows)


def save_stats_csv(result, path: str) -> None:
    with atomic_write(path, newline="") as f:
        w = csv.writer(f)
        w.writerow(["Iteration", "Total_Projects", "Detected_Projects_Count"])
        for it, tot, det in zip(result.iterations, result.total_projects,
                                result.detected_counts):
            w.writerow([int(it), int(tot), int(det)])


def create_detection_rate_graph(result, path: str,
                                file_format: str = "pdf") -> None:
    """Figure 6: the detection-rate line on the primary axis over a
    project-population bar chart on the secondary axis (rq1:46-98)."""
    plt = pyplot()
    rates = result.detection_rates
    fig, ax1 = plt.subplots(figsize=(5, 3))
    ax2 = ax1.twinx()
    ax1.set_zorder(ax2.get_zorder() + 1)
    ax1.patch.set_visible(False)
    ax1.plot(range(len(rates)), rates, color="b", marker="o", markersize=1.0,
             linewidth=1)
    ax1.set_ylabel("Percentage of Projects Detecting Bugs", y=0.45)
    ax1.set_xlabel("Fuzzing Session")
    ax2.bar(range(len(result.total_projects)), result.total_projects,
            color="#88c778", alpha=0.6)
    ax2.set_ylabel("Number of Projects")
    plt.tight_layout(pad=0.1)
    plt.savefig(path, format=file_format)
    plt.close(fig)


def late_stage_stats(result, threshold_pct: float = 5.0) -> dict:
    """Late-stage IQR/median/zero-rate block (rq1:241-268): stats over
    the rates from the first iteration whose rate drops below the
    threshold."""
    rates = result.detection_rates
    below = np.flatnonzero(rates < threshold_pct)
    if len(below) == 0 or len(rates) == 0:
        return {}
    start = below[0]
    late = rates[start:]
    return {
        "first_below_iteration": int(result.iterations[start]),
        "min": float(late.min()),
        "max": float(late.max()),
        "p25": float(np.percentile(late, 25)),
        "p75": float(np.percentile(late, 75)),
        "median": float(np.median(late)),
        "mean": float(late.mean()),
        "zero_fraction": float((late == 0).mean()),
    }


def run_rq1(cfg: Config | None = None, db=None,
            device: str | torch.device = "cuda") -> dict:
    timer = PhaseTimer()
    with timer.phase("extract"):
        ctx = StudyContext.open(cfg, db=db, device=device)
    manifest = RunManifest("rq1", ctx.backend.name, str(ctx.backend.device))

    # Unlinked-issue diagnostic (rq1:161-163): fixed issues of eligible
    # projects with no ok pre-cutoff fuzzing build before their report.
    sql, params = queries.issues_without_matching_build(
        ctx.projects, ctx.cfg.limit_date)
    n_unmatched = ctx.db.count(sql, params)
    print(f"Found {n_unmatched:,} issues without matching build.")

    with timer.phase("detect_kernel"):
        result = ctx.backend.rq1_detection(
            ctx.arrays, limit_date_ns(ctx.cfg), ctx.min_projects)

    n_issues = len(ctx.arrays.issues)
    n_linked = int(result.linked.sum())
    total_builds = int(len(ctx.arrays.fuzz))
    print(f"{ctx.arrays.n_projects:,} projects have {total_builds:,} "
          f"fuzzing builds. (in abstract)")
    if n_issues:
        print(f"linked {n_linked:,}({n_linked / n_issues * 100:.2f}%) issues "
              f"to buildlog data. {n_linked}/{n_issues}")
    print(f"Retained {len(result.iterations):,} iterations for the final "
          "analysis.")

    out_dir = ctx.out_dir("rq1")
    with timer.phase("artifacts"):
        stats_path = os.path.join(out_dir, "rq1_detection_rate_stats.csv")
        save_stats_csv(result, stats_path)
        manifest.add_artifact(stats_path)
        raw_path = os.path.join(out_dir, "rq1_raw_issues_for_analysis.csv")
        if save_raw_issues_csv(ctx, result, raw_path):
            manifest.add_artifact(raw_path)
        figures = Figures(manifest, out_dir)
        pdf_path = os.path.join(out_dir, "rq1_detection_rate.pdf")
        if figures.draw(pdf_path, create_detection_rate_graph, result,
                        pdf_path):
            manifest.add_artifact(pdf_path)
        figures.finish()

    late = late_stage_stats(result)
    if late:
        print(f"Late-stage (from iteration {late['first_below_iteration']}): "
              f"median {late['median']:.2f}%, IQR {late['p25']:.2f}-"
              f"{late['p75']:.2f}%, mean {late['mean']:.2f}%, zero "
              f"{late['zero_fraction'] * 100:.2f}%")

    manifest.record(
        n_projects=ctx.arrays.n_projects,
        n_fuzz_builds=total_builds,
        n_issues=n_issues,
        n_linked=n_linked,
        n_unmatched=n_unmatched,
        n_iterations=len(result.iterations),
        late_stage=late,
    )
    manifest.save(out_dir, timer.as_dict())
    return {"result": result, "late": late, "stats_csv": stats_path,
            "raw_csv": raw_path}


__all__ = ["create_detection_rate_graph", "late_stage_stats", "run_rq1",
           "save_raw_issues_csv", "save_stats_csv"]
