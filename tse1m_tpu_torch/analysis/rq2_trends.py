"""RQ2 coverage trends: a port of ``tse1m_tpu/analysis/rq2_trends.py:47-60,
196-289`` over ``TorchBackend``.

Artifacts, as the JAX package writes them (under ``rq2/``):

- ``coverage_by_session_index.csv``: ragged rows, row i = every project's
  coverage % at its i-th session (rq2_coverage_count.py:347-352);
- where matplotlib imports (``common.Figures``):
  ``all_project_corr_hist.pdf`` (rq2:376-384),
  ``session_coverage_boxplot.pdf`` (rq2:386-435),
  ``average_median_lineplot.pdf`` (rq2:460-474),
  ``session_coverage_distribution_trend.pdf`` (rq2:123-242) and, with
  ``per_project_figures``, ``projects/<corr>_<project>.pdf`` for every
  project with |corr| > 0.5 (rq2:324-327).

The statistics stay on the host in scipy over the already-reduced vectors:
Shapiro-Wilk normality per project and on the median trend, and the
median trend's Spearman correlation (rq2:305-314, 437-458).
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
from .common import Figures, StudyContext, limit_date_ns, pyplot


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


def plot_corr_hist(spearman: np.ndarray, path: str) -> None:
    plt = pyplot()
    valid = spearman[~np.isnan(spearman)]
    plt.figure(figsize=(5, 3))
    plt.hist(valid, bins=40, color="skyblue", edgecolor="black", alpha=0.8)
    plt.xlabel("Correlation")
    plt.ylabel("Frequency")
    plt.tight_layout(pad=0.2)
    plt.savefig(path, format="pdf")
    plt.close()


def plot_session_boxplot(result, path: str, min_projects: int,
                         step: int = 100) -> None:
    """Boxplot every ``step`` sessions over sessions with >= min_projects
    (rq2:386-435): coverage boxes over a project-count bar background."""
    plt = pyplot()
    S = result.matrix.shape[1]
    data, labels = [], []
    for s in range(0, S, step):
        col = result.matrix[result.mask[:, s], s]
        if col.size >= min_projects:
            data.append(col)
            labels.append(s + 1)
    if not data:
        return
    plt.figure(figsize=(7.5, 4.5))
    ax1 = plt.gca()
    ax2 = ax1.twinx()
    ax1.set_zorder(ax2.get_zorder() + 1)
    ax1.patch.set_visible(False)
    ax2.bar(range(1, len(data) + 1), [len(d) for d in data],
            color="#88c778", alpha=0.6, zorder=1)
    ax2.set_ylabel("Number of Projects")
    box = ax1.boxplot(data, patch_artist=True, zorder=3)
    for patch in box["boxes"]:
        patch.set_facecolor("#e3eefa")
    for median in box["medians"]:
        median.set_color("#000000")
    for i, d in enumerate(data, start=1):
        ax1.scatter(i, np.mean(d), color="#215F9A", marker="^", zorder=4, s=8)
    ax1.set_ylabel("Coverage (%)")
    ax1.set_ylim(0, 100)
    ax1.set_xlabel("Coverage Measurement Count")
    pos = list(range(1, len(data) + 1))[::2]
    ax1.set_xticks(pos)
    ax1.set_xticklabels(labels[::2], rotation=45)
    plt.tight_layout(pad=0.2)
    plt.savefig(path, format="pdf", transparent=True)
    plt.close()


def plot_mean_median(result, path: str, min_projects: int) -> None:
    plt = pyplot()
    enough = result.counts >= min_projects
    mean = result.mean[enough]
    median = result.percentiles[2][enough]  # PCTS index 2 = 50
    idx = list(range(int(enough.sum())))
    plt.figure(figsize=(6, 4))
    plt.plot(idx, mean, label="Average", marker="o", color="blue",
             markersize=1, linewidth=1)
    plt.plot(idx, median, label="Median", marker="s", color="orange",
             markersize=1, linewidth=1)
    plt.xlabel(f"Session Index (with >= {min_projects} projects)")
    plt.ylabel("Coverage (%)")
    plt.title("Average and Median Coverage Over Time")
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.5)
    plt.tight_layout()
    plt.savefig(path, format="pdf")
    plt.close()


def plot_distribution_trend(result, path: str, min_projects: int) -> None:
    """Percentile-band distribution plot (rq2:123-242) over sessions with
    >= min_projects data points."""
    plt = pyplot()
    enough = result.counts >= min_projects
    if not enough.any():
        return
    idx = list(range(int(enough.sum())))
    p5, p25, p50, p75, p95 = (result.percentiles[i][enough] for i in range(5))
    mean = result.mean[enough]
    counts = result.counts[enough]

    fig, (ax_num, ax_cov) = plt.subplots(
        2, 1, figsize=(10, 6), sharex=True,
        gridspec_kw={"height_ratios": [1, 3]})
    ax_num.plot(idx, counts, color="tab:blue", linewidth=1.5)
    ax_num.set_ylabel("#Projects")
    ax_num.set_ylim(bottom=0)
    ax_num.set_title("Coverage Percentage across Fuzzing Sessions")

    cmap = plt.get_cmap("Blues")
    ax_cov.fill_between(idx, p25, p75, color=cmap(0.8), alpha=0.35,
                        label="Percentile 25-75%", zorder=1)
    ax_cov.fill_between(idx, p5, p95, color=cmap(0.4), alpha=0.28, zorder=0)
    ax_cov.plot(idx, p5, color="#6889df", linewidth=1.3,
                label="Percentile 5-95%", zorder=3)
    ax_cov.plot(idx, p95, color="#6889df", linewidth=1.3, zorder=3)
    ax_cov.plot(idx, p50, color="#2ca02c", linewidth=2, label="Median",
                zorder=4)
    ax_cov.plot(idx, mean, color="#ffb43b", linewidth=2, label="Mean",
                zorder=4)
    for x in range(0, len(idx), 100):
        ax_cov.axvline(x=x, color="gray", linewidth=0.5, linestyle="--",
                       alpha=0.5)
    ax_cov.set_xticks(range(0, len(idx), 200))
    ax_cov.set_ylabel("Line Coverage %")
    ax_cov.set_xlabel("Coverage Measurement Count (Sessions)")
    ax_cov.set_ylim(0, 100)
    if len(idx) > 1:
        ax_cov.set_xlim(left=0, right=len(idx) - 1)
    handles, labels = ax_cov.get_legend_handles_labels()
    fig.legend(handles, labels, loc="lower center",
               bbox_to_anchor=(0.5, -0.05), ncol=4, frameon=False)
    fig.tight_layout()
    plt.subplots_adjust(bottom=0.2)
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def plot_project_trend(trend: np.ndarray, path: str) -> None:
    """One project's coverage % chart (rq2:23-120, the coverage line;
    drawn when |spearman| > 0.5)."""
    plt = pyplot()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 3))
    ax.plot(range(len(trend)), trend, color="red", alpha=0.7, linewidth=1.3)
    ax.set_ylabel("Coverage (%)")
    ax.set_ylim(0, 105)
    ax.set_xlabel("Coverage Measurement Count")
    fig.tight_layout()
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)


def run_rq2_trends(cfg: Config | None = None, db=None,
                   device: str | torch.device = "cuda",
                   per_project_figures: bool = True) -> dict:
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
    min_p = ctx.min_projects
    with timer.phase("artifacts"):
        csv_path = os.path.join(out_dir, "coverage_by_session_index.csv")
        save_ragged_csv(result, csv_path)
        manifest.add_artifact(csv_path)
        figures = Figures(manifest, out_dir)
        hist = os.path.join(out_dir, "all_project_corr_hist.pdf")
        if figures.draw(hist, plot_corr_hist, result.spearman, hist):
            manifest.add_artifact(hist)
        boxp = os.path.join(out_dir, "session_coverage_boxplot.pdf")
        figures.draw(boxp, plot_session_boxplot, result, boxp, min_p)
        linep = os.path.join(out_dir, "average_median_lineplot.pdf")
        figures.draw(linep, plot_mean_median, result, linep, min_p)
        dist = os.path.join(out_dir,
                            "session_coverage_distribution_trend.pdf")
        figures.draw(dist, plot_distribution_trend, result, dist, min_p)
        if per_project_figures:
            for p in range(ctx.arrays.n_projects):
                corr = result.spearman[p]
                if not np.isnan(corr) and abs(corr) > 0.5:
                    fig_path = os.path.join(
                        out_dir, "projects",
                        f"{corr:.4f}_{ctx.projects[p]}.pdf")
                    figures.draw(fig_path, plot_project_trend,
                                 result.matrix[p, result.mask[p]], fig_path)
        figures.finish()

    # Median-trend stats (rq2:437-458).
    enough = result.counts >= min_p
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
    manifest.record_backend(ctx.backend)
    manifest.save(out_dir, timer.as_dict())
    return {"result": result, "stats": stats, "csv": csv_path}


__all__ = ["plot_corr_hist", "plot_distribution_trend", "plot_mean_median",
           "plot_project_trend", "plot_session_boxplot", "run_rq2_trends",
           "save_ragged_csv"]
