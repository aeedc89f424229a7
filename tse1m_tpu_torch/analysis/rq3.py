"""RQ3, the coverage change when bugs are detected and when not: a port of
``tse1m_tpu/analysis/rq3.py:46-137, 219-288`` over ``TorchBackend``.

Artifacts, as the JAX package writes them (under ``rq3/``):
``detected_coverage_changes.csv`` and ``non_detected_coverage_changes.csv``,
header ``CoverageChangePercent,CoveredLinesChange,TotalLinesChange``
(rq3:307-318); and where matplotlib imports (``common.Figures``) and both
groups have rows, ``coverage_diff_boxplot.pdf`` and
``coverage_diff_histograms.pdf`` (rq3:157-198), ``detected.pdf`` and
``non_detected.pdf`` (rq3:70-152, 357-358).

The statistics stay on the host in scipy over the already-reduced delta
vectors: the summary table per group (rq3:25-66), Anderson-Darling
normality per group (rq3:329-339), Levene (rq3:344) and Brunner-Munzel
(rq3:349).
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


def summary_statistics(data: np.ndarray) -> dict:
    """The reference's summary table block (rq3:25-66)."""
    data = np.asarray(data, dtype=np.float64)
    n = data.size
    if n == 0:
        return {"count": 0}
    return {
        "count": int(n),
        "positive_pct": float((data > 0).sum() / n * 100),
        "zero_pct": float((data == 0).sum() / n * 100),
        "negative_pct": float((data < 0).sum() / n * 100),
        "mean": float(data.mean()),
        "median": float(np.median(data)),
        "std": float(data.std()),
        "min": float(data.min()),
        "q1": float(np.percentile(data, 25)),
        "q3": float(np.percentile(data, 75)),
        "max": float(data.max()),
    }


def print_summary_statistics(data: np.ndarray, name: str) -> dict:
    s = summary_statistics(data)
    print(f"\n--- Summary Statistics for '{name}' Group ---")
    if not s["count"]:
        print("No data available.")
        return s
    rows = [
        ("Count", f"{s['count']}"),
        ("Positive Change Rate (%)", f"{s['positive_pct']:.2f}"),
        ("Zero Change Rate (%)", f"{s['zero_pct']:.2f}"),
        ("Negative Change Rate (%)", f"{s['negative_pct']:.2f}"),
        ("Mean", f"{s['mean']:.4f}"),
        ("Median", f"{s['median']:.4f}"),
        ("Std. Deviation", f"{s['std']:.4f}"),
        ("Min", f"{s['min']:.4f}"),
        ("Q1", f"{s['q1']:.4f}"),
        ("Q3", f"{s['q3']:.4f}"),
        ("Max", f"{s['max']:.4f}"),
    ]
    print("+--------------------------+----------------------+")
    print("| Metric                   | Value                |")
    print("+--------------------------+----------------------+")
    for k, v in rows:
        print(f"| {k:<24} | {v:<20} |")
    print("+--------------------------+----------------------+")
    return s


def statistical_tests(detected: np.ndarray, non_detected: np.ndarray) -> dict:
    """Anderson-Darling per group, Levene, Brunner-Munzel (rq3:329-352)."""
    import warnings

    from scipy import stats

    out: dict = {}
    for name, data in (("detected", detected), ("non_detected", non_detected)):
        if data.size >= 3:
            with warnings.catch_warnings():
                # scipy >= 1.17 deprecates the critical-value result shape;
                # kept because the reference prints critical values
                # (rq3:331-333).
                warnings.simplefilter("ignore", FutureWarning)
                r = stats.anderson(data, dist="norm")
            out[f"anderson_{name}"] = {
                "statistic": float(r.statistic),
                "critical_values": [float(v) for v in r.critical_values],
                "significance_levels": [float(v) for v in r.significance_level],
            }
    if detected.size >= 2 and non_detected.size >= 2:
        stat, p = stats.levene(detected, non_detected)
        out["levene"] = {"statistic": float(stat), "p_value": float(p)}
        stat, p = stats.brunnermunzel(detected, non_detected)
        out["brunner_munzel"] = {"statistic": float(stat), "p_value": float(p)}
    return out


def save_changes_csv(path: str, pct, cov, tot) -> None:
    with atomic_write(path, newline="") as f:
        w = csv.writer(f)
        w.writerow(["CoverageChangePercent", "CoveredLinesChange",
                    "TotalLinesChange"])
        for row in zip(pct, cov, tot):
            w.writerow([row[0], _int_if_whole(row[1]), _int_if_whole(row[2])])


def _int_if_whole(x: float):
    # The covered/total line deltas are integral counts; the reference
    # writes them as ints straight from the DB (rq3:299-300).
    return int(x) if float(x).is_integer() else x


def create_comparison_plots(out_dir: str, detected, non_detected) -> list[str]:
    """Side-by-side symlog boxplot and shared-bin histograms
    (rq3:157-198); returns the paths written."""
    plt = pyplot()
    paths = []

    fig = plt.figure(figsize=(4, 3))
    box = plt.boxplot([detected, non_detected], patch_artist=True,
                      tick_labels=["Detected", "Not Detected"],
                      showfliers=True)
    for patch, color in zip(box["boxes"], ["#A3BCE2", "#E2A3A3"]):
        patch.set_facecolor(color)
    plt.ylabel("Coverage Difference (%)")
    plt.yscale("symlog", linthresh=0.01)
    plt.grid(axis="y", linestyle="--", alpha=0.6)
    plt.tight_layout()
    p = os.path.join(out_dir, "coverage_diff_boxplot.pdf")
    plt.savefig(p)
    plt.close(fig)
    paths.append(p)

    both = np.concatenate([detected, non_detected])
    bins = np.linspace(both.min(), both.max(), 50) if both.size else 10
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(8, 3), sharey=True,
                                   sharex=True)
    ax1.hist(detected, bins=bins, color="skyblue", edgecolor="black")
    ax1.set_title("Detected")
    ax1.set_xlabel("Coverage Difference (%)")
    ax1.set_ylabel("Frequency")
    ax2.hist(non_detected, bins=bins, color="salmon", edgecolor="black")
    ax2.set_title("Not Detected")
    ax2.set_xlabel("Coverage Difference (%)")
    plt.tight_layout()
    p = os.path.join(out_dir, "coverage_diff_histograms.pdf")
    plt.savefig(p)
    plt.close(fig)
    paths.append(p)
    return paths


def create_boxplot(path: str, values) -> None:
    """Single-group symlog boxplot with a mean marker (rq3:70-152)."""
    plt = pyplot()
    from matplotlib.ticker import FuncFormatter

    edge = "#444444"
    fig = plt.figure(figsize=(2.0, 2.5))
    box = plt.boxplot(values, patch_artist=True, widths=0.5, showfliers=True)
    for patch in box["boxes"]:
        patch.set_facecolor("#e3eefa")
        patch.set_linewidth(0.7)
        patch.set_edgecolor(edge)
    plt.setp(box["medians"], color="#FF0000", linewidth=0.3)
    for whisker in box["whiskers"]:
        whisker.set_linewidth(0.7)
        whisker.set_color(edge)
    for cap in box["caps"]:
        cap.set_linewidth(0.7)
        cap.set_color(edge)
    for flier in box["fliers"]:
        flier.set(marker="o", alpha=0.5, markersize=2, markeredgewidth=0.2,
                  markeredgecolor="#c83c3c")
    plt.scatter(1, np.mean(values), color="#2f6ba3", marker="^", s=15,
                zorder=3, label="Mean")
    plt.ylabel("Coverage Difference")
    plt.xticks([])
    plt.yscale("symlog", linthresh=0.01)
    plt.ylim(-100, 100)
    ticks = [-100, -10, -1, -0.1, -0.01, 0, 0.01, 0.1, 1, 10, 100]
    plt.yticks(ticks)

    def fmt(x, pos):
        if x == 0:
            return "0"
        e = int(np.log10(abs(x)))
        return f"$-10^{{{e}}}$" if x < 0 else f"$10^{{{e}}}$"

    plt.gca().get_yaxis().set_major_formatter(FuncFormatter(fmt))
    plt.tight_layout(pad=0)
    plt.savefig(path, bbox_inches="tight")
    plt.close(fig)


def run_rq3(cfg: Config | None = None, db=None,
            device: str | torch.device = "cuda") -> dict:
    timer = PhaseTimer()
    print("--- RQ3 Analysis Started ---")
    with timer.phase("extract"):
        ctx = StudyContext.open(cfg, db=db, announce=False, device=device)
    manifest = RunManifest("rq3", ctx.backend.name, str(ctx.backend.device))
    n_issues = len(ctx.arrays.issues)
    print(f"Fetched {n_issues} fixed issues from target projects.")

    with timer.phase("rq3_kernel"):
        result = ctx.backend.rq3_coverage_at_detection(
            ctx.arrays, limit_date_ns(ctx.cfg))
    detected = result.det_diff_percent
    non_detected = result.nondet_diff_percent
    print(f"\nFound {detected.size} instances of coverage change on bug "
          "detection.")

    out_dir = ctx.out_dir("rq3")
    with timer.phase("artifacts"):
        det_path = os.path.join(out_dir, "detected_coverage_changes.csv")
        save_changes_csv(det_path, detected, result.det_diff_covered,
                         result.det_diff_total)
        manifest.add_artifact(det_path)
        nondet_path = os.path.join(out_dir, "non_detected_coverage_changes.csv")
        save_changes_csv(nondet_path, non_detected,
                         result.nondet_diff_covered, result.nondet_diff_total)
        manifest.add_artifact(nondet_path)

    with timer.phase("stats"):
        stats_summary = {
            "detected": print_summary_statistics(detected, "Detected"),
            "non_detected": print_summary_statistics(non_detected,
                                                     "Not Detected"),
            "detected_total": print_summary_statistics(
                result.det_diff_total, "Detected Total"),
        }
        tests = statistical_tests(detected, non_detected)
    for name in ("detected", "non_detected"):
        t = tests.get(f"anderson_{name}")
        if t:
            print("Detected" if name == "detected" else "Not Detected")
            print("Test statistic (A²):", t["statistic"])
    if "levene" in tests:
        print(f"Levene's test statistic: {tests['levene']['statistic']:.4f}")
        print(f"P-value: {tests['levene']['p_value']:.4f}")
    if "brunner_munzel" in tests:
        print(f"Brunner-Munzel W statistic: "
              f"{tests['brunner_munzel']['statistic']:.4f}")
        print(f"P-value: {tests['brunner_munzel']['p_value']:.4f}")

    with timer.phase("figures"):
        figures = Figures(manifest, out_dir)
        if detected.size and non_detected.size:
            pair = tuple(os.path.join(out_dir, name) for name in (
                "coverage_diff_boxplot.pdf", "coverage_diff_histograms.pdf"))
            if figures.draw(pair, create_comparison_plots, out_dir,
                            detected, non_detected):
                for path in pair:
                    manifest.add_artifact(path)
            for name, vals in (("detected.pdf", detected),
                               ("non_detected.pdf", non_detected)):
                path = os.path.join(out_dir, name)
                if figures.draw(path, create_boxplot, path, vals):
                    manifest.add_artifact(path)
        figures.finish()

    manifest.record(
        n_issues=n_issues,
        n_detected=int(detected.size),
        n_non_detected=int(non_detected.size),
        summary=stats_summary,
        tests=tests,
    )
    manifest.record_backend(ctx.backend)
    manifest.save(out_dir, timer.as_dict())
    print("\n--- RQ3 Analysis Finished ---")
    return {"result": result, "summary": stats_summary, "tests": tests,
            "detected_csv": det_path, "non_detected_csv": nondet_path}


__all__ = ["create_boxplot", "create_comparison_plots",
           "print_summary_statistics", "run_rq3", "save_changes_csv",
           "statistical_tests", "summary_statistics"]
