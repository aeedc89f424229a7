"""RQ4a, the seed corpus's effect on bug detection: a port of
``tse1m_tpu/analysis/rq4a.py:53-75, 181-298`` over ``TorchBackend``.

Artifacts, as the JAX package writes them (under ``rq4/bug/``):

- ``rq4_g1_g2_detection_trend.csv``: ``Iteration,G1_Total_Projects,
  G1_Detected_Count,G1_Detection_Rate_pct,G2_Total_Projects,
  G2_Detected_Count,G2_Detection_Rate_pct`` (rq4a:198-205);
- ``rq4_gc_introduction_iteration.csv``: ``Project,Introduction_Iteration``
  ascending (rq4a:272-291).

Where matplotlib imports (``common.Figures``): ``rq4_g1_g2_detection_
trend.pdf`` (rq4a:749-784), ``rq4_gc_detection_trend.pdf`` (rq4a:513-568)
and ``rq4_gc_bug_detection_venn.pdf`` (rq4a:843-879; plain matplotlib
circles where ``matplotlib_venn`` is absent, as the JAX package draws).

The console block (rq4a:694-801) reports G2's superiority over G1, the
first iteration below 5 %, the G4 pre/post detection rates and the
transition counts.
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
from .corpus import GROUP_LABELS, g4_prepost, load_corpus_groups


def save_trend_csv(result, path: str) -> None:
    g1r, g2r = result.rates("g1"), result.rates("g2")
    with atomic_write(path, newline="") as f:
        w = csv.writer(f)
        w.writerow(["Iteration", "G1_Total_Projects", "G1_Detected_Count",
                    "G1_Detection_Rate_pct", "G2_Total_Projects",
                    "G2_Detected_Count", "G2_Detection_Rate_pct"])
        for i in range(result.iterations.size):
            w.writerow([int(result.iterations[i]), int(result.g1_total[i]),
                        int(result.g1_detected[i]), g1r[i],
                        int(result.g2_total[i]), int(result.g2_detected[i]),
                        g2r[i]])


def save_intro_csv(prepost, path: str) -> int:
    rows = sorted(prepost.intro_iteration.items(), key=lambda kv: kv[1])
    with atomic_write(path, newline="") as f:
        w = csv.writer(f)
        w.writerow(["Project", "Introduction_Iteration"])
        w.writerows(rows)
    return len(rows)


def plot_g1_g2_trend(result, max_valid_iteration: int, path: str) -> None:
    plt = pyplot()
    keep = result.iterations <= max_valid_iteration
    it = result.iterations[keep]
    plt.figure(figsize=(5, 3))
    plt.plot(it, result.rates("g1")[keep], color="#1f77b4", linestyle="-",
             label=GROUP_LABELS["group1"], linewidth=1, marker="o",
             markersize=1)
    plt.plot(it, result.rates("g2")[keep], color="#ff7f0e", linestyle="-",
             label=GROUP_LABELS["group2"], linewidth=1, alpha=0.7,
             marker="o", markersize=1)
    plt.xlabel("Fuzzing Session")
    plt.ylabel("Percentage of Projects Detecting Bugs", y=0.45)
    plt.legend()
    plt.grid(True, linestyle="--", alpha=0.6)
    if it.size and it.max() > 500:
        from matplotlib.ticker import MaxNLocator

        plt.gca().xaxis.set_major_locator(
            MaxNLocator(integer=True, prune="upper"))
    plt.tight_layout(pad=0.1)
    plt.savefig(path, format="pdf")
    plt.close()


def plot_g4_trend(prepost, n_windows: int, path: str) -> None:
    plt = pyplot()
    rates = prepost.step_rates()
    if rates.size == 0:
        return
    N = n_windows
    sort_idx = [s + N if s < 0 else s + N - 1 for s in prepost.steps]
    plt.figure(figsize=(5, 3))
    plt.plot(sort_idx, rates, color="#2ca02c", linestyle="-", marker="o",
             markersize=5, linewidth=1.5)
    plt.axvline(x=(N - 1) + 0.5, color="r", linestyle="--", linewidth=1.0,
                label="Corpus Specification")
    plt.xlabel("Fuzzing Session (Relative Step: Pre/Post)")
    plt.ylabel("Percentage of Projects Detecting Bugs", y=0.45)
    labels = [f"-{-s}" if s < 0 else f"+{s}" for s in prepost.steps]
    plt.xticks(sort_idx, labels, rotation=0)
    plt.ylim(0, 32)
    plt.legend(loc="upper left")
    plt.grid(True, linestyle="--", alpha=0.6)
    plt.tight_layout(pad=0.1)
    tc = prepost.transition_counts()
    text = "\n".join([
        f"no detection: {tc['no_detection']:>2} project",
        f"pre only detection: {tc['pre_only']:>2} project",
        f"pre&post detection: {tc['pre_and_post']:>2} project",
        f"post only detection: {tc['post_only']:>2} project",
    ])
    plt.gca().text(0.98, 0.05, text, transform=plt.gca().transAxes,
                   ha="right", va="bottom", fontsize=9,
                   fontfamily="monospace",
                   bbox=dict(facecolor="white", alpha=0.85,
                             edgecolor=(0, 0, 0, 0.35), linewidth=0.8))
    plt.savefig(path, format="pdf")
    plt.close()


def plot_transition_venn(prepost, path: str) -> None:
    """Pre/post detection Venn (rq4a:843-879); without matplotlib_venn
    the two circles are drawn with plain matplotlib."""
    plt = pyplot()
    tc = prepost.transition_counts()
    pre_only, post_only = tc["pre_only"], tc["post_only"]
    both, neither = tc["pre_and_post"], tc["no_detection"]
    total = len(prepost.kept_projects)
    try:
        from matplotlib_venn import venn2
    except ImportError:
        venn2 = None
    if venn2 is not None:
        plt.figure(figsize=(5, 4))
        v = venn2(subsets=(pre_only, post_only, both),
                  set_labels=("Detected in Pre", "Detected in Post"))
        for pid, color in (("10", "skyblue"), ("01", "lightgreen"),
                           ("11", "violet")):
            patch = v.get_patch_by_id(pid)
            if patch:
                patch.set_alpha(0.5)
                patch.set_color(color)
        plt.title("Bug Detection Overlap (Group C)")
        plt.text(0, -0.65, f"Neither Detected: {neither}\n(Total: {total})",
                 ha="center", fontsize=9)
    else:
        fig, ax = plt.subplots(figsize=(5, 4))
        for cx, color in ((-0.45, "skyblue"), (0.45, "lightgreen")):
            ax.add_patch(plt.Circle((cx, 0), 0.9, alpha=0.5, color=color))
        ax.text(-0.85, 0, str(pre_only), ha="center", fontsize=12)
        ax.text(0.85, 0, str(post_only), ha="center", fontsize=12)
        ax.text(0, 0, str(both), ha="center", fontsize=12)
        ax.text(-0.45, 1.05, "Detected in Pre", ha="center", fontsize=10)
        ax.text(0.45, 1.05, "Detected in Post", ha="center", fontsize=10)
        ax.text(0, -1.3, f"Neither Detected: {neither}\n(Total: {total})",
                ha="center", fontsize=9)
        ax.set_xlim(-1.8, 1.8)
        ax.set_ylim(-1.6, 1.3)
        ax.set_aspect("equal")
        ax.axis("off")
        ax.set_title("Bug Detection Overlap (Group C)")
    plt.savefig(path, bbox_inches="tight")
    plt.close()


def first_below(rates: np.ndarray, threshold: float = 5.0) -> int:
    below = np.flatnonzero(rates < threshold)
    return int(below[0]) if below.size else len(rates)


def run_rq4a(cfg: Config | None = None, db=None,
             device: str | torch.device = "cuda") -> dict:
    timer = PhaseTimer()
    print("--- Starting RQ4 Bug Detection Trend Analysis ---")
    with timer.phase("extract"):
        ctx = StudyContext.open(cfg, db=db, announce=False, device=device)
    manifest = RunManifest("rq4a", ctx.backend.name, str(ctx.backend.device))
    lim = limit_date_ns(ctx.cfg)
    N = ctx.cfg.analysis_iterations

    groups = load_corpus_groups(ctx.cfg.corpus_csv, set(ctx.projects),
                                ctx.cfg.days_threshold)
    pidx = ctx.arrays.project_index()
    g1_idx = groups.indices("group1", pidx)
    g2_idx = groups.indices("group2", pidx)

    with timer.phase("trend_kernel"):
        result = ctx.backend.rq4a_detection_trend(
            ctx.arrays, lim, g1_idx, g2_idx, ctx.min_projects)
    with timer.phase("g4_prepost"):
        prepost = g4_prepost(ctx.arrays, lim, groups, N)

    out_dir = ctx.out_dir("rq4/bug")
    with timer.phase("artifacts"):
        trend_csv = os.path.join(out_dir, "rq4_g1_g2_detection_trend.csv")
        save_trend_csv(result, trend_csv)
        manifest.add_artifact(trend_csv)

        intro_csv = os.path.join(out_dir, "rq4_gc_introduction_iteration.csv")
        n_intro = save_intro_csv(prepost, intro_csv)
        manifest.add_artifact(intro_csv)

    # Console reporting block (rq4a:694-747).
    g1r, g2r = result.rates("g1"), result.rates("g2")
    n_valid = result.iterations.size
    print(f"Groups used: {GROUP_LABELS['group1']} "
          f"({len(groups.groups['group1'])} projects), "
          f"{GROUP_LABELS['group2']} "
          f"({len(groups.groups['group2'])} projects)")
    superior = int((g2r > g1r).sum())
    pct = superior / n_valid * 100 if n_valid else 0.0
    print("Count of Group B exceeding Group A within valid data range: "
          f"{superior}/{n_valid} ({pct:.2f}%)")
    for label, rates in (("Group A", g1r), ("Group B", g2r)):
        fb = first_below(rates)
        if fb < len(rates):
            print(f"{label}: {int(result.iterations[fb])}th iteration "
                  f"fell below 5% (value: {rates[fb]:.2f}%)")
            late = rates[fb:]
            iqr = np.subtract(*np.percentile(late, [75, 25]))
            print(f"{label}: median {np.median(late):.2f}, IQR {iqr:.2f}")
        else:
            print(f"{label}: No iteration fell below 5%")

    max_valid = int(result.iterations.max()) if n_valid else 0
    print(f"\n[Graph Limit Info] Max iteration where both groups "
          f"maintained >= {ctx.min_projects} projects: {max_valid}")

    # G4 block (rq4a:788-801).
    intro_vals = np.array([v for v in prepost.intro_iteration.values()
                           if v > 0])
    if intro_vals.size:
        print(f"[RESULT] Introduction Iteration (N={intro_vals.size}): "
              f"mean {intro_vals.mean():.2f}, "
              f"median {np.median(intro_vals):.1f}, "
              f"min {intro_vals.min()}, max {intro_vals.max()}")
    rates = prepost.step_rates()
    n_kept = len(prepost.kept_projects)
    pre_rate = float(rates[:N].mean()) if n_kept else 0.0
    post_rate = float(rates[N:].mean()) if n_kept else 0.0
    print(f"Average Pre-Introduction Detection Rate:  {pre_rate:.2f}%")
    print(f"Average Post-Introduction Detection Rate: {post_rate:.2f}%")
    print(f"Effect (Post - Pre): {post_rate - pre_rate:+.2f} points")
    tc = prepost.transition_counts()
    print("\n=== Group C Pre/Post Detection Transition ===")
    print(f"Total Projects: {n_kept}")
    print(f" (i)-(iii) Detected in Pre AND Detected in Post: "
          f"{tc['pre_and_post']}")
    print(f" (i)-(iv)  Detected in Pre AND NOT Detected in Post: "
          f"{tc['pre_only']}")
    print(f" (ii)-(iii) NOT Detected in Pre AND Detected in Post: "
          f"{tc['post_only']}")
    print(f" (ii)-(iv)  NOT Detected in Pre AND NOT Detected in Post: "
          f"{tc['no_detection']}")
    print(f"Valid project count for Group C: {n_kept}")

    with timer.phase("figures"):
        figures = Figures(manifest, out_dir)
        trend_pdf = os.path.join(out_dir, "rq4_g1_g2_detection_trend.pdf")
        if figures.draw(trend_pdf, plot_g1_g2_trend, result, max_valid,
                        trend_pdf):
            manifest.add_artifact(trend_pdf)
        g4_pdf = os.path.join(out_dir, "rq4_gc_detection_trend.pdf")
        if figures.draw(g4_pdf, plot_g4_trend, prepost, N, g4_pdf):
            manifest.add_artifact(g4_pdf)
        venn_pdf = os.path.join(out_dir, "rq4_gc_bug_detection_venn.pdf")
        if n_kept and figures.draw(venn_pdf, plot_transition_venn, prepost,
                                   venn_pdf):
            manifest.add_artifact(venn_pdf)
        figures.finish()

    manifest.record(
        n_projects=ctx.arrays.n_projects,
        group_sizes={k: len(v) for k, v in groups.groups.items()},
        n_valid_iterations=n_valid,
        g2_superiority={"count": superior, "total": n_valid, "pct": pct},
        g4={"n_kept": n_kept, "n_intro": n_intro,
            "missing_pre": len(prepost.missing_pre),
            "pre_rate": pre_rate, "post_rate": post_rate,
            "transitions": tc},
    )
    manifest.record_backend(ctx.backend)
    manifest.save(out_dir, timer.as_dict())
    print("--- RQ4 Bug Detection Trend Analysis Finished ---")
    return {"result": result, "prepost": prepost, "groups": groups,
            "trend_csv": trend_csv, "intro_csv": intro_csv}


__all__ = ["first_below", "plot_g1_g2_trend", "plot_g4_trend",
           "plot_transition_venn", "run_rq4a", "save_intro_csv",
           "save_trend_csv"]
