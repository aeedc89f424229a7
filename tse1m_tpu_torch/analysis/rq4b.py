"""RQ4b, the seed corpus's effect on coverage: a port of
``tse1m_tpu/analysis/rq4b.py:56-262, 357-451`` over ``TorchBackend``.

Artifacts, as the JAX package writes them (under ``rq4/coverage/``):
``g2_g1_trend_stats.csv``, the per-session percentile and count table of
G2 and G1 with each session's Brunner-Munzel p-value (rq4b:938-976;
``nan`` where the test did not run); and where matplotlib imports
(``common.Figures``) and the data allow, ``coverage_delta_timeseries_
linear.pdf`` (rq4b:1041-1118) and ``g2_g1_boxplot_comparison.pdf``
(rq4b:491-637).

Console: the per-session Brunner-Munzel summary with the first
significant session, the Q1/median/Q3 win ratios and Spearman trend
correlations (rq4b:799-908); the initial-coverage Mann-Whitney U, Cliff's
delta, Brunner-Munzel and Levene (rq4b:248-313); the per-step coverage
medians around corpus introduction (rq4b:1060-1085).
"""

from __future__ import annotations

import csv
import logging
import os

import numpy as np
import torch

from ..backend.torch_backend import floor_day_ns
from ..config import Config
from ..utils.atomic import atomic_write
from ..utils.manifest import RunManifest
from ..utils.timing import PhaseTimer
from .common import Figures, StudyContext, limit_date_ns, pyplot
from .corpus import CorpusGroups, load_corpus_groups

log = logging.getLogger(__name__)

PERCENTILES = (25, 50, 75)
BOXPLOT_STEP = 100


# -- Analysis 2: pre/post coverage deltas (rq4b:725-797) ---------------------

def coverage_deltas(arrays, groups: CorpusGroups, n_iters: int) -> dict:
    """Pre/post coverage around corpus introduction for G3+G4 projects.

    Reference semantics (rq4b:744-794): last/first ``n_iters`` non-null > 0
    coverage rows strictly before / from the corpus *date* on; projects
    missing a full window on either side are dropped (missing-pre ones
    recorded).  Deltas are relative to Pre-1 (the most recent pre row).
    The reference query is date-unbounded; the extraction window ends at
    limit_date + 1 day, which covers every real corpus introduction."""
    target = groups.groups["group3"] | groups.groups["group4"]
    pidx = arrays.project_index()
    N = n_iters
    out = {
        "pre_deltas": np.zeros((0, N)), "post_deltas": np.zeros((0, N)),
        "pre_coverages": np.zeros((0, N)), "post_coverages": np.zeros((0, N)),
        "group_num": np.zeros(0, dtype=np.int64),
        "projects": [], "missing_pre": set(), "post_truncated": set(),
    }
    pre_rows, post_rows, gnum, kept = [], [], [], []
    for name in sorted(target):
        t_corpus = groups.corpus_time_ns.get(name)
        if t_corpus is None or name not in pidx:
            continue
        seg = arrays.cov.segment(pidx[name])
        sel = (~np.isnan(seg["coverage"])) & (seg["coverage"] > 0)
        dates = seg["date_ns"][sel]
        cov = seg["coverage"][sel]
        corpus_day = floor_day_ns(np.int64(t_corpus))
        k = int(np.searchsorted(dates, corpus_day, side="left"))
        pre = cov[max(0, k - N):k][::-1]     # Pre-1 first (DESC order)
        post = cov[k:k + N]
        if pre.size < N or post.size < N:
            if pre.size == 0:
                out["missing_pre"].add(name)
            elif pre.size >= N:  # hence post.size < N
                # A full-pre project short only on the post side may be a
                # casualty of the extraction's cutoff + 1 day window (the
                # reference's queries are date-unbounded, rq4b:758-774).
                out["post_truncated"].add(name)
            continue
        pre_rows.append(pre)
        post_rows.append(post)
        gnum.append(4 if name in groups.groups["group4"] else 3)
        kept.append(name)
    if kept:
        pre_m = np.array(pre_rows)
        post_m = np.array(post_rows)
        base = pre_m[:, 0:1]
        out.update(
            pre_deltas=base - pre_m,          # [n, N], col i = Pre-(i+1)
            post_deltas=post_m - base,        # [n, N], col i = Post-(i+1)
            pre_coverages=pre_m, post_coverages=post_m,
            group_num=np.array(gnum), projects=kept,
        )
    return out


# -- Analysis 1: initial coverage stats (rq4b:248-313) ----------------------

def initial_coverage_stats(g2_cov: np.ndarray, g1_cov: np.ndarray) -> dict:
    from scipy.stats import brunnermunzel, levene, mannwhitneyu

    n2, n1 = len(g2_cov), len(g1_cov)
    if n2 == 0 or n1 == 0:
        return {"n_g2": n2, "n_g1": n1}
    _, p_mw = mannwhitneyu(g2_cov, g1_cov, alternative="two-sided")
    u1, _ = mannwhitneyu(g2_cov, g1_cov, alternative="greater")
    cliffs = (2 * u1) / (n2 * n1) - 1
    bm_stat, p_bm = brunnermunzel(g2_cov, g1_cov, alternative="two-sided")
    lv_stat, p_lv = levene(g2_cov, g1_cov)
    return {
        "n_g2": n2, "n_g1": n1,
        "mannwhitney_p_two_sided": float(p_mw),
        "cliffs_delta": float(cliffs),
        "brunner_stat": float(bm_stat), "brunner_p": float(p_bm),
        "levene_stat": float(lv_stat), "levene_p": float(p_lv),
    }


# -- Analysis 3: per-session BM + trend summary (rq4b:799-1012) -------------

def session_bm_pvalues(result, g1_idx, g2_idx, min_n: int = 5) -> np.ndarray:
    """Two-sided Brunner-Munzel per session where both groups have >= min_n
    values (rq4b:978-985)."""
    import warnings

    from scipy.stats import brunnermunzel

    S = result.matrix.shape[1]
    p_values = np.full(S, np.nan)
    for s in range(S):
        g2_d = result.matrix[g2_idx, s][result.mask[g2_idx, s]]
        g1_d = result.matrix[g1_idx, s][result.mask[g1_idx, s]]
        if g2_d.size >= min_n and g1_d.size >= min_n:
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    _, p_values[s] = brunnermunzel(g2_d, g1_d,
                                                   alternative="two-sided")
            except ValueError:  # brunnermunzel rejects degenerate groups
                pass
    return p_values


def summarize_trends(result, p_values: np.ndarray,
                     min_projects: int) -> dict:
    """The reference's trend summary block (rq4b:799-1012): slice to the
    LAST session where both groups hold >= min_projects, then report BM
    significance, per-percentile win ratios, and Spearman correlations."""
    from scipy.stats import spearmanr

    both = (result.g1_counts >= min_projects) & (result.g2_counts >= min_projects)
    if not both.any():
        return {"valid_sessions": 0}
    last = int(np.flatnonzero(both)[-1])
    sl = slice(0, last + 1)
    p = p_values[sl]
    valid_p = ~np.isnan(p)
    sig = valid_p & (p < 0.05)
    first_sig = int(np.flatnonzero(sig)[0]) + 1 if sig.any() else None

    g2p, g1p = result.g2_percentiles[:, sl], result.g1_percentiles[:, sl]
    ok = ~(np.isnan(g2p).any(axis=0) | np.isnan(g1p).any(axis=0))
    n_cmp = int(ok.sum())
    wins = {}
    spearman = {}
    if n_cmp:
        it = np.arange(1, n_cmp + 1)
        for i, pct in enumerate(result.percentiles):
            wins[pct] = int((g2p[i, ok] > g1p[i, ok]).sum())
            cg1, pg1 = spearmanr(it, g1p[i, ok])
            cg2, pg2 = spearmanr(it, g2p[i, ok])
            spearman[pct] = {"g1": (float(cg1), float(pg1)),
                             "g2": (float(cg2), float(pg2))}
    return {
        "valid_sessions": last + 1,
        "bm_significant": int(sig.sum()),
        "bm_valid": int(valid_p.sum()),
        "first_significant_session": first_sig,
        "comparison_n": n_cmp,
        "wins": wins,
        "spearman": spearman,
    }


def print_trend_summary(summary: dict, percentiles=PERCENTILES) -> None:
    print("\n=== Trend Analysis Summary (Trend Summary) ===")
    if not summary.get("valid_sessions"):
        print("No sessions met the condition.")
        return
    print(f"Target Valid Period: 1 ~ {summary['valid_sessions']} Sessions")
    if summary["bm_valid"]:
        pct = summary["bm_significant"] / summary["bm_valid"] * 100
        print("Brunner-Munzel Test Significant Difference (p<0.05) Rate: "
              f"{summary['bm_significant']}/{summary['bm_valid']} ({pct:.2f}%)")
        if summary["first_significant_session"]:
            print("First significant difference detected at: "
                  f"{summary['first_significant_session']}th session")
        else:
            print("No significant difference detected.")
    n = summary["comparison_n"]
    if n:
        names = {25: "Q1", 50: "Median", 75: "Q3"}
        print(f"Group B > Group A Ratio (N={n}):")
        for pct in percentiles:
            w = summary["wins"][pct]
            print(f"  - {names.get(pct, pct):<18}: {w}/{n} ({w / n * 100:.2f}%)")
        print(f"\nSpearman Rank Correlation with Coverage Measurement Count "
              f"(N={n}):")
        for glabel, gkey in (("Group A (No Corpus)", "g1"),
                             ("Group B (Initial Corpus)", "g2")):
            print(f" [{glabel}]")
            for pct in percentiles:
                c, p = summary["spearman"][pct][gkey]
                print(f"  - {names.get(pct, pct):<15} : corr={c:.4f}, "
                      f"p-value={p:.4e}")
    print("============================================\n")


def save_trend_csv(result, p_values, path: str) -> None:
    S = result.matrix.shape[1]
    with atomic_write(path, newline="") as f:
        w = csv.writer(f)
        header = ["Session"]
        for g in ("G2", "G1"):
            header += [f"{g}_{p}" for p in result.percentiles]
            header.append(f"{g}_Count")
        header.append("BM_p_value")
        w.writerow(header)
        for s in range(S):
            row = [s + 1]
            row += [result.g2_percentiles[i, s]
                    for i in range(len(result.percentiles))]
            row.append(int(result.g2_counts[s]))
            row += [result.g1_percentiles[i, s]
                    for i in range(len(result.percentiles))]
            row.append(int(result.g1_counts[s]))
            row.append(p_values[s])
            w.writerow(row)


# -- Entry point -------------------------------------------------------------

# -- Plots --------------------------------------------------------------------

def plot_coverage_deltas(deltas: dict, n_iters: int, path: str) -> None:
    """Pre/post delta boxplots, chronological t=-N..-1,1..N
    (rq4b:1041-1118)."""
    plt = pyplot()
    if not deltas["projects"]:
        return
    N = n_iters
    data, labels, colors = [], [], []
    for i in range(N - 1, -1, -1):
        data.append(deltas["pre_deltas"][:, i])
        labels.append(f"-{i + 1}")
        colors.append("#ffcc99")
    for i in range(N):
        data.append(deltas["post_deltas"][:, i])
        labels.append(f"{i + 1}")
        colors.append("#99ff99")
    fig, ax = plt.subplots(figsize=(5, 3))
    box = ax.boxplot(data, patch_artist=True, widths=0.6,
                     flierprops=dict(markersize=2))
    for patch, c in zip(box["boxes"], colors):
        patch.set_facecolor(c)
        patch.set_alpha(0.6)
        patch.set_edgecolor("#333333")
    for part in ("whiskers", "caps", "medians"):
        for line in box[part]:
            line.set_color("#333333")
    ax.set_xticks(range(1, 2 * N + 1))
    ax.set_xticklabels(labels)
    ax.set_ylim(-50, 50)
    ax.set_ylabel("Coverage Delta (Relative to Pre-1)")
    ax.set_xlabel("Time Step (t)")
    ax.axhline(0, ls="--", color="black", linewidth=1.0)
    ax.axvline(N + 0.5, ls=":", color="red", linewidth=1.5)
    plt.tight_layout()
    plt.savefig(path, format="pdf")
    plt.close(fig)


def plot_comparative_boxplot(result, g1_idx, g2_idx, min_projects: int,
                             path: str, step: int = BOXPLOT_STEP) -> None:
    """Side-by-side G1/G2 boxplots every ``step`` sessions, cut at the
    first sampled session where either group < min_projects
    (rq4b:491-637)."""
    plt = pyplot()
    S = result.matrix.shape[1]
    sessions, data_a, data_b = [], [], []
    for idx in range(0, S, step):
        a = result.matrix[g1_idx, idx][result.mask[g1_idx, idx]]
        b = result.matrix[g2_idx, idx][result.mask[g2_idx, idx]]
        if a.size < min_projects or b.size < min_projects:
            break
        sessions.append(idx + 1)
        data_a.append(a)
        data_b.append(b)
    if not sessions:
        log.warning("No sufficient data for boxplot.")
        return
    fig, ax1 = plt.subplots(figsize=(5, 3))
    central = np.arange(len(sessions))
    w, d = 0.25, 0.125
    bp_a = ax1.boxplot(data_a, positions=central - d, widths=w,
                       patch_artist=True, showfliers=False)
    bp_b = ax1.boxplot(data_b, positions=central + d, widths=w,
                       patch_artist=True, showfliers=False)
    for bp, face, edge, ls in ((bp_a, "#66b3ff", "#104e8b", "--"),
                               (bp_b, "#ff9999", "#d65f00", "-")):
        for box in bp["boxes"]:
            box.set(facecolor=face, edgecolor=edge, linewidth=1.0, alpha=0.6,
                    linestyle=ls)
        for part in ("whiskers", "caps"):
            for line in bp[part]:
                line.set(color=edge, linewidth=1.0, linestyle=ls)
        for median in bp["medians"]:
            median.set(color=edge, linewidth=1.2)
    from matplotlib.patches import Patch

    ax1.set_ylabel("Coverage (%)")
    ax1.set_xlabel("Coverage Measurement Count")
    ax1.set_ylim(0, 100)
    ax1.set_yticks([0, 20, 40, 60, 80, 100])
    ax1.set_xticks(central)
    ax1.set_xticklabels(sessions, rotation=45)
    ax1.set_xlim(left=-0.5, right=len(sessions) - 0.5)
    ax1.legend(handles=[
        Patch(facecolor="#66b3ff", edgecolor="#333333", alpha=0.6,
              label="Group A (No Seed)"),
        Patch(facecolor="#ff9999", edgecolor="#333333", alpha=0.6,
              label="Group B (Initial Seed)"),
    ], loc="upper left", fontsize="small", ncol=2)
    plt.tight_layout()
    plt.savefig(path, format="pdf", bbox_inches="tight")
    plt.close(fig)


def run_rq4b(cfg: Config | None = None, db=None,
             device: str | torch.device = "cuda") -> dict:
    timer = PhaseTimer()
    with timer.phase("extract"):
        ctx = StudyContext.open(cfg, db=db, announce=False, device=device)
    manifest = RunManifest("rq4b", ctx.backend.name, str(ctx.backend.device))
    lim = limit_date_ns(ctx.cfg)
    N = ctx.cfg.analysis_iterations

    groups = load_corpus_groups(ctx.cfg.corpus_csv, set(ctx.projects),
                                ctx.cfg.days_threshold)
    print("\n=== Number of Projects by Group ===")
    for i, key in enumerate(("group1", "group2", "group3", "group4"), 1):
        print(f"Group {i}: {len(groups.groups[key])} projects")
    pidx = ctx.arrays.project_index()
    g1_idx = groups.indices("group1", pidx)
    g2_idx = groups.indices("group2", pidx)

    with timer.phase("trend_kernel"):
        result = ctx.backend.rq4b_group_trends(ctx.arrays, lim, g1_idx,
                                               g2_idx, PERCENTILES)
    with timer.phase("bm_tests"):
        p_values = session_bm_pvalues(result, g1_idx, g2_idx)
    with timer.phase("stats"):
        summary = summarize_trends(result, p_values, ctx.min_projects)
    print_trend_summary(summary)

    with timer.phase("deltas"):
        deltas = coverage_deltas(ctx.arrays, groups, N)
    print("\n=== Analysis 2: Pre/Post Corpus Introduction Difference "
          "Analysis (Group C: Strict Filter Applied) ===")
    print(f"Number of projects meeting conditions and analyzed: "
          f"{len(deltas['projects'])}")
    if deltas["post_truncated"]:
        log.warning(
            "%d project(s) dropped with a full pre but short post window; "
            "coverage extraction ends at limit_date + 1 day while the "
            "reference's pre/post queries are date-unbounded",
            len(deltas["post_truncated"]))
    if deltas["projects"]:
        print("\n--- Coverage Median for Each Step (Group C) ---")
        for i in reversed(range(N)):
            med = np.median(deltas["pre_coverages"][:, i])
            print(f" Pre-{i + 1:<3}: {med:.2f} "
                  f"(N={deltas['pre_coverages'].shape[0]})")
        for i in range(N):
            med = np.median(deltas["post_coverages"][:, i])
            print(f" Post-{i + 1:<2}: {med:.2f} "
                  f"(N={deltas['post_coverages'].shape[0]})")

    # Analysis 1: initial coverage = session-1 column of the trend matrix
    # (first non-null > 0 coverage row per project, rq4b:230-239).
    if result.matrix.shape[1]:
        first_col = result.matrix[:, 0]
        first_mask = result.mask[:, 0]
        g2_cov = first_col[g2_idx][first_mask[g2_idx]]
        g1_cov = first_col[g1_idx][first_mask[g1_idx]]
    else:
        g2_cov = np.array([])
        g1_cov = np.array([])
    print("\n=== Analysis 1: G2 vs G1 Initial Coverage Comparison ===")
    print(f"Number of Group 2 projects: {len(groups.groups['group2'])}")
    print(f"Number of Group 1 projects: {len(groups.groups['group1'])}")
    with timer.phase("stats"):
        init_stats = initial_coverage_stats(g2_cov, g1_cov)
    for k, v in init_stats.items():
        print(f"[RESULT] {k}: {v}")

    out_dir = ctx.out_dir("rq4/coverage")
    with timer.phase("artifacts"):
        trend_csv = os.path.join(out_dir, "g2_g1_trend_stats.csv")
        save_trend_csv(result, p_values, trend_csv)
        manifest.add_artifact(trend_csv)
    with timer.phase("figures"):
        figures = Figures(manifest, out_dir)
        delta_pdf = os.path.join(out_dir,
                                 "coverage_delta_timeseries_linear.pdf")
        if figures.draw(delta_pdf, plot_coverage_deltas, deltas, N,
                        delta_pdf):
            manifest.add_artifact(delta_pdf)
        box_pdf = os.path.join(out_dir, "g2_g1_boxplot_comparison.pdf")
        if figures.draw(box_pdf, plot_comparative_boxplot, result, g1_idx,
                        g2_idx, ctx.min_projects, box_pdf):
            manifest.add_artifact(box_pdf)
        figures.finish()

    manifest.record(
        group_sizes={k: len(v) for k, v in groups.groups.items()},
        trend_summary=summary,
        initial_coverage=init_stats,
        deltas={"n_projects": len(deltas["projects"]),
                "missing_pre": len(deltas["missing_pre"]),
                "post_truncated": len(deltas["post_truncated"])},
    )
    manifest.save(out_dir, timer.as_dict())
    print("--- Analysis Finished ---")
    return {"result": result, "p_values": p_values, "summary": summary,
            "deltas": deltas, "initial_stats": init_stats,
            "trend_csv": trend_csv}


__all__ = ["BOXPLOT_STEP", "PERCENTILES", "coverage_deltas",
           "initial_coverage_stats", "plot_comparative_boxplot",
           "plot_coverage_deltas", "print_trend_summary", "run_rq4b",
           "save_trend_csv", "session_bm_pvalues", "summarize_trends"]
