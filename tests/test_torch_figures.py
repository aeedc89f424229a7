"""The port's RQ figures against the JAX package's, on the CPU.

The frozen golden study (tests/goldens/generate_goldens.py) in test mode
(every data-gated figure drawn, as ``tests/test_figures.py`` runs it)
goes through the JAX package's six drivers (pandas backend) and the
port's six drivers: the port writes the same set of PDFs, the three
data-gated ones and the per-project charts among them, with the same
names.  A figure's bytes depend on the statistics it draws, which the
backends compute in their own float arithmetic (JAX's pandas and
jax_tpu backends already differ in the 7th digit of the RQ2 Spearman
values, so their PDFs differ from each other); so each of the port's
PDFs is held byte for byte against the JAX package's own figure writer
drawing the port's results, under ``SOURCE_DATE_EPOCH=0``.  The Venn
figure is drawn both ways: with ``matplotlib_venn`` hidden (plain
circles) and, where it is installed, with it.  Then with matplotlib
hidden (``sys.modules["matplotlib"] = None``, the card's machine) the
port's ``all`` returns 0, every CSV is still byte-equal to JAX's, and
each driver's manifest lists the figures it skipped.  Tolerance: exact.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from tse1m_tpu.analysis import rq1 as jrq1
from tse1m_tpu.analysis import rq2_trends as jrq2
from tse1m_tpu.analysis import rq3 as jrq3
from tse1m_tpu.analysis import rq4a as jrq4a
from tse1m_tpu.analysis import rq4b as jrq4b
from tse1m_tpu.analysis.rq1 import run_rq1 as j_rq1
from tse1m_tpu.analysis.rq2_changepoints import run_rq2_changepoints as j_rq2a
from tse1m_tpu.analysis.rq2_trends import run_rq2_trends as j_rq2b
from tse1m_tpu.analysis.rq3 import run_rq3 as j_rq3
from tse1m_tpu.analysis.rq4a import run_rq4a as j_rq4a
from tse1m_tpu.analysis.rq4b import run_rq4b as j_rq4b
from tse1m_tpu.config import Config as JConfig
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.analysis import RQ_DRIVERS
from tse1m_tpu_torch.analysis import rq4a as trq4a
from tse1m_tpu_torch.analysis.common import StudyContext
from tse1m_tpu_torch.analysis.corpus import load_corpus_groups
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data.synth import SynthSpec, generate_study

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GEN = os.path.join(REPO, "tests", "goldens", "generate_goldens.py")
_spec = importlib.util.spec_from_file_location("generate_goldens", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

GATED = ("rq2/session_coverage_boxplot.pdf",
         "rq2/session_coverage_distribution_trend.pdf",
         "rq4/coverage/g2_g1_boxplot_comparison.pdf")
MANIFESTS = {"rq1": "rq1/rq1_manifest.json",
             "rq2b": "rq2/rq2_trends_manifest.json",
             "rq3": "rq3/rq3_manifest.json",
             "rq4a": "rq4/bug/rq4a_manifest.json",
             "rq4b": "rq4/coverage/rq4b_manifest.json"}


def _files(root, suffix):
    out = set()
    for d, _, names in os.walk(root):
        out |= {os.path.relpath(os.path.join(d, n), root) for n in names
                if n.endswith(suffix)}
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setenv("SOURCE_DATE_EPOCH", "0")
    # The fallback Venn in both packages (matplotlib_venn is optional).
    mp.setitem(sys.modules, "matplotlib_venn", None)
    d = tmp_path_factory.mktemp("figures")
    db_path, csv_path = str(d / "study.sqlite"), str(d / "corpus.csv")
    study = generate_study(SynthSpec(**gen.SPEC))
    study.to_db(db_path)
    study.write_corpus_csv(csv_path)
    jout, tout, hidden = str(d / "jax"), str(d / "port"), str(d / "hidden")
    jcfg = JConfig(backend="pandas", engine="sqlite", sqlite_path=db_path,
                   result_dir=jout, corpus_csv=csv_path, test_mode=True)
    try:
        for fn in (j_rq1, j_rq2a, j_rq2b, j_rq3, j_rq4a, j_rq4b):
            fn(jcfg)
        tcfg = Config(sqlite_path=db_path, result_dir=tout,
                      corpus_csv=csv_path, test_mode=True)
        results = {name: fn(tcfg, device="cpu")
                   for name, fn in RQ_DRIVERS.items()}
        redraw = str(d / "jax_writers")
        _jax_writers(tcfg, results, redraw)
        mp.setitem(sys.modules, "matplotlib", None)
        rc = cli_main(["all", "--db", db_path, "--result-dir", hidden,
                       "--test-mode", "--corpus-csv", csv_path,
                       "--device", "cpu"])
    finally:
        mp.undo()
    return {"jax": jout, "port": tout, "hidden": hidden, "hidden_rc": rc,
            "redraw": redraw, "dir": d}


def _jax_writers(cfg, results, out):
    """The JAX package's figure writers over the port's results, to the
    paths the port's drivers use (rq1.py:162, rq2_trends.py:243-263,
    rq3.py:269-274, rq4a.py:244-282, rq4b.py:426-434)."""
    ctx = StudyContext.open(cfg, announce=False, device="cpu")
    min_p, n_it = ctx.min_projects, cfg.analysis_iterations
    sub = {k: os.path.join(out, k) for k in ("rq1", "rq2", "rq3", "rq4/bug",
                                            "rq4/coverage")}
    for d in sub.values():
        os.makedirs(d, exist_ok=True)
    r1 = results["rq1"]["result"]
    jrq1.create_detection_rate_graph(
        r1, os.path.join(sub["rq1"], "rq1_detection_rate.pdf"))
    r2 = results["rq2b"]["result"]
    jrq2.plot_corr_hist(r2.spearman,
                        os.path.join(sub["rq2"], "all_project_corr_hist.pdf"))
    jrq2.plot_session_boxplot(
        r2, os.path.join(sub["rq2"], "session_coverage_boxplot.pdf"), min_p)
    jrq2.plot_mean_median(
        r2, os.path.join(sub["rq2"], "average_median_lineplot.pdf"), min_p)
    jrq2.plot_distribution_trend(
        r2, os.path.join(sub["rq2"],
                         "session_coverage_distribution_trend.pdf"), min_p)
    for p, corr in enumerate(r2.spearman):
        if not np.isnan(corr) and abs(corr) > 0.5:
            jrq2.plot_project_trend(
                r2.matrix[p, r2.mask[p]],
                os.path.join(sub["rq2"], "projects",
                             f"{corr:.4f}_{ctx.projects[p]}.pdf"))
    r3 = results["rq3"]["result"]
    det, non = r3.det_diff_percent, r3.nondet_diff_percent
    if det.size and non.size:
        jrq3.create_comparison_plots(sub["rq3"], det, non)
        for name, vals in (("detected.pdf", det), ("non_detected.pdf", non)):
            jrq3.create_boxplot(os.path.join(sub["rq3"], name), vals)
    r4, prepost = results["rq4a"]["result"], results["rq4a"]["prepost"]
    max_valid = int(r4.iterations.max()) if r4.iterations.size else 0
    jrq4a.plot_g1_g2_trend(
        r4, max_valid, os.path.join(sub["rq4/bug"],
                                    "rq4_g1_g2_detection_trend.pdf"))
    jrq4a.plot_g4_trend(prepost, n_it, os.path.join(
        sub["rq4/bug"], "rq4_gc_detection_trend.pdf"))
    if prepost.kept_projects:
        jrq4a.plot_transition_venn(prepost, os.path.join(
            sub["rq4/bug"], "rq4_gc_bug_detection_venn.pdf"))
    r4b = results["rq4b"]
    groups = load_corpus_groups(cfg.corpus_csv, set(ctx.projects),
                                cfg.days_threshold)
    pidx = ctx.arrays.project_index()
    jrq4b.plot_coverage_deltas(r4b["deltas"], n_it, os.path.join(
        sub["rq4/coverage"], "coverage_delta_timeseries_linear.pdf"))
    jrq4b.plot_comparative_boxplot(
        r4b["result"], groups.indices("group1", pidx),
        groups.indices("group2", pidx), min_p,
        os.path.join(sub["rq4/coverage"], "g2_g1_boxplot_comparison.pdf"))


def test_the_port_writes_jax_s_figures(runs):
    want = _files(runs["jax"], ".pdf")
    assert set(GATED) <= want
    assert any(p.startswith(os.path.join("rq2", "projects")) for p in want)
    assert _files(runs["port"], ".pdf") == want
    # Where the statistics a figure draws agree exactly, the JAX run's
    # file is byte-equal too (RQ1's rates, the per-project trends).
    for rel in ["rq1/rq1_detection_rate.pdf"] + sorted(
            p for p in want if p.startswith(os.path.join("rq2", "projects"))):
        assert _bytes(os.path.join(runs["port"], rel)) == \
            _bytes(os.path.join(runs["jax"], rel)), rel


def test_every_pdf_equals_jax_writers_byte_for_byte(runs):
    want = _files(runs["port"], ".pdf")
    assert _files(runs["redraw"], ".pdf") == want
    for rel in sorted(want):
        assert _bytes(os.path.join(runs["port"], rel)) == \
            _bytes(os.path.join(runs["redraw"], rel)), rel


def test_manifests_list_the_figures_as_jax(runs):
    """Each figure that JAX's manifest lists is in the port's, and the
    port records no ``figures_skipped`` when it drew them."""
    for name, rel in MANIFESTS.items():
        with open(os.path.join(runs["jax"], rel)) as f:
            j = json.load(f)
        with open(os.path.join(runs["port"], rel)) as f:
            t = json.load(f)
        jpdf = sorted(os.path.basename(a) for a in j["artifacts"]
                      if a.endswith(".pdf"))
        tpdf = sorted(os.path.basename(a) for a in t["artifacts"]
                      if a.endswith(".pdf"))
        assert tpdf == jpdf, name
        assert "figures_skipped" not in t, name


def test_without_matplotlib_every_csv_still_equals_jax(runs):
    assert runs["hidden_rc"] == 0
    assert _files(runs["hidden"], ".pdf") == set()
    want = _files(runs["jax"], ".csv")
    assert want and _files(runs["hidden"], ".csv") == want
    for rel in sorted(want):
        assert _bytes(os.path.join(runs["hidden"], rel)) == \
            _bytes(os.path.join(runs["jax"], rel)), rel


def test_without_matplotlib_manifests_list_the_skipped_figures(runs):
    drawn = _files(runs["port"], ".pdf")
    listed = set()
    for name, rel in MANIFESTS.items():
        with open(os.path.join(runs["hidden"], rel)) as f:
            manifest = json.load(f)
        assert not any(a.endswith(".pdf") for a in manifest["artifacts"])
        sub = os.path.dirname(rel)
        skipped = manifest["figures_skipped"]
        assert skipped, name
        listed |= {os.path.join(sub, s) for s in skipped}
    # Every figure the drawing run wrote is listed as skipped.
    assert drawn <= listed


@pytest.mark.parametrize("with_venn", [False, True])
def test_venn_both_paths_equal_jax(tmp_path, monkeypatch, with_venn):
    """``plot_transition_venn`` with and without matplotlib_venn, byte for
    byte the JAX package's."""
    if with_venn:
        pytest.importorskip("matplotlib_venn")
    else:
        monkeypatch.setitem(sys.modules, "matplotlib_venn", None)
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")

    class _PrePost:
        kept_projects = ["a", "b", "c", "d", "e"]

        @staticmethod
        def transition_counts():
            return {"pre_only": 2, "post_only": 1, "pre_and_post": 1,
                    "no_detection": 1}

    jpath, tpath = tmp_path / "j.pdf", tmp_path / "t.pdf"
    jrq4a.plot_transition_venn(_PrePost(), str(jpath))
    trq4a.plot_transition_venn(_PrePost(), str(tpath))
    assert jpath.stat().st_size > 1024
    assert tpath.read_bytes() == jpath.read_bytes()
