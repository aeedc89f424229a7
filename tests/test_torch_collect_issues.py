"""The port's C7 issue scraping, C8 corpus archaeology, the normalization
adapters and the `collect` command, against the JAX package's; then the
round trip from the collectors' CSVs through ingest to RQ1 in both
packages, and the `collect` command leaving CUDA untouched."""

from __future__ import annotations

import json
import os
import sqlite3
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
import torch

import tse1m_tpu.collect.corpus as jcorp
import tse1m_tpu.collect.issues as jiss
import tse1m_tpu.collect.normalize as jnorm
import tse1m_tpu_torch.collect.corpus as tcorp
import tse1m_tpu_torch.collect.issues as tiss
import tse1m_tpu_torch.collect.normalize as tnorm
from tse1m_tpu_torch.collect import table
from tests.test_collect import COVERAGE_LOG, ERROR_LOG, FUZZ_LOG
from tests.test_collect_issues import (DESCRIPTION, SHA_A, SHA_B, FakeClient,
                                       FakeGitHub, _page, _revision_tables)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _tree(d) -> dict:
    out = {}
    for root, _, files in os.walk(d):
        for name in files:
            p = os.path.join(root, name)
            out[os.path.relpath(p, d)] = _bytes(p)
    return out


# -- C7 parsing ---------------------------------------------------------------

def test_issue_url_and_revision_ranges_as_jax():
    for n in (1, 9_999_999, 10_000_000, 42_000_000):
        assert tiss.issue_url(n) == jiss.issue_url(n)
    for text in (f"{SHA_A}:{SHA_B}", "v1.2:3", SHA_A, "a:b:c", ""):
        assert (tiss.split_revision_range(text)
                == jiss.split_revision_range(text))
    for url in ("https://x/revisions?range=1:2", "https://x/no-range"):
        assert (tiss.revision_buildtime_from_url(url)
                == jiss.revision_buildtime_from_url(url))


@pytest.mark.parametrize("text", [
    DESCRIPTION, DESCRIPTION.replace("zlib", "brotli"), "",
    "Project: a\nCrash State:\n  x\n  y\nSee more\n  z\n",
    "<b>Fixed:</b> https://x/revisions?range=1:2 tail\n",
    "**Crash Type**: UAF\nFuzzer (libFuzzer): f\n"])
def test_parse_description_as_jax(text):
    assert tiss.parse_description(text) == jiss.parse_description(text)


def test_extract_fixed_and_assemble_as_jax():
    events = [tiss.IssueEvent(text="filed", time_iso="2024-01-01T00:00:00Z"),
              tiss.IssueEvent(
                  text="Fixed: https://oss-fuzz.com/revisions?range=3:4\nx",
                  time_iso="2024-02-01T00:00:00Z"),
              tiss.IssueEvent(text="ClusterFuzz testcase 1 is verified as "
                                   "fixed in", time_iso="2024-04-01T00:00:00Z",
                              revision_links=["https://o/revisions?range=5"])]
    assert tiss.extract_fixed_from_events(events) == \
        jiss.extract_fixed_from_events(events)
    assert tiss.extract_fixed_from_events([]) == (None, None)
    client = FakeClient({42: _page(42)}, _revision_tables())
    for page in (_page(42), _page(43, "brotli"),
                 jiss.RawIssuePage(final_id="7", url="u", load_error=True)):
        assert (tiss.assemble_issue_record(page, client)
                == jiss.assemble_issue_record(page, client))


def test_window_checkpoints_and_recovers_bytes_equal_jax(tmp_path):
    ids = [101, 102, 103, 104, 105]
    pages = {i: _page(i) for i in ids}
    made = {"jax": [], "torch": []}
    for pkg, mod in (("jax", jiss), ("torch", tiss)):
        def factory(pkg=pkg):
            c = FakeClient(pages, _revision_tables(), fail_ids={102})
            made[pkg].append(c)
            return c

        assert mod.run_scraper_window(factory, ids, 0, str(tmp_path / pkg),
                                      save_interval=2) == 4
    assert len(made["torch"]) == 2 and made["torch"][0].closed == 1
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    assert sorted(_tree(tmp_path / "torch")) == [
        os.path.join("window_0", f) for f in ("001.csv", "002.csv",
                                              "003.csv")]


def _varied_records():
    """Records whose merged CSV exercises pandas' forms: bools, missing
    columns across windows, JSON null, lists, ids that look numeric."""
    client = FakeClient({}, _revision_tables())
    recs = [tiss.assemble_issue_record(_page(300 + i, ("zlib", "brotli")[
        i % 2]), client) for i in range(5)]
    recs.append({"id": "399", "url": "u", "error": True,
                 "title": "Failed to load page"})
    recs[1]["Assignee"] = None
    recs[2]["hotlists"] = ["OSS-Fuzz", "Security"]
    recs[3].pop("Status")
    recs[4]["count"] = 5
    return recs


def test_merge_window_csvs_bytes_equal_jax(tmp_path):
    recs = _varied_records()
    for pkg, mod in (("jax", jiss), ("torch", tiss)):
        res = tmp_path / pkg / "res"
        mod.save_issue_batch(recs[:3], str(res / "window_0"), 1)
        mod.save_issue_batch(recs[3:], str(res / "window_1"), 1)
        assert mod.merge_window_csvs(str(res), str(tmp_path / pkg /
                                                   "merged.csv")) == 6
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")
    assert tiss.merge_window_csvs(str(tmp_path / "none"),
                                  str(tmp_path / "m.csv")) == 0


def test_scrape_issues_forked_windows_as_jax(tmp_path):
    ids = list(range(200, 211))
    pages = {i: _page(i) for i in ids}
    for pkg, mod in (("jax", jiss), ("torch", tiss)):
        mod.scrape_issues(lambda: FakeClient(pages), ids,
                          str(tmp_path / pkg), num_workers=3, save_interval=2)
    got = _tree(tmp_path / "torch")
    assert got == _tree(tmp_path / "jax")
    assert {k.split(os.sep)[0] for k in got} == {"window_0", "window_1",
                                                 "window_2"}
    tiss.scrape_issues(lambda: FakeClient(pages), ids[:4],
                       str(tmp_path / "inline"), num_workers=2,
                       parallel=False)
    assert tiss.merge_window_csvs(str(tmp_path / "inline"),
                                  str(tmp_path / "inline.csv")) == 4


@pytest.mark.parametrize("conditions", [
    {"Status": True}, {"Status": False}, {"Status": "fixed"},
    {"Assignee": True}, {"hotlists": "secur"}, {"error": "true"},
    {"missing_col": True}, {"Status": 5}, {"count": False},
    {"Status": False, "Type": "vuln"}])
def test_plan_run_and_rescrape_dsl_as_jax(tmp_path, conditions):
    recs = _varied_records()
    results = tmp_path / "results"
    tiss.save_issue_batch(recs, str(results / "w0"), 1)
    merged = tmp_path / "merged.csv"
    tiss.merge_window_csvs(str(results), str(merged))
    targets = {300, 301, 302, 303, 304, 399, 500, 501}
    assert (tiss.plan_run(targets, str(results))
            == jiss.plan_run(targets, str(results)) == [501, 500])
    assert (tiss.plan_run(targets, str(results), str(merged), conditions)
            == jiss.plan_run(targets, str(results), str(merged),
                             conditions))
    assert (tiss.select_rescrape_ids(table.read_csv(str(merged),
                                                    json_cells=True),
                                     conditions)
            == jiss.select_rescrape_ids(pd.read_csv(merged), conditions))


# -- C8: corpus ---------------------------------------------------------------

def test_corpus_analysis_bytes_equal_jax(oss_fuzz_repo, tmp_path):
    for pkg, mod in (("jax", jcorp), ("torch", tcorp)):
        resolver = mod.GitHubMergeTimeResolver(
            fetcher=FakeGitHub("2021-04-16T12:00:00Z"), token="t")
        out = mod.analyze_repository(oss_fuzz_repo,
                                     ["brotli", "zlib", "ghost"], resolver)
        path = tmp_path / f"{pkg}.csv"
        if pkg == "jax":
            out.to_csv(path, index=False, encoding="utf-8")
        else:
            table.write_csv(out, str(path))
            assert out.col("project_name") == ["brotli", "zlib"]
            z = out.rows()[1]
            assert z["is_Corpus"] is True
            assert z["time_elapsed_seconds"] == 45 * 86400
            assert z["merged_time_elapsed_seconds"] == 46 * 86400 + 7200
    assert _bytes(tmp_path / "torch.csv") == _bytes(tmp_path / "jax.csv")
    # No token: merge times never resolve, in both.
    for mod in (jcorp, tcorp):
        r = mod.GitHubMergeTimeResolver(fetcher=FakeGitHub("x"))
        assert r.merge_time(SHA_A) is None


def test_corpus_collector_skips_existing_and_feeds_rq4(oss_fuzz_repo,
                                                       tmp_path):
    from tse1m_tpu.analysis.corpus import load_corpus_groups as jgroups
    from tse1m_tpu_torch.analysis.corpus import load_corpus_groups

    for pkg, mod in (("jax", jcorp), ("torch", tcorp)):
        out = tmp_path / f"{pkg}.csv"
        assert len(mod.run_corpus_collector(oss_fuzz_repo, str(out))) == 2
        assert len(mod.run_corpus_collector(oss_fuzz_repo, str(out))) == 2
    assert _bytes(tmp_path / "torch.csv") == _bytes(tmp_path / "jax.csv")
    eligible = {"brotli", "zlib", "other"}
    got = load_corpus_groups(str(tmp_path / "torch.csv"), eligible)
    want = jgroups(str(tmp_path / "jax.csv"), eligible)
    assert got.groups == want.groups
    assert "brotli" in got.groups["group2"] and "zlib" in \
        got.groups["group4"] and "other" in got.groups["group1"]


# -- normalization ------------------------------------------------------------

def _json_records(recs):
    return [{k: json.dumps(v, ensure_ascii=False) for k, v in r.items()}
            for r in recs]


def test_issue_table_rows_bytes_equal_jax(tmp_path):
    recs = _varied_records()
    jnorm.issue_table_rows(pd.DataFrame(_json_records(recs))).to_csv(
        tmp_path / "j1.csv", index=False)
    table.write_csv(tnorm.issue_table_rows(table.from_records(
        _json_records(recs))), str(tmp_path / "t1.csv"))
    assert _bytes(tmp_path / "t1.csv") == _bytes(tmp_path / "j1.csv")
    t = table.read_csv(str(tmp_path / "t1.csv"))
    assert len(t) == 5 and t.col("regressed_build")[0] == \
        "{" + SHA_A + "," + SHA_B + "}"
    # And through a merged CSV, as the collect command reads it.
    tiss.save_issue_batch(recs, str(tmp_path / "res" / "w"), 1)
    tiss.merge_window_csvs(str(tmp_path / "res"), str(tmp_path / "m.csv"))
    jnorm.issue_table_rows(pd.read_csv(tmp_path / "m.csv")).to_csv(
        tmp_path / "j2.csv", index=False)
    table.write_csv(tnorm.issue_table_rows(table.read_csv(
        str(tmp_path / "m.csv"), json_cells=True)), str(tmp_path / "t2.csv"))
    assert _bytes(tmp_path / "t2.csv") == _bytes(tmp_path / "j2.csv")


def _analyzed_records(n=30):
    from tse1m_tpu_torch.collect.buildlogs import parse_build_log

    base = pd.Timestamp("2024-05-01 10:00:00")
    out = []
    for i in range(n):
        rec = parse_build_log(f"b{i}", (FUZZ_LOG, COVERAGE_LOG,
                                        ERROR_LOG, "")[i % 4 if i % 7 else 3])
        out.append({"id": rec.build_id, "project": rec.project,
                    "build_type": rec.build_type, "result": rec.result,
                    "timecreated": str(base + pd.Timedelta(hours=i)),
                    "modules": json.dumps(rec.modules),
                    "revisions": json.dumps(rec.revisions)})
    return out


def test_buildlog_and_coverage_rows_bytes_equal_jax(tmp_path):
    recs = _analyzed_records()
    jnorm.buildlog_table_rows(pd.DataFrame(recs)).to_csv(
        tmp_path / "jb.csv", index=False)
    table.write_csv(tnorm.buildlog_table_rows(table.from_records(recs)),
                    str(tmp_path / "tb.csv"))
    assert _bytes(tmp_path / "tb.csv") == _bytes(tmp_path / "jb.csv")
    # Through the batch CSVs, as the collect command reads them.
    pd.DataFrame(recs).to_csv(tmp_path / "batch.csv", index=False)
    jnorm.buildlog_table_rows(pd.read_csv(tmp_path / "batch.csv")).to_csv(
        tmp_path / "jb2.csv", index=False)
    table.write_csv(tnorm.buildlog_table_rows(table.read_csv(
        str(tmp_path / "batch.csv"))), str(tmp_path / "tb2.csv"))
    assert _bytes(tmp_path / "tb2.csv") == _bytes(tmp_path / "jb2.csv")
    cov = {"date": [f"202405{d:02d}" for d in range(1, 11)] + ["2024xx01"],
           "project": ["zlib"] * 11,
           "coverage": list(np.linspace(50, 60, 11)),
           "covered_line": list(np.linspace(500, 600, 11)),
           "total_line": [1000.0] * 11, "exist": [True] * 11}
    pd.DataFrame(cov).to_csv(tmp_path / "cov.csv", index=False)
    jnorm.coverage_table_rows(pd.read_csv(tmp_path / "cov.csv")).to_csv(
        tmp_path / "jc.csv", index=False)
    table.write_csv(tnorm.coverage_table_rows(table.read_csv(
        str(tmp_path / "cov.csv"))), str(tmp_path / "tc.csv"))
    assert _bytes(tmp_path / "tc.csv") == _bytes(tmp_path / "jc.csv")


# -- the round trip: collectors -> ingest -> RQ1 ------------------------------

def _collector_csvs(d, pkg, repo):
    """The four table CSVs written by one package's collectors."""
    os.makedirs(d, exist_ok=True)
    recs = _analyzed_records()
    cov = [{"date": f"202405{k:02d}", "project": "zlib",
            "coverage": 50 + k / 3, "covered_line": 500.0 + k,
            "total_line": 1000.0, "exist": True} for k in range(1, 11)]
    client = FakeClient({}, _revision_tables())
    issue_recs = _json_records([tiss.assemble_issue_record(_page(500 + i),
                                                           client)
                                for i in range(3)])
    if pkg == "jax":
        from tse1m_tpu.collect.projects import collect_project_info

        collect_project_info(repo).to_csv(os.path.join(
            d, "project_info.csv"), index=False)
        jnorm.buildlog_table_rows(pd.DataFrame(recs)).to_csv(
            os.path.join(d, "buildlog_data.csv"), index=False)
        jnorm.coverage_table_rows(pd.DataFrame(cov)).to_csv(
            os.path.join(d, "total_coverage.csv"), index=False)
        jnorm.issue_table_rows(pd.DataFrame(issue_recs)).to_csv(
            os.path.join(d, "issues.csv"), index=False)
    else:
        from tse1m_tpu_torch.collect.projects import collect_project_info

        table.write_csv(collect_project_info(repo),
                        os.path.join(d, "project_info.csv"))
        table.write_csv(tnorm.buildlog_table_rows(table.from_records(recs)),
                        os.path.join(d, "buildlog_data.csv"))
        table.write_csv(tnorm.coverage_table_rows(table.from_records(cov)),
                        os.path.join(d, "total_coverage.csv"))
        table.write_csv(tnorm.issue_table_rows(table.from_records(
            issue_recs)), os.path.join(d, "issues.csv"))


def _dump(path) -> dict:
    out = {}
    with sqlite3.connect(path) as conn:
        for t in ("projects", "project_info", "buildlog_data",
                  "total_coverage", "issues"):
            out[t] = sorted(conn.execute(f"SELECT * FROM {t}").fetchall(),
                            key=repr)
    return out


def test_round_trip_collectors_to_rq1_as_jax(tmp_path, oss_fuzz_repo):
    """Collector CSVs -> ingest -> StudyArrays -> RQ1 in both packages:
    the CSVs byte-equal, the studies equal (and JAX's ingest of the
    port's CSVs gives JAX's study), RQ1 equal."""
    from tse1m_tpu.backend.pandas_backend import PandasBackend
    from tse1m_tpu.config import Config as JConfig
    from tse1m_tpu.data.columnar import StudyArrays as JArrays
    from tse1m_tpu.db.connection import DB as JDB
    from tse1m_tpu.db.ingest import ingest_csv_dir as j_ingest
    from tse1m_tpu_torch.backend.torch_backend import TorchBackend
    from tse1m_tpu_torch.config import Config
    from tse1m_tpu_torch.data.columnar import StudyArrays
    from tse1m_tpu_torch.db.connection import DB
    from tse1m_tpu_torch.db.ingest import ingest_csv_dir as t_ingest

    for pkg in ("jax", "torch"):
        _collector_csvs(str(tmp_path / pkg), pkg, oss_fuzz_repo)
    assert _tree(tmp_path / "torch") == _tree(tmp_path / "jax")

    limit = "2026-01-01"
    jcfg = JConfig(engine="sqlite", sqlite_path=str(tmp_path / "j.sqlite"),
                   limit_date=limit)
    jdb = JDB(config=jcfg).connect()
    counts = j_ingest(jdb, str(tmp_path / "jax"))
    assert counts["buildlog_data"] > 10 and counts["issues"] == 3
    jarr = JArrays.from_db(jdb, jcfg, projects=["zlib"])
    limit_ns = int(np.datetime64(limit, "ns").astype(np.int64))
    want = PandasBackend().rq1_detection(jarr, limit_ns, min_projects=1)
    jdb.closeConnection()
    # JAX's ingest of the port's CSVs gives JAX's study.
    jdb2 = JDB(config=JConfig(engine="sqlite", sqlite_path=str(
        tmp_path / "j2.sqlite"))).connect()
    j_ingest(jdb2, str(tmp_path / "torch"))
    jdb2.closeConnection()

    cfg = Config(engine="sqlite", sqlite_path=str(tmp_path / "t.sqlite"),
                 limit_date=limit)
    with DB(config=cfg).connect() as db:
        assert t_ingest(db, str(tmp_path / "torch")) == counts
        arrays = StudyArrays.from_db(db, cfg, projects=["zlib"])
        got = TorchBackend("cpu").rq1_detection(arrays, limit_ns,
                                                min_projects=1)
    assert _dump(tmp_path / "t.sqlite") == _dump(tmp_path / "j.sqlite") \
        == _dump(tmp_path / "j2.sqlite")
    assert got.total_projects.size > 0
    for field in ("iterations", "total_projects", "detected_counts",
                  "iteration_of_issue", "link_idx"):
        np.testing.assert_array_equal(np.asarray(getattr(got, field)),
                                      np.asarray(getattr(want, field)))


# -- the collect command ------------------------------------------------------

def _run(pkg, args, cwd, env=None):
    mod = "tse1m_tpu.cli" if pkg == "jax" else "tse1m_tpu_torch"
    e = dict(os.environ, JAX_PLATFORMS="cpu", **(env or {}))
    e["PYTHONPATH"] = REPO + os.pathsep + e.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", mod, *args], cwd=cwd,
                          env=e, capture_output=True, text=True, timeout=300)


def test_collect_command_projects_corpus_issues_as_jax(oss_fuzz_repo,
                                                       tmp_path):
    """The six-step command, letter for letter: projects, corpus and the
    issues merge (an empty plan) as children of both packages."""
    recs = _varied_records()
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg
        tiss.save_issue_batch(recs[:3], str(d / "issue_scraping_results" /
                                            "window_0"), 1)
        tiss.save_issue_batch(recs[3:], str(d / "issue_scraping_results" /
                                            "window_1"), 1)
        for step in ("projects", "corpus", "issues"):
            proc = _run(pkg, ["collect", step, "--no-clone", "--repo",
                              oss_fuzz_repo, "--data-dir", str(d)],
                        str(tmp_path), env={"GITHUB_TOKEN": ""})
            assert proc.returncode == 0, proc.stderr[-2000:]
    got = _tree(tmp_path / "torch")
    assert got == _tree(tmp_path / "jax")
    assert {"project_info.csv", "project_corpus_analysis.csv",
            "issues_merged.csv", "issues.csv"} <= set(got)
    bad = _run("torch", ["collect", "nope"], str(tmp_path))
    assert bad.returncode == _run("jax", ["collect", "nope"],
                                  str(tmp_path)).returncode == 2


def test_collect_leaves_cuda_uninitialised(oss_fuzz_repo, tmp_path,
                                           monkeypatch):
    """The command computes nothing on a device: no step, not even the
    issue scraper that forks its windows, initialises CUDA."""
    from tse1m_tpu_torch.__main__ import main

    calls = []
    monkeypatch.setattr(torch.cuda, "_lazy_init",
                        lambda: calls.append("init"))
    monkeypatch.setattr(torch.cuda, "init", lambda: calls.append("init"))
    recs = _varied_records()
    tiss.save_issue_batch(recs, str(tmp_path / "d" / "issue_scraping_results"
                                    / "window_0"), 1)
    for step in ("projects", "corpus", "issues"):
        assert main(["collect", step, "--no-clone", "--repo", oss_fuzz_repo,
                     "--data-dir", str(tmp_path / "d")]) == 0
    assert calls == [] and not torch.cuda.is_initialized()
    # The fork-based scraper under the same guard.
    pages = {i: _page(i) for i in range(10)}
    tiss.scrape_issues(lambda: FakeClient(pages), list(range(10)),
                       str(tmp_path / "fork"), num_workers=3)
    assert calls == [] and len(os.listdir(tmp_path / "fork")) == 3
