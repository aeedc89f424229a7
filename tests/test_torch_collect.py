"""The port's collection layer (tse1m_tpu_torch/collect/) against the JAX
package's: the transport, the checkpoints, the C3-C6 collectors, the
pandas-free CSV table and the PyYAML-free project.yaml reader.  Each
collector runs in both packages on the same fixtures and its CSVs must be
byte-equal; where pandas' reading would change what a value means the
port keeps the text, and each such case is pinned with the JAX value
beside it."""

from __future__ import annotations

import csv
import datetime
import json
import math
import os
import random
import subprocess
import warnings
from datetime import date

import pandas as pd
import pytest
import yaml

import tse1m_tpu.collect.buildlogs as jbl
import tse1m_tpu.collect.checkpoint as jck
import tse1m_tpu.collect.coverage as jcov
import tse1m_tpu.collect.gcs_metadata as jgcs
import tse1m_tpu.collect.projects as jproj
import tse1m_tpu.collect.transport as jtr
import tse1m_tpu_torch.collect.buildlogs as tbl
import tse1m_tpu_torch.collect.checkpoint as tck
import tse1m_tpu_torch.collect.coverage as tcov
import tse1m_tpu_torch.collect.gcs_metadata as tgcs
import tse1m_tpu_torch.collect.projects as tproj
import tse1m_tpu_torch.collect.transport as ttr
from tse1m_tpu_torch.collect import table
from tse1m_tpu_torch.collect import yaml_subset as Y
from tests.test_collect import (C_FAMILY_HTML, COVERAGE_LOG, ERROR_LOG,
                                FUZZ_LOG, JVM_HTML, PYTHON_HTML, UUID_NAME,
                                _coverage_fixture, _PagedFetcher,
                                _ScriptedSession)

PKGS = {"jax": (jtr, jck, jgcs, jcov, jbl, jproj),
        "torch": (ttr, tck, tgcs, tcov, tbl, tproj)}


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


# -- transport ----------------------------------------------------------------

def _policy(tr, **kw):
    kw.setdefault("backoff_factor", 0.0)
    return tr.FetchPolicy(**kw)


@pytest.mark.parametrize("pkg", list(PKGS))
def test_http_fetcher_retries_then_succeeds(pkg):
    tr = PKGS[pkg][0]
    session = _ScriptedSession([(503, b""), (503, b""), (200, b"ok")])
    resp = tr.HttpFetcher(_policy(tr, retries=3), session=session).get(
        "https://x/y")
    assert resp.text == "ok" and session.calls == 3


@pytest.mark.parametrize("pkg", list(PKGS))
def test_http_fetcher_404_budget_and_connection_errors(pkg):
    tr = PKGS[pkg][0]
    assert tr.HttpFetcher(_policy(tr), session=_ScriptedSession(
        [(404, b"")])).get("https://x/missing") is None
    session = _ScriptedSession([(503, b"")] * 3)
    with pytest.raises(tr.FetchError):
        tr.HttpFetcher(_policy(tr, retries=2), session=session).get(
            "https://x/y")
    assert session.calls == 3
    session = _ScriptedSession([OSError("reset"), (200, b"fine")])
    assert tr.HttpFetcher(_policy(tr, retries=1), session=session).get(
        "https://x/y").text == "fine"


def test_dir_fetcher_maps_urls_and_params_as_jax(tmp_path):
    base = tmp_path / "host" / "a"
    base.mkdir(parents=True)
    (base / "b.html").write_text("payload")
    (tmp_path / "host" / "api#c=1&d=2").write_text("{}")
    for tr in (jtr, ttr):
        f = tr.DirFetcher(str(tmp_path))
        assert f.get("https://host/a/b.html").text == "payload"
        assert f.get("https://host/api", params={"d": 2, "c": 1}).text == "{}"
        assert f.get("https://host/nope") is None
    assert (jtr.DirFetcher(str(tmp_path)).path_for("https://h/p?q=1 2")
            == ttr.DirFetcher(str(tmp_path)).path_for("https://h/p?q=1 2"))


# -- checkpoints --------------------------------------------------------------

def test_batch_checkpointer_merge_bytes_equal_jax(tmp_path):
    rows = [{"id": i, "v": i * 10, "w": None if i % 2 else 1.5,
             "flag": True if i % 3 else None, "s": f"x,{i}"}
            for i in range(7)]
    out = {}
    for pkg, mods in PKGS.items():
        ckpt = mods[1].CsvBatchCheckpointer(str(tmp_path / pkg), "meta",
                                            batch_size=3)
        for r in rows:
            ckpt.add(r)
        final = tmp_path / f"{pkg}.csv"
        assert ckpt.merge(str(final)) == 7
        assert not list((tmp_path / pkg).glob("meta_batch_*.csv"))
        out[pkg] = _bytes(final)
    assert out["torch"] == out["jax"]
    # An int column with a blank in one batch is written 4.0 everywhere.
    assert b"1.5" in out["torch"] and b"True," in out["torch"]


def test_batch_checkpointer_resumes_numbering(tmp_path):
    for pkg, mods in PKGS.items():
        d = str(tmp_path / pkg)
        mods[1].CsvBatchCheckpointer(d, "meta", batch_size=1).add({"id": 1})
        mods[1].CsvBatchCheckpointer(d, "meta", batch_size=1).add({"id": 2})
        assert sorted(os.listdir(d)) == ["meta_batch_1.csv",
                                         "meta_batch_2.csv"]


def test_processed_ids_plain_and_json_as_jax(tmp_path):
    (tmp_path / "w").mkdir()
    pd.DataFrame({"id": [3, 4]}).to_csv(tmp_path / "w" / "a.csv", index=False)
    pd.DataFrame({"id": ['"7"', "null"]}).to_csv(tmp_path / "w" / "b.csv",
                                                 index=False)
    for enc in (False, True):
        assert (tck.processed_ids_from_csvs(str(tmp_path), json_encoded=enc)
                == jck.processed_ids_from_csvs(str(tmp_path),
                                               json_encoded=enc))
    assert tck.processed_ids_from_csvs(str(tmp_path), json_encoded=True) \
        == {3, 4, 7}


@pytest.mark.parametrize("dates", [
    ["20250103", "20250105"], ["2025-01-03", "20250105"], ["20250105.0"],
    ["", "20250101"], ["x"], ["2025-1-5"], ["2025/01/05"], ["20251301"],
    ["2025-01-05T10:00:00+00:00", "2025-01-06T00:00:00+00:00"],
    ["2025-01-05 23:30:00-05:00"], ["NA", "20250102"]])
def test_last_date_and_resume_as_jax(tmp_path, dates):
    path = tmp_path / "proj.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(["date", "v"])
        w.writerows([d, i] for i, d in enumerate(dates))
    assert tck.last_date_in_csv(str(path)) == jck.last_date_in_csv(str(path))
    for start in (date(2025, 1, 1), date(2025, 2, 1)):
        assert (tck.resume_start_date(str(path), start)
                == jck.resume_start_date(str(path), start))
    missing = str(tmp_path / "none.csv")
    assert tck.resume_start_date(missing, date(2025, 1, 1)) == \
        date(2025, 1, 1)


def test_mixed_time_zones_raise_as_jax(tmp_path):
    path = tmp_path / "p.csv"
    path.write_text("date\n2025-01-05T10:00:00+00:00\n2025-01-06\n")
    with pytest.raises(ValueError):
        jck.last_date_in_csv(str(path))
    with pytest.raises(ValueError, match="Mixed timezones"):
        tck.last_date_in_csv(str(path))


# -- the CSV table against pandas ---------------------------------------------

_TOKENS = {
    "int": ["0", "5", "-3", "123456", "42"],
    "float": ["2.5", "1e5", "-0.25", "3.0", ".5", "1E-3", "inf", "100",
              "0.1", "33.333333333333336", "1e+16"],
    "bool": ["True", "false", "TRUE", "False"],
    "str": ["x", "hello world", "a,b", 'q"r', "line\nbreak", "5x", " pad",
            "ünï"],
    "na": [""],
    "big": ["18446744073709551615", "123456789012345678901234"],
}


def _random_csvs(rng, d, k):
    paths = []
    for t in range(rng.randint(1, 3)):
        cols = rng.sample(["a", "b", "c", "d"], rng.randint(1, 4))
        fam = {c: rng.choice(list(_TOKENS)) for c in cols}
        rows = [[rng.choice(_TOKENS[fam[c]] + (
            [""] if rng.random() < 0.2 else [])) for c in cols]
            for _ in range(rng.randint(1, 4))]
        p = os.path.join(d, f"{k}_{t}.csv")
        with open(p, "w", newline="") as f:
            w = csv.writer(f, lineterminator="\n")
            w.writerow(cols)
            w.writerows(rows)
        paths.append(p)
    return paths


@pytest.mark.parametrize("seed", range(4))
def test_read_concat_write_equals_pandas(tmp_path, seed):
    """``read_csv -> concat -> to_csv`` over seeded random tables: every
    mix of ints, floats, bools, text, blanks and 64-bit overflows, columns
    missing from some tables, in every order."""
    rng = random.Random(seed)
    warnings.simplefilter("ignore")
    for k in range(250):
        paths = _random_csvs(rng, str(tmp_path), k)
        want = pd.concat([pd.read_csv(p) for p in paths],
                         ignore_index=True).to_csv(index=False)
        out = tmp_path / f"{k}.out.csv"
        table.write_csv(table.concat([table.read_csv(p) for p in paths]),
                        str(out))
        assert out.read_text() == want, [open(p).read() for p in paths]


_VALUES = [1, -7, 2 ** 63, 0, 2.5, 1e16, 0.1, float("nan"), None, True,
           False, "x", "a,b", "", [1, 2], {"k": 1},
           date(2020, 1, 2), datetime.datetime(2020, 1, 2, 3, 4, 5),
           datetime.datetime(2020, 1, 2),
           datetime.datetime(2021, 3, 1, 10, tzinfo=datetime.timezone.utc)]


@pytest.mark.parametrize("seed", range(3))
def test_from_records_write_equals_pandas(tmp_path, seed):
    """``DataFrame(records).to_csv``: column order by first appearance,
    each column's dtype from its values (ints with a blank as floats,
    bools with a blank as objects, naive datetimes at midnight as
    dates)."""
    rng = random.Random(seed)
    families = [[v] for v in _VALUES] + [
        [1, None], [1, 2.5], [True, None], ["x", None], [1, "x"],
        [datetime.datetime(2020, 1, 2), None],
        [datetime.datetime(2020, 1, 2), datetime.datetime(2020, 1, 3, 4)]]
    for k in range(200):
        cols = rng.sample("abcde", rng.randint(1, 5))
        fam = {c: rng.choice(families) for c in cols}
        recs = []
        for _ in range(rng.randint(1, 4)):
            recs.append({c: rng.choice(fam[c]) for c in cols
                         if rng.random() < 0.9})
        if not any(recs):
            continue
        want = pd.DataFrame(recs).to_csv(index=False)
        out = tmp_path / f"{k}.csv"
        table.write_csv(table.from_records(recs), str(out))
        assert out.read_text() == want, recs


@pytest.mark.parametrize("text,jax_cell,port_cell", [
    ("NA", "", "NA"), ("null", "", "null"), ("nan", "", "nan"),
    ("N/A", "", "N/A"), ("None", "", "None"), ("NULL", "", "NULL"),
    ("007", "7", "007"), ("+5", "5", "+5"), ("-0", "0", "-0")])
def test_meaning_changing_cells_are_kept(tmp_path, text, jax_cell,
                                         port_cell):
    """Kept by design (ROADMAP Queue 3): pandas reads these as NaN or as
    another int; the port keeps the text, and writes the rest of the
    column as pandas does."""
    src = tmp_path / "in.csv"
    src.write_text(f"id,v\n{text},1\n12,2\n")
    want = pd.read_csv(src).to_csv(index=False)
    out = tmp_path / "out.csv"
    table.write_csv(table.read_csv(str(src)), str(out))
    got = out.read_text()
    assert want.splitlines()[1].split(",")[0] == jax_cell
    assert got.splitlines()[1].split(",")[0] == port_cell
    # The other cells of the column are pandas' (12 or 12.0 alike).
    assert got.splitlines()[2] == want.splitlines()[2]
    assert got.splitlines()[0] == want.splitlines()[0]


def test_json_cells_read_null_as_missing(tmp_path):
    src = tmp_path / "in.csv"
    src.write_text('a,b\nnull,"""x"""\ntrue,null\n')
    t = table.read_csv(str(src), json_cells=True)
    assert t.col("a") == [None, True] and t.kind("a") == "object"
    assert t.col("b") == ['"x"', None]
    out = tmp_path / "out.csv"
    table.write_csv(t, str(out))
    assert out.read_text() == pd.read_csv(src).to_csv(index=False)


# -- C4: GCS metadata pager ---------------------------------------------------

def test_gcs_name_filter_as_jax():
    items = [{"name": UUID_NAME, "size": "10", "timeCreated": "2024-01-01",
              "mediaLink": "m", "selfLink": "s", "extra": "dropped"},
             {"name": "junk.txt"}, {"name": "x" * len(UUID_NAME)}]
    assert tgcs.extract_log_records(items) == jgcs.extract_log_records(items)
    for name in (UUID_NAME, "log-not-a-uuid.txt", None, ""):
        assert (tgcs.is_build_log_name(name)
                == jgcs.is_build_log_name(name))


def test_gcs_collector_bytes_equal_jax(tmp_path):
    def page(i, next_token=None):
        items = [{"name": f"log-{i:08d}-370a-40e2-916b-8f4aaf10569{j}.txt",
                  "selfLink": f"s{i}", "mediaLink": f"m{i}" if j else None,
                  "size": str(i * 10 + j),
                  "timeCreated": "2024-01-01T00:00:00Z"} for j in range(3)]
        items.append({"name": "other/object.json", "size": "1"})
        d = {"items": items}
        if next_token:
            d["nextPageToken"] = next_token
        return d

    pages = {"": page(0, "t1"), "t1": page(1, "t2"), "t2": page(2, "t3"),
             "t3": page(3)}
    out = {}
    for pkg, mods in PKGS.items():
        coll = mods[2].GcsMetadataCollector(
            _PagedFetcher(pages), str(tmp_path / pkg / "batches"),
            pages_per_batch=2)
        final = tmp_path / pkg / "buildlog_metadata.csv"
        assert coll.collect(str(final)) == 12 and coll.pages_fetched == 4
        assert not list((tmp_path / pkg / "batches").glob("*.csv"))
        out[pkg] = _bytes(final)
    assert out["torch"] == out["jax"]


# -- C5: coverage -------------------------------------------------------------

@pytest.mark.parametrize("html", [C_FAMILY_HTML, PYTHON_HTML, JVM_HTML,
                                  "<html><p>no table</p></html>"])
def test_coverage_parsers_as_jax(html):
    assert tcov.extract_tables(html) == jcov.extract_tables(html)
    for name in ("parse_c_family_report", "parse_python_report",
                 "parse_jvm_report"):
        a, b = getattr(tcov, name)(html), getattr(jcov, name)(html)
        assert (None if a is None else vars(a)) == \
            (None if b is None else vars(b))


def test_coverage_collector_walks_resumes_and_merges_as_jax(tmp_path):
    fx = tmp_path / "fx"
    _coverage_fixture(fx, "zlib", "20250101", C_FAMILY_HTML)
    _coverage_fixture(fx, "zlib", "20250103", C_FAMILY_HTML)
    _coverage_fixture(fx, "pyproj", "20250102", PYTHON_HTML,
                      page="index.html")
    out = {}
    for pkg, mods in PKGS.items():
        f = mods[0].DirFetcher(str(fx))
        pp = str(tmp_path / pkg / "pp")
        coll = mods[3].CoverageCollector(f, pp, finish_date=date(2025, 1, 3))
        assert coll.collect_project("zlib", "c", date(2025, 1, 1)) == 2
        assert mods[3].fetch_day_coverage(f, "zlib", "c", "20250102") is None
        out[pkg] = [_bytes(os.path.join(pp, "zlib.csv"))]
        _coverage_fixture(fx, "zlib", "20250104", JVM_HTML)
        coll2 = mods[3].CoverageCollector(f, pp, finish_date=date(2025, 1, 4))
        f.requests.clear()
        assert coll2.collect_project("zlib", "c", date(2025, 1, 1)) == 0
        assert f.requests == [mods[3].REPORT_URL_TEMPLATE.format(
            project="zlib", day="20250104") + "file_view_index.html"]
        assert coll2.collect_project("pyproj", "python",
                                     date(2025, 1, 1)) == 1
        merged = tmp_path / pkg / "total.csv"
        assert coll2.merge(str(merged)) == 3
        out[pkg] += [_bytes(os.path.join(pp, "zlib.csv")), _bytes(merged)]
        os.remove(fx / "storage.googleapis.com" / "oss-fuzz-coverage" /
                  "zlib" / "reports" / "20250104" / "linux" /
                  "file_view_index.html")
    assert out["torch"] == out["jax"]


def test_coverage_collect_all_from_project_info_csv(tmp_path):
    fx = tmp_path / "fx"
    _coverage_fixture(fx, "pyproj", "20250101", PYTHON_HTML,
                      page="index.html")
    _coverage_fixture(fx, "cproj", "20250101", C_FAMILY_HTML)
    _coverage_fixture(fx, "cproj", "20250102", C_FAMILY_HTML)
    info = tmp_path / "project_info.csv"
    pd.DataFrame({
        "project": ["pyproj", "goproj", "cproj", "late", "nodate"],
        "first_commit_datetime": ["2025-01-01 00:00:00+00:00",
                                  "2025-01-01 00:00:00+00:00",
                                  # 01:00+02:00 is the last UTC day
                                  "2025-01-02 01:00:00+02:00",
                                  "2026-01-01 00:00:00+00:00", None],
        "language": ["python", "go", "c", "c", "c"],
    }).to_csv(info, index=False)
    out = {}
    for pkg, mods in PKGS.items():
        reader = pd.read_csv if pkg == "jax" else table.read_csv
        coll = mods[3].CoverageCollector(mods[0].DirFetcher(str(fx)),
                                         str(tmp_path / pkg / "pp"),
                                         finish_date=date(2025, 1, 2))
        total = coll.collect_all(reader(str(info)),
                                 str(tmp_path / pkg / "total.csv"))
        out[pkg] = (total, _bytes(tmp_path / pkg / "total.csv"))
    assert out["torch"] == out["jax"] and out["jax"][0] == 3


# -- C6: build logs -----------------------------------------------------------

@pytest.mark.parametrize("text", [FUZZ_LOG, COVERAGE_LOG, ERROR_LOG, "",
                                  "Step #1: {\nStep #1: }\nERROR\n"])
def test_parse_build_log_as_jax(text):
    assert vars(tbl.parse_build_log("b", text)) == \
        vars(jbl.parse_build_log("b", text))


def _log_fixture(tmp_path, n):
    logs = tmp_path / "oss-fuzz-build-logs.storage.googleapis.com"
    logs.mkdir(parents=True, exist_ok=True)
    names = [f"b{i}" for i in range(n)]
    for i, name in enumerate(names):
        if i % 5 != 4:  # every fifth log is missing: a 404
            (logs / f"log-{name}.txt").write_text(
                (FUZZ_LOG, COVERAGE_LOG, ERROR_LOG)[i % 3])
    meta = tmp_path / "buildlog_metadata.csv"
    pd.DataFrame({
        "name": names,
        "mediaLink": [None if i % 4 == 3 else
                      "https://oss-fuzz-build-logs.storage.googleapis.com/"
                      f"log-{n}.txt" for i, n in enumerate(names)],
        "size": [None if i == 2 else 100 + i for i in range(n)],
        "timeCreated": ["2024-05-01T10:00:00Z"] * n,
    }).to_csv(meta, index=False)
    return meta


@pytest.mark.parametrize("workers", [1, 4])
def test_buildlog_analyzer_bytes_equal_jax(tmp_path, workers):
    meta = _log_fixture(tmp_path, 14)
    out = {}
    for pkg, mods in PKGS.items():
        reader = pd.read_csv if pkg == "jax" else table.read_csv
        d = tmp_path / f"{pkg}_analyzed"
        an = mods[4].BuildLogAnalyzer(mods[0].DirFetcher(str(tmp_path)),
                                      str(d), batch_size=5, limit=9,
                                      workers=workers)
        assert an.analyze(reader(str(meta))) == 9
        an.limit = None
        assert an.analyze(reader(str(meta))) == 5   # processed-id resume
        assert an.analyze(reader(str(meta))) == 0
        out[pkg] = {p: _bytes(d / p) for p in sorted(os.listdir(d))}
    assert out["torch"] == out["jax"]
    assert list(out["torch"]) == [f"buildlog_analyzed_batch_{i}.csv"
                                  for i in (1, 2, 3)]


# -- C3: projects and the YAML reader ------------------------------------------

def test_first_commit_time_as_jax(oss_fuzz_repo):
    for rel in ("projects/zlib", "projects/brotli", "projects/nope"):
        assert (tproj.first_commit_time(oss_fuzz_repo, rel)
                == jproj.first_commit_time(oss_fuzz_repo, rel))


def test_collect_project_info_as_jax(oss_fuzz_repo, tmp_path):
    t = tproj.collect_project_info(oss_fuzz_repo)
    assert t.col("project") == ["brotli", "zlib"]
    assert t.columns[:2] == ["project", "first_commit_datetime"]
    for pkg, mods in PKGS.items():
        mods[5].run_project_info_collector(oss_fuzz_repo,
                                           str(tmp_path / f"{pkg}.csv"))
    assert _bytes(tmp_path / "torch.csv") == _bytes(tmp_path / "jax.csv")


PROJECT_YAMLS = {
    "alpha": "homepage: https://alpha.org\nlanguage: c++\n"
             "primary_contact: a@x.org\nauto_ccs:\n  - b@x.org\n"
             "  - 'c@x.org'\nsanitizers:\n- address\n- memory:\n"
             "    experimental: true\n- undefined\nbuilds_per_day: 4\n"
             "main_repo: \"https://github.com/a/alpha\"  # the repo\n",
    "beta": "# comment first\nlanguage: c\nfuzzing_engines: [libfuzzer, "
            "afl, honggfuzz]\nvendor_ccs: {x: 1, y: [true, no]}\n"
            "file_github_issue: yes\ndisabled: false\n",
    "gamma": "language: python\nhelp_url: >\n  folded text\n  goes on\n"
             "coverage_extra_args: |\n  -ignore=a\n  -ignore=b\n"
             "labels:\n  fuzzer: [sec, 'x: y']\narchitectures:\n  - x86_64\n"
             "  - i386\nrun_tests: Off\n",
    "delta": "language: jvm\nview_restrictions: none\n"
             "selective_unpack: 2021-03-04\nbuilds_per_day: 0x10\n",
    "eps": "language: rust\nauto_ccs: []\nsanitizers: [address]\n"
           "blackbox: ~\n",
    "zeta": "language: go\nhomepage: 'it''s here'\n"
            "main_repo: \"tab\\there\"\n",
    "broken": "language: c\n\tbad: indent\n",
    "unclosed": "language: 'c\n",
    "noyaml": None,
}


@pytest.fixture()
def rich_repo(tmp_path):
    """An oss-fuzz checkout whose project.yaml files use every form of
    the subset, plus a malformed one and a project with no yaml."""
    repo = str(tmp_path / "oss-fuzz")
    os.makedirs(repo)
    env = dict(os.environ, GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@x",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@x")
    subprocess.run(["git", "init", "-q"], cwd=repo, check=True, env=env)
    for i, (name, text) in enumerate(sorted(PROJECT_YAMLS.items())):
        d = os.path.join(repo, "projects", name)
        os.makedirs(d)
        if text is not None:
            with open(os.path.join(d, "project.yaml"), "w") as f:
                f.write(text)
        with open(os.path.join(d, "build.sh"), "w") as f:
            f.write("compile\n")
        when = f"2021-0{1 + i % 9}-0{1 + i % 7}T0{i % 10}:00:00+0{i % 3}:00"
        subprocess.run(["git", "add", "-A"], cwd=repo, check=True, env=env)
        subprocess.run(["git", "commit", "-qm", name], cwd=repo, check=True,
                       env=dict(env, GIT_AUTHOR_DATE=when,
                                GIT_COMMITTER_DATE=when))
    return repo


def test_rich_project_info_bytes_equal_jax(rich_repo, tmp_path):
    """Lists of mappings, flow collections, quoted and block scalars,
    YAML 1.1 bools and ints, a date, an int column with blanks (4.0), a
    malformed file skipped with a warning in both packages."""
    for pkg, mods in PKGS.items():
        mods[5].run_project_info_collector(rich_repo,
                                           str(tmp_path / f"{pkg}.csv"))
    got = _bytes(tmp_path / "torch.csv")
    assert got == _bytes(tmp_path / "jax.csv")
    text = got.decode()
    assert "4.0" in text and "2021-03-04" in text
    assert "\"['address', {'memory': {'experimental': True}}, " \
           "'undefined']\"" in text


def test_outside_subset_stops_the_run(rich_repo, tmp_path):
    with open(os.path.join(rich_repo, "projects", "alpha", "project.yaml"),
              "a") as f:
        f.write("defaults: &d {x: 1}\n")
    with pytest.raises(Y.OutsideSubset, match="alpha/project.yaml:14"):
        tproj.collect_project_info(rich_repo)


def test_yaml_reader_equals_safe_load_on_generated_documents():
    """At least 500 seeded documents of the subset, each compared with
    ``yaml.safe_load`` value and type for type."""
    rng = random.Random(0)
    for _ in range(600):
        doc = _gen_document(rng)
        assert _same(Y.load(doc), yaml.safe_load(doc)), doc


@pytest.mark.parametrize("text", [
    "a: ~", "a: null", "a: Null", "a:", "a: yes", "a: No", "a: on",
    "a: OFF", "a: true", "a: FALSE", "a: 1_000", "a: 0x1F", "a: 0b101",
    "a: 017", "a: 0o17", "a: 1:30", "a: -7", "a: +5", "a: 00",
    "a: 1.5", "a: 1.0e+3", "a: 1e5", "a: .inf", "a: -.Inf", "a: .nan",
    "a: 3.", "a: 1:30.5", "a: 2020-01-02", "a: 2021-3-4",
    "a: 2020-01-02 03:04:05", "a: 2020-01-02T03:04:05Z",
    "a: 2020-01-02 03:04:05.5 +02:00", "a: '1'", 'a: "true"',
    "yes: 1", "1: a", "on: [off]", "a: v1.2.3", "a: x y",
    "a: http://x.org/a#frag", "a: b # c", "a: {b}", "a: [a,\n  b]",
    "a: b\n  c d", "a: 'x\n  y'", 'a: "x\n\n  y"', 'a: "x \\\n  y"',
    "a: |2\n    x\n   y", "a: >\n  x\n  y\n\n  z\n   w\n  v",
    "a: >-\n  x\n\n", "a: |+\n  x\n\n", "a: |\n\n  x",
    'a: "\\u00e9\\x41\\t"', "a: '''q'''", "- a\n- b", "x", "",
    "# only"])
def test_yaml_scalar_resolution_and_forms(text):
    assert _same(Y.load(text + "\n"), yaml.safe_load(text + "\n")), text


@pytest.mark.parametrize("text,what", [
    ("a: &x 1\nb: *x\n", "an anchor"),
    ("- &x 1\n- *x\n", "an anchor"),
    ("a: !!str 1\n", "a tag"), ("---\na: 1\n", "a document marker"),
    ("a: 1\n...\n", "a document marker"), ("%YAML 1.1\n---\na: 1\n",
                                           "a directive"),
    ("? a\n: b\n", "a complex key"), ("<<: {a: 1}\n", "a merge key"),
    ("a: [b: c]\n", "a single-pair mapping")])
def test_yaml_outside_subset_is_an_error(text, what):
    yaml.safe_load(text)  # valid YAML
    with pytest.raises(Y.OutsideSubset, match=what) as ei:
        Y.load(text, "projects/p/project.yaml")
    assert "projects/p/project.yaml:" in str(ei.value)


@pytest.mark.parametrize("text", [
    "a:\n\tb: 1\n", "a: 'unclosed\n", 'a: "unclosed\n', "a: [1, 2\n",
    "a: b: c\n", "a: 1\n b: 2\n", "a:\n  b: 1\n c: 2\n", 'a: "x" y\n',
    "- a\nb: 1\n", "a: ]\n", "a: @x\n", "a: - b\n", "a: x\n  # c\n  y\n"])
def test_yaml_malformed_is_skipped_like_yamlerror(tmp_path, text):
    with pytest.raises(yaml.YAMLError):
        yaml.safe_load(text)
    with pytest.raises(Y.MalformedYaml):
        Y.load(text)
    p = tmp_path / "project.yaml"
    p.write_text(text)
    assert tproj.read_project_yaml(str(p)) is None
    assert jproj.read_project_yaml(str(p)) is None


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) \
            and math.isnan(b):
        return True
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


_PLAIN = ["c", "c++", "address", "https://github.com/madler/zlib",
          "http://x.org/a#frag", "a b c", "libFuzzer", "true", "False",
          "yes", "No", "on", "OFF", "~", "null", "NULL", "1", "-7", "0x1F",
          "0b101", "017", "1_000", "0o17", "1:30", "1.5", "-2.0", "1.0e+3",
          "1e5", ".inf", "-.Inf", ".nan", "3.", "2020-01-02", "2021-3-4",
          "2020-01-02 03:04:05", "2020-01-02T03:04:05Z", "a,b", "foo # bar",
          "none", "+5", "00", "email@example.com", "v1.2.3"]
_STRS = ["plain", "it's", 'say "hi"', "tab\there", "new\nline", "",
         " spaced ", "ünï", "# not comment", "a: b", "true", "1"]


def _scalar(rng, flow=False):
    if rng.random() < 0.6:
        p = rng.choice(_PLAIN)
        return "word" if flow and any(c in p for c in ",[]{}#") else p
    s = rng.choice(_STRS)
    if rng.random() < 0.5:
        return "'" + s.replace("'", "''") + "'"
    return '"' + (s.replace("\\", "\\\\").replace('"', '\\"')
                  .replace("\n", "\\n").replace("\t", "\\t")) + '"'


def _flow(rng, depth):
    if depth > 1 or rng.random() < 0.6:
        items = [_scalar(rng, True) for _ in range(rng.randint(0, 3))]
        if rng.random() < 0.3 and depth < 2:
            items.append(_flow(rng, depth + 1))
        return "[" + ", ".join(items) + "]"
    keys = rng.sample(["a", "b", "k1", "key two"], rng.randint(0, 3))
    return "{" + ", ".join(f"{k}: {_scalar(rng, True)}" for k in keys) + "}"


def _block_scalar(rng, ind):
    lines = [rng.choice(["first line", "second words here", "x: y # z",
                         "- item", "", "  indented more"])
             for _ in range(rng.randint(1, 4))]
    lines = [ln for ln in lines if ln]
    if not lines or lines[0].startswith(" "):
        lines.insert(0, "only")
    body = "\n".join(" " * ind + ln for ln in lines)
    return (rng.choice("|>") + rng.choice(["", "-", "+"]) + "\n" + body
            + "\n" + "\n" * rng.randint(0, 2))


def _value(rng, ind, depth):
    r = rng.random()
    step = rng.choice([2, 4])
    if depth > 2 or r < 0.45:
        return " " + _scalar(rng) + ("  # c" if rng.random() < 0.15
                                     else "") + "\n"
    if r < 0.55:
        return " " + _flow(rng, 0) + "\n"
    if r < 0.62:
        return " " + _block_scalar(rng, ind + step)
    if r < 0.8:
        sind = ind if rng.random() < 0.5 else ind + step
        out = "\n"
        for _ in range(rng.randint(1, 3)):
            if rng.random() < 0.3 and depth < 2:
                keys = rng.sample(["memory", "address", "experimental"],
                                  rng.randint(1, 2))
                for j, k in enumerate(keys):
                    out += (" " * sind + ("- " if j == 0 else "  ") + k
                            + ":" + _value(rng, sind + 2, depth + 2))
            else:
                out += " " * sind + "- " + _scalar(rng) + "\n"
        return out
    out = "\n"
    for k in rng.sample(["a", "b", "c", "experimental", "yes"],
                        rng.randint(1, 3)):
        out += " " * (ind + step) + k + ":" + _value(rng, ind + step,
                                                     depth + 1)
    return out


def _gen_document(rng) -> str:
    out = "# header\n" if rng.random() < 0.3 else ""
    for k in rng.sample(["homepage", "language", "primary_contact",
                         "auto_ccs", "sanitizers", "fuzzing_engines",
                         "main_repo", "vendor_ccs", "builds_per_day",
                         "labels", "architectures", "disabled", "on",
                         "'quoted key'", '"dq key"'], rng.randint(1, 8)):
        out += k + ":" + _value(rng, 0, 0)
        if rng.random() < 0.1:
            out += "\n  # indented comment\n"
    return out


def test_table_reads_what_pandas_reads_back(tmp_path):
    """The project CSV read back by either reader gives the same
    languages and UTC first-commit days the coverage walk starts from."""
    src = tmp_path / "p.csv"
    src.write_text("project,first_commit_datetime,language\n"
                   "a,2021-03-01 01:00:00+02:00,c\n"
                   "b,,python\nc,garbage,c\n")
    jdf = pd.read_csv(src)
    t = table.read_csv(str(src))
    for row, (_, jrow) in zip(t.rows(), jdf.iterrows()):
        first = pd.to_datetime(jrow["first_commit_datetime"],
                               errors="coerce", utc=True)
        want = None if pd.isna(first) else first.date()
        assert table.utc_date(row["first_commit_datetime"]) == want
        assert row["language"] == jrow["language"]
    assert json.dumps(t.col("project")) == '["a", "b", "c"]'
