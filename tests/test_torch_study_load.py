"""Study loading in tse1m_tpu_torch against the JAX package, on the CPU:
the collectors' CSVs written by ``SynthStudy.to_csv_dir`` (byte for byte),
``ingest_csv_dir`` over JAX-written CSVs (every table's rows and the
counts), the upsert of a corrected CSV, ``restore_sql_dump`` over the
COPY and INSERT fixtures of ``tests/test_restore.py`` and over a dump of a
whole study, the ``stats`` lines, the four host commands in subprocesses,
and the six RQ drivers over an ingested and a restored study.

Comparisons are exact, but for two things.  The RQ manifests' floats
agree within rtol = atol = 2e-5 (the repo's cross-engine tolerance, as
``tests/test_torch_rq_drivers.py``).  A restored array cell (modules,
revisions, regressed_build) is compared by its value: the port stores it
as sqlite's JSON text, as ingest does, where the JAX package keeps the
Postgres literal, on which the study's ``json_each`` queries fail (pinned
here by JAX's ``stats`` raising on its own restored study)."""

import contextlib
import io
import json
import math
import os
import sqlite3
import subprocess
import sys

import pytest

from tse1m_tpu import cli as jcli
from tse1m_tpu.analysis.rq1 import run_rq1 as j_rq1
from tse1m_tpu.analysis.rq2_changepoints import run_rq2_changepoints as j_rq2a
from tse1m_tpu.analysis.rq2_trends import run_rq2_trends as j_rq2b
from tse1m_tpu.analysis.rq3 import run_rq3 as j_rq3
from tse1m_tpu.analysis.rq4a import run_rq4a as j_rq4a
from tse1m_tpu.analysis.rq4b import run_rq4b as j_rq4b
from tse1m_tpu.config import Config as JConfig
from tse1m_tpu.data import synth as jsynth
from tse1m_tpu.db.connection import DB as JDB
from tse1m_tpu.db.ingest import ingest_csv_dir as j_ingest
from tse1m_tpu.db.restore import restore_sql_dump as j_restore
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.analysis import run_rqs
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data import synth as tsynth
from tse1m_tpu_torch.db import connect
from tse1m_tpu_torch.db.ingest import ingest_csv_dir as t_ingest
from tse1m_tpu_torch.db.ingest import parse_array
from tse1m_tpu_torch.db.restore import restore_sql_dump as t_restore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_restore import _INSERT_DUMP, _PG_DUMP  # noqa: E402

TABLES = ("projects", "project_info", "buildlog_data", "total_coverage",
          "issues")
CSV_FILES = ("project_info.csv", "buildlog_data.csv", "total_coverage.csv",
             "issues.csv", "project_corpus_analysis.csv")
ARRAY_COLS = {"buildlog_data": ("modules", "revisions"),
              "issues": ("regressed_build",)}
SPECS = {
    "defaults": dict(),
    "ineligible": dict(n_projects=12, days=200, seed=3,
                       ineligible_fraction=0.5),
    "busy": dict(n_projects=8, days=400, seed=7, fuzz_rate=2.5,
                 ineligible_fraction=0.0),
}
STUDY = dict(n_projects=12, days=400, seed=5, ineligible_fraction=0.1)
TOL = 2e-5


def _jdb(path: str) -> JDB:
    return JDB(config=JConfig(engine="sqlite", sqlite_path=path)).connect()


def _dump(path: str, by_value: bool = False) -> dict:
    """Every table's rows, sorted; array cells by value when asked."""
    out = {}
    with sqlite3.connect(path) as conn:
        for table in TABLES:
            cur = conn.execute(f"SELECT * FROM {table}")
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
            if by_value and table in ARRAY_COLS:
                idx = [cols.index(c) for c in ARRAY_COLS[table]]
                rows = [tuple(parse_array(v) if i in idx and v is not None
                              else v for i, v in enumerate(r))
                        for r in rows]
            out[table] = sorted(rows, key=repr)
    return out


def _copy_text(v) -> str:
    if v is None:
        return "\\N"
    s = repr(v) if isinstance(v, float) else str(v)
    return (s.replace("\\", "\\\\").replace("\t", "\\t")
            .replace("\n", "\\n").replace("\r", "\\r"))


def _write_dump(study, path: str) -> None:
    """A study as pg_dump writes it: SET and CREATE noise, one COPY block
    a table (an empty array as ``{}``), and a block of an unknown table."""
    with open(path, "w", encoding="utf-8") as f:
        f.write("--\n-- PostgreSQL database dump\n--\n"
                "SET statement_timeout = 0;\n"
                "CREATE TABLE public.issues (\n    project text\n);\n\n")
        for table in ("project_info", "buildlog_data", "total_coverage",
                      "issues"):
            cols = getattr(study, table)
            arrays = ARRAY_COLS.get(table, ())
            f.write(f"COPY public.{table} ({', '.join(cols)}) FROM stdin;\n")
            for row in zip(*cols.values()):
                f.write("\t".join(
                    _copy_text("{}" if c in arrays and v == "" else v)
                    for c, v in zip(cols, row)) + "\n")
            f.write("\\.\n\n")
        f.write("COPY public.pg_stat_internal (a, b) FROM stdin;\n1\t2\n\\.\n")


# -- the collectors' CSVs -----------------------------------------------------

@pytest.mark.parametrize("spec", list(SPECS))
def test_to_csv_dir_bytes_equal_jax(tmp_path, spec):
    jsynth.generate_study(jsynth.SynthSpec(**SPECS[spec])).to_csv_dir(
        str(tmp_path / "jax"))
    tsynth.generate_study(tsynth.SynthSpec(**SPECS[spec])).to_csv_dir(
        str(tmp_path / "port"))
    assert sorted(os.listdir(tmp_path / "port")) == sorted(CSV_FILES)
    for name in CSV_FILES:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name


@pytest.fixture(scope="module")
def jax_csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("csvs")
    jsynth.generate_study(jsynth.SynthSpec(**STUDY)).to_csv_dir(str(d))
    return d


def test_ingest_equals_jax(jax_csvs, tmp_path):
    tpath, jpath = str(tmp_path / "port.sqlite"), str(tmp_path / "jax.sqlite")
    with connect(tpath) as db:
        got = t_ingest(db, str(jax_csvs))
    jdb = _jdb(jpath)
    want = j_ingest(jdb, str(jax_csvs))
    jdb.closeConnection()
    assert got == want and got["buildlog_data"] > 1000
    assert _dump(tpath) == _dump(jpath)


def test_reingest_of_a_corrected_csv_updates_the_row(jax_csvs, tmp_path):
    fixed = tmp_path / "fixed"
    fixed.mkdir()
    lines = (jax_csvs / "issues.csv").read_text().splitlines(True)
    head, first = lines[0], lines[1].split(",")
    first[5] = "Critical"  # the severity of the first issue
    (fixed / "issues.csv").write_text(head + ",".join(first))
    dumps = []
    for pkg in ("port", "jax"):
        path = str(tmp_path / f"{pkg}.sqlite")
        if pkg == "port":
            with connect(path) as db:
                t_ingest(db, str(jax_csvs))
                t_ingest(db, str(fixed))
        else:
            jdb = _jdb(path)
            j_ingest(jdb, str(jax_csvs))
            j_ingest(jdb, str(fixed))
            jdb.closeConnection()
        with sqlite3.connect(path) as conn:
            assert conn.execute(
                "SELECT severity FROM issues WHERE project = ? AND "
                "number = ?", (first[0], first[1])).fetchone() == (
                "Critical",)
        dumps.append(_dump(path))
    assert dumps[0] == dumps[1]


# -- dump restore -------------------------------------------------------------

_CANON_DUMP = ("COPY public.buildlog_data (name, project, timecreated, "
               "build_type, result) FROM stdin;\n"
               "log-a.txt\tzlib\t2023-06-01 01:00:00\tFuzzing\tSuccess\n"
               "log-b.txt\tzlib\t2023-06-01 02:00:00\tFuzzing\tError\n"
               "\\.\n")
_EDGE_DUMP = ("INSERT INTO buildlog_data (name, project, timecreated, "
              "build_type, result) VALUES\n"
              "  ('log-1.txt', 'zlib', '2023-06-01 01:00:00', 'Fuzzing',"
              " 'Finish'),\n"
              "  ('log-2.txt', 'zlib', '2023-06-01 02:00:00', 'Fuzzing',"
              " 'Finish');\n"
              "INSERT INTO issues (project, number, rts, status, crash_type,"
              " regressed_build) VALUES ('zlib', '7', '2023-06-01 05:00:00',"
              " 'Fixed', 'dropped 5% after fix?;\nsecond line', "
              "'{a,\"b c\"}');\n")
FIXTURES = {"copy": _PG_DUMP, "insert": _INSERT_DUMP, "canon": _CANON_DUMP,
            "edges": _EDGE_DUMP}


def _restore_both(text: str, tmp_path):
    dump = tmp_path / "dump.sql"
    dump.write_text(text)
    tpath, jpath = str(tmp_path / "port.sqlite"), str(tmp_path / "jax.sqlite")
    with connect(tpath) as db:
        got = t_restore(db, str(dump))
    jdb = _jdb(jpath)
    want = j_restore(jdb, str(dump))
    jdb.closeConnection()
    return got, want, tpath, jpath


@pytest.mark.parametrize("fixture", list(FIXTURES))
def test_restore_equals_jax(tmp_path, fixture):
    got, want, tpath, jpath = _restore_both(FIXTURES[fixture], tmp_path)
    assert got == want
    assert _dump(tpath, by_value=True) == _dump(jpath, by_value=True)
    with sqlite3.connect(tpath) as conn:
        for table, cols in ARRAY_COLS.items():
            for col in cols:
                for (v,) in conn.execute(f"SELECT {col} FROM {table}"):
                    assert v is None or isinstance(json.loads(v), list)


def test_restore_parses_coverage_numbers_as_ingest(tmp_path):
    """A coverage number of a COPY block is the double ``float`` gives,
    as ingest stores it; sqlite 3.40's own conversion of the first two
    lands one unit in the last place off."""
    texts = ("688694.486883562", "55877.39440652751", "41.1941", "70194.0")
    dump = tmp_path / "cov.sql"
    dump.write_text(
        "COPY public.total_coverage (project, date, coverage, covered_line,"
        " total_line) FROM stdin;\n" + "".join(
            f"p\t2024-01-0{i + 1}\t{v}\t{v}\t\\N\n"
            for i, v in enumerate(texts)) + "\\.\n")
    with connect(str(tmp_path / "r.sqlite")) as db:
        t_restore(db, str(dump))
        rows = db.query("SELECT coverage, covered_line, total_line FROM "
                        "total_coverage ORDER BY date")
    assert rows == [(float(v), float(v), None) for v in texts]


def test_restored_study_equals_the_ingested_one(tmp_path):
    """A whole study's dump restores to the rows its CSVs ingest to (array
    cells by value); the port's ``stats`` reads it, JAX's fails on its
    own restored copy."""
    study = tsynth.generate_study(tsynth.SynthSpec(**STUDY))
    dump, csvs = str(tmp_path / "study.sql"), str(tmp_path / "csv")
    _write_dump(study, dump)
    study.to_csv_dir(csvs)
    ingested = str(tmp_path / "ingested.sqlite")
    with connect(ingested) as db:
        t_ingest(db, csvs)
    got, want, tpath, jpath = _restore_both(open(dump).read(), tmp_path)
    assert got == want
    assert got["buildlog_data"] == len(study.buildlog_data["name"])
    assert _dump(tpath) == _dump(ingested)
    assert _dump(jpath, by_value=True) == _dump(ingested, by_value=True)
    lines = []
    for path in (tpath, ingested):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli_main(["stats", "--db", path]) == 0
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] and "regression-tracked" in lines[0]
    with pytest.raises(sqlite3.OperationalError, match="malformed JSON"):
        jcli.main(["stats", "--db", jpath])


# -- stats and the commands ---------------------------------------------------

def test_stats_prints_jax_lines(jax_csvs, tmp_path, capsys):
    path = str(tmp_path / "s.sqlite")
    jdb = _jdb(path)
    j_ingest(jdb, str(jax_csvs))
    jdb.closeConnection()
    assert jcli.main(["stats", "--db", path]) == 0
    want = capsys.readouterr().out
    assert cli_main(["stats", "--db", path]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 9


def test_the_four_commands_in_subprocesses(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TSE1M_")}
    env["TSE1M_CORPUS_CSV"] = str(tmp_path / "corpus.csv")

    def run(*args) -> str:
        proc = subprocess.run([sys.executable, "-m", "tse1m_tpu_torch",
                               *args], cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        return proc.stdout

    spec = dict(n_projects=6, days=400, seed=3)
    csvs, dump = tmp_path / "csv", str(tmp_path / "study.sql")
    run("synth", "--db", str(tmp_path / "synth.sqlite"), "--projects", "6",
        "--days", "400", "--seed", "3", "--csv-dir", str(csvs))
    jsynth.generate_study(jsynth.SynthSpec(**spec)).to_csv_dir(
        str(tmp_path / "jax_csv"))
    for name in CSV_FILES:
        assert ((csvs / name).read_bytes()
                == (tmp_path / "jax_csv" / name).read_bytes()), name
    ingested = json.loads(run("ingest", "--csv-dir", str(csvs), "--db",
                              str(tmp_path / "ingested.sqlite")))
    _write_dump(tsynth.generate_study(tsynth.SynthSpec(**spec)), dump)
    restored = json.loads(run("restore", dump, "--db",
                              str(tmp_path / "restored.sqlite")))
    assert ingested["ingested"]["buildlog_data"] \
        == restored["restored"]["buildlog_data"] > 0
    assert restored["restored"]["skipped_statements"] >= 1  # the CREATE
    assert _dump(str(tmp_path / "ingested.sqlite")) == _dump(
        str(tmp_path / "synth.sqlite"))
    stats = [run("stats", "--db", str(tmp_path / f"{n}.sqlite"))
             for n in ("synth", "ingested", "restored")]
    assert stats[0] == stats[1] == stats[2]
    jdb = _jdb(str(tmp_path / "jax.sqlite"))
    j_ingest(jdb, str(csvs))
    jdb.closeConnection()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main(["stats", "--db", str(tmp_path / "jax.sqlite")])
    assert stats[0] == buf.getvalue()


# -- the six drivers over a loaded study --------------------------------------

def _capture(fn) -> list:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


def _assert_close(got, want, where: str) -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)), where
        if math.isnan(want):
            assert math.isnan(got), where
        else:
            assert abs(got - want) <= TOL + TOL * abs(want), (where, got,
                                                              want)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


RUN_KEYS = {"name", "backend", "device", "started_at", "wall_seconds",
            "host", "python", "jax", "torch", "timings", "artifacts"}


@pytest.mark.parametrize("load", ["ingest", "restore"])
def test_drivers_over_a_loaded_study_equal_jax(tmp_path, load):
    """Each package loads the same CSVs (or dump) with its own command,
    then runs the six drivers over its own file: the same CSVs byte for
    byte, the same printed lines, manifests within the tolerance."""
    jstudy = jsynth.generate_study(jsynth.SynthSpec(**STUDY))
    src = tmp_path / "src"
    jstudy.to_csv_dir(str(src))
    corpus = str(src / "project_corpus_analysis.csv")
    dump = str(tmp_path / "study.sql")
    _write_dump(tsynth.generate_study(tsynth.SynthSpec(**STUDY)), dump)
    tpath, jpath = str(tmp_path / "port.sqlite"), str(tmp_path / "jax.sqlite")
    with connect(tpath) as db:
        (t_ingest(db, str(src)) if load == "ingest" else t_restore(db, dump))
    jdb = _jdb(jpath)
    (j_ingest(jdb, str(src)) if load == "ingest" else j_restore(jdb, dump))
    jdb.closeConnection()
    jout, tout = str(tmp_path / "jax_out"), str(tmp_path / "port_out")
    jcfg = JConfig(backend="pandas", engine="sqlite", sqlite_path=jpath,
                   result_dir=jout, corpus_csv=corpus,
                   min_projects_per_iteration=2)

    def run_jax():
        j_rq1(jcfg)
        j_rq2a(jcfg)
        j_rq2b(jcfg, per_project_figures=False)
        j_rq3(jcfg)
        j_rq4a(jcfg)
        j_rq4b(jcfg)

    jlines = _capture(run_jax)
    tcfg = Config(sqlite_path=tpath, result_dir=tout, corpus_csv=corpus,
                  min_projects_per_iteration=2)
    tlines = _capture(lambda: run_rqs(tcfg, device="cpu"))
    assert len(tlines) > 50 and tlines == jlines
    n_csv = 0
    for root, _, files in os.walk(jout):
        for name in files:
            if not name.endswith((".csv", "_manifest.json")):
                continue  # figures: the port draws none (ROADMAP Queue 1)
            rel = os.path.relpath(os.path.join(root, name), jout)
            with open(os.path.join(tout, rel), "rb") as f:
                got = f.read()
            with open(os.path.join(jout, rel), "rb") as f:
                want = f.read()
            if name.endswith(".csv"):
                n_csv += 1
                assert got == want, rel
            else:
                g, w = json.loads(got), json.loads(want)
                _assert_close({k: v for k, v in g.items()
                               if k not in RUN_KEYS},
                              {k: v for k, v in w.items()
                               if k not in RUN_KEYS}, rel)
    assert n_csv >= 8
