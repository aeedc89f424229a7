"""The RQ path's data layer in tse1m_tpu_torch against the JAX package's,
on the CPU: the synthetic study generator (column for column), the sqlite
writer (every table's rows) and the columnar extraction (offsets, times,
flags, text columns, the RQ2 group boundaries and the RQ3 revision
hashes).  Tolerance: exact."""

import importlib.util
import os
import sqlite3

import numpy as np
import pytest

from tse1m_tpu.config import Config as JConfig
from tse1m_tpu.data import columnar as jcol
from tse1m_tpu.data import synth as jsynth
from tse1m_tpu.db import queries as jq
from tse1m_tpu.db.connection import DB
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data import columnar as tcol
from tse1m_tpu_torch.data import synth as tsynth
from tse1m_tpu_torch.db import connect
from tse1m_tpu_torch.db import queries as tq

_GEN = os.path.join(os.path.dirname(__file__), "goldens",
                    "generate_goldens.py")
_spec = importlib.util.spec_from_file_location("generate_goldens", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

# The conftest fixture study and the frozen golden study.
SPECS = {"conftest": dict(n_projects=16, days=420, seed=7),
         "golden": gen.SPEC}
TABLES = ("project_info", "buildlog_data", "total_coverage", "issues",
          "corpus_analysis")
SEGMENTED = ("fuzz", "covb", "issues", "cov")


@pytest.fixture(scope="module", params=list(SPECS))
def studies(request):
    spec = SPECS[request.param]
    return (request.param, jsynth.generate_study(jsynth.SynthSpec(**spec)),
            tsynth.generate_study(tsynth.SynthSpec(**spec)))


@pytest.mark.parametrize("table", TABLES)
def test_generate_study_matches_jax(studies, table):
    _, want, got = studies
    want, got = getattr(want, table), getattr(got, table)
    assert list(got) == list(want.columns)
    for col in want.columns:
        assert got[col] == want[col].tolist(), (table, col)


@pytest.fixture(scope="module")
def written(studies, tmp_path_factory):
    """The same study written by each package's to_db."""
    name, jstudy, tstudy = studies
    d = tmp_path_factory.mktemp(f"db_{name}")
    jpath, tpath = str(d / "jax.sqlite"), str(d / "port.sqlite")
    db = DB(config=JConfig(engine="sqlite", sqlite_path=jpath)).connect()
    jstudy.to_db(db)
    db.closeConnection()
    tstudy.to_db(tpath)
    return jpath, tpath


def _rows(path: str, table: str) -> list:
    with sqlite3.connect(path) as conn:
        return conn.execute(f"SELECT * FROM {table} ORDER BY rowid").fetchall()


@pytest.mark.parametrize("table", ("projects", "project_info",
                                   "buildlog_data", "total_coverage",
                                   "issues"))
def test_to_db_rows_match_jax(written, table):
    jpath, tpath = written
    want = _rows(jpath, table)
    assert want and _rows(tpath, table) == want


@pytest.fixture(scope="module")
def extracted(study_db, study_cfg):
    """(JAX, port) extraction of the JAX-written conftest study."""
    want = jcol.StudyArrays.from_db(study_db, study_cfg)
    cfg = Config(sqlite_path=study_cfg.sqlite_path,
                 limit_date=study_cfg.limit_date,
                 min_coverage_days=study_cfg.min_coverage_days)
    with connect(cfg.sqlite_path) as db:
        got = tcol.StudyArrays.from_db(db, cfg)
    return want, got


def _plain(col):
    return col.materialize() if hasattr(col, "materialize") else col


def _group_starts(seg, g):
    return np.concatenate([[True], (g[1:] != g[:-1]) | (seg[1:] != seg[:-1])])


@pytest.mark.parametrize("table", SEGMENTED)
def test_from_db_matches_jax(extracted, table):
    want, got = extracted
    assert got.projects == want.projects
    a, b = getattr(want, table), getattr(got, table)
    np.testing.assert_array_equal(b.offsets, a.offsets)
    assert b.offsets.dtype == a.offsets.dtype
    assert set(b.columns) == set(a.columns)
    assert len(b) > 0
    for name, col in a.columns.items():
        if name == "grouphash":
            continue
        w, g = _plain(col), _plain(b.columns[name])
        assert type(b.columns[name]) is not np.ndarray or g.dtype == w.dtype
        if w.dtype == object:
            assert list(g) == list(w), (table, name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{table}.{name}")
    if table == "covb":
        seg = np.repeat(np.arange(want.n_projects), a.counts())
        np.testing.assert_array_equal(
            _group_starts(seg, b.columns["grouphash"]),
            _group_starts(seg, a.columns["grouphash"]))


def test_text_columns_keep_the_jax_encodings(extracted):
    want, got = extracted
    for table, name, kind in (("fuzz", "result", "CodedColumn"),
                              ("fuzz", "name", "BytesColumn"),
                              ("covb", "revisions_raw", "CodedColumn"),
                              ("fuzz", "revisions_raw", "BytesColumn")):
        a = getattr(want, table).columns[name]
        b = getattr(got, table).columns[name]
        assert type(a).__name__ == type(b).__name__ == kind
        for i in (0, len(b) // 2, len(b) - 1):
            assert b[i] == a[i]
        assert list(b[3:9].materialize()) == list(a[3:9].materialize())


def test_revision_hashes_match_jax_on_all_rows(extracted):
    want, got = extracted
    for fn in ("fuzz_revhash_at", "covb_revhash_at"):
        n = len(getattr(want, fn.split("_")[0]))
        idx = np.arange(n)
        np.testing.assert_array_equal(getattr(got, fn)(idx),
                                      getattr(want, fn)(idx))


def test_study_arrays_from_numpy_carries_jax_columns(extracted):
    want, _ = extracted
    fields = {"projects": want.projects}
    for table in SEGMENTED:
        t = getattr(want, table)
        fields[table] = {"offsets": t.offsets,
                         "columns": {k: _plain(v)
                                     for k, v in t.columns.items()}}
    got = tcol.study_arrays_from_numpy(fields)
    for table in SEGMENTED:
        a, b = getattr(want, table), getattr(got, table)
        np.testing.assert_array_equal(b.offsets, a.offsets)
        for name, col in a.columns.items():
            assert list(b.columns[name]) == list(_plain(col))


def test_empty_study_gives_empty_segments(study_db, study_cfg):
    """No project is eligible: both packages give zero projects and empty
    segments."""
    jcfg = JConfig(engine="sqlite", sqlite_path=study_cfg.sqlite_path,
                   min_coverage_days=10_000)
    want = jcol.StudyArrays.from_db(study_db, jcfg)
    cfg = Config(sqlite_path=study_cfg.sqlite_path, min_coverage_days=10_000)
    with connect(cfg.sqlite_path) as db:
        got = tcol.StudyArrays.from_db(db, cfg)
    assert got.projects == want.projects == []
    for table in SEGMENTED:
        a, b = getattr(want, table), getattr(got, table)
        np.testing.assert_array_equal(b.offsets, a.offsets)
        assert len(b) == len(a) == 0
        for name, col in b.columns.items():
            assert len(col) == 0, (table, name)


def test_time_lanes_match_jax():
    ns = np.array([np.datetime64("2014-12-31T23:59:59.5", "ns"),
                   np.datetime64("2015-01-01", "ns"),
                   np.datetime64("2024-02-29T12:00:00.000000001", "ns")]
                  ).astype(np.int64)
    for fn in ("ns_to_device_pair", "ns_to_device_s"):
        want, got = getattr(jcol, fn)(ns), getattr(tcol, fn)(ns)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    text = ["2023-06-01 13:11:05", "2024-01-31", "2015-01-01T00:00:00"]
    np.testing.assert_array_equal(tcol.to_epoch_ns(text),
                                  jcol.to_epoch_ns(text))


@pytest.mark.parametrize("targets", [["proj000", "proj'; --"], []])
@pytest.mark.parametrize("name,args", [
    ("eligible_projects", (365, "2025-01-08")),
    ("all_fuzzing_builds_bulk", ()),
    ("coverage_builds_bulk", ()),
    ("issues_bulk", ("2025-01-08",)),
    ("issues_without_matching_build", ("2025-01-08",)),
    ("total_coverage_bulk", ("2025-01-09",)),
])
def test_queries_match_jax(name, args, targets):
    """The same SQL text and bound parameters as the JAX package's sqlite
    queries; a hostile project name stays a bound value."""
    from tse1m_tpu.db import queries as jq
    from tse1m_tpu_torch.db import queries as tq

    if name != "eligible_projects":
        args = (targets, *args)
    assert getattr(tq, name)(*args) == getattr(jq, name)(*args)
