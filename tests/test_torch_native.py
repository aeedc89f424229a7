"""The port's native host layer (``tse1m_tpu_torch/native``) on the CPU:
the sqlite decoder against the port's numpy extraction and the JAX
package's ``from_db`` (every table and column), the strict ISO 8601
parser and what it rejects, the per-table fall back on a timezone suffix,
NULL text, float and interned columns, the delta grouper's ``rep_of``
against the numpy ``_group_rows`` of both packages, ``encode_delta``
against JAX's ``DeltaEncoding``, the numpy path when no library builds,
and where the libraries are built.  Comparisons are exact."""

import os
import shutil
import sqlite3

import numpy as np
import pytest

from tse1m_tpu.cluster import encode as jenc
from tse1m_tpu.config import Config as JConfig
from tse1m_tpu.data import columnar as jcol
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.db.connection import DB as JDB
from tse1m_tpu_torch import native
from tse1m_tpu_torch.cluster import encode as tenc
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data import columnar as tcol
from tse1m_tpu_torch.data.columnar import BytesColumn, CodedColumn
from tse1m_tpu_torch.data.synth import SynthSpec, generate_study
from tse1m_tpu_torch.db import connect
from tse1m_tpu_torch.db.schema import create_schema

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tse1m_tpu_torch")
LIMIT = "2026-01-01"
SEGMENTED = ("fuzz", "covb", "issues", "cov")


@pytest.fixture(scope="module")
def study(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "study.sqlite")
    generate_study(SynthSpec(n_projects=8, days=400, seed=11,
                             ineligible_fraction=0.2)).to_db(path)
    return path


def _extract(path, monkeypatch=None, projects=None, **cfg):
    """(port arrays, JAX arrays) of the study at ``path``; the port on the
    numpy path when ``monkeypatch`` is given."""
    cfg = dict(limit_date=LIMIT, **cfg)
    if monkeypatch is not None:
        monkeypatch.setattr(tcol, "_native_db_path", lambda _db: None)
    with connect(path) as db:
        got = tcol.StudyArrays.from_db(db, Config(sqlite_path=path, **cfg),
                                       projects=projects)
    jdb = JDB(config=JConfig(engine="sqlite", sqlite_path=path)).connect()
    want = jcol.StudyArrays.from_db(
        jdb, JConfig(engine="sqlite", sqlite_path=path, **cfg),
        projects=projects)
    jdb.closeConnection()
    return got, want


def _assert_identical(a, b):
    """Port against port: the same arrays, arenas and vocabularies."""
    assert a.projects == b.projects
    for table in SEGMENTED:
        sa, sb = getattr(a, table), getattr(b, table)
        np.testing.assert_array_equal(sa.offsets, sb.offsets)
        assert sa.columns.keys() == sb.columns.keys()
        for name, va in sa.columns.items():
            vb = sb.columns[name]
            where = f"{table}.{name}"
            assert type(va) is type(vb), where
            if isinstance(va, BytesColumn):
                for part in ("arena", "starts", "lens"):
                    x, y = getattr(va, part), getattr(vb, part)
                    assert x.dtype == y.dtype, where
                    np.testing.assert_array_equal(x, y, err_msg=where)
            elif isinstance(va, CodedColumn):
                np.testing.assert_array_equal(va.codes, vb.codes,
                                              err_msg=where)
                assert list(va.vocab) == list(vb.vocab), where
            else:
                assert va.dtype == vb.dtype, where
                assert list(va) == list(vb) if va.dtype == object else \
                    np.array_equal(va, vb, equal_nan=va.dtype.kind == "f"), \
                    where


def _plain(col):
    return col.materialize() if hasattr(col, "materialize") else col


def _assert_values(got, want):
    """Port against JAX: offsets, then each column by value."""
    assert got.projects == want.projects
    for table in SEGMENTED:
        a, b = getattr(got, table), getattr(want, table)
        np.testing.assert_array_equal(a.offsets, b.offsets)
        for name, col in b.columns.items():
            if name == "grouphash":
                continue
            g, w = _plain(a.columns[name]), _plain(col)
            if w.dtype == object:
                assert list(g) == list(w), (table, name)
            else:
                assert g.dtype == w.dtype, (table, name)
                np.testing.assert_array_equal(g, w,
                                              err_msg=f"{table}.{name}")


def test_from_db_native_equals_numpy_equals_jax(study, monkeypatch):
    native_arrays, want = _extract(study)
    assert native_arrays.native_decode and len(native_arrays.fuzz) > 1000
    numpy_arrays, _ = _extract(study, monkeypatch)
    assert not numpy_arrays.native_decode
    _assert_identical(native_arrays, numpy_arrays)
    _assert_values(native_arrays, want)


_TIMES = ["2023-06-01T04:12:33", "2023-06-02 23:59:59", "2020-02-29T00:00:00",
          "1999-12-31T12:00:00.5", "2023-01-01T01:02:03.123456789",
          "2023-01-01", "1969-07-20T20:17:40", "2038-01-19T03:14:08",
          "2024-12-31T23:59:59.999999"]


def _one_column(tmp_path, values, decl="ts TEXT") -> str:
    p = str(tmp_path / "col.sqlite")
    con = sqlite3.connect(p)
    con.execute(f"CREATE TABLE t ({decl})")
    con.executemany("INSERT INTO t VALUES (?)", [(v,) for v in values])
    con.commit()
    con.close()
    return p


def test_iso_parser_gives_numpy_and_jax_ns(tmp_path):
    (got,) = native.fetch_table(_one_column(tmp_path, _TIMES),
                                "SELECT ts FROM t", (), "t", [])
    np.testing.assert_array_equal(got, tcol.to_epoch_ns(_TIMES))
    np.testing.assert_array_equal(got, jcol.to_epoch_ns(_TIMES))


@pytest.mark.parametrize("bad", [
    "2024-01-01T00:00:00+00:00",  # timezone suffix
    "2024-01-01T00:00:00Z",
    "01/02/2024",                 # not ISO 8601
    "2024-13-01",                 # month out of range
    "2023-02-29T00:00:00",        # day invalid for the month (no leap)
    "2024-04-31",                 # day invalid for the month
    "not a date",
])
def test_iso_parser_rejects_rather_than_guesses(tmp_path, bad):
    with pytest.raises(RuntimeError, match="unparseable timestamp"):
        native.fetch_table(_one_column(tmp_path, [bad]), "SELECT ts FROM t",
                           (), "t", [])


def test_timezone_suffix_falls_back_for_its_table(study, tmp_path,
                                                  monkeypatch):
    """A timezone-suffixed issue time sends the issues fetch down the numpy
    path, which reads it as UTC, as JAX's pandas path does; the other
    three tables stay native."""
    path = str(tmp_path / "tz.sqlite")
    shutil.copy(study, path)
    with connect(path) as db:
        proj = db.query("SELECT project FROM issues LIMIT 1")[0][0]
        db.execute("INSERT INTO issues (project, number, rts, status, "
                    "crash_type, severity, regressed_build, new_id, type) "
                    "VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
                    (proj, "999999", "2024-01-01T00:00:00+02:00", "Fixed",
                     "Heap-buffer-overflow", "High", "[]", None, "Bug"))
        db.commit()
    fetched = []
    real = tcol._from_native
    monkeypatch.setattr(tcol, "_from_native", lambda raw, cols, spec: (
        fetched.append(spec), real(raw, cols, spec))[1])
    got, want = _extract(path)
    assert not got.native_decode and fetched == ["pbtcbb", "ptccc", "ptfff"]
    before, _ = _extract(study)
    assert len(got.issues) == len(before.issues) + 1
    assert int(np.datetime64("2023-12-31T22:00:00", "ns").astype(np.int64)) \
        in got.issues.columns["time_ns"]
    _assert_values(got, want)
    numpy_arrays, _ = _extract(path, monkeypatch)
    _assert_identical(got, numpy_arrays)


def test_null_text_float_and_interned_columns(tmp_path, monkeypatch):
    """NULL cells of the lazy-bytes, coded and float columns decode alike
    on both paths, the arena layout included (a NULL cell is (0, -1))."""
    path = str(tmp_path / "nulls.sqlite")
    with connect(path) as db:
        create_schema(db)
        db.executeMany(
            "INSERT INTO buildlog_data (name, project, timecreated, "
            "build_type, result, modules, revisions) VALUES (?,?,?,?,?,?,?)",
            [("b1", "p0", "2024-01-01 10:00:00", "Fuzzing", "Finish",
              '["m1"]', None),
             ("b2", "p0", "2024-01-02 10:00:00", "Fuzzing", "Error", None,
              '["r2"]'),
             ("c1", "p0", "2024-01-01 11:00:00", "Coverage", "Finish", None,
              '["r1"]')])
        db.executeMany(
            "INSERT INTO total_coverage (project, date, coverage, "
            "covered_line, total_line) VALUES (?,?,?,?,?)",
            [("p0", "2024-01-01", 10.0, 1.0, 10.0),
             ("p0", "2024-01-02", None, None, 10.0)])
    got, want = _extract(path, projects=["p0"], min_coverage_days=1)
    assert got.native_decode
    _assert_values(got, want)
    fuzz = got.fuzz.columns
    assert fuzz["revisions_raw"][0] is None and fuzz["modules_raw"][1] is None
    assert got.covb.columns["modules_raw"][0] is None
    assert np.isnan(got.cov.columns["coverage"][1])
    numpy_arrays, _ = _extract(path, monkeypatch, projects=["p0"],
                               min_coverage_days=1)
    _assert_identical(got, numpy_arrays)


def test_float_interned_and_object_cells(tmp_path):
    p = str(tmp_path / "cells.sqlite")
    con = sqlite3.connect(p)
    con.execute("CREATE TABLE t (k TEXT, v REAL, tag TEXT, num)")
    con.executemany("INSERT INTO t VALUES (?,?,?,?)",
                    [("a", 1.5, "x", 1), ("a", None, "y", 2.5),
                     ("b", 3, "x", "txt"), ("b", 0.25, None, None)])
    con.commit()
    con.close()
    codes, vals, tags, nums = native.fetch_table(
        p, "SELECT k, v, tag, num FROM t", (), "pfso", ["a", "b"])
    np.testing.assert_array_equal(codes, np.array([0, 0, 1, 1], np.int32))
    assert vals[0] == 1.5 and np.isnan(vals[1]) and vals[2] == 3.0
    assert tags[0] is tags[2] and tags[3] is None  # one object a value
    assert nums[0] == 1 and isinstance(nums[0], int)
    assert nums[1] == 2.5 and nums[2] == "txt" and nums[3] is None
    with pytest.raises(RuntimeError, match="key value not in key_values"):
        native.fetch_table(p, "SELECT k FROM t", (), "p", ["a"])


# -- the delta grouper --------------------------------------------------------

def _skewed(seed: int) -> np.ndarray:
    """Replica-heavy rows: a few bases repeated thousands of times, each
    copy with 0-6 of 32 positions changed, then shuffled."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 1 << 20, size=(5, 32), dtype=np.uint32)
    rows = bases[rng.choice(5, size=6000, p=[0.6, 0.2, 0.1, 0.05, 0.05])]
    for i in range(rows.shape[0]):
        k = int(rng.integers(0, 7))
        rows[i, rng.choice(32, size=k, replace=False)] = rng.integers(
            0, 1 << 20, size=k, dtype=np.uint32)
    return rows


def _c_like(seed: int) -> np.ndarray:
    """Cell (c)'s rows at a small count: planted near-duplicate 64-id
    sessions."""
    return synth_session_sets(20_000, set_size=64, seed=seed)[0]


@pytest.mark.parametrize("rows", ["skewed", "c_like"])
@pytest.mark.parametrize("max_diffs,n_probes", [(16, 3), (4, 1), (40, 4)])
def test_group_delta_equals_both_group_rows(rows, max_diffs, n_probes):
    items = _skewed(1) if rows == "skewed" else _c_like(2)
    got = native.group_delta(items, max_diffs, n_probes)
    want = tenc._group_rows(items, max_diffs, n_probes)
    assert got.dtype == np.int64 and (got >= 0).sum() > 0
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jenc._group_rows(items, max_diffs,
                                                        n_probes))
    assert (got[got[got >= 0]] == -1).all()  # no chains


def test_group_key_zero_is_its_own_key():
    """A row whose every hashed id is 0 keys 0, one with a 1 among them
    keys 1: both packages' numpy groupers keep them apart, and so does the
    port's table, which marks an empty slot by its row rather than by
    key 0 (the JAX package's native table groups them)."""
    a, b = tenc._PROBES[0]
    inv = pow(a, -1, 1 << 32)
    x0 = (-b * inv) % (1 << 32)
    x1 = ((1 - b) * inv) % (1 << 32)
    items = np.array([[x0] * 8, [x0] * 7 + [x1]], np.uint32)
    assert tenc.sketch_keys(items, 0).tolist() == [0, 1]
    got = native.group_delta(items, 4, 1)
    np.testing.assert_array_equal(got, tenc._group_rows(items, 4, 1))
    np.testing.assert_array_equal(got, jenc._group_rows(items, 4, 1))
    assert got.tolist() == [-1, -1]
    # The JAX package's encode.cc maps key 0 to 1 and groups the two.
    from tse1m_tpu.native import group_delta_native

    jax_native = group_delta_native(items, 4, 1)
    assert jax_native is None or jax_native.tolist() == [-1, 0]


@pytest.mark.parametrize("rows", ["skewed", "c_like"])
def test_encode_delta_equals_jax(rows):
    items = _skewed(3) if rows == "skewed" else _c_like(4)
    got = tenc.encode_delta(items)
    for want in (jenc.encode_delta(items, use_native=False),
                 jenc.encode_delta(items)):
        assert (got.n, got.set_size) == (want.n, want.set_size)
        for field in ("mask_bits", "full_rows", "rep_in_full", "counts",
                      "pos_flat", "val_flat"):
            g, w = getattr(got, field), getattr(want, field)
            assert g.dtype == w.dtype, field
            np.testing.assert_array_equal(g, w, err_msg=field)
    np.testing.assert_array_equal(tenc.decode_host(got), items)


# -- building and falling back ------------------------------------------------

def test_libraries_build_outside_the_package():
    for which in ("decode", "encode", "pgdecode"):
        assert native.loaded(which)
    assert native.BUILD_DIR == os.path.join(REPO, "build", "tse1m_tpu_torch",
                                            "native")
    built = set(os.listdir(native.BUILD_DIR))
    assert {"_tse1m_torch_decode.so", "_tse1m_torch_encode.so",
            "_tse1m_torch_pgdecode.so"} <= built
    for root, _, files in os.walk(PKG):
        assert not [f for f in files if f.endswith(".so")], root


def test_stale_library_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_modules", {})
    builds = []
    real = native._compile
    monkeypatch.setattr(native, "_compile", lambda name, so: (
        builds.append(name), real(name, so))[1])
    assert native.loaded("encode") and builds == ["_tse1m_torch_encode"]
    so = tmp_path / "_tse1m_torch_encode.so"
    assert sorted(os.listdir(tmp_path)) == [so.name]  # no temp file left
    monkeypatch.setattr(native, "_modules", {})
    assert native.loaded("encode") and len(builds) == 1  # fresh: reused
    os.utime(so, (0, 0))  # older than its source
    monkeypatch.setattr(native, "_modules", {})
    assert native.loaded("encode") and len(builds) == 2


def test_without_a_compiler_the_numpy_path_runs(study, tmp_path,
                                                monkeypatch):
    want, _ = _extract(study)
    items = _c_like(5)
    want_enc = tenc.encode_delta(items)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "_modules", {})
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    assert native.fetch_table(study, "SELECT 1", (), "o", []) is None
    assert native.group_delta(items, 16, 3) is None
    assert not native.loaded("decode")
    got, _ = _extract(study)
    assert not got.native_decode
    _assert_identical(got, want)
    enc = tenc.encode_delta(items)
    np.testing.assert_array_equal(enc.mask_bits, want_enc.mask_bits)
    np.testing.assert_array_equal(enc.rep_in_full, want_enc.rep_in_full)
