"""The port's Postgres engine against the JAX package's, on the CPU and
with no server: the ctypes libpq driver's offline units, the native
COPY-binary parser on crafted streams (and what it rejects), the COPY
wrapper SQL, the dialect decisions and the Postgres DDL, the dialect's
upsert and array storage, the config's engine and ``[POSTGRES]`` keys,
and the sqlite statement deadline.  Comparisons are exact.

A live run against a server, as the JAX package's
``tests/test_postgres_live.py``, waits for a machine where one runs."""

import datetime as dt
import os
import struct

import numpy as np
import pytest

from tse1m_tpu import config as jconfig
from tse1m_tpu.data import columnar as jcol
from tse1m_tpu.db import ingest as jingest
from tse1m_tpu.db import pglib as jpg
from tse1m_tpu.db import schema as jschema
from tse1m_tpu.db.connection import DB as JDB
from tse1m_tpu.native import parse_copy_binary as j_parse
from tse1m_tpu_torch import config as tconfig
from tse1m_tpu_torch import native
from tse1m_tpu_torch import observability as tobs
from tse1m_tpu_torch.data import columnar as tcol
from tse1m_tpu_torch.db import DB, connect
from tse1m_tpu_torch.db import ingest as tingest
from tse1m_tpu_torch.db import pglib as tpg
from tse1m_tpu_torch.db import queries as tq
from tse1m_tpu_torch.db import schema as tschema

PG_EPOCH_NS = 946684800 * 10**9


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("TSE1M_"):
            monkeypatch.delenv(k)


# -- the libpq driver's offline units -----------------------------------------

@pytest.mark.parametrize("sql", [
    "SELECT * FROM t WHERE a = %s AND b = %s",
    "SELECT '%s literal', 'it''s %s' -- trailing %s comment\n"
    "FROM t WHERE x = %s AND y = '100%%' AND z = %s",
    "SELECT %s, 100%%",
    "LIKE 'x' || %s || '%%'",
])
def test_format_to_dollar_as_jax(sql):
    assert tpg.format_to_dollar(sql) == jpg.format_to_dollar(sql)
    assert tpg.format_to_dollar("SELECT %s, 100%%") == "SELECT $1, 100%"


@pytest.mark.parametrize("value", [
    None, True, False, 42, 1.5, "x'y", b"raw",
    dt.datetime(2023, 6, 1, 12, 30), dt.date(2023, 6, 1),
    ["a", 'b"c', None], ("t", "u"),
])
def test_adapt_param_as_jax(value):
    assert tpg.adapt_param(value) == jpg.adapt_param(value)


def test_array_literal_round_trip_as_jax():
    items = ["plain", "with,comma", 'with"quote', "with\\back", ""]
    lit = tpg.compose_array(items)
    assert lit == jpg.compose_array(items)
    assert tpg.parse_text_array(lit) == items
    for text in ("{}", "{a,NULL,c}", '{a,"b,c"}', lit):
        assert tpg.parse_text_array(text) == jpg.parse_text_array(text)


@pytest.mark.parametrize("oid,text", [
    (23, "7"), (20, "9"), (701, "1.25"), (1700, "10.5"), (16, "t"),
    (16, "f"), (25, "text stays"), (1082, "2023-06-01"),
    (1114, "2023-06-01 12:30:45.5"), (1184, "2023-06-01 12:30:45+02"),
    (1184, "2023-06-01 12:30:45-05:30"), (1184, "infinity"),
    (1009, '{a,"b,c"}'),
])
def test_convert_cell_as_jax(oid, text):
    got = tpg.convert_cell(oid, text)
    assert got == jpg.convert_cell(oid, text)
    assert type(got) is type(jpg.convert_cell(oid, text))


def test_libpq_loads_and_a_refused_connect_raises():
    assert tpg.available() == jpg.available()
    if not tpg.available():
        pytest.skip("libpq not present")
    with pytest.raises(tpg.Error):
        tpg.connect(database="nope", user="nope", password="nope",
                    host="127.0.0.1", port=59999)
    assert tpg.conninfo("d", "u", "p'w", "h", 1) == jpg.conninfo(
        "d", "u", "p'w", "h", 1)


# -- the native COPY-binary parser --------------------------------------------

def _stream(rows, ncol):
    out = b"PGCOPY\n\xff\r\n\x00" + struct.pack(">ii", 0, 0)
    for row in rows:
        out += struct.pack(">h", ncol)
        for cell in row:
            if cell is None:
                out += struct.pack(">i", -1)
            else:
                out += struct.pack(">i", len(cell)) + cell
    return out + struct.pack(">h", -1)


def _ts(us):
    return struct.pack(">q", us)


def _f8(v):
    return struct.pack(">d", v)


def _d4(days):
    return struct.pack(">i", days)


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            _same(g, w)
        elif isinstance(w, list):
            assert g == w
        elif w.dtype == object:
            assert list(g) == list(w)
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_parse_all_spec_chars_as_jax():
    rows = [
        [b"alpha", _ts(1_000_000), _f8(42.5), b"Finish", b"{a,b}",
         b"log-1.txt", b"123"],
        [b"beta", _ts(0), None, b"Finish", None, b"log-2.txt", None],
        [b"alpha", _d4(3), _f8(-1.0), None, b"{c}", None, b"9"],
    ]
    data = _stream(rows, 7)
    got = native.parse_copy_binary(data, "ptfscbo", ["alpha", "beta"])
    proj, t, f, s, c, b, o = got
    np.testing.assert_array_equal(proj, [0, 1, 0])
    assert t.tolist() == [PG_EPOCH_NS + 1_000_000_000, PG_EPOCH_NS,
                          PG_EPOCH_NS + 3 * 86400 * 10**9]
    assert f[0] == 42.5 and np.isnan(f[1]) and f[2] == -1.0
    assert list(s) == ["Finish", "Finish", None]
    assert c[0].tolist() == [0, -1, 1] and c[1] == ["{a,b}", "{c}"]
    arena, starts, lens = b
    assert bytes(arena[starts[0]:starts[0] + lens[0]]) == b"log-1.txt"
    assert lens[2] == -1 and list(o) == ["123", None, "9"]
    want = j_parse(data, "ptfscbo", ["alpha", "beta"])
    if want is not None:
        _same(got, want)


@pytest.mark.parametrize("case", ["signature", "trailer", "key value",
                                  "field count", "timestamp width",
                                  "infinity"])
def test_parse_rejects_malformed_streams(case):
    good = _stream([[b"alpha"]], 1)
    data, spec = {
        "signature": (b"NOTPGCOPY" + good[9:], "p"),
        "trailer": (good[:-2], "p"),
        "key value": (_stream([[b"zulu"]], 1), "p"),
        "field count": (_stream([[b"alpha", b"x"]], 2), "p"),
        "timestamp width": (_stream([[struct.pack(">h", 1)]], 1), "t"),
        "infinity": (_stream([[struct.pack(">q", 2**63 - 1)]], 1), "t"),
    }[case]
    with pytest.raises(RuntimeError, match=case):
        native.parse_copy_binary(data, spec, ["alpha"])


def test_copy_wrapper_sql_as_jax():
    sql = "SELECT * FROM t WHERE a IN (?, ?) AND b < ? AND c = ?"
    params = ("x", "o'brien", 5, None)
    assert tcol._inline_params(sql, params) == jcol._inline_params(sql,
                                                                   params)
    assert tcol._inline_params(sql, params) == (
        "SELECT * FROM t WHERE a IN ('x', 'o''brien') AND b < 5 AND c = NULL")
    with pytest.raises(ValueError, match="placeholder"):
        tcol._inline_params("SELECT ?", ("a", "b"))
    for (q, p), spec in ((tq.all_fuzzing_builds_bulk(["a", "b"]), "pbtcbb"),
                         (tq.total_coverage_bulk(["a"], "2025-01-01"),
                          "ptfff"),
                         (tq.issues_bulk(["a"]), "potsss")):
        got = tcol._pg_copy_sql(q, p, spec)
        assert got == jcol._pg_copy_sql(q, p, spec)
        assert got.startswith("COPY (SELECT") and got.endswith(
            "TO STDOUT (FORMAT binary)")


def test_driver_rows_of_postgres_decode_on_the_numpy_path():
    """A driver's native cells (tz-aware datetimes, TEXT[] lists), as
    psycopg2 and pglib return them, go through the numpy path."""

    class Rows:
        dialect = "postgres"

        def query(self, sql, params):
            tz = dt.timezone(dt.timedelta(hours=2))
            return [("b", dt.datetime(2024, 1, 1, 2, 0, tzinfo=tz),
                     ["m", "n"], ["r"], "Finish"),
                    ("a", dt.datetime(2024, 1, 1, 0, 0), None, ["r"],
                     "Error")]

    out, codes = tcol._fetch(Rows(), "q", (), ["project", "t", "m", "r",
                                                 "res"], "ptbcc",
                             {"a": 0, "b": 1})
    assert codes.tolist() == [0, 1]
    assert out["t"].tolist() == [
        int(np.datetime64("2024-01-01T00:00", "ns").astype(np.int64))] * 2
    assert list(out["m"]) == [None, ["m", "n"]]
    assert out["r"].vocab.tolist() == [("r",)]
    assert [tingest.parse_array(v) for v in out["r"].materialize()] == [
        ["r"], ["r"]]


# -- dialects, DDL and the statement layer ------------------------------------

def test_qmark_adaptation_as_jax():
    sql = "SELECT * FROM t WHERE a = ? AND b IN (?, ?)"
    for dialect in ("postgres", "sqlite"):
        t, j = DB.__new__(DB), JDB.__new__(JDB)
        t.dialect = j.dialect = dialect
        assert t._adapt(sql) == j._adapt(sql)


def test_ddl_as_jax():
    for dialect in ("sqlite", "postgres"):
        assert tschema.ddl(dialect) == jschema.ddl(dialect)
    assert "timestamptz" in tschema.ddl("postgres").lower()
    assert "timestamptz" not in tschema.ddl("sqlite").lower()
    with pytest.raises(ValueError, match="unknown dialect"):
        tschema.ddl("mysql")


@pytest.mark.parametrize("dialect", ["sqlite", "postgres"])
def test_upsert_array_storage_and_severity_sql_as_jax(dialect):
    class Fake:
        pass

    t, j = Fake(), Fake()
    t.dialect = j.dialect = dialect
    cols, conflict = ("project", "date", "coverage"), ("project", "date")
    assert tingest._upsert_sql(t, "total_coverage", cols, conflict) == \
        jingest._upsert_sql(j, "total_coverage", cols, conflict)
    assert tingest.store_array(t, ["a", "b"]) == jingest.store_array(
        j, ["a", "b"])
    from tse1m_tpu.db import queries as jq
    assert tq.severity_issues("High", ["p"], dialect, "2025-01-01") == \
        jq.severity_issues("High", ["p"], dialect, "2025-01-01")


def _pair(engine, tmp_path):
    path = str(tmp_path / f"{engine}.sqlite")
    t = DB(config=tconfig.Config(engine=engine, sqlite_path=path))
    j = JDB(config=jconfig.Config(engine=engine, sqlite_path=path))
    return t, j


def test_dialect_resolution_as_jax(tmp_path, monkeypatch):
    for engine in ("sqlite", "postgres"):
        t, j = _pair(engine, tmp_path)
        assert (t.dialect, t._pg_driver) == (j.dialect, j._pg_driver)
    monkeypatch.setattr(tpg, "available", lambda: False)
    monkeypatch.setattr(jpg, "available", lambda: False)
    t, j = _pair("postgres", tmp_path)
    assert t.dialect == j.dialect == "sqlite"
    t.connect()
    t.execute("CREATE TABLE t (x INTEGER)")
    t.execute("INSERT INTO t VALUES (?)", (3,))
    assert t.query("SELECT x FROM t") == [(3,)]
    t.close()


def test_postgres_resolves_to_pglib_without_psycopg2(tmp_path):
    try:
        import psycopg2  # noqa: F401

        pytest.skip("psycopg2 present; the resolution prefers it")
    except ImportError:
        pass
    if not tpg.available():
        pytest.skip("libpq not present")
    t, _ = _pair("postgres", tmp_path)
    assert (t.dialect, t._pg_driver) == ("postgres", "pglib")
    assert tcol._native_pg_conninfo(t) == jpg.conninfo(
        "replication_db", "replication_user", "replication_pass", "db", 5432)
    assert tcol._native_db_path(t) is None


def test_engine_and_postgres_keys_as_jax(tmp_path, monkeypatch):
    ini = tmp_path / "env.ini"
    ini.write_text("[POSTGRES]\nPOSTGRES_DB = study\nPOSTGRES_USER = u\n"
                   "POSTGRES_PASSWORD = pw\nPOSTGRES_IP = 10.0.0.5\n"
                   "POSTGRES_PORT = 6543\n\n[FRAMEWORK]\nengine = postgres\n"
                   "db_statement_timeout_ms = 250\n")
    monkeypatch.setenv("TSE1M_ENVFILE", str(ini))
    got, want = tconfig.load_config(), jconfig.load_config()
    assert got.engine == want.engine == "postgres"
    assert vars(got.postgres) == vars(want.postgres)
    assert got.postgres.port == 6543 and got.postgres.host == "10.0.0.5"
    assert got.db_statement_timeout_ms == want.db_statement_timeout_ms == 250
    monkeypatch.setenv("TSE1M_ENGINE", "sqlite")
    monkeypatch.setenv("TSE1M_DB_STATEMENT_TIMEOUT_MS", "75")
    got, want = tconfig.load_config(), jconfig.load_config()
    assert (got.engine, got.db_statement_timeout_ms) == (
        want.engine, want.db_statement_timeout_ms) == ("sqlite", 75)
    monkeypatch.setenv("TSE1M_ENGINE", "mysql")
    with pytest.raises(ValueError) as t_err:
        tconfig.load_config()
    with pytest.raises(ValueError) as j_err:
        jconfig.load_config()
    assert str(t_err.value) == str(j_err.value)


def test_sqlite_statement_deadline_interrupts(tmp_path):
    """Past four times the statement timeout a runaway sqlite statement is
    interrupted in its own thread, after a ``deadline_interrupt`` event."""
    tobs.pop_degradation_events()
    db = DB(config=tconfig.Config(sqlite_path=str(tmp_path / "d.sqlite"),
                                  db_statement_timeout_ms=50)).connect()
    runaway = ("WITH RECURSIVE c(x) AS (SELECT 1 UNION ALL SELECT x + 1 "
               "FROM c) SELECT COUNT(*) FROM c")
    with pytest.raises(Exception, match="interrupted"):
        db.query(runaway)
    assert [e["kind"] for e in tobs.pop_degradation_events()] == [
        "deadline_interrupt"]
    assert db.query("SELECT 1") == [(1,)]  # the next statement runs
    db.close()
    with connect(str(tmp_path / "d.sqlite")) as plain:
        assert plain.config.db_statement_timeout_ms == 0
