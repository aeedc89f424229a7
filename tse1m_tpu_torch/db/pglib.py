"""Minimal Postgres driver over ``libpq`` via ctypes: a copy of
``tse1m_tpu/db/pglib.py``.

The reference hard-requires psycopg2 (dbFile.py:1); environments that
ship ``libpq.so.5`` but no psycopg2 wheel (this image, minimal CI boxes)
would otherwise silently fall back to sqlite.  This module implements the
slice of DB-API the framework's connection layer actually uses —
``connect`` -> connection with ``cursor()``/``commit()``/``close()``,
cursors with ``execute(sql, params)`` (``%s`` placeholders),
``executemany``, ``fetchall``/``fetchone``, ``rowcount`` — against libpq
directly, so ``engine = postgres`` works wherever the C library exists.

Fidelity notes (mirroring psycopg2 where the framework depends on it):
- parameters go out of band via ``PQexecParams`` (no string interpolation;
  the security property the rebuild's parameterized queries exist for);
- results convert by column OID: ints, floats/numeric, bool, text,
  date/timestamp(tz) -> ``datetime``, ``text[]`` -> ``list[str]`` (the
  shape test_postgres_live.py's round-trip asserts);
- transactions are explicit: a lazy ``BEGIN`` before the first statement,
  ``commit()`` sends ``COMMIT`` — psycopg2's default behavior.

The pure pieces (placeholder rewrite, parameter adaption, OID
conversion, array literal parse/compose) are unit-tested offline
(tests/test_torch_pg.py); the transport needs a live server.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import datetime as _dt
import logging
import re
from typing import Any, Iterable, Sequence

log = logging.getLogger("tse1m_tpu_torch.pglib")

# -- libpq binding -----------------------------------------------------------

_CONNECTION_OK = 0
_PGRES_COMMAND_OK = 1
_PGRES_TUPLES_OK = 2

_lib = None
_lib_tried = False


def _libpq():
    """Load libpq lazily; None when absent (callers fall back)."""
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    name = (ctypes.util.find_library("pq") or "libpq.so.5")
    try:
        lib = ctypes.CDLL(name)
    except OSError as e:
        log.info("libpq unavailable (%s)", e)
        return None
    c_char_p, c_int, c_void_p = ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p
    protos = {
        "PQconnectdb": ([c_char_p], c_void_p),
        "PQstatus": ([c_void_p], c_int),
        "PQerrorMessage": ([c_void_p], c_char_p),
        "PQfinish": ([c_void_p], None),
        "PQexec": ([c_void_p, c_char_p], c_void_p),
        "PQexecParams": ([c_void_p, c_char_p, c_int, c_void_p,
                          ctypes.POINTER(c_char_p), ctypes.POINTER(c_int),
                          ctypes.POINTER(c_int), c_int], c_void_p),
        "PQresultStatus": ([c_void_p], c_int),
        "PQresultErrorMessage": ([c_void_p], c_char_p),
        "PQntuples": ([c_void_p], c_int),
        "PQnfields": ([c_void_p], c_int),
        "PQftype": ([c_void_p, c_int], ctypes.c_uint),
        "PQgetisnull": ([c_void_p, c_int, c_int], c_int),
        "PQgetvalue": ([c_void_p, c_int, c_int], c_char_p),
        "PQcmdTuples": ([c_void_p], c_char_p),
        "PQclear": ([c_void_p], None),
    }
    for fn, (argtypes, restype) in protos.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    _lib = lib
    return _lib


def available() -> bool:
    return _libpq() is not None


# -- SQL placeholder rewrite -------------------------------------------------

def format_to_dollar(sql: str) -> str:
    """``%s`` placeholders -> ``$1..$n`` (PQexecParams style), skipping
    string literals and SQL comments; ``%%`` unescapes to a literal %."""
    out = []
    n = 0
    i = 0
    ln = len(sql)
    while i < ln:
        ch = sql[i]
        if ch == "'":  # string literal: copy until closing quote ('' stays)
            j = i + 1
            while j < ln:
                if sql[j] == "'":
                    if j + 1 < ln and sql[j + 1] == "'":
                        j += 2
                        continue
                    break
                j += 1
            out.append(sql[i:j + 1])
            i = j + 1
        elif ch == "-" and sql[i:i + 2] == "--":
            j = sql.find("\n", i)
            j = ln if j < 0 else j
            out.append(sql[i:j])
            i = j
        elif ch == "%" and sql[i:i + 2] == "%s":
            n += 1
            out.append(f"${n}")
            i += 2
        elif ch == "%" and sql[i:i + 2] == "%%":
            out.append("%")
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


# -- parameter / result conversion -------------------------------------------

def adapt_param(v: Any) -> bytes | None:
    """Python value -> libpq text-format parameter (None = SQL NULL)."""
    if v is None:
        return None
    if isinstance(v, bool):
        return b"t" if v else b"f"
    if isinstance(v, bytes):
        return v
    if isinstance(v, (_dt.datetime, _dt.date)):
        return v.isoformat().encode()
    if isinstance(v, (list, tuple)):
        return compose_array(v).encode()
    return str(v).encode()


def compose_array(items: Iterable[Any]) -> str:
    """Python list -> Postgres array literal with full quoting."""
    parts = []
    for it in items:
        if it is None:
            parts.append("NULL")
            continue
        s = str(it)
        s = s.replace("\\", "\\\\").replace('"', '\\"')
        parts.append(f'"{s}"')
    return "{" + ",".join(parts) + "}"


def parse_text_array(lit: str) -> list:
    """Postgres ``text[]`` literal -> list[str|None] (psycopg2's shape)."""
    from .ingest import _split_pg_array

    body = lit.strip()
    if body.startswith("{") and body.endswith("}"):
        body = body[1:-1]
    if not body:
        return []
    out = []
    for tok in _split_pg_array(body):
        out.append(None if tok == "NULL" else tok)
    return out


_TS_RE = re.compile(
    r"^(\d{4})-(\d{2})-(\d{2})[ T](\d{2}):(\d{2}):(\d{2})(\.\d+)?"
    r"(?:([+-])(\d{2})(?::?(\d{2}))?)?$")


def _parse_timestamp(text: str) -> Any:
    m = _TS_RE.match(text)
    if not m:
        return text  # infinity / BC dates — out of study scope, keep raw
    y, mo, d, h, mi, s = (int(m.group(k)) for k in range(1, 7))
    frac = m.group(7)
    us = int(float(frac) * 1e6) if frac else 0
    tz = None
    if m.group(8):
        sign = 1 if m.group(8) == "+" else -1
        off = _dt.timedelta(hours=int(m.group(9)),
                            minutes=int(m.group(10) or 0))
        tz = _dt.timezone(sign * off)
    return _dt.datetime(y, mo, d, h, mi, s, us, tzinfo=tz)


def convert_cell(oid: int, text: str) -> Any:
    """libpq text-format cell -> Python value by column OID (the psycopg2
    conversions the framework's consumers rely on)."""
    if oid in (20, 21, 23, 26):          # int8/int2/int4/oid
        return int(text)
    if oid in (700, 701, 1700):          # float4/float8/numeric
        return float(text)
    if oid == 16:                        # bool
        return text == "t"
    if oid in (1114, 1184):              # timestamp / timestamptz
        return _parse_timestamp(text)
    if oid == 1082:                      # date
        return _dt.date.fromisoformat(text)
    if oid in (1009, 1015):              # text[] / varchar[]
        return parse_text_array(text)
    return text


# -- DB-API slice ------------------------------------------------------------

class Error(Exception):
    pass


class OperationalError(Error):
    """Connection-level failure (server gone, network drop) — the
    reconnect-class error ``db/connection.py``'s retry engine looks for
    (psycopg2 raises its own OperationalError for the same states)."""


# libpq error strings that mean the connection itself died.
_CONN_DEAD_MARKERS = (
    "server closed the connection", "terminating connection",
    "connection to server", "no connection to the server",
    "could not receive data", "could not send data", "connection reset",
    "ssl connection has been closed",
)


def _classify(message: str) -> type[Error]:
    low = message.lower()
    if any(m in low for m in _CONN_DEAD_MARKERS):
        return OperationalError
    return Error


class Cursor:
    def __init__(self, conn: "Connection"):
        self._conn = conn
        self._rows: list = []
        self._pos = 0
        self.rowcount = -1

    def execute(self, sql: str, params: Sequence[Any] | None = None):
        from ..resilience.faults import fault_point

        fault_point("pglib.exec")
        self._conn._check_alive()
        self._conn._begin()
        res = self._conn._exec_params(sql, params or ())
        lib = _libpq()
        try:
            status = lib.PQresultStatus(res)
            if status == _PGRES_TUPLES_OK:
                nt, nf = lib.PQntuples(res), lib.PQnfields(res)
                oids = [lib.PQftype(res, j) for j in range(nf)]
                rows = []
                for i in range(nt):
                    row = []
                    for j in range(nf):
                        if lib.PQgetisnull(res, i, j):
                            row.append(None)
                        else:
                            row.append(convert_cell(
                                oids[j],
                                lib.PQgetvalue(res, i, j).decode()))
                    rows.append(tuple(row))
                self._rows, self._pos = rows, 0
                self.rowcount = nt
            elif status == _PGRES_COMMAND_OK:
                self._rows, self._pos = [], 0
                t = lib.PQcmdTuples(res)
                self.rowcount = int(t) if t else -1
            else:
                msg = lib.PQresultErrorMessage(res).decode().strip()
                raise _classify(msg)(msg)
        finally:
            lib.PQclear(res)
        return self

    def executemany(self, sql: str, seq: Iterable[Sequence[Any]]):
        total = 0
        for params in seq:
            self.execute(sql, params)
            total += max(self.rowcount, 0)
        self.rowcount = total
        return self

    def fetchall(self) -> list[tuple]:
        rows = self._rows[self._pos:]
        self._pos = len(self._rows)
        return rows

    def fetchone(self):
        if self._pos >= len(self._rows):
            return None
        row = self._rows[self._pos]
        self._pos += 1
        return row

    def close(self) -> None:
        self._rows = []


class Connection:
    def __init__(self, pgconn):
        self._pg = pgconn
        self._in_txn = False

    @property
    def closed(self) -> bool:
        """True when the underlying libpq connection is gone or in a bad
        state (PQstatus != CONNECTION_OK) — psycopg2's ``closed`` shape."""
        if self._pg is None:
            return True
        return _libpq().PQstatus(self._pg) != _CONNECTION_OK

    def _check_alive(self) -> None:
        if self._pg is None:
            raise OperationalError("connection already closed")
        if _libpq().PQstatus(self._pg) != _CONNECTION_OK:
            raise OperationalError("no connection to the server")

    def _begin(self) -> None:
        if not self._in_txn:
            self._command("BEGIN")
            self._in_txn = True

    def _command(self, sql: str) -> None:
        lib = _libpq()
        res = lib.PQexec(self._pg, sql.encode())
        if not res:  # libpq returns NULL when the connection dropped
            raise OperationalError(
                lib.PQerrorMessage(self._pg).decode().strip()
                or "no connection to the server")
        try:
            if lib.PQresultStatus(res) not in (_PGRES_COMMAND_OK,
                                               _PGRES_TUPLES_OK):
                msg = lib.PQresultErrorMessage(res).decode().strip()
                raise _classify(msg)(msg)
        finally:
            lib.PQclear(res)

    def _exec_params(self, sql: str, params: Sequence[Any]):
        lib = _libpq()
        adapted = [adapt_param(p) for p in params]
        n = len(adapted)
        values = (ctypes.c_char_p * n)(*adapted) if n else None
        res = lib.PQexecParams(self._pg, format_to_dollar(sql).encode(),
                               n, None, values, None, None, 0)
        if not res:
            msg = lib.PQerrorMessage(self._pg).decode().strip()
            raise (_classify(msg) if msg else OperationalError)(
                msg or "no connection to the server")
        return res

    def cursor(self) -> Cursor:
        return Cursor(self)

    def commit(self) -> None:
        if self._in_txn:
            self._command("COMMIT")
            self._in_txn = False

    def rollback(self) -> None:
        if self._in_txn:
            self._command("ROLLBACK")
            self._in_txn = False

    def close(self) -> None:
        if self._pg is not None:
            _libpq().PQfinish(self._pg)
            self._pg = None


def conninfo(database: str, user: str, password: str, host: str,
             port: int | str, connect_timeout: int = 10) -> str:
    def esc(v) -> str:
        s = str(v).replace("\\", "\\\\").replace("'", "\\'")
        return f"'{s}'"
    return (f"dbname={esc(database)} user={esc(user)} "
            f"password={esc(password)} host={esc(host)} port={esc(port)} "
            f"connect_timeout={int(connect_timeout)}")


def connect(database: str, user: str, password: str, host: str,
            port: int | str) -> Connection:
    lib = _libpq()
    if lib is None:
        raise Error("libpq is not available on this system")
    pg = lib.PQconnectdb(conninfo(database, user, password, host,
                                  port).encode())
    if lib.PQstatus(pg) != _CONNECTION_OK:
        msg = lib.PQerrorMessage(pg).decode().strip()
        lib.PQfinish(pg)
        raise Error(msg or "connection failed")
    return Connection(pg)
