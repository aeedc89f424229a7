"""The study database: ``tse1m_tpu/db/connection.py``'s ``DB``, with its
retry engine, reconnect and fault seats.

``DB(config=...)`` resolves its dialect as the JAX package does: the
``postgres`` engine goes through psycopg2 where it imports, else through
the ctypes libpq driver (``db/pglib.py``), else falls back to sqlite at
``config.sqlite_path``; the ``sqlite`` engine opens that file with the
JAX package's pragmas (WAL journal, NORMAL sync).  Queries take ``?``
placeholders, rewritten to ``%s`` for Postgres; values are always bound.
With ``db_statement_timeout_ms`` set, Postgres gets ``SET
statement_timeout`` and a sqlite statement is interrupted at four times
the timeout (``resilience.deadline_guard``).

Connects and statements run under the shared retry engine
(``utils/retry.py``) with the config's ``db_retry_*`` policy, at the
fault seats ``db.connect`` and ``db.execute``.  ``is_transient`` is the
allowlist: dropped connections (``is_disconnect``: the next attempt
reconnects first), sqlite lock and I/O contention, and injected faults;
an SQL error surfaces at once.  A statement that commits is retried
whole; one that does not is retried only while no transaction of the
caller's is open, since the recovery rollback would drop that
transaction's earlier statements: the failure surfaces instead.
``run_transaction`` retries a multi-statement unit as a whole.
``executeQuery``, ``executeMany``, ``executeValues`` and
``closeConnection`` are the reference's names (``dbFile.py:16-38``).
``connect(path)`` opens a sqlite study file.
"""

from __future__ import annotations

import logging
import os
import re
import sqlite3
from typing import Any, Callable, Iterable, Sequence

from ..config import Config, load_config
from ..resilience.faults import InjectedFault, fault_point
from ..resilience.watchdog import deadline_guard
from ..utils.retry import io_retry_policy, retry_call

log = logging.getLogger("tse1m_tpu_torch.db")

_QMARK_RE = re.compile(r"\?")

# Message markers that mean the server connection is gone, across
# psycopg2, libpq (db/pglib.py) and sqlite.
_DISCONNECT_MARKERS = (
    "server closed the connection", "connection already closed",
    "terminating connection", "connection reset", "could not connect",
    "connection refused", "connection timed out", "broken pipe",
    "ssl connection has been closed", "no connection to the server",
)

# sqlite's transient failures: retried on the same connection.
_SQLITE_TRANSIENT_MARKERS = ("database is locked", "disk i/o error",
                             "database table is locked")


def is_disconnect(e: BaseException) -> bool:
    """True when the exception means the connection itself died, so the
    next attempt needs a fresh connection."""
    if isinstance(e, ConnectionError):  # InjectedConnectionDrop too
        return True
    from . import pglib

    if isinstance(e, pglib.OperationalError):
        return True
    mod = type(e).__module__ or ""
    if mod.startswith("psycopg2") and type(e).__name__ in (
            "OperationalError", "InterfaceError"):
        return True
    if isinstance(e, sqlite3.ProgrammingError):
        return "closed" in str(e).lower()
    return any(m in str(e).lower() for m in _DISCONNECT_MARKERS)


def is_transient(e: BaseException) -> bool:
    """The retry allowlist of the database's seats: dropped connections,
    lock and busy contention, and injected faults.  SQL and programming
    errors (syntax, a missing table, a constraint) surface at once."""
    if is_disconnect(e) or isinstance(e, InjectedFault):
        return True
    if isinstance(e, (sqlite3.OperationalError, sqlite3.DatabaseError)):
        return any(m in str(e).lower() for m in _SQLITE_TRANSIENT_MARKERS)
    return False


class DB:
    """One connection to the study database, either dialect."""

    # A wedged sqlite statement is interrupted at this multiple of the
    # statement timeout, above the busy timeout so lock waits get their
    # full budget first.  Postgres enforces its timeout server-side.
    _STMT_DEADLINE_MULT = 4

    def __init__(self, config: Config | None = None) -> None:
        self.config = config or load_config()
        self.dialect = self._resolve_dialect()
        self.connection = None
        self.cursor = None
        # Uncommitted writes since the last commit, rollback or connect:
        # a transaction of the caller's is open, and retrying a statement
        # is no longer safe.
        self._dirty = False
        # > 0 inside run_transaction: the unit owns the retry there.
        self._txn_depth = 0
        c = self.config
        self._retry_policy = io_retry_policy(
            max_attempts=max(1, c.db_retry_attempts),
            base_delay=c.db_retry_base_delay,
            max_delay=c.db_retry_max_delay)

    def _resolve_dialect(self) -> str:
        self._pg_driver = None
        if self.config.engine == "postgres":
            try:
                import psycopg2  # noqa: F401

                self._pg_driver = "psycopg2"
                return "postgres"
            except ImportError:
                pass
            from . import pglib

            if pglib.available():
                self._pg_driver = "pglib"
                log.info("psycopg2 unavailable; using the ctypes libpq "
                         "driver (db/pglib.py)")
                return "postgres"
            log.warning("psycopg2 and libpq unavailable; falling back to "
                        "sqlite at %s", self.config.sqlite_path)
        return "sqlite"

    # -- lifecycle ---------------------------------------------------------

    def connect(self) -> "DB":
        retry_call(self._connect_once, policy=self._retry_policy,
                   site="db.connect", should_retry=is_transient)
        return self

    def _connect_once(self) -> None:
        fault_point("db.connect")
        self._dirty = False  # a fresh connection has no open transaction
        timeout_ms = self.config.db_statement_timeout_ms
        if self.dialect == "postgres":
            pg = self.config.postgres
            if self._pg_driver == "pglib":
                from . import pglib

                self.connection = pglib.connect(
                    database=pg.database, user=pg.user,
                    password=pg.password, host=pg.host, port=pg.port)
            else:
                import psycopg2

                self.connection = psycopg2.connect(
                    database=pg.database, user=pg.user, password=pg.password,
                    host=pg.host, port=pg.port)
            self.cursor = self.connection.cursor()
            if timeout_ms > 0:
                # SET is transactional: commit it so a later rollback (the
                # retry engine's recovery issues them) cannot revert the
                # timeout for the rest of the session.
                self.cursor.execute(
                    f"SET statement_timeout = {int(timeout_ms)}")
                self.connection.commit()
        else:
            path = self.config.sqlite_path
            if path != ":memory:":
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self.connection = sqlite3.connect(
                path, timeout=timeout_ms / 1000.0 if timeout_ms > 0 else 5.0)
            self.connection.execute("PRAGMA journal_mode=WAL")
            self.connection.execute("PRAGMA synchronous=NORMAL")
            if timeout_ms > 0:
                self.connection.execute(
                    f"PRAGMA busy_timeout={int(timeout_ms)}")
            self.cursor = self.connection.cursor()

    def _reconnect(self) -> None:
        """Drop the (possibly dead) connection and open a fresh one: the
        recovery hook the retry engine runs after a disconnect."""
        log.warning("db: reconnecting after dropped connection")
        try:
            self.closeConnection()
        except Exception:  # graftlint: disable=broad-except -- best-effort teardown of a connection already known dead
            self.cursor = self.connection = None
        self._connect_once()

    def closeConnection(self) -> None:
        if self.cursor is not None:
            self.cursor.close()
        if self.connection is not None:
            self.connection.close()
        self.cursor = self.connection = None
        self._dirty = False

    close = closeConnection

    def __enter__(self) -> "DB":
        return self if self.connection is not None else self.connect()

    def __exit__(self, *exc) -> None:
        self.closeConnection()

    # -- statements --------------------------------------------------------

    def _adapt(self, sql: str) -> str:
        if self.dialect == "postgres":
            return _QMARK_RE.sub("%s", sql)
        return sql

    def _with_statement_deadline(self, op: Callable, site: str):
        """Run ``op()`` under the sqlite statement deadline, when a
        statement timeout is configured: past it ``Connection.interrupt``
        cancels the statement, which fails in-thread as an
        OperationalError, and the retry engine owns the recovery."""
        timeout_ms = self.config.db_statement_timeout_ms
        if self.dialect != "sqlite" or timeout_ms <= 0:
            return op()
        budget_s = timeout_ms * self._STMT_DEADLINE_MULT / 1000.0
        with deadline_guard(budget_s, self.connection.interrupt, site=site):
            return op()

    def _rollback_quietly(self) -> None:
        try:  # clear an aborted transaction before the next attempt
            self.connection.rollback()
        except Exception:  # graftlint: disable=broad-except -- best-effort rollback; the retried attempt surfaces real failures
            pass

    def _statement(self, op: Callable, site: str = "db.execute",
                   commits: bool = False, writes: bool = False):
        """Run ``op()`` (a closure over ``self.cursor``) under the retry
        engine at the ``site`` seat: a transient failure re-executes on
        the same connection, a disconnect reconnects first.

        An op that commits (``commits=True``) is always retried: the
        recovery discards nothing committed and the whole op re-applies.
        One that does not is retried only while no transaction of the
        caller's is open (``_dirty``): after an uncommitted write the
        recovery rollback would drop that transaction's earlier
        statements and the caller's ``commit()`` would persist half a
        unit, so the failure surfaces.  Inside :meth:`run_transaction`
        the unit retries; a statement runs once per unit attempt.  A
        retried commit may apply twice when the server committed and then
        dropped before replying (at-least-once)."""

        def attempt():
            fault_point(site)
            if self.connection is None or self.cursor is None:
                self._connect_once()
            result = self._with_statement_deadline(op, site)
            if commits:
                self._dirty = False
            elif writes:
                self._dirty = True
            return result

        if self._txn_depth:
            return attempt()  # the enclosing run_transaction retries
        if self._dirty and not commits:
            return attempt()  # a caller's open transaction: surface it

        def recover(exc: BaseException, _attempt: int) -> None:
            if is_disconnect(exc):
                self._reconnect()
            else:
                self._rollback_quietly()

        return retry_call(attempt, policy=self._retry_policy, site=site,
                          should_retry=is_transient, on_retry=recover)

    def run_transaction(self, fn: Callable[["DB"], Any],
                        site: str = "db.txn"):
        """``fn(self)`` as one retried, atomic unit: its statements run
        once per attempt, a transient failure rolls the unit back
        (reconnecting when the connection died) and runs it again from
        the top, and the commit follows a whole successful attempt.
        ``fn`` must be idempotent as a whole (the DELETE+INSERT rebuild of
        ``db/ingest.derive_projects``, the IF-NOT-EXISTS DDL of
        ``db/schema.create_schema``)."""

        def attempt():
            if self.connection is None or self.cursor is None:
                self._connect_once()
            self._txn_depth += 1
            try:
                result = fn(self)
            finally:
                self._txn_depth -= 1
            self.connection.commit()
            self._dirty = False
            return result

        def recover(exc: BaseException, _attempt: int) -> None:
            self._dirty = False
            if is_disconnect(exc):
                self._reconnect()
            else:
                self._rollback_quietly()

        return retry_call(attempt, policy=self._retry_policy, site=site,
                          should_retry=is_transient, on_retry=recover)

    def execute(self, sql: str, params: Sequence[Any] = ()) -> None:
        self._statement(
            lambda: self.cursor.execute(self._adapt(sql), tuple(params)),
            writes=True)

    def execute_raw(self, sql: str, commit: bool = False) -> int:
        """Execute one complete statement verbatim: no placeholder
        rewrite and no parameters, since a dump's literals may hold ``?``
        or ``%``.  ``commit=True`` commits it as its own unit, which keeps
        it retryable.  Returns the driver's affected-row count (0 when
        unknown)."""

        def op() -> int:
            self.cursor.execute(sql)
            n = self.cursor.rowcount
            if commit:
                self.connection.commit()
            return int(n) if n and n > 0 else 0

        return self._statement(op, commits=commit, writes=True)

    def query(self, sql: str, params: Sequence[Any] = ()) -> list[tuple]:
        def op() -> list[tuple]:
            self.cursor.execute(self._adapt(sql), tuple(params))
            return self.cursor.fetchall()

        return self._statement(op)

    def count(self, sql: str, params: Sequence[Any] = ()) -> int:
        """Row count of a query without fetching its rows."""
        # graftlint: disable=sql-interp -- wraps an already-parameterized query; no identifier reaches the text
        (n,), = self.query(f"SELECT COUNT(*) FROM ({sql}) AS t", params)
        return int(n)

    def commit(self) -> None:
        self.connection.commit()
        self._dirty = False

    def rollback(self) -> None:
        self.connection.rollback()
        self._dirty = False

    def require_study_tables(self) -> None:
        """Fail with guidance when the study schema is absent."""
        try:
            self.query("SELECT 1 FROM issues LIMIT 1")
        except Exception as e:  # noqa: BLE001 - either driver's error
            raise SystemExit(
                f"study database not initialised ({e}). Populate it first: "
                "`python -m tse1m_tpu_torch synth` for a synthetic study, "
                "`python -m tse1m_tpu_torch ingest --csv-dir ...` for "
                "collector CSVs or `python -m tse1m_tpu_torch restore "
                "DUMP` for a pg_dump.") from e

    # -- the reference's surface (dbFile.py:16-38) -------------------------

    def executeQuery(self, type: str, sql: str, params: Sequence[Any] = ()):
        """``type`` 'select' returns the rows; anything else is DML and
        commits, as dbFile.py's select/insert/update switch does."""

        def op():
            self.cursor.execute(self._adapt(sql), tuple(params))
            if type == "select":
                return self.cursor.fetchall()
            self.connection.commit()
            return None

        return self._statement(op, commits=(type != "select"))

    def executeMany(self, sql: str, rows: Iterable[Sequence[Any]]) -> None:
        """One statement over many parameter rows, committed together."""
        rows = [tuple(r) for r in rows]

        def op() -> None:
            self.cursor.executemany(self._adapt(sql), rows)
            self.connection.commit()

        self._statement(op, commits=True)

    def executeValues(self, sql: str, rows: Iterable[Sequence[Any]],
                      page_size: int = 1000) -> None:
        """Bulk insert; ``sql`` is ``INSERT INTO t (cols) VALUES ?`` with
        one placeholder.  Postgres through psycopg2 uses
        ``execute_values`` (dbFile.py:37's mechanism), through libpq one
        multi-VALUES statement per page; sqlite uses executemany.  The
        pages commit together, so a retried attempt re-inserts from the
        start rather than double-applying a committed prefix."""
        rows = [tuple(r) for r in rows]
        if not rows:
            return

        def op() -> None:
            width = len(rows[0])
            if self.dialect == "postgres" and self._pg_driver == "pglib":
                for i in range(0, len(rows), page_size):
                    page = rows[i:i + page_size]
                    tuples = ",".join(
                        "(" + ",".join("%s" for _ in range(width)) + ")"
                        for _ in page)
                    flat = [v for r in page for v in r]
                    self.cursor.execute(
                        self._adapt(sql).replace("VALUES %s",
                                                 f"VALUES {tuples}"), flat)
            elif self.dialect == "postgres":
                from psycopg2.extras import execute_values

                execute_values(self.cursor, self._adapt(sql), rows,
                               page_size=page_size)
            else:
                placeholders = "(" + ",".join("?" * width) + ")"
                self.cursor.executemany(
                    sql.replace("VALUES ?", f"VALUES {placeholders}"), rows)
            self.connection.commit()

        self._statement(op, commits=True)


def connect(path: str) -> DB:
    """An open connection to the sqlite study file at ``path``."""
    return DB(config=Config(engine="sqlite", sqlite_path=path)).connect()


__all__ = ["DB", "connect", "is_disconnect", "is_transient"]
