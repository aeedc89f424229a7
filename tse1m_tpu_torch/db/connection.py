"""The study database: a copy of ``tse1m_tpu/db/connection.py``'s ``DB``
without its retry engine and fault points.

``DB(config=...)`` resolves its dialect as the JAX package does: the
``postgres`` engine goes through psycopg2 where it imports, else through
the ctypes libpq driver (``db/pglib.py``), else falls back to sqlite at
``config.sqlite_path``; the ``sqlite`` engine opens that file with the
JAX package's pragmas (WAL journal, NORMAL sync).  Queries take ``?``
placeholders, rewritten to ``%s`` for Postgres; values are always bound.
With ``db_statement_timeout_ms`` set, Postgres gets ``SET
statement_timeout`` and a sqlite statement is interrupted at four times
the timeout (``resilience.deadline_guard``).  ``connect(path)`` opens a
sqlite study file.
"""

from __future__ import annotations

import logging
import os
import re
import sqlite3
from typing import Any, Callable, Iterable, Sequence

from ..config import Config, load_config
from ..resilience.watchdog import deadline_guard

log = logging.getLogger("tse1m_tpu_torch.db")

_QMARK_RE = re.compile(r"\?")


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
                # SET is transactional: commit it so a later rollback
                # cannot revert the timeout for the rest of the session.
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
        return self

    def close(self) -> None:
        if self.cursor is not None:
            self.cursor.close()
        if self.connection is not None:
            self.connection.close()
        self.cursor = self.connection = None

    def __enter__(self) -> "DB":
        return self if self.connection is not None else self.connect()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- statements --------------------------------------------------------

    def _adapt(self, sql: str) -> str:
        if self.dialect == "postgres":
            return _QMARK_RE.sub("%s", sql)
        return sql

    def _statement(self, op: Callable, site: str = "db.execute"):
        """Run ``op()`` under the sqlite statement deadline, when a
        statement timeout is configured: past it ``Connection.interrupt``
        cancels the statement, which fails in-thread."""
        timeout_ms = self.config.db_statement_timeout_ms
        if self.dialect != "sqlite" or timeout_ms <= 0:
            return op()
        budget_s = timeout_ms * self._STMT_DEADLINE_MULT / 1000.0
        with deadline_guard(budget_s, self.connection.interrupt, site=site):
            return op()

    def execute(self, sql: str, params: Sequence[Any] = ()) -> None:
        self._statement(
            lambda: self.cursor.execute(self._adapt(sql), tuple(params)))

    def execute_raw(self, sql: str, commit: bool = False) -> int:
        """Execute one complete statement verbatim: no placeholder
        rewrite and no parameters, since a dump's literals may hold ``?``
        or ``%``.  ``commit=True`` commits it as its own unit.  Returns
        the driver's affected-row count (0 when unknown)."""

        def op() -> int:
            self.cursor.execute(sql)
            n = self.cursor.rowcount
            if commit:
                self.connection.commit()
            return int(n) if n and n > 0 else 0

        return self._statement(op, site="db.execute_raw")

    def query(self, sql: str, params: Sequence[Any] = ()) -> list[tuple]:
        def op() -> list[tuple]:
            self.cursor.execute(self._adapt(sql), tuple(params))
            return self.cursor.fetchall()

        return self._statement(op, site="db.query")

    def count(self, sql: str, params: Sequence[Any] = ()) -> int:
        """Row count of a query without fetching its rows."""
        # graftlint: disable=sql-interp -- wraps an already-parameterized query; no identifier reaches the text
        (n,), = self.query(f"SELECT COUNT(*) FROM ({sql}) AS t", params)
        return int(n)

    def executeMany(self, sql: str, rows: Iterable[Sequence[Any]]) -> None:
        """One statement over many parameter rows, committed together."""
        rows = [tuple(r) for r in rows]

        def op() -> None:
            self.cursor.executemany(self._adapt(sql), rows)
            self.connection.commit()

        self._statement(op, site="db.executeMany")

    def run_transaction(self, fn: Callable[["DB"], Any]):
        """``fn(self)`` as one atomic unit: committed after it returns,
        rolled back when it raises."""
        try:
            result = fn(self)
        except BaseException:
            self.connection.rollback()
            raise
        self.connection.commit()
        return result

    def commit(self) -> None:
        self.connection.commit()

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


def connect(path: str) -> DB:
    """An open connection to the sqlite study file at ``path``."""
    return DB(config=Config(engine="sqlite", sqlite_path=path)).connect()


__all__ = ["DB", "connect"]
