"""The study database, sqlite only: a stand-in for ``tse1m_tpu/db/
connection.py``'s ``DB`` trimmed to what the RQ path calls.

``connect(path)`` opens the file with the JAX package's pragmas (WAL
journal, NORMAL sync) and returns a ``SqliteDB`` with ``query``,
``count``, ``executemany`` and ``close``.  Parameters bind in qmark style.
The JAX package's retry engine, fault points and statement deadlines, and
its Postgres drivers, are not carried.
"""

from __future__ import annotations

import os
import sqlite3
from typing import Any, Iterable, Sequence


class SqliteDB:
    dialect = "sqlite"

    def __init__(self, path: str):
        self.path = path
        if path != ":memory:":
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.connection = sqlite3.connect(path, timeout=5.0)
        self.connection.execute("PRAGMA journal_mode=WAL")
        self.connection.execute("PRAGMA synchronous=NORMAL")

    def query(self, sql: str, params: Sequence[Any] = ()) -> list[tuple]:
        return self.connection.execute(sql, tuple(params)).fetchall()

    def count(self, sql: str, params: Sequence[Any] = ()) -> int:
        """Row count of a query without fetching its rows."""
        (n,), = self.query(f"SELECT COUNT(*) FROM ({sql}) AS t", params)
        return int(n)

    def execute(self, sql: str, params: Sequence[Any] = ()) -> None:
        self.connection.execute(sql, tuple(params))

    def executemany(self, sql: str, rows: Iterable[Sequence[Any]]) -> None:
        self.connection.executemany(sql, rows)

    def transaction(self):
        """``with db.transaction():`` commits the block's statements
        together, or rolls them all back."""
        return self.connection

    def require_study_tables(self) -> None:
        """Fail with guidance when the study schema is absent."""
        row = self.query("SELECT name FROM sqlite_master WHERE type = "
                         "'table' AND name = 'issues'")
        if not row:
            raise SystemExit(
                f"study database {self.path} not initialised: write a "
                "study first (tse1m_tpu_torch.data.synth.generate_study("
                "...).to_db(path))")

    def close(self) -> None:
        self.connection.close()

    def __enter__(self) -> "SqliteDB":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def connect(path: str) -> SqliteDB:
    return SqliteDB(path)


__all__ = ["SqliteDB", "connect"]
