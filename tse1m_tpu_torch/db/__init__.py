"""The study database, sqlite only: connection, schema, row loaders and
the RQ path's queries."""

from .sqlite import SqliteDB, connect

__all__ = ["SqliteDB", "connect"]
