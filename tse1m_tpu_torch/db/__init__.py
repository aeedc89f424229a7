"""The study database: the connection (sqlite, or Postgres through
psycopg2 or libpq), schema, CSV ingest, dump restore and the RQ path's
queries."""

from .connection import DB, connect

__all__ = ["DB", "connect"]
