"""The DDL of the five study tables in both dialects: a copy of
``tse1m_tpu/db/schema.py``.

Array-valued columns (``modules``, ``revisions``, ``regressed_build``)
are ``TEXT[]`` on Postgres and JSON text on sqlite; ``db/ingest.py``
converts the Postgres literal form on the way in and ``pg_array_literal``
re-emits it for artifacts.  Postgres types the times (``TIMESTAMPTZ``,
``DATE``) and the coverage numbers (``DOUBLE PRECISION``).
"""

from __future__ import annotations

SCHEMA_TABLES = ("projects", "project_info", "buildlog_data",
                 "total_coverage", "issues")

_SQLITE_DDL = """
CREATE TABLE IF NOT EXISTS projects (
    project_name TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS project_info (
    project TEXT PRIMARY KEY,
    first_commit_datetime TEXT,
    language TEXT,
    homepage TEXT,
    main_repo TEXT,
    primary_contact TEXT,
    yaml_json TEXT
);
CREATE TABLE IF NOT EXISTS buildlog_data (
    name TEXT PRIMARY KEY,
    project TEXT NOT NULL,
    timecreated TEXT NOT NULL,
    build_type TEXT NOT NULL,
    result TEXT NOT NULL,
    modules TEXT,
    revisions TEXT
);
CREATE INDEX IF NOT EXISTS idx_buildlog_project_time
    ON buildlog_data(project, build_type, timecreated);
CREATE TABLE IF NOT EXISTS total_coverage (
    project TEXT NOT NULL,
    date TEXT NOT NULL,
    coverage REAL,
    covered_line REAL,
    total_line REAL,
    PRIMARY KEY (project, date)
);
CREATE TABLE IF NOT EXISTS issues (
    project TEXT NOT NULL,
    number TEXT NOT NULL,
    rts TEXT NOT NULL,
    status TEXT,
    crash_type TEXT,
    severity TEXT,
    type TEXT,
    regressed_build TEXT,
    new_id TEXT,
    PRIMARY KEY (project, number)
);
CREATE INDEX IF NOT EXISTS idx_issues_project_rts ON issues(project, rts);
"""

_POSTGRES_DDL = """
CREATE TABLE IF NOT EXISTS projects (
    project_name TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS project_info (
    project TEXT PRIMARY KEY,
    first_commit_datetime TIMESTAMPTZ,
    language TEXT,
    homepage TEXT,
    main_repo TEXT,
    primary_contact TEXT,
    yaml_json TEXT
);
CREATE TABLE IF NOT EXISTS buildlog_data (
    name TEXT PRIMARY KEY,
    project TEXT NOT NULL,
    timecreated TIMESTAMPTZ NOT NULL,
    build_type TEXT NOT NULL,
    result TEXT NOT NULL,
    modules TEXT[],
    revisions TEXT[]
);
CREATE INDEX IF NOT EXISTS idx_buildlog_project_time
    ON buildlog_data(project, build_type, timecreated);
CREATE TABLE IF NOT EXISTS total_coverage (
    project TEXT NOT NULL,
    date DATE NOT NULL,
    coverage DOUBLE PRECISION,
    covered_line DOUBLE PRECISION,
    total_line DOUBLE PRECISION,
    PRIMARY KEY (project, date)
);
CREATE TABLE IF NOT EXISTS issues (
    project TEXT NOT NULL,
    number TEXT NOT NULL,
    rts TIMESTAMPTZ NOT NULL,
    status TEXT,
    crash_type TEXT,
    severity TEXT,
    type TEXT,
    regressed_build TEXT[],
    new_id TEXT,
    PRIMARY KEY (project, number)
);
CREATE INDEX IF NOT EXISTS idx_issues_project_rts ON issues(project, rts);
"""


def ddl(dialect: str) -> str:
    if dialect == "sqlite":
        return _SQLITE_DDL
    if dialect == "postgres":
        return _POSTGRES_DDL
    raise ValueError(f"unknown dialect {dialect!r}")


def create_schema(db) -> None:
    """Create every study table (IF NOT EXISTS) in the connection's
    dialect, in one transaction."""
    statements = [s.strip() for s in ddl(db.dialect).split(";") if s.strip()]

    def _create(dbx) -> None:
        for stmt in statements:
            dbx.execute(stmt)

    db.run_transaction(_create)


__all__ = ["SCHEMA_TABLES", "create_schema", "ddl"]
