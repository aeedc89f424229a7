"""The sqlite DDL of the five study tables: a copy of the sqlite half of
``tse1m_tpu/db/schema.py``.

Array-valued columns (``modules``, ``revisions``, ``regressed_build``)
are stored as JSON text; ``db/ingest.py`` converts the Postgres literal
form on the way in and ``pg_array_literal`` re-emits it for artifacts.
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


def create_schema(db) -> None:
    """Create every study table (IF NOT EXISTS) in one transaction."""
    statements = [s.strip() for s in _SQLITE_DDL.split(";") if s.strip()]
    with db.transaction():
        for stmt in statements:
            db.execute(stmt)


__all__ = ["SCHEMA_TABLES", "create_schema"]
