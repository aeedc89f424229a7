"""Configuration: a trimmed copy of ``tse1m_tpu/config.py``.

The study-wide constants (the result and status vocabularies, the study
cutoff), the fields the RQ drivers read, the cluster command's
signature store and the storage engine with its Postgres server, with the
JAX package's defaults.  ``load_config`` reads them as the JAX package
does: the ``[POSTGRES]`` and ``[FRAMEWORK]`` sections of the INI at
``TSE1M_ENVFILE`` (else ``program/envFile.ini``), then the environment.
This package has no backend switch: the RQ path runs on ``TorchBackend``.
"""

from __future__ import annotations

import os
from configparser import ConfigParser
from dataclasses import dataclass, field

# The build-result and issue-status vocabularies (queries1.py:3-4 of the
# reference); ingest canonicalises the analyzer's 'Success' to 'Finish'.
RESULT_OK = ("Finish", "Halfway")
FIXED_STATUSES = ("Fixed", "Fixed (Verified)")

DEFAULT_LIMIT_DATE = "2025-01-08"
DEFAULT_INI = "program/envFile.ini"


@dataclass
class PostgresConfig:
    """The server of the ``postgres`` engine (the reference's
    ``program/envFile.ini`` ``[POSTGRES]`` keys)."""

    database: str = "replication_db"
    user: str = "replication_user"
    password: str = "replication_pass"
    host: str = "db"
    port: int = 5432


@dataclass
class Config:
    # Storage engine: "sqlite" (embedded) or "postgres" (the reference's,
    # through psycopg2 or libpq; sqlite at sqlite_path when neither loads).
    engine: str = "sqlite"
    sqlite_path: str = "data/database/tse1m.sqlite"
    # Where the server is, not what the study is: left out of equality.
    postgres: PostgresConfig = field(default_factory=PostgresConfig,
                                     compare=False)
    # Study cutoff: rows at or after it are outside the study.
    limit_date: str = DEFAULT_LIMIT_DATE
    # Eligibility: projects with at least this many non-zero coverage days
    # before the cutoff (rq1_detection_rate.py:144-151).
    min_coverage_days: int = 365
    # RQ1 keeps iterations with at least this many projects (rq1:233).
    min_projects_per_iteration: int = 100
    result_dir: str = "data/result_data"
    # The corpus-analysis CSV that RQ4a and RQ4b group projects by
    # (rq4a_bug.py:34).
    corpus_csv: str = "data/processed_data/csv/project_corpus_analysis.csv"
    # RQ4's pre/post window half-width N and the G3/G4 boundary in days
    # (rq4a_bug.py:43-44).
    analysis_iterations: int = 7
    days_threshold: int = 7
    # The reference's TEST_MODE: the first 10 eligible projects, and a
    # per-iteration floor of 1 project (rq1_detection_rate.py:20,155-158).
    test_mode: bool = False
    # Persistent signature store of the cluster warm path
    # (cluster/store.py); None = cold runs.  CLI `cluster --sig-store`.
    sig_store: str | None = None
    # Per-statement timeout in ms: Postgres `SET statement_timeout`, the
    # sqlite busy timeout and its statement deadline.  0 = off.
    db_statement_timeout_ms: int = 0


def ini_path(path: str | None = None) -> str | None:
    """The INI to read: ``path``, else ``TSE1M_ENVFILE``, else
    ``program/envFile.ini``; None when it names no file."""
    path = path or os.environ.get("TSE1M_ENVFILE", DEFAULT_INI)
    return path if path and os.path.exists(path) else None


def load_config(ini: str | None = None) -> Config:
    """Defaults, then the INI's ``[POSTGRES]`` keys (POSTGRES_DB,
    POSTGRES_USER, POSTGRES_PASSWORD, POSTGRES_IP, POSTGRES_PORT) and
    ``[FRAMEWORK]`` keys engine, sqlite_path, limit_date, result_dir,
    corpus_csv, test_mode, sig_store and db_statement_timeout_ms, then the
    environment: TSE1M_ENGINE, TSE1M_SQLITE_PATH, TSE1M_CORPUS_CSV,
    TSE1M_RESULT_DIR, TSE1M_TEST_MODE (1/true/yes), TSE1M_SIG_STORE,
    TSE1M_DB_STATEMENT_TIMEOUT_MS.  An engine other than sqlite or
    postgres raises ValueError."""
    cfg = Config()
    path = ini_path(ini)
    if path:
        parser = ConfigParser()
        parser.read(path)
        if parser.has_section("POSTGRES"):
            pg = parser["POSTGRES"]
            cfg.postgres = PostgresConfig(
                database=pg.get("POSTGRES_DB", cfg.postgres.database),
                user=pg.get("POSTGRES_USER", cfg.postgres.user),
                password=pg.get("POSTGRES_PASSWORD", cfg.postgres.password),
                host=pg.get("POSTGRES_IP", cfg.postgres.host),
                port=pg.getint("POSTGRES_PORT", cfg.postgres.port))
        if parser.has_section("FRAMEWORK"):
            fw = parser["FRAMEWORK"]
            cfg.engine = fw.get("engine", cfg.engine)
            cfg.sqlite_path = fw.get("sqlite_path", cfg.sqlite_path)
            cfg.limit_date = fw.get("limit_date", cfg.limit_date)
            cfg.result_dir = fw.get("result_dir", cfg.result_dir)
            cfg.corpus_csv = fw.get("corpus_csv", cfg.corpus_csv)
            cfg.test_mode = fw.getboolean("test_mode", cfg.test_mode)
            cfg.sig_store = fw.get("sig_store", cfg.sig_store)
            cfg.db_statement_timeout_ms = fw.getint(
                "db_statement_timeout_ms", cfg.db_statement_timeout_ms)
    cfg.engine = os.environ.get("TSE1M_ENGINE", cfg.engine)
    cfg.sqlite_path = os.environ.get("TSE1M_SQLITE_PATH", cfg.sqlite_path)
    cfg.corpus_csv = os.environ.get("TSE1M_CORPUS_CSV", cfg.corpus_csv)
    cfg.result_dir = os.environ.get("TSE1M_RESULT_DIR", cfg.result_dir)
    if "TSE1M_TEST_MODE" in os.environ:
        cfg.test_mode = os.environ["TSE1M_TEST_MODE"].lower() in (
            "1", "true", "yes")
    cfg.sig_store = os.environ.get("TSE1M_SIG_STORE", cfg.sig_store)
    if "TSE1M_DB_STATEMENT_TIMEOUT_MS" in os.environ:
        cfg.db_statement_timeout_ms = int(
            os.environ["TSE1M_DB_STATEMENT_TIMEOUT_MS"])
    if cfg.engine not in ("sqlite", "postgres"):
        raise ValueError(f"unknown engine {cfg.engine!r}; expected "
                         "'sqlite' or 'postgres'")
    return cfg


__all__ = ["Config", "DEFAULT_INI", "DEFAULT_LIMIT_DATE", "FIXED_STATUSES",
           "PostgresConfig", "RESULT_OK", "ini_path", "load_config"]
