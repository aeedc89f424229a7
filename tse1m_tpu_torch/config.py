"""Study configuration of the RQ path: a trimmed copy of
``tse1m_tpu/config.py``.

The study-wide constants (the result and status vocabularies, the study
cutoff) and the fields the RQ path reads, with the JAX package's defaults.
``load_config`` applies the same environment overrides as the JAX package
for the sqlite path, the result directory and test mode.  This package
reads sqlite only and has no backend switch: the RQ path runs on
``TorchBackend``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

# The build-result and issue-status vocabularies (queries1.py:3-4 of the
# reference); ingest canonicalises the analyzer's 'Success' to 'Finish'.
RESULT_OK = ("Finish", "Halfway")
FIXED_STATUSES = ("Fixed", "Fixed (Verified)")

DEFAULT_LIMIT_DATE = "2025-01-08"


@dataclass
class Config:
    sqlite_path: str = "data/database/tse1m.sqlite"
    # Study cutoff: rows at or after it are outside the study.
    limit_date: str = DEFAULT_LIMIT_DATE
    # Eligibility: projects with at least this many non-zero coverage days
    # before the cutoff (rq1_detection_rate.py:144-151).
    min_coverage_days: int = 365
    # RQ1 keeps iterations with at least this many projects (rq1:233).
    min_projects_per_iteration: int = 100
    result_dir: str = "data/result_data"
    # The reference's TEST_MODE: the first 10 eligible projects, and a
    # per-iteration floor of 1 project (rq1_detection_rate.py:20,155-158).
    test_mode: bool = False


def load_config() -> Config:
    """Defaults, then the environment: TSE1M_SQLITE_PATH,
    TSE1M_RESULT_DIR, TSE1M_TEST_MODE (1/true/yes)."""
    cfg = Config()
    cfg.sqlite_path = os.environ.get("TSE1M_SQLITE_PATH", cfg.sqlite_path)
    cfg.result_dir = os.environ.get("TSE1M_RESULT_DIR", cfg.result_dir)
    if "TSE1M_TEST_MODE" in os.environ:
        cfg.test_mode = os.environ["TSE1M_TEST_MODE"].lower() in (
            "1", "true", "yes")
    return cfg


__all__ = ["Config", "DEFAULT_LIMIT_DATE", "FIXED_STATUSES", "RESULT_OK",
           "load_config"]
