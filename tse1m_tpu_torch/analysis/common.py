"""Shared analysis plumbing: a trimmed copy of ``tse1m_tpu/analysis/
common.py:24-84``.

``StudyContext.open`` opens the study database (``cfg.engine``), prints the study-design
lines of the reference transcript (rq1_detection_rate.py:121-153),
extracts ``StudyArrays`` for the eligible projects (the first 10 in test
mode) and holds the backend ``get_backend(cfg, device)`` gives: a
``TorchBackend`` on the device asked for, or under ``backend = auto`` on
a card the per-RQ router (``backend/auto.py``).

``pyplot`` and ``Figures`` draw the drivers' PDFs.  matplotlib is imported
inside the functions that draw, never when a module is imported (the
card's machine has none).  Where it does not import, a driver still
writes every CSV, lists the figures it skipped in its manifest under
``figures_skipped`` and returns normally; the JAX package's drivers raise
there instead.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..backend import Backend, get_backend
from ..config import FIXED_STATUSES, Config, load_config
from ..data.columnar import StudyArrays
from ..db import queries
from ..db.connection import DB


def limit_date_ns(cfg: Config) -> int:
    return int(np.datetime64(cfg.limit_date, "ns").astype(np.int64))


def fmt_ts_ns(ns: int) -> str:
    """Epoch ns -> 'YYYY-MM-DD HH:MM:SS', with '.ffffff' only when the
    microseconds are non-zero (as psycopg2's str(datetime) and the JAX
    package's pandas formatting give)."""
    secs, rem = divmod(int(ns), 1_000_000_000)
    base = str(np.datetime64(secs, "s")).replace("T", " ")
    micro = rem // 1000
    return f"{base}.{micro:06d}" if micro else base


@dataclass
class StudyContext:
    cfg: Config
    db: DB
    backend: Backend
    projects: list
    arrays: StudyArrays

    @classmethod
    def open(cls, cfg: Config | None = None, db: DB | None = None,
             announce: bool = True,
             device: str | torch.device = "cuda") -> "StudyContext":
        cfg = cfg or load_config()
        # The device first: without a card this raises before any work.
        backend = get_backend(cfg, device)
        if db is None:
            db = DB(config=cfg).connect()
        db.require_study_tables()
        if announce:
            n_all, p_all = _issue_counts(db, cfg, fixed=False)
            n_fix, p_fix = _issue_counts(db, cfg, fixed=True)
            print(f"Found {n_all:,} issues from {p_all:,} projects before "
                  f"{cfg.limit_date}. (in study design)")
            print(f"Found {n_fix:,} fixed issues from {p_fix:,} projects "
                  f"before {cfg.limit_date}. (in study design)")
        sql, params = queries.eligible_projects(cfg.min_coverage_days,
                                                cfg.limit_date)
        projects = sorted(r[0] for r in db.query(sql, params))
        if announce:
            print(f"Found {len(projects):,} projects with at least "
                  f"{cfg.min_coverage_days} coverage reports.")
        if cfg.test_mode:
            projects = projects[:10]
            print(f"[TEST MODE] Limiting to the first {len(projects)} "
                  "projects.")
        arrays = StudyArrays.from_db(db, cfg, projects=projects)
        return cls(cfg=cfg, db=db, backend=backend, projects=projects,
                   arrays=arrays)

    @property
    def min_projects(self) -> int:
        return 1 if self.cfg.test_mode else self.cfg.min_projects_per_iteration

    def out_dir(self, sub: str) -> str:
        path = os.path.join(self.cfg.result_dir, sub)
        os.makedirs(path, exist_ok=True)
        return path


def pyplot():
    """matplotlib's pyplot on the Agg backend (raises ImportError where
    matplotlib is not installed)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


class Figures:
    """One driver's figures: ``draw`` runs a figure writer when matplotlib
    imports, else records the figure's path under the driver's output
    directory; ``finish`` lists the skipped ones in the manifest
    (``figures_skipped``)."""

    def __init__(self, manifest, out_dir: str) -> None:
        self.manifest = manifest
        self.out_dir = out_dir
        self.skipped: list[str] = []
        try:
            pyplot()
        except ImportError:
            self.available = False
        else:
            self.available = True

    def draw(self, paths, writer, *args, **kwargs) -> bool:
        """``writer(*args, **kwargs)``, which writes the file ``paths``
        (or each of a tuple of them), or nothing when its data gate is
        closed; True when the files are there."""
        paths = (paths,) if isinstance(paths, str) else tuple(paths)
        if not self.available:
            self.skipped += [os.path.relpath(p, self.out_dir) for p in paths]
            return False
        writer(*args, **kwargs)
        return all(os.path.exists(p) for p in paths)

    def finish(self) -> None:
        if self.skipped:
            self.manifest.record(figures_skipped=list(self.skipped))


def _issue_counts(db: DB, cfg: Config, fixed: bool) -> tuple[int, int]:
    sql = "SELECT COUNT(*), COUNT(DISTINCT project) FROM issues WHERE rts < ?"
    params: tuple = (cfg.limit_date,)
    if fixed:
        sql += f" AND status IN {queries._in(FIXED_STATUSES)}"
        params += FIXED_STATUSES
    (n, p), = db.query(sql, params)
    return n, p


__all__ = ["Figures", "StudyContext", "fmt_ts_ns", "limit_date_ns",
           "pyplot"]
