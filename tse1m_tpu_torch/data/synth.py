"""Synthetic workloads (numpy, seeded): the study fixture of the RQ path
and the planted near-duplicate session sets of the cluster path.

Copies of ``tse1m_tpu.data.synth``'s ``SynthSpec``, ``SynthStudy``,
``generate_study``, ``synth_session_sets`` and ``synth_session_hitcounts``:
the same spec or seed gives the same rows in both packages.  The study's
tables are columns (a dict of lists a table) instead of DataFrames;
``generate_study`` makes its random draws in the JAX generator's order and
formats the timestamps in bulk at the end.
"""

from __future__ import annotations

import csv
import os
from dataclasses import dataclass, field

import numpy as np

from ..utils.atomic import atomic_write

_CRASH_TYPES = [
    "Heap-buffer-overflow READ", "Heap-buffer-overflow WRITE",
    "Use-after-free READ",
    "Stack-buffer-overflow READ", "Null-dereference READ", "UNKNOWN READ",
    "Timeout", "Out-of-memory", "Abrt", "Integer-overflow",
]
_SEVERITIES = ["High", "Medium", "Low"]
_LANGUAGES = ["c++", "c", "python", "rust", "go", "jvm", "swift"]
_STATUS_OTHER = ["New", "Duplicate", "WontFix", "Invalid"]
# rng.choice(list("0123456789abcdef"), 40) draws rng.integers(0, 16, 40)
# and indexes the list; the digits' bytes are translated from the draws.
_HEX = bytes.maketrans(bytes(range(16)), b"0123456789abcdef")
_DAY_S = 86_400

PROJECT_INFO_COLS = ("project", "first_commit_datetime", "language",
                     "homepage", "main_repo", "primary_contact")
BUILDLOG_COLS = ("name", "project", "timecreated", "build_type", "result",
                 "modules", "revisions")
TOTAL_COVERAGE_COLS = ("project", "date", "coverage", "covered_line",
                       "total_line")
ISSUES_COLS = ("project", "number", "rts", "status", "crash_type",
               "severity", "type", "regressed_build", "new_id")
CORPUS_COLS = ("project_name", "is_Corpus", "corpus_commit_time",
               "corpus_merged_time", "project_creation_time",
               "time_elapsed_seconds", "merged_time_elapsed_seconds")


@dataclass
class SynthSpec:
    n_projects: int = 24
    days: int = 450
    start: str = "2023-06-01"
    seed: int = 0
    # Mean fuzzing builds per project per day (Poisson).
    fuzz_rate: float = 1.4
    # Fraction of projects given < 365 coverage days (ineligible).
    ineligible_fraction: float = 0.15
    # Detection-rate decay: p(session) = a * session^-k, floored.
    detect_a: float = 0.35
    detect_k: float = 0.75
    detect_floor: float = 0.02
    # Revision change cadence (days) for coverage builds.
    revision_period: int = 3
    # Corpus group fractions (G1 none, G2 initial, G3 1-7d, G4 >=7d).
    corpus_fractions: tuple = (0.40, 0.30, 0.15, 0.15)


def _rows(table: dict):
    """A table's rows as dicts (the loaders' input)."""
    cols = list(table)
    return (dict(zip(cols, vals)) for vals in zip(*table.values()))


@dataclass
class SynthStudy:
    """Five tables, each a dict of equal-length column lists."""

    project_info: dict
    buildlog_data: dict
    total_coverage: dict
    issues: dict
    corpus_analysis: dict
    spec: SynthSpec = field(repr=False, default=None)

    def to_db(self, path: str) -> None:
        """Write the four study tables and the derived ``projects`` table
        into the sqlite file at ``path`` (created if absent)."""
        from ..db.ingest import (derive_projects, load_buildlog_data,
                                 load_issues, load_project_info,
                                 load_total_coverage)
        from ..db.schema import create_schema
        from ..db.connection import connect

        with connect(path) as db:
            create_schema(db)
            load_project_info(db, _rows(self.project_info))
            load_buildlog_data(db, _rows(self.buildlog_data))
            load_total_coverage(db, _rows(self.total_coverage))
            load_issues(db, _rows(self.issues))
            derive_projects(db)

    def to_csv_dir(self, path: str) -> None:
        """The study as the collectors' CSVs in ``path``: ``<table>.csv``
        for the four study tables (what ``db.ingest.ingest_csv_dir``
        reads) and ``project_corpus_analysis.csv``, each byte for byte
        what the JAX package's ``to_csv(path, index=False)`` writes."""
        os.makedirs(path, exist_ok=True)
        for name in ("project_info", "buildlog_data", "total_coverage",
                     "issues"):
            _write_csv(getattr(self, name), os.path.join(path, f"{name}.csv"))
        self.write_corpus_csv(os.path.join(path,
                                           "project_corpus_analysis.csv"))

    def write_corpus_csv(self, path: str) -> None:
        """The corpus-analysis table as the CSV that RQ4a and RQ4b read."""
        _write_csv(self.corpus_analysis, path)


def _write_csv(table: dict, path: str) -> None:
    """One table as pandas' ``to_csv(index=False)`` writes it: a header,
    '\n' line ends, minimal quoting, ``True``/``False``, empty cells and
    each float's shortest repr."""
    with atomic_write(path, newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(list(table))
        w.writerows(zip(*table.values()))


def _fmt_s(secs: list) -> list:
    """Epoch seconds -> 'YYYY-MM-DD HH:MM:SS' strings."""
    iso = np.datetime_as_string(np.asarray(secs, dtype="datetime64[s]"),
                                unit="s")
    return [t.replace("T", " ") for t in iso.tolist()]


def _fmt_days(days: list) -> list:
    """Epoch days -> 'YYYY-MM-DD' strings."""
    return np.datetime_as_string(
        np.asarray(days, dtype="datetime64[D]")).tolist()


def generate_study(spec: SynthSpec | None = None) -> SynthStudy:
    """The JAX package's synthetic study: per project a saturating
    coverage trend, Poisson fuzzing builds with issues whose detection
    rate decays with the session index, one coverage build and report a
    day, revision changes every few days, and a corpus group."""
    spec = spec or SynthSpec()
    rng = np.random.default_rng(spec.seed)
    random, uniform, integers = rng.random, rng.uniform, rng.integers
    poisson, normal, choice = rng.poisson, rng.normal, rng.choice
    start_day = int(np.datetime64(spec.start, "D").astype(np.int64))

    info = {c: [] for c in PROJECT_INFO_COLS}
    builds = {c: [] for c in BUILDLOG_COLS}
    cov = {c: [] for c in TOTAL_COVERAGE_COLS}
    issues = {c: [] for c in ISSUES_COLS}
    corpus = {c: [] for c in CORPUS_COLS}
    b_name, b_project, b_secs = (builds["name"], builds["project"],
                                 builds["timecreated"])
    b_type, b_result = builds["build_type"], builds["result"]
    b_modules, b_revisions = builds["modules"], builds["revisions"]
    c_days = cov["date"]
    first_commit_days, creation_days = [], []
    issue_counter = 10000
    group_labels = choice(4, size=spec.n_projects,
                          p=list(spec.corpus_fractions))
    detect_a, detect_k = spec.detect_a, spec.detect_k
    detect_floor, fuzz_rate = spec.detect_floor, spec.fuzz_rate
    period = spec.revision_period

    for p in range(spec.n_projects):
        name = f"proj{p:03d}"
        ineligible = random() < spec.ineligible_fraction
        n_days = int(integers(60, 300)) if ineligible else spec.days
        day0 = start_day + int(integers(0, 30))
        first_commit_days.append(day0 - int(integers(200, 2000)))
        info["project"].append(name)
        info["language"].append(str(choice(_LANGUAGES)))
        info["homepage"].append(f"https://example.org/{name}")
        info["main_repo"].append(f"https://github.com/example/{name}")
        info["primary_contact"].append(f"{name}@example.org")

        # Coverage trend: saturating curve with noise; a few decline.
        c0 = float(uniform(0.15, 0.45))
        c1 = float(uniform(0.5, 0.9))
        tau = float(uniform(60, 200))
        declining = random() < 0.1
        total_lines0 = int(integers(5_000, 80_000))

        session_idx = 0
        build_serial = 0
        rev_sha = None
        rev_serial = 0
        modules = "{" + name + ",libfuzzer}"
        group = int(group_labels[p])
        corpus_build_idx = int(integers(10, 120)) if group == 3 else None
        introduced_day = None

        for d in range(n_days):
            day_s = (day0 + d) * _DAY_S
            if d % period == 0 or rev_sha is None:
                rev_sha = integers(0, 16, size=40).astype(
                    np.uint8).tobytes().translate(_HEX).decode()
                # All builds of one revision period share the revision set.
                rev_serial = 350000 + d * 100
            revisions = "{" + rev_sha + "," + str(rev_serial) + "}"

            # Fuzzing builds.
            k = poisson(fuzz_rate)
            if d == 0:
                k = max(k, 1)
            for h in np.sort(uniform(0, 23, size=k)).tolist():
                session_idx += 1
                build_serial += 1
                ts = day_s + int(h * 3600)
                r = random()
                b_name.append(f"log-{name}-{build_serial:07d}.txt")
                b_project.append(name)
                b_secs.append(ts)
                b_type.append("Fuzzing")
                b_result.append("Finish" if r < 0.90 else
                                ("Halfway" if r < 0.95 else "Error"))
                b_modules.append(modules)
                b_revisions.append(revisions)
                if session_idx == corpus_build_idx:
                    introduced_day = d
                # Issue detection decaying with the session index.
                p_detect = max(detect_a * session_idx ** -detect_k,
                               detect_floor)
                if random() < p_detect:
                    issue_counter += 1
                    rts = ts + int(uniform(1, 20) * 3600)
                    fixed = random() < 0.82
                    status = (("Fixed" if random() < 0.5
                               else "Fixed (Verified)") if fixed
                              else str(choice(_STATUS_OTHER)))
                    regressed = ("{" + f"{name}-regress-{build_serial}" + "}"
                                 if random() < 0.6 else "")
                    issues["project"].append(name)
                    issues["number"].append(str(issue_counter))
                    issues["rts"].append(rts)
                    issues["status"].append(status)
                    issues["crash_type"].append(str(choice(_CRASH_TYPES)))
                    issues["severity"].append(str(choice(_SEVERITIES)))
                    issues["type"].append("Vulnerability" if random() < 0.5
                                          else "Bug")
                    issues["regressed_build"].append(regressed)
                    issues["new_id"].append(str(42000000 + issue_counter))

            # Daily coverage build (that day's revision set).
            build_serial += 1
            b_name.append(f"log-{name}-{build_serial:07d}.txt")
            b_project.append(name)
            b_secs.append(day_s + 13 * 3600 + 11 * 60 + int(integers(0, 60)))
            b_type.append("Coverage")
            cr = random()
            b_result.append("Finish" if cr < 0.92 else
                            ("Halfway" if cr < 0.97 else "Error"))
            b_modules.append(modules)
            b_revisions.append(revisions)

            # Daily coverage report row.
            grown = (c1 - c0) * (1 - float(np.exp(-(d / tau))))
            frac = c1 - grown if declining else c0 + grown
            # A Python float, as JAX's float(np.clip(...)): round() below
            # is Python's correctly rounded one, not numpy's.
            frac = float(min(max(frac + normal(0, 0.01), 0.01), 0.99))
            total_line = float(total_lines0 + d * int(integers(0, 12)))
            cov["project"].append(name)
            c_days.append(day0 + d)
            cov["coverage"].append(round(frac * 100, 4))
            cov["covered_line"].append(float(round(frac * total_line)))
            cov["total_line"].append(total_line)

        # Corpus-analysis record in C8's CSV schema (user_corpus.py:225-
        # 233): NaN -> G1, 0 -> G2, <7d -> G3, >=7d -> G4 (rq4a_bug.py:97).
        if group == 0:
            elapsed_s = None
        elif group == 1:
            elapsed_s = 0.0
        elif group == 2:
            elapsed_s = float(uniform(1, 7)) * 86400.0
        else:
            delay_days = float(introduced_day if introduced_day is not None
                               else uniform(7, 60))
            elapsed_s = max(delay_days, 7.0) * 86400.0
        corpus["project_name"].append(name)
        corpus["is_Corpus"].append(elapsed_s is not None)
        corpus["corpus_commit_time"].append(
            "" if elapsed_s is None
            else _fmt_s([day0 * _DAY_S + int(elapsed_s)])[0])
        corpus["corpus_merged_time"].append("")
        creation_days.append(day0)
        corpus["time_elapsed_seconds"].append(
            elapsed_s if elapsed_s is not None else "")
        corpus["merged_time_elapsed_seconds"].append("")

    info["first_commit_datetime"] = [
        d + " 00:00:00" for d in _fmt_days(first_commit_days)]
    corpus["project_creation_time"] = [
        d + " 00:00:00" for d in _fmt_days(creation_days)]
    builds["timecreated"] = _fmt_s(b_secs)
    cov["date"] = _fmt_days(c_days)
    issues["rts"] = _fmt_s(issues["rts"])
    return SynthStudy(project_info=info, buildlog_data=builds,
                      total_coverage=cov, issues=issues,
                      corpus_analysis=corpus, spec=spec)


def synth_session_sets(
    n_sessions: int,
    set_size: int = 64,
    universe: int = 1 << 24,
    dup_fraction: float = 0.6,
    mean_cluster_size: float = 8.0,
    mutate_prob: float = 0.05,
    seed: int = 0,
    dtype=np.uint32,
) -> tuple[np.ndarray, np.ndarray]:
    """Planted near-duplicate session coverage sets.

    Returns (items [N, set_size] uint32, labels [N] int64).  ``dup_fraction``
    of sessions belong to multi-member clusters whose members share a base
    set with ~``mutate_prob`` of items replaced (expected Jaccard ~0.9);
    the rest are singletons.
    """
    rng = np.random.default_rng(seed)
    n_dup = int(n_sessions * dup_fraction)
    n_clusters = max(1, int(n_dup / mean_cluster_size))

    labels = np.empty(n_sessions, dtype=np.int64)
    labels[:n_dup] = rng.integers(0, n_clusters, size=n_dup)
    labels[n_dup:] = np.arange(n_clusters, n_clusters + (n_sessions - n_dup))

    base = rng.integers(0, universe, size=(n_clusters, set_size), dtype=dtype)
    items = np.empty((n_sessions, set_size), dtype=dtype)
    items[:n_dup] = base[labels[:n_dup]]
    items[n_dup:] = rng.integers(0, universe, size=(n_sessions - n_dup, set_size),
                                 dtype=dtype)

    # Mutate a small fraction of the duplicated rows' items.
    mutate_mask = rng.random((n_dup, set_size)) < mutate_prob
    n_mut = int(mutate_mask.sum())
    items[:n_dup][mutate_mask] = rng.integers(0, universe, size=n_mut, dtype=dtype)

    perm = rng.permutation(n_sessions)
    return items[perm], labels[perm]


def synth_session_hitcounts(
    items: np.ndarray,
    labels: np.ndarray,
    max_weight: int = 8,
    noise_prob: float = 0.05,
    seed: int = 0,
) -> np.ndarray:
    """Per-edge hit counts for the weighted workload (``--scheme
    weighted``): [N, S] uint32 in [1, max_weight].

    Members of a planted cluster share a per-cluster count profile (small
    counts common, hot edges rare), with ``noise_prob`` of positions
    re-rolled per row, so planted weighted Jaccard stays high within a
    cluster.  A count of 0 never occurs: membership implies a hit."""
    rng = np.random.default_rng(seed)
    items = np.asarray(items)
    labels = np.asarray(labels)
    uniq, inv = np.unique(labels, return_inverse=True)
    base = np.minimum(
        1 + rng.geometric(0.45, size=(uniq.size, items.shape[1])) - 1,
        int(max_weight)).astype(np.uint32)
    base = np.maximum(base, np.uint32(1))
    w = base[inv].copy()
    noise = rng.random(w.shape) < noise_prob
    w[noise] = rng.integers(1, int(max_weight) + 1,
                            size=int(noise.sum())).astype(np.uint32)
    return w
