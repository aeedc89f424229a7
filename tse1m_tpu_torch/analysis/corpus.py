"""Seed-corpus grouping shared by RQ4a and RQ4b: a copy of
``tse1m_tpu/analysis/corpus.py:33-173`` that reads the CSV without pandas.

The eligible projects fall into four groups by the timing of their
seed-corpus introduction in C8's ``project_corpus_analysis.csv``
(rq4a_bug.py:82-121, rq4b_coverage.py:164-230):

- G1 "No Corpus":      time_elapsed_seconds empty or not a number, and every
                       eligible project absent from the CSV (rq4a:110-113).
- G2 "Initial Corpus": time_elapsed_seconds == 0.
- G3 "1-7 Days":       0 < s < days_threshold * 86400.
- G4 ">= 7 Days":      s >= days_threshold * 86400 (the pre/post cohort;
                       carries corpus_commit_time).

``load_corpus_groups`` gives what the JAX package's ``pd.read_csv`` /
``pd.to_datetime(errors="coerce", utc=True, format="mixed")`` /
``pd.to_numeric(errors="coerce")`` reading gives for ISO 8601 times (a
space or 'T' before the time, fractional seconds to the nanosecond, 'Z',
'UTC' or a +hh:mm offset converted to UTC, naive times taken as UTC).
A time in another layout counts as unparseable here.  Numbers are read
correctly rounded, where pandas' fast parser can be a unit in the last
place off; the groups compare them with 0 and the day bound only.  The G4 pre/post
windows (rq4a:348-412) are O(|G4| x N) scalars, computed on the host.
"""

from __future__ import annotations

import csv
import logging
import os
import re
from dataclasses import dataclass

import numpy as np

from ..data.columnar import StudyArrays

log = logging.getLogger(__name__)

GROUP_LABELS = {
    "group1": "Group A (No Corpus)",
    "group2": "Group B (Initial Corpus)",
    "group3": "Group D (1-5 Day Corpus)",
    "group4": "Group C (>5 Day Corpus)",
}

# The cells pandas.read_csv reads as missing by default.
_NA = frozenset({"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN",
                 "-NaN", "-nan", "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA",
                 "NULL", "NaN", "None", "n/a", "nan", "null"})
_ISO_TIME = re.compile(
    r"(\d{4})-(\d{2})-(\d{2})"
    r"(?:[T ](\d{1,2}):(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?)?"
    r"\s*(Z|UTC|[+-]\d{2}(?::?\d{2})?)?")
_S_NS = 1_000_000_000


def parse_time_ns(text: str | None) -> int | None:
    """An ISO 8601 time -> epoch ns in UTC; None when missing or
    unparseable (pandas' NaT under errors="coerce")."""
    m = _ISO_TIME.fullmatch(text.strip()) if text else None
    if m is None:
        return None
    y, mo, d, hh, mi, ss, frac, tz = m.groups()
    hh, mi, ss = int(hh or 0), int(mi or 0), int(ss or 0)
    if hh > 23 or mi > 59 or ss > 59:
        return None
    try:
        day = int(np.datetime64(f"{y}-{mo}-{d}", "D").astype(np.int64))
    except ValueError:  # no such calendar day
        return None
    ns = (day * 86_400 + hh * 3_600 + mi * 60 + ss) * _S_NS
    ns += int((frac or "").ljust(9, "0"))
    if tz and tz not in ("Z", "UTC"):
        digits = tz[1:].replace(":", "")
        off = int(digits[:2]) * 3_600 + int(digits[2:] or 0) * 60
        ns -= (off if tz[0] == "+" else -off) * _S_NS
    return ns


def parse_number(text: str | None) -> float:
    """A numeric cell -> float; NaN when missing or not a number (pandas'
    to_numeric under errors="coerce")."""
    if text is None or "_" in text:
        return float("nan")
    try:
        return float(text)
    except ValueError:
        return float("nan")


def _read_rows(csv_path: str) -> list[dict]:
    """The CSV's non-blank rows as {column: cell}, with pandas' missing
    cells as None."""
    with open(csv_path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        header = next(reader, [])
        rows = []
        for cells in reader:
            if not cells:
                continue
            cells += [""] * (len(header) - len(cells))
            rows.append({k: (None if v in _NA else v)
                         for k, v in zip(header, cells)})
    return rows


@dataclass
class CorpusGroups:
    groups: dict[str, set]          # group key -> project names
    corpus_time_ns: dict[str, int]  # project -> corpus_commit_time (ns); every
                                    # non-null-elapsed project (G2/G3/G4) that
                                    # has a parseable commit time (rq4b:216)

    def indices(self, key: str, project_index: dict[str, int]) -> np.ndarray:
        return np.array(sorted(project_index[p] for p in self.groups[key]
                               if p in project_index), dtype=np.int64)


def load_corpus_groups(csv_path: str, eligible: set,
                       days_threshold: int = 7) -> CorpusGroups:
    """rq4a_bug.py:82-121: a missing CSV file is an error; eligible
    projects without a row default to G1."""
    if not os.path.exists(csv_path):
        raise SystemExit(
            f"corpus analysis CSV not found at {csv_path}. Generate it "
            "first: `python -m tse1m_tpu_torch synth` (synthetic study); "
            "or point corpus_csv/TSE1M_CORPUS_CSV at an existing file.")
    rows = [r for r in _read_rows(csv_path) if r["project_name"] in eligible]
    bound = days_threshold * 86400
    groups = {k: set() for k in ("group1", "group2", "group3", "group4")}
    corpus_time_ns = {}
    for r in rows:
        name = r["project_name"]
        elapsed = parse_number(r["time_elapsed_seconds"])
        if np.isnan(elapsed):
            groups["group1"].add(name)
            continue
        if elapsed == 0:
            groups["group2"].add(name)
        elif 0 < elapsed < bound:
            groups["group3"].add(name)
        elif elapsed >= bound:
            groups["group4"].add(name)
        t = parse_time_ns(r["corpus_commit_time"])
        if t is not None:
            corpus_time_ns[name] = t
    groups["group1"].update(eligible - {r["project_name"] for r in rows})
    log.info("Projects categorized: G1=%d, G2=%d, G3=%d, G4=%d",
             *(len(groups[k]) for k in ("group1", "group2", "group3",
                                        "group4")))
    return CorpusGroups(groups=groups, corpus_time_ns=corpus_time_ns)


@dataclass
class G4PrePost:
    """Fixed-N pre/post windows around corpus introduction (rq4a:348-412).

    detect: [n_kept, 2N] bool, columns ordered step -N..-1, 1..N; kept
    projects pass the completeness filter (rq4a:374).  intro_iteration maps
    every G4 project (with builds data) to the iteration at which its
    corpus arrived (rq4a:246-299; 0 when the project has no builds)."""

    steps: np.ndarray               # [-N..-1, 1..N]
    detect: np.ndarray              # [n_kept, 2N] bool
    kept_projects: list[str]
    missing_pre: set
    intro_iteration: dict[str, int]

    @property
    def pre_any(self) -> np.ndarray:
        return self.detect[:, : self.detect.shape[1] // 2].any(axis=1)

    @property
    def post_any(self) -> np.ndarray:
        return self.detect[:, self.detect.shape[1] // 2:].any(axis=1)

    def transition_counts(self) -> dict:
        pre, post = self.pre_any, self.post_any
        return {
            "no_detection": int((~pre & ~post).sum()),
            "pre_only": int((pre & ~post).sum()),
            "pre_and_post": int((pre & post).sum()),
            "post_only": int((~pre & post).sum()),
        }

    def step_rates(self) -> np.ndarray:
        """Detection rate (%) per step column."""
        if self.detect.size == 0:
            return np.zeros(self.steps.size)
        return self.detect.mean(axis=0) * 100.0


def g4_prepost(arrays: StudyArrays, limit_date_ns: int,
               groups: CorpusGroups, n_windows: int) -> G4PrePost:
    N = n_windows
    pidx = arrays.project_index()
    fuzz_t = arrays.fuzz.columns["time_ns"]
    issue_t = arrays.issues.columns["time_ns"]

    steps = np.array([s for s in range(-N, N + 1) if s != 0], dtype=np.int64)
    rows, kept, missing, intro = [], [], set(), {}
    for name in sorted(groups.groups["group4"]):
        t_corpus = groups.corpus_time_ns.get(name)
        if t_corpus is None or name not in pidx:
            continue
        p = pidx[name]
        flo, fhi = arrays.fuzz.offsets[p], arrays.fuzz.offsets[p + 1]
        btimes = fuzz_t[flo:fhi][fuzz_t[flo:fhi] < limit_date_ns]
        # Introduction iteration = #builds strictly before corpus arrival
        # (rq4a:269); 0 when the project has no builds (rq4a:265-267).
        pos = int(np.searchsorted(btimes, t_corpus, side="left"))
        intro[name] = pos
        if btimes.size == 0 or pos == 0:
            continue  # no pre-introduction build (rq4a:365-366)
        idx_pre_last = pos - 1
        if (idx_pre_last - (N - 1) < 0) or (idx_pre_last + N >= btimes.size - 1):
            missing.add(name)  # incomplete N-window (rq4a:374-376)
            continue
        ilo, ihi = arrays.issues.offsets[p], arrays.issues.offsets[p + 1]
        itimes = issue_t[ilo:ihi]
        row = np.zeros(2 * N, dtype=bool)
        for j, s in enumerate(steps):
            idx = idx_pre_last - (-s - 1) if s < 0 else idx_pre_last + s
            t_start, t_end = btimes[idx], btimes[idx + 1]
            # any issue with t_start <= rts < t_end (rq4a:392,403)
            row[j] = (np.searchsorted(itimes, t_end, side="left")
                      - np.searchsorted(itimes, t_start, side="left")) > 0
        rows.append(row)
        kept.append(name)

    detect = (np.array(rows, dtype=bool) if rows
              else np.zeros((0, 2 * N), dtype=bool))
    return G4PrePost(steps=steps, detect=detect, kept_projects=kept,
                     missing_pre=missing, intro_iteration=intro)


__all__ = ["CorpusGroups", "G4PrePost", "GROUP_LABELS", "g4_prepost",
           "load_corpus_groups", "parse_number", "parse_time_ns"]
