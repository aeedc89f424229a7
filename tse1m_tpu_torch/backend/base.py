"""Backend interface and the six RQ result types: a copy of
``tse1m_tpu/backend/base.py:18-232``.

Each method is one research question's hot loop in the reference
(SURVEY.md §3); ``TorchBackend`` implements them on the card, and its
results equal the JAX package's backends field for field.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

import numpy as np

from ..data.columnar import StudyArrays


@dataclass
class RQ1Result:
    """Per-iteration detection stats (rq1_detection_rate.py:189-268).

    iterations: retained 1-based iteration numbers (>= min-projects filter),
    ascending; total_projects / detected_counts align with it.
    iteration_of_issue: for every fixed issue row in arrays.issues, the
    number of fuzzing builds strictly before its report time.
    link_idx: index into arrays.fuzz rows of the latest *successful* build
    strictly before the report (and before the study cutoff), -1 if none —
    the SAME_DATE_BUILD_ISSUE join (queries1.py:15-58).
    """

    iterations: np.ndarray
    total_projects: np.ndarray
    detected_counts: np.ndarray
    iteration_of_issue: np.ndarray
    link_idx: np.ndarray

    @property
    def detection_rates(self) -> np.ndarray:
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(self.total_projects > 0,
                            self.detected_counts / self.total_projects * 100.0, 0.0)

    @property
    def linked(self) -> np.ndarray:
        return self.link_idx >= 0


@dataclass
class RQ2ChangePointsResult:
    """Revision change points per project (rq2_coverage_and_added.py:126-219).

    Flat arrays over all change points, project-major in covb row order.
    end_i / start_ip1 index into arrays.covb rows: the last build of group i
    and the first build of group i+1.  covered/total are the same-day
    total_coverage rows (NaN where no date match); diffs are NaN unless both
    sides are valid with non-zero total (reference rq2:189-200).
    """

    project_idx: np.ndarray
    end_i: np.ndarray
    start_ip1: np.ndarray
    covered_i: np.ndarray
    total_i: np.ndarray
    covered_ip1: np.ndarray
    total_ip1: np.ndarray

    def _valid(self):
        vi = ~np.isnan(self.total_i) & (self.total_i != 0)
        vp = ~np.isnan(self.total_ip1) & (self.total_ip1 != 0)
        return vi, vp

    @property
    def diff_total_line(self) -> np.ndarray:
        vi, vp = self._valid()
        return np.where(vi & vp, self.total_ip1 - self.total_i, np.nan)

    @property
    def diff_coverage(self) -> np.ndarray:
        vi, vp = self._valid()
        with np.errstate(invalid="ignore", divide="ignore"):
            ci = np.where(vi, self.covered_i / self.total_i * 100.0, np.nan)
            cp = np.where(vp, self.covered_ip1 / self.total_ip1 * 100.0, np.nan)
        return np.where(vi & vp, cp - ci, np.nan)


@dataclass
class RQ2TrendsResult:
    """Per-project coverage%-vs-session trends (rq2_coverage_count.py).

    matrix: [P, S] coverage% padded with NaN (S = longest trend); mask marks
    valid cells.  Trends keep the reference's skip-zero-total rule
    (rq2:300-303): sessions with total_line == 0 are dropped, then the rest
    are re-indexed densely.  spearman aligns with arrays.projects;
    percentiles rows follow PCTS; mean/counts are per session index.
    """

    PCTS = (5, 25, 50, 75, 95)

    matrix: np.ndarray
    mask: np.ndarray
    spearman: np.ndarray
    percentiles: np.ndarray  # [len(PCTS), S]
    mean: np.ndarray         # [S]
    counts: np.ndarray       # [S]


@dataclass
class RQ3Result:
    """Coverage change at detection vs elsewhere
    (rq3_diff_coverage_at_detection.py:202-302).

    Detected rows: for each fixed issue that links to a fuzzing build, a
    nearby successful coverage build with identical revisions (<24h gap),
    and a day-after coverage report — the (prev, day-after) coverage delta.
    Non-detected rows: every other consecutive coverage-day pair of projects
    with >= 1 fixed issue, excluding pairs whose current date equals a
    detected issue's report date (the reference's exclusion key, rq3:249-251).
    det_issue_idx indexes into arrays.issues rows; *_project_idx into
    arrays.projects.
    """

    det_diff_percent: np.ndarray
    det_diff_covered: np.ndarray
    det_diff_total: np.ndarray
    det_project_idx: np.ndarray
    det_issue_idx: np.ndarray
    det_issue_time_ns: np.ndarray
    nondet_diff_percent: np.ndarray
    nondet_diff_covered: np.ndarray
    nondet_diff_total: np.ndarray
    nondet_project_idx: np.ndarray


@dataclass
class RQ4aTrendResult:
    """G1-vs-G2 detection-rate trend (rq4a_bug.py:302-346,156-207).

    Unlike RQ1, iteration totals count ALL fuzzing builds before the cutoff
    regardless of result (rq4a:128-134), and a project counts as detecting
    at iteration k when k = #builds strictly before a fixed issue's report
    time is > 0 — no successful-build linkage required (rq4a:343-346).
    iterations holds only rows where BOTH groups have >= min_projects
    (rq4a:170-177); per-group arrays align with it.
    """

    iterations: np.ndarray
    g1_total: np.ndarray
    g1_detected: np.ndarray
    g2_total: np.ndarray
    g2_detected: np.ndarray

    def rates(self, group: str) -> np.ndarray:
        tot = getattr(self, f"{group}_total")
        det = getattr(self, f"{group}_detected")
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.where(tot > 0, det / tot * 100.0, 0.0)


@dataclass
class RQ4bTrendsResult:
    """Per-session coverage% distributions for two corpus groups
    (rq4b_coverage.py:910-1015).

    Trends are the raw ``coverage`` column (non-null, > 0, pre-cutoff,
    rq4b:315-326) re-indexed densely per project — NOT covered/total like
    RQ2.  matrix/mask are [P, S] over ALL projects (S = longest trend);
    group percentile rows follow ``percentiles`` and counts are per-session
    group populations.
    """

    percentiles: tuple
    matrix: np.ndarray            # [P, S] float64, NaN-padded
    mask: np.ndarray              # [P, S] bool
    g1_percentiles: np.ndarray    # [K, S]
    g1_counts: np.ndarray         # [S]
    g2_percentiles: np.ndarray    # [K, S]
    g2_counts: np.ndarray         # [S]


class Backend(abc.ABC):
    name: str

    @abc.abstractmethod
    def rq1_detection(self, arrays: StudyArrays, limit_date_ns: int,
                      min_projects: int) -> RQ1Result:
        ...

    @abc.abstractmethod
    def rq2_change_points(self, arrays: StudyArrays,
                          limit_date_ns: int) -> RQ2ChangePointsResult:
        ...

    @abc.abstractmethod
    def rq2_trends(self, arrays: StudyArrays,
                   limit_date_ns: int) -> RQ2TrendsResult:
        ...

    @abc.abstractmethod
    def rq3_coverage_at_detection(self, arrays: StudyArrays,
                                  limit_date_ns: int) -> RQ3Result:
        ...

    @abc.abstractmethod
    def rq4a_detection_trend(self, arrays: StudyArrays, limit_date_ns: int,
                             g1_idx: np.ndarray, g2_idx: np.ndarray,
                             min_projects: int) -> RQ4aTrendResult:
        ...

    @abc.abstractmethod
    def rq4b_group_trends(self, arrays: StudyArrays, limit_date_ns: int,
                          g1_idx: np.ndarray, g2_idx: np.ndarray,
                          percentiles: tuple = (25, 50, 75)
                          ) -> RQ4bTrendsResult:
        ...

    def rq_suite(self, arrays: StudyArrays, limit_date_ns: int,
                 min_projects: int, g1_idx: np.ndarray, g2_idx: np.ndarray,
                 percentiles: tuple = (25, 50, 75)) -> dict:
        """All six RQs over one study: {'rq1', 'rq2cp', 'rq2tr', 'rq3',
        'rq4a', 'rq4b'} -> result objects.  Default: six sequential calls.
        ``TorchBackend`` overrides this with one fused pass on the card and
        one packed fetch (torch_backend._rq_suite_body)."""
        return {
            "rq1": self.rq1_detection(arrays, limit_date_ns, min_projects),
            "rq2cp": self.rq2_change_points(arrays, limit_date_ns),
            "rq2tr": self.rq2_trends(arrays, limit_date_ns),
            "rq3": self.rq3_coverage_at_detection(arrays, limit_date_ns),
            "rq4a": self.rq4a_detection_trend(arrays, limit_date_ns,
                                              g1_idx, g2_idx, min_projects),
            "rq4b": self.rq4b_group_trends(arrays, limit_date_ns,
                                           g1_idx, g2_idx, percentiles),
        }
