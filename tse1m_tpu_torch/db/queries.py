"""Parameterized queries of the RQ path and ``stats``: copies of
``tse1m_tpu/db/queries.py``'s ``count_projects`` (:47),
``eligible_projects`` (:56), the four bulk fetches
(``all_fuzzing_builds_bulk`` :88, ``coverage_builds_bulk`` :111,
``total_coverage_bulk`` :215, ``issues_bulk`` :232), RQ1's diagnostic
``issues_without_matching_build`` (:161) and ``severity_issues`` (:181).
Every builder returns ``(sql, params)`` with ``?`` placeholders; values
are always bound, never interpolated.
"""

from __future__ import annotations

from typing import Sequence

from ..config import DEFAULT_LIMIT_DATE, FIXED_STATUSES, RESULT_OK

Query = tuple[str, tuple]


def _in(values: Sequence[str]) -> str:
    # An empty target set becomes a never-matching one-element list, as
    # in the JAX package (portable to Postgres, where `IN ()` is an error).
    if not values:
        return "(NULL)"
    return "(" + ",".join("?" * len(values)) + ")"


def count_projects() -> Query:
    # queries1.py:6-11
    return (
        "SELECT project_name, COUNT(*) AS frequency FROM projects "
        "GROUP BY project_name ORDER BY frequency DESC",
        (),
    )


def eligible_projects(min_days: int = 365,
                      limit_date: str = DEFAULT_LIMIT_DATE) -> Query:
    """Projects with >= min_days non-zero coverage days before limit_date
    (rq1_detection_rate.py:144-151)."""
    return (
        "SELECT project FROM total_coverage "
        "WHERE coverage IS NOT NULL AND coverage > 0 AND date < ? "
        "GROUP BY project HAVING COUNT(*) >= ? "
        "ORDER BY project",
        (limit_date, min_days),
    )


def all_fuzzing_builds_bulk(targets: Sequence[str]) -> Query:
    return (
        "SELECT project, name, timecreated, result, modules, revisions "
        "FROM buildlog_data "
        f"WHERE build_type = 'Fuzzing' AND project IN {_in(targets)} "
        "ORDER BY project, timecreated",
        tuple(targets),
    )


def coverage_builds_bulk(targets: Sequence[str]) -> Query:
    """Every coverage build with its result (RQ3 needs the first build
    after an issue whatever its result); no name column (no RQ reads it)."""
    return (
        "SELECT project, timecreated, modules, revisions, result "
        "FROM buildlog_data "
        f"WHERE build_type = 'Coverage' AND project IN {_in(targets)} "
        "ORDER BY project, timecreated",
        tuple(targets),
    )


def issues_without_matching_build(targets: Sequence[str],
                                  limit_date: str = DEFAULT_LIMIT_DATE
                                  ) -> Query:
    # queries1.py:280-314
    sql = (
        "SELECT i.project, i.number, i.rts, p.first_commit_datetime, "
        "i.new_id\n"
        "FROM issues i JOIN project_info p ON i.project = p.project\n"
        f"WHERE i.status IN {_in(FIXED_STATUSES)}\n"
        f"  AND i.project IN {_in(targets)}\n"
        "  AND NOT EXISTS (\n"
        "    SELECT 1 FROM buildlog_data bd\n"
        "    WHERE bd.project = i.project AND i.rts > bd.timecreated\n"
        "      AND bd.build_type = 'Fuzzing'\n"
        f"      AND bd.result IN {_in(RESULT_OK)}\n"
        "      AND bd.timecreated < ?\n"
        "  )\n"
        "ORDER BY i.project ASC, i.rts ASC"
    )
    return sql, (*FIXED_STATUSES, *targets, *RESULT_OK, limit_date)


def severity_issues(severity: str, targets: Sequence[str], dialect: str,
                    limit_date: str = DEFAULT_LIMIT_DATE) -> Query:
    """Issues of a severity with at least one non-null regressed build
    (queries1.py:104-118; unnest on Postgres, json_each on sqlite)."""
    if dialect == "postgres":
        exists = ("EXISTS (SELECT 1 FROM unnest(regressed_build) AS b "
                  "WHERE b IS NOT NULL)")
    else:
        exists = ("regressed_build IS NOT NULL AND EXISTS ("
                  "SELECT 1 FROM json_each(regressed_build) "
                  "WHERE json_each.value IS NOT NULL)")
    return (
        "SELECT project, rts, regressed_build, severity FROM issues "
        f"WHERE project IN {_in(targets)} AND rts < ? AND severity = ? "
        f"AND {exists} "
        "ORDER BY project, rts, number",
        (*targets, limit_date, severity),
    )


def total_coverage_bulk(targets: Sequence[str],
                        limit_date: str = DEFAULT_LIMIT_DATE) -> Query:
    """All coverage rows before ``limit_date``, unfiltered (callers pass
    the cutoff + 1 day where RQ3 reads the boundary day)."""
    return (
        "SELECT project, date, coverage, covered_line, total_line "
        "FROM total_coverage "
        f"WHERE project IN {_in(targets)} AND date < ? "
        "ORDER BY project, date",
        (*targets, limit_date),
    )


def issues_bulk(targets: Sequence[str], limit_date: str = DEFAULT_LIMIT_DATE,
                fixed_only: bool = True) -> Query:
    sql = (
        "SELECT project, number, rts, status, crash_type, severity "
        "FROM issues "
        f"WHERE project IN {_in(targets)} AND rts < ? "
    )
    params: tuple = (*targets, limit_date)
    if fixed_only:
        sql += f"AND status IN {_in(FIXED_STATUSES)} "
        params += FIXED_STATUSES
    sql += "ORDER BY project, rts, number"
    return sql, params


__all__ = ["all_fuzzing_builds_bulk", "count_projects",
           "coverage_builds_bulk", "eligible_projects", "issues_bulk",
           "issues_without_matching_build", "severity_issues",
           "total_coverage_bulk"]
