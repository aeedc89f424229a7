"""Adapters from collector outputs to the ``ingest_csv_dir`` table CSVs: a
port of ``tse1m_tpu/collect/normalize.py`` over ``collect/table.py``.

The reference never closes this loop — its collectors emit CSVs in
scraper-native shapes and the DB ships pre-built (SURVEY.md §1, "gap in
the reference").  These functions map each collector's output onto the
canonical table schemas of ``db/schema.py``:

- C6 analyzed batches       -> ``buildlog_data.csv``
- C7 merged issue records   -> ``issues.csv``
- C5 merged coverage rows   -> ``total_coverage.csv``
- C3 project rows           -> ``project_info.csv`` (already table-shaped)
"""

from __future__ import annotations

import json
import logging
import re
from datetime import date

from ..db.ingest import pg_array_literal
from . import table

log = logging.getLogger("tse1m_tpu_torch.collect.normalize")


def _json_cell(value):
    """Issue CSVs store every value JSON-encoded (5_…py:303)."""
    if table.is_na(value):
        return None
    if not isinstance(value, str):
        return value
    try:
        return json.loads(value)
    except (json.JSONDecodeError, TypeError):
        return value


def _str_column(values: list) -> table.Column:
    return table.Column(table.record_kind(values), values)


def buildlog_table_rows(analyzed: table.Table) -> table.Table:
    """C6 batch rows as buildlog_data.csv columns.  Arrays go out as
    Postgres literals, so the CSV round-trips through ``parse_array`` and
    matches the golden artifact format."""
    cols = ["name", "project", "timecreated", "build_type", "result",
            "modules", "revisions"]
    data = {"name": analyzed.data["id"]}
    for c in ("project", "timecreated", "build_type", "result"):
        data[c] = analyzed.data[c]
    for c in ("modules", "revisions"):
        data[c] = _str_column([pg_array_literal(_json_cell(v) or [])
                               for v in analyzed.col(c)])
    out = table.Table(cols, data, len(analyzed))
    # Rows whose log never revealed a project cannot join to anything.
    keep = [i for i, p in enumerate(out.col("project")) if p != ""]
    dropped = len(out) - len(keep)
    if dropped:
        log.warning("dropping %d buildlog rows with no project", dropped)
    return out.take(keep)


def _yyyymmdd(value) -> str | None:
    """``pd.to_datetime(v, format="%Y%m%d", errors="coerce")
    .strftime("%Y-%m-%d")``, None for NaT."""
    if table.is_na(value) or isinstance(value, bool):
        return None
    if isinstance(value, float):
        if not value.is_integer():
            return None
        value = int(value)
    s = str(value)
    if not re.fullmatch(r"\d{8}", s):
        return None
    try:
        return date(int(s[:4]), int(s[4:6]), int(s[6:])).strftime("%Y-%m-%d")
    except ValueError:
        return None


def coverage_table_rows(merged: table.Table) -> table.Table:
    """C5 merged rows as total_coverage.csv columns; the scrape-side
    ``exist`` flag is internal."""
    days = [_yyyymmdd(v) for v in merged.col("date")]
    return table.Table(
        ["project", "date", "coverage", "covered_line", "total_line"],
        {"project": merged.data["project"],
         "date": table.Column("str" if any(d is not None for d in days)
                              else "float", days),
         "coverage": merged.data["coverage"],
         "covered_line": merged.data["covered_line"],
         "total_line": merged.data["total_line"]}, len(merged))


def _severity(record: dict):
    """Tracker metadata Severity first, else the description's
    recommended security severity."""
    return (record.get("Severity")
            or record.get("Recommended Security Severity"))


def _flatten_revisions(value) -> list[str]:
    """regressed_revisions is a list of 1- or 2-element ranges
    (5_…py:113); the DB's regressed_build array stores the endpoints."""
    out: list[str] = []
    if isinstance(value, list):
        for item in value:
            if isinstance(item, list):
                out.extend(str(v) for v in item)
            else:
                out.append(str(item))
    elif value:
        out.append(str(value))
    return out


def issue_table_rows(merged: table.Table,
                     requested_ids: dict | None = None) -> table.Table:
    """C7 merged records (JSON-encoded cells) as issues.csv columns.

    ``number`` is the id the study targeted (Monorail numbering where one
    exists), ``new_id`` the tracker id the page resolved to;
    ``requested_ids`` maps a final id to the id requested, for redirected
    fetches."""
    requested_ids = requested_ids or {}
    rows = []
    for raw in merged.rows():
        rec = {k: _json_cell(v) for k, v in raw.items()}
        if rec.get("error"):
            continue
        final_id = str(rec.get("id", ""))
        project = rec.get("Project")
        rts = rec.get("reported_time") or rec.get("Metadata_Reported_Date")
        if not project or not rts:
            continue
        crash_type = rec.get("Crash Type")
        if isinstance(crash_type, list):
            crash_type = crash_type[0] if crash_type else None
        rows.append({
            "project": project,
            "number": str(requested_ids.get(final_id, final_id)),
            "rts": rts,
            "status": rec.get("Status"),
            "crash_type": crash_type,
            "severity": _severity(rec),
            "type": rec.get("Type"),
            "regressed_build": pg_array_literal(
                _flatten_revisions(rec.get("regressed_revisions"))),
            "new_id": final_id,
        })
    kept = table.from_records(rows, columns=[
        "project", "number", "rts", "status", "crash_type", "severity",
        "type", "regressed_build", "new_id"])
    log.info("normalized %d/%d issue records", len(kept), len(merged))
    return kept


__all__ = ["buildlog_table_rows", "coverage_table_rows", "issue_table_rows"]
