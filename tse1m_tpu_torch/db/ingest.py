"""CSV -> study database: a copy of ``tse1m_tpu/db/ingest.py`` (result
canonicalisation, array literals, the four table loaders, the derived
``projects`` table and ``ingest_csv_dir``, the directory walk over the
collectors' ``<table>.csv`` files).

Each loader writes its table with one ``executeMany``, an upsert: a
re-ingested, corrected CSV updates its rows (``INSERT OR REPLACE`` on
sqlite, ``ON CONFLICT ... DO UPDATE`` on Postgres).  Array cells (``{a,b}``
or JSON) are stored as JSON text on sqlite and as ``TEXT[]`` on Postgres;
``load_buildlog_data`` converts each distinct raw cell once, since a
study repeats its modules and revisions across thousands of builds.
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Iterable, Sequence

from .ident import col_list, quote_ident
from .schema import create_schema

log = logging.getLogger("tse1m_tpu_torch.ingest")

# The reference's analyzer emits {Success, Error, Unknown}
# (4_get_buildlog_analysis.py:230-237) while the DB and every query use
# {Finish, Halfway, Error} (queries1.py:4): canonicalise at the door.
_RESULT_CANON = {"Success": "Finish", "success": "Finish"}


def canon_result(value: str | None) -> str:
    if value is None:
        return "Unknown"
    return _RESULT_CANON.get(value, value)


def _split_pg_array(body: str) -> list[str]:
    """Tokenise the body of a Postgres array literal, honouring
    double-quoted items (kept verbatim, empty ones included) and backslash
    escapes; unquoted tokens are stripped and dropped when empty."""
    if '"' not in body:
        # No quoted item: the comma-split tokens, stripped, empty dropped.
        return [t for t in (t.strip() for t in body.split(",")) if t]
    items: list[tuple[str, bool]] = []
    buf: list[str] = []
    in_quotes = False
    was_quoted = False
    i = 0
    while i < len(body):
        c = body[i]
        if in_quotes:
            if c == "\\" and i + 1 < len(body):
                buf.append(body[i + 1])
                i += 2
                continue
            if c == '"':
                in_quotes = False
            else:
                buf.append(c)
        elif c == '"':
            in_quotes = True
            was_quoted = True
        elif c == ",":
            items.append(("".join(buf), was_quoted))
            buf = []
            was_quoted = False
        else:
            buf.append(c)
        i += 1
    if buf or was_quoted or items:
        items.append(("".join(buf), was_quoted))
    out: list[str] = []
    for text, quoted in items:
        if quoted:
            out.append(text)
        else:
            text = text.strip()
            if text:
                out.append(text)
    return out


def parse_array(value) -> list[str]:
    """Accept '{a,b}' (with optional quoted items), '["a","b"]', a Python
    list, '' or None."""
    if value is None or (isinstance(value, float) and value != value):
        return []
    if isinstance(value, (list, tuple)):
        return [str(v) for v in value]
    s = str(value).strip()
    if not s or s in ("{}", "[]"):
        return []
    if s.startswith("{") and s.endswith("}"):
        return _split_pg_array(s[1:-1])
    if s.startswith("["):
        return [str(v) for v in json.loads(s)]
    return [s]


def pg_array_literal(items: Sequence[str]) -> str:
    """The Postgres literal form, quoting items that contain delimiters so
    that parse_array and Postgres round-trip them losslessly."""
    out = []
    for item in items:
        s = str(item)
        if s == "" or s != s.strip() or any(
                c in s for c in ',{}" \\') or not s.isprintable():
            s = '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'
        out.append(s)
    return "{" + ",".join(out) + "}"


def store_array(db, items: Sequence[str]):
    """Storage form of an array cell: a list on Postgres, JSON text on
    sqlite."""
    if db.dialect == "postgres":
        return list(items)
    return json.dumps(list(items))


def _read_csv(path: str) -> Iterable[dict]:
    with open(path, newline="", encoding="utf-8") as f:
        yield from csv.DictReader(f)


def _upsert_sql(db, table: str, cols: Sequence[str],
                conflict: Sequence[str]) -> str:
    """Last-write-wins insert in the connection's dialect; names pass the
    identifier validator."""
    qs = ",".join("?" * len(cols))
    if db.dialect == "sqlite":
        return (f"INSERT OR REPLACE INTO {quote_ident(table)} "
                f"({col_list(cols)}) VALUES ({qs})")
    updates = ", ".join(f"{quote_ident(c)} = EXCLUDED.{quote_ident(c)}"
                        for c in cols if c not in conflict)
    return (f"INSERT INTO {quote_ident(table)} ({col_list(cols)}) "
            f"VALUES ({qs}) "
            f"ON CONFLICT ({col_list(conflict)}) DO UPDATE SET {updates}")


_INFO_COLS = ("project", "first_commit_datetime", "language", "homepage",
              "main_repo", "primary_contact")


def load_project_info(db, rows: Iterable[dict]) -> int:
    batch = []
    for r in rows:
        yaml_keys = {k: v for k, v in r.items() if k not in _INFO_COLS}
        batch.append((r["project"], r.get("first_commit_datetime"),
                      r.get("language"), r.get("homepage"),
                      r.get("main_repo"), r.get("primary_contact"),
                      json.dumps(yaml_keys) if yaml_keys else None))
    db.executeMany(_upsert_sql(db, "project_info",
                               _INFO_COLS + ("yaml_json",), ("project",)),
                   batch)
    return len(batch)


def load_buildlog_data(db, rows: Iterable[dict]) -> int:
    stored: dict = {}

    def array_cell(raw):
        # Memoised by the raw cell: parse_array is a pure function of it.
        if not isinstance(raw, str):
            return store_array(db, parse_array(raw))
        out = stored.get(raw)
        if out is None:
            out = stored[raw] = store_array(db, parse_array(raw))
        return out

    batch = [(r["name"], r["project"], r["timecreated"], r["build_type"],
              canon_result(r.get("result")), array_cell(r.get("modules")),
              array_cell(r.get("revisions"))) for r in rows]
    db.executeMany(_upsert_sql(db, "buildlog_data",
                               ("name", "project", "timecreated",
                                "build_type", "result", "modules",
                                "revisions"), ("name",)),
                   batch)
    return len(batch)


def load_total_coverage(db, rows: Iterable[dict]) -> int:
    def _f(v):
        if v is None or v == "":
            return None
        return float(v)

    batch = [(r["project"], r["date"], _f(r.get("coverage")),
              _f(r.get("covered_line")), _f(r.get("total_line")))
             for r in rows]
    db.executeMany(_upsert_sql(db, "total_coverage",
                               ("project", "date", "coverage",
                                "covered_line", "total_line"),
                               ("project", "date")),
                   batch)
    return len(batch)


def load_issues(db, rows: Iterable[dict]) -> int:
    batch = [(r["project"], str(r["number"]), r["rts"], r.get("status"),
              r.get("crash_type"), r.get("severity"), r.get("type"),
              store_array(db, parse_array(r.get("regressed_build"))),
              r.get("new_id")) for r in rows]
    db.executeMany(_upsert_sql(db, "issues",
                               ("project", "number", "rts", "status",
                                "crash_type", "severity", "type",
                                "regressed_build", "new_id"),
                               ("project", "number")),
                   batch)
    return len(batch)


_LOADERS = {
    "project_info": load_project_info,
    "buildlog_data": load_buildlog_data,
    "total_coverage": load_total_coverage,
    "issues": load_issues,
}


def ingest_csv_dir(db, csv_dir: str) -> dict:
    """Load every recognised CSV in ``csv_dir`` (``<table>.csv``) into the
    schema (created if absent), then derive ``projects``.  Returns the
    rows read per table."""
    create_schema(db)
    counts: dict = {}
    for table, loader in _LOADERS.items():
        path = os.path.join(csv_dir, f"{table}.csv")
        if os.path.exists(path):
            counts[table] = loader(db, _read_csv(path))
            log.info("loaded %-16s %8d rows from %s", table, counts[table],
                     path)
    derive_projects(db)
    return counts


def derive_projects(db) -> None:
    """Rebuild the count-only ``projects`` table (queries1.py:6-11) from
    the build rows, DELETE and INSERT in one transaction."""

    def _rebuild(dbx) -> None:
        dbx.execute("DELETE FROM projects")
        dbx.execute("INSERT INTO projects (project_name) "
                    "SELECT project FROM buildlog_data")

    db.run_transaction(_rebuild, site="db.derive_projects")


__all__ = ["canon_result", "derive_projects", "ingest_csv_dir",
           "load_buildlog_data", "load_issues", "load_project_info",
           "load_total_coverage", "parse_array", "pg_array_literal",
           "store_array"]
