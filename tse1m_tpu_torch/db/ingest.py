"""Row loaders of the study tables, sqlite only: a copy of
``tse1m_tpu/db/ingest.py:37-264`` (result canonicalisation, array
literals, the four table loaders and the derived ``projects`` table).

Each loader writes its table with one ``executemany`` in one transaction
where the JAX package goes through its retried statement layer; the rows
stored are the same.  Array cells (``{a,b}`` or JSON) are stored as JSON
text; ``load_buildlog_data`` converts each distinct raw cell once, since
a study repeats its modules and revisions across thousands of builds.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

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


def store_array(items: Sequence[str]) -> str:
    """sqlite storage form of an array cell: JSON text."""
    return json.dumps(list(items))


def _upsert_sql(table: str, cols: Sequence[str]) -> str:
    """Last-write-wins insert, as the JAX package's sqlite upsert."""
    qs = ",".join("?" * len(cols))
    return (f"INSERT OR REPLACE INTO {table} ({', '.join(cols)}) "
            f"VALUES ({qs})")


def _write(db, table: str, cols: Sequence[str], rows: list) -> int:
    with db.transaction():
        db.executemany(_upsert_sql(table, cols), rows)
    return len(rows)


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
    return _write(db, "project_info", _INFO_COLS + ("yaml_json",), batch)


def load_buildlog_data(db, rows: Iterable[dict]) -> int:
    stored: dict = {}

    def array_cell(raw):
        # Memoised by the raw cell: parse_array is a pure function of it.
        key = raw if isinstance(raw, str) else None
        if key is None:
            return store_array(parse_array(raw))
        out = stored.get(key)
        if out is None:
            out = stored[key] = store_array(parse_array(raw))
        return out

    batch = [(r["name"], r["project"], r["timecreated"], r["build_type"],
              canon_result(r.get("result")), array_cell(r.get("modules")),
              array_cell(r.get("revisions"))) for r in rows]
    return _write(db, "buildlog_data",
                  ("name", "project", "timecreated", "build_type", "result",
                   "modules", "revisions"), batch)


def load_total_coverage(db, rows: Iterable[dict]) -> int:
    def _f(v):
        if v is None or v == "":
            return None
        return float(v)

    batch = [(r["project"], r["date"], _f(r.get("coverage")),
              _f(r.get("covered_line")), _f(r.get("total_line")))
             for r in rows]
    return _write(db, "total_coverage",
                  ("project", "date", "coverage", "covered_line",
                   "total_line"), batch)


def load_issues(db, rows: Iterable[dict]) -> int:
    batch = [(r["project"], str(r["number"]), r["rts"], r.get("status"),
              r.get("crash_type"), r.get("severity"), r.get("type"),
              store_array(parse_array(r.get("regressed_build"))),
              r.get("new_id")) for r in rows]
    return _write(db, "issues",
                  ("project", "number", "rts", "status", "crash_type",
                   "severity", "type", "regressed_build", "new_id"), batch)


def derive_projects(db) -> None:
    """Rebuild the count-only ``projects`` table (queries1.py:6-11) from
    the build rows, DELETE and INSERT in one transaction."""
    with db.transaction():
        db.execute("DELETE FROM projects")
        db.execute("INSERT INTO projects (project_name) "
                   "SELECT project FROM buildlog_data")


__all__ = ["canon_result", "derive_projects", "load_buildlog_data",
           "load_issues", "load_project_info", "load_total_coverage",
           "parse_array", "pg_array_literal", "store_array"]
