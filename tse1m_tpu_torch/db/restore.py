"""Restore a SQL dump of the study database: a copy of
``tse1m_tpu/db/restore.py`` with one repair (the array cells, below).

The reference's canonical DB bootstrap is a pg_dump restored with
``psql -U user -d dbname < backup_clean.sql`` (reference README.md:55);
the dump itself is gitignored there (.gitignore:7) and absent from the
snapshot.  This module gives holders of the real dump a first-class path
into EITHER engine:

- pg_dump's default format carries data as COPY blocks::

      COPY public.buildlog_data (name, project, ...) FROM stdin;
      <tab-separated rows, \\N for NULL>
      \\.

  The restorer applies the canonical DDL (db/schema.py: the five-table
  schema with the Success/Finish enum unified) and streams
  each known table's COPY rows in as parameterized inserts.  pg_dump's
  DDL/SET/ALTER/sequence noise is skipped, so the same dump restores
  into sqlite and Postgres alike.
- ``INSERT INTO <study table> ...`` statements (pg_dump --inserts, or a
  hand-written fixture) execute as-is.

Array columns (modules/revisions/regressed_build) are stored as the
dialect stores them (db/schema.py): on Postgres as ``TEXT[]`` from their
literal form (``{a,b}``), on sqlite as JSON text, as ingest stores them.
The JAX package keeps the literal form on sqlite, where the JSON
functions of the study's queries (``severity_issues``'s ``json_each``)
then fail with "malformed JSON"; a cell already JSON stays as it is.  On
sqlite the coverage numbers of a COPY block are parsed by Python's
``float``, as ingest parses them: sqlite's own text-to-REAL conversion
(3.40) can land one unit in the last place off a long decimal.
"""

from __future__ import annotations

import json
import logging
import re

from .ident import col_list, quote_ident
from .ingest import _RESULT_CANON, derive_projects, parse_array
from .schema import SCHEMA_TABLES, create_schema

log = logging.getLogger("tse1m_tpu_torch.restore")

_COPY_RE = re.compile(
    r"^COPY\s+(?:[\w\"]+\.)?(\w+)\s*\(([^)]*)\)\s+FROM\s+stdin;\s*$",
    re.IGNORECASE)
_INSERT_RE = re.compile(r"^INSERT\s+INTO\s+(?:[\w\"]+\.)?(\w+)",
                        re.IGNORECASE)

# COPY text-format escapes (https://www.postgresql.org/docs/current/
# sql-copy.html#id-1.9.3.55.9.2) — the ones pg_dump emits.
_UNESCAPE = {"\\\\": "\\", "\\b": "\b", "\\f": "\f", "\\n": "\n",
             "\\r": "\r", "\\t": "\t", "\\v": "\v"}
_ESC_RE = re.compile(r"\\[\\bfnrtv]")


def _copy_cell(cell: str):
    if cell == "\\N":
        return None
    if "\\" in cell:
        cell = _ESC_RE.sub(lambda m: _UNESCAPE[m.group(0)], cell)
    return cell


# The array-valued and the REAL columns of the study tables.
_ARRAY_COLS = {"buildlog_data": ("modules", "revisions"),
               "issues": ("regressed_build",)}
_REAL_COLS = {"total_coverage": ("coverage", "covered_line", "total_line")}


def _real(cell):
    return None if cell is None else float(cell)


class _SqliteArrays:
    """Postgres array literals -> sqlite's JSON text, memoised by the raw
    cell (a study repeats its modules and revisions across many builds).
    NULL stays NULL, and JSON text stays as it is."""

    def __init__(self):
        self._memo: dict = {}

    def __call__(self, cell):
        if cell is None or not cell.startswith("{"):
            return cell
        out = self._memo.get(cell)
        if out is None:
            out = self._memo[cell] = json.dumps(parse_array(cell))
        return out

    def fix_table(self, db, table: str) -> None:
        """Convert the literal-form cells that INSERT statements stored."""
        for col in _ARRAY_COLS[table]:
            rows = db.query(f"SELECT rowid, {quote_ident(col)} FROM "
                            f"{quote_ident(table)} WHERE "
                            f"{quote_ident(col)} LIKE '{{%'")
            db.executeMany(f"UPDATE {quote_ident(table)} SET "
                           f"{quote_ident(col)} = ? WHERE rowid = ?",
                           [(self(v), rid) for rid, v in rows])


def _scan_quotes(text: str, in_string: bool) -> bool:
    """Track single-quote string state across a statement fragment so a
    ``;`` at a line end inside a text literal (pg_dump emits embedded
    newlines verbatim) doesn't terminate the statement early.  The SQL
    ``''`` escape toggles twice — a no-op, as required."""
    for ch in text:
        if ch == "'":
            in_string = not in_string
    return in_string


def restore_sql_dump(db, path: str, create: bool = True,
                     batch: int = 5000) -> dict:
    """Load ``path`` (pg_dump or INSERT-style SQL) into ``db``.

    Returns per-table inserted row counts.  Unknown tables and non-data
    statements are skipped (counted under ``"skipped_statements"``); the
    ``projects`` table is re-derived from buildlog rows when the dump
    doesn't carry it (db/ingest.derive_projects — it is derived data).
    """
    if create:
        create_schema(db)
    counts: dict = {t: 0 for t in SCHEMA_TABLES}
    skipped = 0
    arrays = _SqliteArrays() if db.dialect == "sqlite" else None
    inserted_arrays: set = set()  # tables INSERT statements wrote

    with open(path, encoding="utf-8") as f:
        in_copy = None  # (table, insert sql, pending rows, converters)
        stmt_parts: list = []
        in_string = False
        for raw in f:
            line = raw.rstrip("\n")
            if in_copy is not None:
                table, sql, rows, conv = in_copy
                if line == "\\.":
                    if rows:
                        db.executeMany(sql, rows)
                        counts[table] += len(rows)
                    in_copy = None
                    continue
                if sql is None:
                    continue  # data of an unknown table — skipped
                row = [_copy_cell(c) for c in line.split("\t")]
                for i, fn in conv:
                    row[i] = fn(row[i])
                rows.append(row)
                if len(rows) >= batch:
                    db.executeMany(sql, rows)
                    counts[table] += len(rows)
                    rows.clear()
                continue

            m = _COPY_RE.match(line)
            if m:
                table = m.group(1).lower()
                cols = [c.strip().strip('"') for c in m.group(2).split(",")]
                if table in counts:
                    # The COPY header is attacker-controlled text in a
                    # hostile dump; identifiers must validate before they
                    # touch SQL (db/ident.py).
                    ph = ", ".join("?" * len(cols))
                    sql = (f"INSERT INTO {quote_ident(table)} "
                           f"({col_list(cols)}) VALUES ({ph})")
                    # sqlite's storage forms, cell by cell (none on
                    # Postgres, which parses the text itself).
                    conv = [] if arrays is None else [
                        (i, arrays if c in _ARRAY_COLS.get(table, ())
                         else _real) for i, c in enumerate(cols)
                        if c in _ARRAY_COLS.get(table, ())
                        or c in _REAL_COLS.get(table, ())]
                    in_copy = (table, sql, [], conv)
                else:
                    log.info("restore: skipping COPY into unknown table %s",
                             table)
                    in_copy = ("__skip__", None, None, None)
                    counts.setdefault("__skip__", 0)
                continue

            # Accumulate ;-terminated statements (quote-aware: a ';' at a
            # line end inside a string literal doesn't end the statement);
            # execute only the study tables' INSERTs verbatim, drop
            # everything else (SET/CREATE/ALTER/...).
            stmt_parts.append(line)
            in_string = _scan_quotes(line, in_string)
            if not in_string and line.rstrip().endswith(";"):
                stmt = "\n".join(stmt_parts).strip()
                stmt_parts = []
                m = _INSERT_RE.match(stmt)
                if m and m.group(1).lower() in counts:
                    table = m.group(1).lower()
                    # rowcount, not statement count: pg_dump --inserts can
                    # pack many rows per VALUES list.  commit=True: each
                    # dump INSERT is its own unit, so a failure mid-stream
                    # loses no earlier row.
                    counts[table] += db.execute_raw(
                        stmt.rstrip(";").replace(f"public.{table}", table),
                        commit=True)
                    if table in _ARRAY_COLS:
                        inserted_arrays.add(table)
                elif stmt and not stmt.startswith("--"):
                    skipped += 1
    # A COPY block for a skipped table collects under "__skip__": drop it.
    counts.pop("__skip__", None)
    if arrays is not None:
        for table in sorted(inserted_arrays):
            arrays.fix_table(db, table)
    # Canonicalise the result enum at the door (db/ingest._RESULT_CANON):
    # a dump produced by the reference's analyzer carries 'Success' where
    # every analysis query filters ('Finish','Halfway') — left unmapped,
    # those sessions would silently vanish from every RQ.
    if counts.get("buildlog_data", 0):

        def _canon(dbx) -> None:
            for src, dst in _RESULT_CANON.items():
                dbx.execute("UPDATE buildlog_data SET result = ? "
                            "WHERE result = ?", (dst, src))

        db.run_transaction(_canon)
    if counts.get("projects", 0) == 0 and counts.get("buildlog_data", 0):
        derive_projects(db)
        counts["projects"] = db.count("SELECT * FROM projects", ())
    db.commit()
    counts["skipped_statements"] = skipped
    log.info("restore: %s", counts)
    return counts
