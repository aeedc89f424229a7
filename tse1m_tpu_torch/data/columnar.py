"""Bulk columnar extraction: a study database -> per-project CSR arrays.

A port of ``tse1m_tpu/data/columnar.py``, in numpy instead of pandas.
Each table is fetched once, ordered by (project, time), and cut into
per-project segments with offset arrays, ready for
``backend/torch_backend.py``.

Decode specs of a fetched column: 'p' project -> code, 't' timestamp
-> int64 epoch nanoseconds, 'f' float64 (NULL -> NaN), 'c' dictionary
codes in first-appearance order with NULL as -1 (``CodedColumn``), 'b' a
lazy bytes arena (``BytesColumn``), 's'/'o' the stored objects.  A table
of an on-disk sqlite study goes through the native decoder
(``native/decode.cc``), of a Postgres study through its COPY-binary
decoder (``native/pg_decode.cc``); where the decoder is missing or its
strict parsers reject the data (a timestamp with a timezone suffix), that
table takes the numpy path, which gives the same arrays.
``StudyArrays.native_decode`` says whether all four tables went native.
``StudyArrays.from_db`` gives the arrays the JAX package's ``from_db``
gives on the same file (``tests/test_torch_rq_data.py``,
``tests/test_torch_native.py``).
"""

from __future__ import annotations

import datetime as _dt
import hashlib
import logging
import os
import warnings
from dataclasses import dataclass, field

import numpy as np

from .. import native
from ..config import RESULT_OK
from ..db import queries
from ..db.ingest import parse_array

log = logging.getLogger("tse1m_tpu_torch.columnar")

STUDY_EPOCH = np.datetime64("2015-01-01T00:00:00", "ns")


def _naive_utc(v):
    """A driver's datetime (Postgres rows) as naive UTC; text unchanged."""
    if isinstance(v, _dt.datetime) and v.tzinfo is not None:
        return v.astimezone(_dt.timezone.utc).replace(tzinfo=None)
    return v


def to_epoch_ns(values) -> np.ndarray:
    """Timestamps -> int64 epoch nanoseconds: ISO 8601 text (date-only or
    with a space or 'T' before the time), or a driver's dates and
    datetimes.  A timezone suffix converts to UTC, as the JAX package's
    pandas path does (the study's times are all UTC)."""
    vals = list(values)
    if vals and not isinstance(vals[0], str):
        vals = [_naive_utc(v) for v in vals]
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message="no explicit representation of timezones")
        return np.asarray(vals, dtype="datetime64[ns]").astype(np.int64)


def ns_to_device_s(ns: np.ndarray) -> np.ndarray:
    return ((ns - STUDY_EPOCH.astype(np.int64))
            // 1_000_000_000).astype(np.int32)


def ns_to_device_pair(ns: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Epoch ns -> (seconds since STUDY_EPOCH, ns remainder) int32 lanes:
    the JAX package's two-lane device time.  Floor division and modulo
    keep the pair's lexicographic order equal to the int64 order, which is
    why this package compares one int64 lane on the card instead."""
    rel = ns - STUDY_EPOCH.astype(np.int64)
    return ((rel // 1_000_000_000).astype(np.int32),
            (rel % 1_000_000_000).astype(np.int32))


def rev_hash(revisions: list[str]) -> np.int64:
    """Deterministic 63-bit hash of a revision list: RQ3's revision-set
    equality (rq3_diff_coverage_at_detection.py:280) becomes an integer
    comparison."""
    digest = hashlib.blake2b(
        ("\x1f".join(sorted(revisions))).encode(), digest_size=8
    ).digest()
    return np.int64(int.from_bytes(digest, "little") >> 1)


def _revhash_at(raw, idx, memo: dict | None = None) -> np.ndarray:
    """rev_hash of ``parse_array(raw[i])`` for each i in idx, each row
    hashed once through ``memo`` (row index -> hash)."""
    idx = np.asarray(idx, dtype=np.int64)
    if not idx.size:
        return np.empty(0, np.int64)
    uniq, inv = np.unique(idx, return_inverse=True)
    if memo is None:
        memo = {}
    hashes = np.empty(uniq.size, dtype=np.int64)
    for k, i in enumerate(uniq):
        key = int(i)
        h = memo.get(key)
        if h is None:
            h = memo[key] = rev_hash(parse_array(raw[key]))
        hashes[k] = h
    return hashes[inv]


def _offsets_from_sorted_codes(codes: np.ndarray,
                               n_segments: int) -> np.ndarray:
    return np.searchsorted(codes, np.arange(n_segments + 1)).astype(np.int64)


class CodedColumn:
    """Dictionary-encoded text column: int32 codes + object vocab, code -1
    = NULL.  Scalar indexing gives str | None; slice and fancy indexing
    give a CodedColumn over the same vocab."""

    __slots__ = ("codes", "vocab")

    def __init__(self, codes: np.ndarray, vocab: np.ndarray):
        self.codes = np.asarray(codes, dtype=np.int32)
        self.vocab = np.asarray(vocab, dtype=object)

    @classmethod
    def factorize(cls, vals) -> "CodedColumn":
        """Codes in order of first appearance, None -> -1 (the order
        ``pd.factorize`` gives).  A driver's list cells (Postgres
        ``TEXT[]``) are coded as tuples."""
        if any(isinstance(v, list) for v in vals):
            vals = [tuple(v) if isinstance(v, list) else v for v in vals]
        uniq = [v for v in dict.fromkeys(vals) if v is not None]
        lookup = {v: i for i, v in enumerate(uniq)}
        lookup[None] = -1
        codes = np.fromiter(map(lookup.__getitem__, vals), dtype=np.int32,
                            count=len(vals))
        vocab = np.empty(len(uniq), dtype=object)
        vocab[:] = uniq
        return cls(codes, vocab)

    def __len__(self) -> int:
        return int(self.codes.size)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            c = int(self.codes[i])
            return None if c < 0 else self.vocab[c]
        return CodedColumn(self.codes[i], self.vocab)

    def materialize(self) -> np.ndarray:
        """Object-array form (None for NULL)."""
        padded = np.append(self.vocab, None)  # code -1 -> last slot
        return padded[self.codes]


class BytesColumn:
    """Lazy text column: one shared uint8 arena + per-row (start, len),
    len -1 = NULL.  Cells decode on scalar access; slice and fancy
    indexing share the arena."""

    __slots__ = ("arena", "starts", "lens")

    def __init__(self, arena: np.ndarray, starts: np.ndarray,
                 lens: np.ndarray):
        self.arena = np.asarray(arena, dtype=np.uint8)
        self.starts = np.asarray(starts, dtype=np.int64)
        self.lens = np.asarray(lens, dtype=np.int32)

    @classmethod
    def from_objects(cls, vals) -> "BytesColumn":
        """From str | None cells."""
        n = len(vals)
        joined = "".join(vals) if None not in vals else None
        arena = joined.encode("utf-8") if joined is not None else b""
        if joined is not None and len(arena) == len(joined):
            # Every cell ASCII and present: byte lengths are str lengths.
            lens = np.fromiter(map(len, vals), dtype=np.int64, count=n)
            null = np.zeros(n, dtype=bool)
        else:
            enc = [b"" if v is None else v.encode("utf-8") for v in vals]
            arena = b"".join(enc)
            lens = np.fromiter(map(len, enc), dtype=np.int64, count=n)
            null = np.fromiter((v is None for v in vals), dtype=bool,
                               count=n)
        starts = np.zeros(n, np.int64)
        np.cumsum(lens[:-1], out=starts[1:])
        starts[null] = 0  # NULL cells: (0, -1), as the JAX package
        lens[null] = -1
        return cls(np.frombuffer(arena, dtype=np.uint8), starts, lens)

    def __len__(self) -> int:
        return int(self.starts.size)

    def __getitem__(self, i):
        if isinstance(i, (int, np.integer)):
            ln = int(self.lens[i])
            if ln < 0:
                return None
            s = int(self.starts[i])
            return self.arena[s:s + ln].tobytes().decode("utf-8")
        return BytesColumn(self.arena, self.starts[i], self.lens[i])

    def materialize(self) -> np.ndarray:
        return np.array([self[i] for i in range(len(self))], dtype=object)


@dataclass
class Segmented:
    """One table's per-project CSR view."""

    offsets: np.ndarray  # [P+1] int64
    columns: dict = field(default_factory=dict)

    def segment(self, p: int) -> dict:
        """Project ``p``'s rows of every column: numpy slices, and
        ``CodedColumn`` / ``BytesColumn`` views over the same vocab or
        arena."""
        lo, hi = self.offsets[p], self.offsets[p + 1]
        return {k: v[lo:hi] for k, v in self.columns.items()}

    def counts(self) -> np.ndarray:
        return np.diff(self.offsets)

    def __len__(self) -> int:
        return int(self.offsets[-1])


def masked_csr(offsets: np.ndarray, mask: np.ndarray):
    """Filter a CSR view by a row mask: (original row indices of the kept
    rows, new per-segment offsets); empty segments stay empty."""
    pos = np.flatnonzero(mask)
    running = np.concatenate([[0], np.cumsum(mask.astype(np.int64))])
    return pos, running[offsets]


def _native_db_path(db) -> str | None:
    """The file the native sqlite decoder opens (read-only, its own
    connection), or None: not sqlite, in memory, or not on disk."""
    if getattr(db, "dialect", None) != "sqlite":
        return None
    path = getattr(db.config, "sqlite_path", None)
    if not path or path == ":memory:" or not os.path.exists(path):
        return None
    return path


def _native_pg_conninfo(db) -> str | None:
    """libpq conninfo of the native Postgres decoder (its own
    connection), or None off Postgres."""
    if getattr(db, "dialect", None) != "postgres":
        return None
    from ..db import pglib

    pg = db.config.postgres
    return pglib.conninfo(pg.database, pg.user, pg.password, pg.host,
                          pg.port)


def _inline_params(sql: str, params) -> str:
    """qmark SQL + params -> literal SQL (a COPY statement takes no
    parameters).  Values are the study's own strings and numbers; strings
    escape by ''-doubling.  The query builders put no literal '?' in SQL
    text, so the split is exact."""
    parts = sql.split("?")
    if len(parts) != len(params) + 1:
        raise ValueError("placeholder/param count mismatch")
    out = [parts[0]]
    for p, nxt in zip(params, parts[1:]):
        if p is None:
            lit = "NULL"
        elif isinstance(p, (int, float)):
            lit = str(p)
        else:
            lit = "'" + str(p).replace("'", "''") + "'"
        out.append(lit)
        out.append(nxt)
    return "".join(out)


def _pg_copy_sql(sql: str, params, spec: str) -> str:
    """A bulk query wrapped in ``COPY ... TO STDOUT (FORMAT binary)``, its
    columns aliased by position and the text-spec'd ones cast ``::text``,
    so array columns arrive in their Postgres literal form."""
    inner = _inline_params(sql, params)
    alias = ", ".join(f'"c{i}"' for i in range(len(spec)))
    sel = ", ".join(f'q."c{i}"::text' if sp in "pscubo" else f'q."c{i}"'
                    for i, sp in enumerate(spec))
    return (f"COPY (SELECT {sel} FROM ({inner}) AS q({alias})) "
            "TO STDOUT (FORMAT binary)")


def _fetch_native(db, sql: str, params, spec: str, projects: list):
    """The native decoder's columns of one bulk query, or None when the
    decoder is missing, the database is not one it reads, or its strict
    parsers reject the data."""
    try:
        path = _native_db_path(db)
        if path is not None:
            return native.fetch_table(path, sql, params, spec, projects)
        conninfo = _native_pg_conninfo(db)
        if conninfo is not None:
            return native.fetch_table_pg(
                conninfo, _pg_copy_sql(sql, params, spec), spec, projects)
    except RuntimeError as e:
        log.info("native decode fell back to numpy: %s", e)
    return None


def _by_project(out: dict, key: str) -> tuple[dict, np.ndarray]:
    """Columns stably re-sorted by project code (SQL's collation may order
    project names otherwise than Python; the stable sort keeps SQL's time
    order within a project)."""
    codes = out.pop(key).astype(np.int64, copy=False)
    order = np.argsort(codes, kind="stable")
    return {c: v[order] for c, v in out.items()}, codes[order]


def _fetch(db, sql: str, params, cols: list, spec: str,
           pidx: dict) -> tuple[dict, np.ndarray]:
    """One bulk query through the driver -> ({col: array}, project codes)
    sorted by project code."""
    rows = db.query(sql, params)
    cells = list(zip(*rows)) if rows else [()] * len(cols)
    out = {}
    for c, sp, vals in zip(cols, spec, cells):
        if sp == "p":
            out[c] = np.fromiter(map(pidx.__getitem__, vals),
                                 dtype=np.int64, count=len(vals))
        elif sp == "t":
            out[c] = to_epoch_ns(vals)
        elif sp == "f":
            out[c] = np.array([np.nan if v is None else v for v in vals],
                              dtype=np.float64)
        elif sp == "c":
            out[c] = CodedColumn.factorize(vals)
        elif sp == "b" and all(v is None or isinstance(v, str)
                               for v in vals):
            out[c] = BytesColumn.from_objects(vals)
        else:
            # 's', 'o', and a driver's list cells in a 'b' column.
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
            out[c] = arr
    return _by_project(out, cols[0])


def _from_native(raw: tuple, cols: list, spec: str) -> tuple[dict,
                                                              np.ndarray]:
    out = {}
    for c, sp, v in zip(cols, spec, raw):
        if sp == "c":
            out[c] = CodedColumn(*v)
        elif sp == "b":
            out[c] = BytesColumn(*v)
        else:
            out[c] = v
    return _by_project(out, cols[0])


def _ok_mask(result_col: CodedColumn) -> np.ndarray:
    ok_vocab = np.isin(result_col.vocab, list(RESULT_OK))
    c = result_col.codes
    good = np.zeros(c.size, dtype=bool)
    valid = c >= 0
    good[valid] = ok_vocab[c[valid]]
    return good


@dataclass
class StudyArrays:
    projects: list
    fuzz: Segmented    # time_ns, name, result, ok, modules_raw, revisions_raw
    covb: Segmented    # time_ns, result, ok, modules_raw, revisions_raw,
    #                    grouphash
    issues: Segmented  # time_ns, number, status, crash_type
    cov: Segmented     # date_ns, coverage, covered, total
    # True when all four tables went through the native decoder.
    native_decode: bool = False

    @property
    def n_projects(self) -> int:
        return len(self.projects)

    def project_index(self) -> dict:
        return {p: i for i, p in enumerate(self.projects)}

    @classmethod
    def from_db(cls, db, cfg, projects: list | None = None
                ) -> "StudyArrays":
        """Extract the study of ``projects`` (default: the eligible ones
        under ``cfg.min_coverage_days`` and ``cfg.limit_date``) from an
        open ``DB``, each table through the native decoder where it
        applies, else through the driver and numpy."""
        if projects is None:
            sql, params = queries.eligible_projects(cfg.min_coverage_days,
                                                    cfg.limit_date)
            projects = [r[0] for r in db.query(sql, params)]
        projects = sorted(projects)
        pidx = {p: i for i, p in enumerate(projects)}
        n = len(projects)
        plus1 = str(np.datetime64(cfg.limit_date) + np.timedelta64(1, "D"))
        n_native = 0

        def fetch(query, cols: list, spec: str):
            nonlocal n_native
            raw = _fetch_native(db, *query, spec, projects)
            if raw is None:
                return _fetch(db, *query, cols, spec, pidx)
            n_native += 1
            return _from_native(raw, cols, spec)

        ftb, fcodes = fetch(
            queries.all_fuzzing_builds_bulk(projects),
            ["project", "name", "timecreated", "result", "modules",
             "revisions"], "pbtcbb")
        fuzz = Segmented(
            offsets=_offsets_from_sorted_codes(fcodes, n),
            columns={"time_ns": ftb["timecreated"], "name": ftb["name"],
                     "result": ftb["result"], "ok": _ok_mask(ftb["result"]),
                     "modules_raw": ftb["modules"],
                     "revisions_raw": ftb["revisions"]})

        # RQ2's group key: equality of the (modules, revisions) pair
        # (rq2_coverage_and_added.py:129), as one int64 of the two codes
        # (+1 folds NULL into its own group).
        ctb, ccodes = fetch(
            queries.coverage_builds_bulk(projects),
            ["project", "timecreated", "modules", "revisions", "result"],
            "ptccc")
        if len(ccodes):
            cm = ctb["modules"].codes.astype(np.int64) + 1
            cr = ctb["revisions"].codes.astype(np.int64) + 1
            ghash = cm * (int(cr.max()) + 1) + cr
        else:
            ghash = np.empty(0, np.int64)
        covb = Segmented(
            offsets=_offsets_from_sorted_codes(ccodes, n),
            columns={"time_ns": ctb["timecreated"], "result": ctb["result"],
                     "ok": _ok_mask(ctb["result"]),
                     "modules_raw": ctb["modules"],
                     "revisions_raw": ctb["revisions"],
                     "grouphash": ghash})

        itb, icodes = fetch(
            queries.issues_bulk(projects, cfg.limit_date, fixed_only=True),
            ["project", "number", "rts", "status", "crash_type",
             "severity"], "potsss")
        issues = Segmented(
            offsets=_offsets_from_sorted_codes(icodes, n),
            columns={"time_ns": itb["rts"], "number": itb["number"],
                     "status": itb["status"],
                     "crash_type": itb["crash_type"]})

        # Daily coverage up to the cutoff + 1 day: RQ3 reads the boundary
        # day (rq3:263); every other reader masks back to the cutoff.
        vtb, vcodes = fetch(
            queries.total_coverage_bulk(projects, plus1),
            ["project", "date", "coverage", "covered", "total"], "ptfff")
        cov = Segmented(
            offsets=_offsets_from_sorted_codes(vcodes, n),
            columns={"date_ns": vtb["date"], "coverage": vtb["coverage"],
                     "covered": vtb["covered"], "total": vtb["total"]})
        return cls(projects=projects, fuzz=fuzz, covb=covb, issues=issues,
                   cov=cov, native_decode=n_native == 4)

    def fuzz_revhash_at(self, idx: np.ndarray) -> np.ndarray:
        """Revision-set hashes of the given fuzz rows, memoised per row."""
        if not hasattr(self, "_fuzz_revhash_memo"):
            self._fuzz_revhash_memo: dict = {}
        return _revhash_at(self.fuzz.columns["revisions_raw"], idx,
                           self._fuzz_revhash_memo)

    def covb_revhash_at(self, idx: np.ndarray) -> np.ndarray:
        """Revision-set hashes of the given coverage-build rows."""
        if not hasattr(self, "_covb_revhash_memo"):
            self._covb_revhash_memo: dict = {}
        return _revhash_at(self.covb.columns["revisions_raw"], idx,
                           self._covb_revhash_memo)


def study_arrays_from_numpy(fields: dict) -> StudyArrays:
    """A StudyArrays from plain arrays: ``fields["projects"]`` a list and,
    for each of "fuzz", "covb", "issues" and "cov", ``{"offsets": [P+1]
    int64, "columns": {name: array}}`` with the columns ``from_db`` gives
    (text columns as object arrays).  Carries another extraction, such as
    the JAX package's, into this package unchanged."""
    tables = {
        name: Segmented(
            offsets=np.asarray(fields[name]["offsets"], dtype=np.int64),
            columns={k: np.asarray(v)
                     for k, v in fields[name]["columns"].items()})
        for name in ("fuzz", "covb", "issues", "cov")}
    return StudyArrays(projects=list(fields["projects"]), **tables)


__all__ = ["BytesColumn", "CodedColumn", "STUDY_EPOCH", "Segmented",
           "StudyArrays", "masked_csr", "ns_to_device_pair",
           "ns_to_device_s", "rev_hash", "study_arrays_from_numpy",
           "to_epoch_ns"]
