"""The collectors' CSVs without pandas: the one place that reads and writes
them, cell for cell as the JAX package's pandas round trips do.

The JAX collectors write through ``DataFrame(records).to_csv`` and merge
through ``read_csv -> concat -> to_csv``; the card's machine has no
pandas.  This module keeps a small typed table (:class:`Table`: named
columns, each a pandas-like kind and a list of Python values, ``None``
for a missing cell) and reproduces pandas' inference at each step:

- :func:`from_records` is ``DataFrame(records)``: a column of ints is
  ``int``, of ints and blanks ``float`` (written ``4.0``), of bools
  ``bool``, of bools and blanks ``object``, of strings ``str``.
- :func:`read_csv` is ``pd.read_csv`` with its defaults: ints, floats
  (``1e5`` reads as 100000.0), bools (``true``/``TRUE``/``True``) and
  blanks are typed as the C parser types them.
- :func:`concat` is ``pd.concat(..., ignore_index=True)``: the union of
  the columns in order of appearance, each column's kind promoted as
  pandas promotes it (an int column missing from one table becomes
  ``float``, a bool one ``object``).
- :func:`write_csv` is ``to_csv(index=False)``: floats as their shortest
  repr, bools as ``True``/``False``, blanks empty, quoting minimal.

Where pandas' reading would change what a value means, the text is kept
as written (a :class:`Verbatim` cell) and the column's other cells are
still written in pandas' form: the default NA strings other than the
empty one (``NA``, ``null``, ``nan``, ``N/A``, ``None`` and the rest,
which pandas empties) and integers whose text is not their canonical
form (``007``, ``+5``, ``-0``, which pandas reads as 7, 5 and 0).  With
``json_cells=True`` (the issue scraper's JSON-encoded cells) ``null`` and
``NaN`` are what JSON means by them, a missing value, and read as such.
"""

from __future__ import annotations

import csv
import math
import re
from dataclasses import dataclass, field
from datetime import date, datetime, timedelta, timezone

from ..utils.atomic import atomic_write

# pandas' default ``na_values`` (pandas/_libs/parsers.pyx STR_NA_VALUES).
NA_TOKENS = frozenset((
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null"))
# What JSON means by a missing value, in a JSON-encoded cell.
_JSON_NA = frozenset(("", "null", "NaN"))
_TRUE = frozenset(("True", "TRUE", "true"))
_FALSE = frozenset(("False", "FALSE", "false"))
_INT_RE = re.compile(r"^\s*[+-]?\d+\s*$")
_FLOAT_RE = re.compile(
    r"^\s*[+-]?(?:(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?|inf|infinity)\s*$",
    re.IGNORECASE)
_INT64_MAX = 2 ** 63 - 1
_UINT64_MAX = 2 ** 64 - 1

KINDS = ("int", "uint", "float", "bool", "str", "object", "datetime")


class Verbatim(str):
    """A cell kept as written where pandas would read another value: a
    non-empty NA string (``NA``, ``null``...) or an integer whose text is
    not canonical (``007``)."""


@dataclass
class Column:
    kind: str                       # one of KINDS
    values: list = field(default_factory=list)


@dataclass
class Table:
    """Named columns of equal length, in order."""

    columns: list = field(default_factory=list)
    data: dict = field(default_factory=dict)    # name -> Column
    n: int = 0

    def __len__(self) -> int:
        return self.n

    def __contains__(self, name) -> bool:
        return name in self.data

    def col(self, name: str) -> list:
        return self.data[name].values

    def kind(self, name: str) -> str:
        return self.data[name].kind

    def rows(self) -> list[dict]:
        """The rows as dicts in column order (``DataFrame.iterrows``)."""
        cols = [(c, self.data[c].values) for c in self.columns]
        return [{c: v[i] for c, v in cols} for i in range(self.n)]

    def take(self, idx: list[int]) -> "Table":
        """The rows at ``idx``, in that order."""
        return Table(list(self.columns),
                     {c: Column(col.kind, [col.values[i] for i in idx])
                      for c, col in self.data.items()}, len(idx))

    def select(self, columns: list[str]) -> "Table":
        return Table(list(columns), {c: self.data[c] for c in columns},
                     self.n)


def is_na(v) -> bool:
    """pandas' ``isna`` over the values this module holds."""
    return v is None or (isinstance(v, float) and math.isnan(v))


# -- inference -----------------------------------------------------------


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def record_kind(values: list) -> str:
    """``DataFrame(records)``'s dtype of one column."""
    present = [v for v in values if not is_na(v)]
    has_na = len(present) < len(values)
    if not present:
        return "float" if values and all(
            isinstance(v, float) for v in values) else "object"
    if all(isinstance(v, bool) for v in present):
        return "object" if has_na else "bool"
    if all(_is_int(v) for v in present):
        if has_na:
            return "float"
        if all(v <= _INT64_MAX for v in present):
            return "int" if all(v >= -_INT64_MAX - 1 for v in present) \
                else "object"
        return "uint" if all(0 <= v <= _UINT64_MAX for v in present) \
            else "object"
    if all(_is_int(v) or isinstance(v, float) for v in present):
        return "float"
    if all(isinstance(v, str) for v in present):
        return "str"
    if all(isinstance(v, datetime) and v.tzinfo is None for v in present):
        return "datetime"
    return "object"


def _coerce(kind: str, values: list) -> list:
    """The values as a column of ``kind`` holds them."""
    if kind == "float":
        return [v if isinstance(v, Verbatim) or v is None
                else (None if is_na(v) else float(v)) for v in values]
    if kind in ("int", "uint"):
        return [v if isinstance(v, Verbatim) or v is None else int(v)
                for v in values]
    return [None if (not isinstance(v, Verbatim) and is_na(v)) else v
            for v in values]


def from_records(records: list[dict], columns: list[str] | None = None
                 ) -> Table:
    """``pd.DataFrame(records[, columns=columns])``."""
    if columns is None:
        columns = []
        seen = set()
        for r in records:
            for k in r:
                if k not in seen:
                    seen.add(k)
                    columns.append(k)
    data = {}
    for c in columns:
        values = [r.get(c) for r in records]
        kind = record_kind(values)
        data[c] = Column(kind, _coerce(kind, values))
    return Table(list(columns), data, len(records))


def _read_kind(texts: list[str], json_cells: bool) -> tuple[str, list]:
    """The C parser's dtype of one column of CSV texts, and its values."""
    na = _JSON_NA if json_cells else NA_TOKENS
    values: list = [None] * len(texts)
    present = [(i, t) for i, t in enumerate(texts) if t not in na]
    for i, t in enumerate(texts):
        if t in na and t != "" and not json_cells:
            values[i] = Verbatim(t)  # pandas would empty it
    has_na = len(present) < len(texts)
    if not present:
        return "float", values
    if all(_INT_RE.match(t) for _, t in present):
        ints = [int(t) for _, t in present]
        lo, hi = min(ints), max(ints)
        if lo >= -_INT64_MAX - 1 and hi <= _INT64_MAX:
            kind = "float" if has_na else "int"
        elif lo >= 0 and hi <= _UINT64_MAX and not has_na:
            kind = "uint"
        elif lo >= 0 and hi <= _UINT64_MAX:
            # pandas keeps such a column as text, a blank as "".
            return "str", [t if t not in na or isinstance(v, Verbatim)
                           else (v if v is not None else "")
                           for t, v in zip(texts, values)]
        else:
            kind = "object"     # Python ints past 64 bits
        for (i, t), v in zip(present, ints):
            values[i] = v if t == str(v) else Verbatim(t)
        return kind, _coerce(kind, values)
    if all(_FLOAT_RE.match(t) for _, t in present):
        for i, t in present:
            values[i] = (Verbatim(t) if _INT_RE.match(t) and
                         t != str(int(t)) else float(t))
        return "float", values
    if all(t in _TRUE or t in _FALSE for _, t in present):
        for i, t in present:
            values[i] = t in _TRUE
        return ("object" if has_na else "bool"), values
    for i, t in present:
        values[i] = t
    return "str", values


def _mangle(header: list[str]) -> list[str]:
    """pandas' names for a header: blanks ``Unnamed: i``, repeats
    ``name.1``, ``name.2``..."""
    out: list[str] = []
    seen: dict = {}
    for i, h in enumerate(header):
        name = h if h != "" else f"Unnamed: {i}"
        if name in seen:
            k = seen[name]
            while f"{name}.{k}" in seen:
                k += 1
            seen[name] = k + 1
            name = f"{name}.{k}"
        seen.setdefault(name, 1)
        out.append(name)
    return out


def read_csv(path: str, json_cells: bool = False) -> Table:
    """``pd.read_csv(path)``.  Raises ValueError on an empty file or a
    row wider than the header, as pandas does."""
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse from file")
    header = _mangle(rows[0])
    body = rows[1:]
    width = len(header)
    cols: list[list[str]] = [[] for _ in range(width)]
    for r in body:
        if len(r) > width:
            raise ValueError(f"{path}: expected {width} fields, saw "
                             f"{len(r)}")
        r = r + [""] * (width - len(r))
        for j in range(width):
            cols[j].append(r[j])
    data = {}
    for name, texts in zip(header, cols):
        if not body:
            data[name] = Column("object", [])
            continue
        kind, values = _read_kind(texts, json_cells)
        data[name] = Column(kind, values)
    return Table(header, data, len(body))


# -- concat --------------------------------------------------------------

_NUMERIC = ("int", "uint", "float", "bool")


def _concat_kind(kinds: list[str], gaps: bool) -> str:
    """pandas 3's common dtype of one column over the tables holding it,
    in order.  With no table missing the column, its bool-with-number
    promotion depends on which table comes first; with one missing, a
    bool never mixes with a number."""
    s = set(kinds)
    if len(s) == 1:
        return kinds[0]
    if not s <= set(_NUMERIC):
        return "object"
    if "bool" in s and (gaps or not (kinds[0] == "float"
                                     or s <= {"bool", "int", "uint"})):
        return "object"
    if s <= {"bool", "int"}:
        return "int"
    if s <= {"bool", "uint"}:
        return "uint"
    return "float"     # numpy's promotion: int with uint or float


def concat(tables: list[Table]) -> Table:
    """``pd.concat(tables, ignore_index=True)``."""
    columns: list[str] = []
    for t in tables:
        columns += [c for c in t.columns if c not in columns]
    data = {}
    for c in columns:
        holders = [t for t in tables if c in t.data]
        gaps = len(holders) < len(tables)
        kind = _concat_kind([t.data[c].kind for t in holders], gaps)
        if gaps:
            kind = {"int": "float", "uint": "float",
                    "bool": "object"}.get(kind, kind)
        values: list = []
        for t in tables:
            values += t.data[c].values if c in t.data else [None] * t.n
        data[c] = Column(kind, _coerce(kind, values))
    return Table(columns, data, sum(t.n for t in tables))


# -- writing -------------------------------------------------------------


def cell_text(kind: str, v) -> str:
    """One cell as ``to_csv`` writes it."""
    if isinstance(v, Verbatim):
        return str(v)
    if is_na(v):
        return ""
    if kind == "float":
        return repr(float(v))
    return str(v)


def astype_str(kind: str, v) -> str:
    """One cell of ``Series.astype(str)``: a missing value is ``nan``."""
    if isinstance(v, Verbatim):
        return str(v)
    if is_na(v):
        return "nan"
    if kind == "float":
        return repr(float(v))
    return str(v)


def _datetime_texts(values: list) -> list:
    """A naive datetime64 column as ``to_csv`` writes it: dates alone
    when every time is midnight, microseconds when any has them."""
    present = [v for v in values if v is not None]
    if all(v.time() == datetime.min.time() for v in present):
        fmt = "%Y-%m-%d"
    elif any(v.microsecond for v in present):
        fmt = "%Y-%m-%d %H:%M:%S.%f"
    else:
        fmt = "%Y-%m-%d %H:%M:%S"
    return [None if v is None else Verbatim(v.strftime(fmt))
            for v in values]


def write_csv(table: Table, path: str) -> None:
    """``to_csv(path, index=False, encoding="utf-8")``, written to a temp
    file and renamed, so a crash never leaves a torn CSV."""
    cols = [(table.data[c].kind, _datetime_texts(table.data[c].values)
             if table.data[c].kind == "datetime" else table.data[c].values)
            for c in table.columns]
    with atomic_write(path, newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(table.columns)
        for i in range(table.n):
            w.writerow([cell_text(k, v[i]) for k, v in cols])


# -- dates ---------------------------------------------------------------

_ISO_RE = re.compile(
    r"^(\d{4})[-/](\d{1,2})[-/](\d{1,2})"
    r"(?:[T ](\d{1,2}):(\d{2})(?::(\d{2})(?:\.(\d{1,9}))?)?"
    r"\s*(Z|[+-]\d{2}:?\d{2})?)?$")


def parse_datetime(text) -> datetime | None:
    """One value as ``pd.to_datetime(..., format="mixed",
    errors="coerce")`` reads the forms the collectors write and meet:
    ``YYYYMMDD`` and ISO dates and date-times with an optional offset.
    None where pandas gives NaT."""
    if text is None:
        return None
    s = str(text).strip()
    try:
        if re.fullmatch(r"\d{8}", s):
            return datetime(int(s[:4]), int(s[4:6]), int(s[6:]))
        m = _ISO_RE.match(s)
        if m is None:
            return None
        y, mo, d, hh, mm, ss, frac, tz = m.groups()
        micro = int((frac or "0")[:6].ljust(6, "0"))
        out = datetime(int(y), int(mo), int(d), int(hh or 0), int(mm or 0),
                       int(ss or 0), micro)
    except ValueError:
        return None
    if tz:
        if tz == "Z":
            return out.replace(tzinfo=timezone.utc)
        sign = -1 if tz[0] == "-" else 1
        digits = tz[1:].replace(":", "")
        off = timedelta(hours=int(digits[:2]), minutes=int(digits[2:]))
        return out.replace(tzinfo=timezone(sign * off))
    return out


def max_date(texts: list[str]) -> date | None:
    """``pd.to_datetime(texts, errors="coerce", format="mixed").max()
    .date()``: None when no value parses.  Raises ValueError on mixed
    time zones, as pandas does."""
    parsed = [p for p in (parse_datetime(t) for t in texts) if p is not None]
    if not parsed:
        return None
    offsets = {p.utcoffset() for p in parsed}
    if len(offsets) > 1:
        raise ValueError("Mixed timezones detected. Pass utc=True in "
                         "to_datetime or tz='UTC' in DatetimeIndex to "
                         "convert to a common timezone.")
    return max(parsed).date()


def utc_date(value) -> date | None:
    """``pd.to_datetime(value, errors="coerce", utc=True).date()``: a
    naive time is taken as UTC; None where pandas gives NaT."""
    if is_na(value):
        return None
    p = parse_datetime(value)
    if p is None:
        return None
    if p.tzinfo is not None:
        p = p.astimezone(timezone.utc)
    return p.date()


__all__ = ["Column", "NA_TOKENS", "Table", "Verbatim", "astype_str",
           "cell_text", "concat", "from_records", "is_na", "max_date",
           "parse_datetime", "read_csv", "record_kind", "utc_date",
           "write_csv"]
