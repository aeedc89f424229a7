"""C5, the daily coverage-report collector (reference:
``3_get_coverage_data.py``): a port of ``tse1m_tpu/collect/coverage.py``.

For each supported project, walks day by day from its first-commit date,
fetching the OSS-Fuzz coverage report for that day and parsing the summary
row with language-specific rules (``3_…py:139-202``):

- C/C++/Rust/Swift: ``file_view_index.html``, totals row's "Line Coverage"
  cell, format ``"90.00% (180/200)"``;
- Python: ``index.html``, totals row's ``statements`` / ``missing`` columns;
- JVM: ``index.html``, totals row's ``Lines`` and second ``Missed`` columns
  (pandas would surface it as ``Missed_1``/``Missed.1``; here it is simply
  the second column named ``Missed``).

Tables are extracted with a stdlib ``html.parser`` state machine — no
bs4/lxml dependency — and each per-project CSV resumes from the day after
its last recorded date (``3_…py:255-267``).  A 404 means "no report today"
and is skipped silently (``3_…py:79-80``).  The per-project CSVs and their
merge go through ``collect/table.py``, byte for byte as the JAX package's
pandas round trips.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from dataclasses import dataclass
from datetime import date, timedelta
from html.parser import HTMLParser

from . import table
from .checkpoint import resume_start_date
from .transport import Fetcher

log = logging.getLogger("tse1m_tpu_torch.collect.coverage")

REPORT_URL_TEMPLATE = ("https://storage.googleapis.com/oss-fuzz-coverage/"
                       "{project}/reports/{day}/linux/")
C_FAMILY = ("c", "c++", "rust", "swift")
INDEX_FAMILY = ("go", "python", "jvm")
SUPPORTED_LANGUAGES = ("c", "c++", "rust", "swift", "python", "jvm")


class _TableParser(HTMLParser):
    """Collect every <table> as a list of rows of stripped cell texts."""

    def __init__(self):
        super().__init__(convert_charrefs=True)
        self.tables: list[list[list[str]]] = []
        self._rows: list[list[str]] | None = None
        self._cell: list[str] | None = None

    def handle_starttag(self, tag, attrs):
        if tag == "table":
            self._rows = []
        elif tag == "tr" and self._rows is not None:
            self._rows.append([])
        elif tag in ("td", "th") and self._rows is not None:
            self._cell = []

    def handle_endtag(self, tag):
        if tag == "table" and self._rows is not None:
            self.tables.append([r for r in self._rows if r])
            self._rows = None
        elif tag in ("td", "th") and self._cell is not None:
            if self._rows and self._rows[-1] is not None:
                self._rows[-1].append(" ".join(self._cell).strip())
            self._cell = None

    def handle_data(self, data):
        if self._cell is not None and data.strip():
            self._cell.append(data.strip())


def extract_tables(html: str) -> list[list[list[str]]]:
    parser = _TableParser()
    parser.feed(html)
    return parser.tables


def _to_number(cell: str) -> float | None:
    m = re.search(r"-?[\d,]+(?:\.\d+)?", cell)
    if not m:
        return None
    return float(m.group(0).replace(",", ""))


@dataclass(frozen=True)
class CoverageStats:
    coverage: float
    covered_line: float
    total_line: float


def parse_c_family_report(html: str) -> CoverageStats | None:
    """Totals row of the first table's "Line Coverage" column:
    ``"<pct>% (<covered>/<total>)"`` (3_…py:145-158)."""
    for table in extract_tables(html):
        if len(table) < 2:
            continue
        header = table[0]
        try:
            col = next(i for i, h in enumerate(header)
                       if "line coverage" in h.lower())
        except StopIteration:
            continue
        last = table[-1]
        if col >= len(last):
            continue
        numbers = re.findall(r"[\d.]+", last[col])
        if len(numbers) >= 3:
            return CoverageStats(coverage=float(numbers[0]),
                                 covered_line=float(numbers[1]),
                                 total_line=float(numbers[2]))
    return None


def _totals_from_columns(html: str, total_col_name: str,
                         missed_col_name: str,
                         missed_occurrence: int = 1) -> CoverageStats | None:
    """Shared shape of the Python/JVM parsers: covered = total - missed from
    the totals (last) row; coverage derived as a percentage."""
    for table in extract_tables(html):
        if len(table) < 2:
            continue
        header = [h.strip() for h in table[0]]
        total_idx = None
        missed_idxs = []
        for i, h in enumerate(header):
            name = h.lower()
            if name == total_col_name and total_idx is None:
                total_idx = i
            if name == missed_col_name:
                missed_idxs.append(i)
        if total_idx is None or len(missed_idxs) < missed_occurrence:
            continue
        missed_idx = missed_idxs[missed_occurrence - 1]
        last = table[-1]
        if max(total_idx, missed_idx) >= len(last):
            continue
        total = _to_number(last[total_idx])
        missed = _to_number(last[missed_idx])
        if total is None or missed is None or total <= 0:
            return None
        covered = total - missed
        return CoverageStats(coverage=covered / total * 100.0,
                             covered_line=covered, total_line=total)
    return None


def parse_python_report(html: str) -> CoverageStats | None:
    """``statements``/``missing`` columns (3_…py:174-185)."""
    return _totals_from_columns(html, "statements", "missing")


def parse_jvm_report(html: str) -> CoverageStats | None:
    """``Lines`` total with the *second* ``Missed`` column (3_…py:188-202:
    pandas renames the duplicate to ``Missed_1``/``Missed.1``)."""
    return _totals_from_columns(html, "lines", "missed", missed_occurrence=2)


def fetch_day_coverage(fetcher: Fetcher, project: str, language: str,
                       day: str) -> CoverageStats | None:
    """One day's stats, or None when the report is absent/unparseable.
    ``day`` is YYYYMMDD (the report path format, 3_…py:130)."""
    base = REPORT_URL_TEMPLATE.format(project=project, day=day)
    if language in C_FAMILY:
        resp = fetcher.get(base + "file_view_index.html")
        if resp is None:
            return None
        return parse_c_family_report(resp.text)
    if language in INDEX_FAMILY:
        resp = fetcher.get(base + "index.html")
        if resp is None:
            return None
        if language == "python":
            return parse_python_report(resp.text)
        if language == "jvm":
            return parse_jvm_report(resp.text)
        return None  # go reports carry no parse rule in the reference
    return None


@dataclass
class CoverageCollector:
    """Per-project day-walk with resume, per-project CSVs, final merge
    (3_…py:226-298)."""

    fetcher: Fetcher
    per_project_dir: str
    finish_date: date

    def collect_project(self, project: str, language: str,
                        start: date) -> int:
        """Scrape ``project`` from max(start, resume point) through
        ``finish_date``; append to its CSV.  Returns new-row count."""
        os.makedirs(self.per_project_dir, exist_ok=True)
        csv_path = os.path.join(self.per_project_dir, f"{project}.csv")
        begin = resume_start_date(csv_path, start)
        rows = []
        day = begin
        while day <= self.finish_date:
            stamp = day.strftime("%Y%m%d")
            stats = fetch_day_coverage(self.fetcher, project, language, stamp)
            if stats is not None:
                rows.append({"date": stamp, "project": project,
                             "coverage": stats.coverage,
                             "covered_line": stats.covered_line,
                             "total_line": stats.total_line,
                             "exist": True})
            day += timedelta(days=1)
        if rows:
            new = table.from_records(rows)
            if os.path.exists(csv_path):
                new = table.concat([table.read_csv(csv_path), new])
            table.write_csv(new, csv_path)
        log.info("%s: %d new coverage rows (from %s)", project, len(rows),
                 begin)
        return len(rows)

    def collect_all(self, project_info: table.Table, final_csv: str) -> int:
        """Walk every supported-language project from its first-commit date
        (3_…py:240-282), then merge the per-project CSVs."""
        total = 0
        for row in project_info.rows():
            language = row.get("language")
            if language not in SUPPORTED_LANGUAGES:
                continue
            first = table.utc_date(row["first_commit_datetime"])
            if first is None:
                continue
            total += self.collect_project(row["project"], language, first)
        self.merge(final_csv)
        return total

    def merge(self, final_csv: str) -> int:
        files = sorted(glob.glob(os.path.join(self.per_project_dir, "*.csv")))
        if not files:
            log.warning("no per-project coverage CSVs to merge")
            return 0
        merged = table.concat([table.read_csv(f) for f in files])
        table.write_csv(merged, final_csv)
        log.info("merged %d files -> %s (%d rows)", len(files), final_csv,
                 len(merged))
        return len(merged)


__all__ = ["C_FAMILY", "CoverageCollector", "CoverageStats", "INDEX_FAMILY",
           "REPORT_URL_TEMPLATE", "SUPPORTED_LANGUAGES", "extract_tables",
           "fetch_day_coverage", "parse_c_family_report", "parse_jvm_report",
           "parse_python_report"]
