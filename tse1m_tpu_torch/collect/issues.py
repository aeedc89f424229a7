"""C7, the issue-tracker collector (reference: ``5_get_issue_reports.py``):
a port of ``tse1m_tpu/collect/issues.py``.

The reference is one 500-line Selenium script; here the concerns are
separated so the scraping *logic* is testable offline:

- **URL routing**: old Monorail vs new tracker by id threshold
  (5_…py:128-131).
- **Pure parsing** over a :class:`RawIssuePage`: description key/value
  extraction with parenthesis-tolerant labels (5_…py:231-267), "Fixed"
  commit extraction from the event stream (5_…py:198-228), revision-range
  splitting (5_…py:53-57).
- **Client protocol**: :class:`IssuePageClient` yields structured pages;
  the Selenium implementation (:mod:`.issues_selenium`) drives the live
  shadow-DOM tracker when selenium is installed; tests use a fake.
- **Driver**: process-parallel windows with private output dirs
  (5_…py:486-497,320-322), checkpoint every ``save_interval`` issues
  (5_…py:333-334), client restart on unhandled errors (5_…py:328-332),
  processed-id resume and the re-scrape filter DSL (5_…py:364-454).

The window CSVs hold every value JSON-encoded; their merge and the filter
DSL read them through ``collect/table.py`` (``json_cells=True``), byte for
byte as the JAX package's pandas merge.  ``scrape_issues`` forks worker
processes: the ``collect`` command touches no device before it, so no
CUDA context crosses the fork.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Protocol

from ..resilience.faults import reraise_if_fault
from ..utils.atomic import atomic_write
from . import table
from .checkpoint import processed_ids_from_csvs

log = logging.getLogger("tse1m_tpu_torch.collect.issues")

MONORAIL_THRESHOLD = 10_000_000
MONORAIL_URL = "https://bugs.chromium.org/p/oss-fuzz/issues/detail?id={}"
TRACKER_URL = "https://issues.oss-fuzz.com/issues/{}"

# Description labels harvested into the record (5_…py:231).
DESCRIPTION_KEYS = (
    "Project", "Fuzzing Engine", "Fuzz Target", "Job Type", "Platform Id",
    "Crash Type", "Crash Address", "Crash State", "Sanitizer", "Regressed",
    "Reproducer Testcase", "Crash Revision", "Download", "Fixed", "Fuzzer",
    "Fuzzer binary", "Fuzz target binary", "Minimized Testcase",
    "Recommended Security Severity", "Unminimized Testcase", "Build log",
    "Build type",
)
# Labels whose value is a URL possibly followed by extra text (5_…py:254).
URL_VALUE_KEYS = ("Regressed", "Fixed", "Crash Revision", "Build log",
                  "Reproducer Testcase", "Minimized Testcase")
# Sub-pages scraped for component/revision tables (5_…py:272).
REVISION_SUBPAGES = {"Regressed": "regressed", "Fixed": "fixed",
                     "Crash Revision": "crash"}

_LABEL_RES = {key: re.compile(rf"^{re.escape(key)}(?:\s*\(.*\))?\s*:",
                              re.IGNORECASE)
              for key in DESCRIPTION_KEYS}


def issue_url(issue_no: int) -> str:
    """Monorail ids are < 10M; everything newer lives on the new tracker."""
    if int(issue_no) < MONORAIL_THRESHOLD:
        return MONORAIL_URL.format(issue_no)
    return TRACKER_URL.format(issue_no)


def split_revision_range(text: str) -> list[str]:
    """``"<sha>:<sha>"`` -> both endpoints; anything else stays whole
    (5_…py:53-57: both sides must look like revisions, > 10 chars)."""
    parts = text.split(":")
    if len(parts) == 2 and len(parts[0]) > 10 and len(parts[1]) > 10:
        return parts
    return [text]


def parse_description(text: str) -> dict:
    """Key/value extraction from the issue description (5_…py:234-267).

    A line starting with a known label (optionally ``(size)``-annotated)
    opens that key; later unlabeled lines continue it as a list until a
    blank line, an auto-filing boilerplate line, or the next label."""
    out: dict = {}
    current: str | None = None
    for line in text.split("\n"):
        stripped = line.strip().replace("<b>", "").replace("</b>", "")
        if not stripped:
            current = None
            continue
        clean = stripped.replace("**", "")
        matched = False
        for key, pattern in _LABEL_RES.items():
            if pattern.match(clean):
                current = key
                value = stripped.split(":", 1)[1].strip()
                if key in URL_VALUE_KEYS and "http" in value:
                    value = value.split(" ")[0]
                out[key] = value
                matched = True
                break
        if matched or current is None:
            continue
        if "Issue filed automatically" in stripped or "See " in stripped:
            current = None
            continue
        existing = out.get(current)
        if isinstance(existing, list):
            existing.append(stripped)
        elif existing:
            out[current] = [existing, stripped]
        else:
            out[current] = [stripped]
    return out


@dataclass
class IssueEvent:
    """One timeline event: its visible comment text, ISO timestamp, and any
    ``/revisions`` links it contains."""

    text: str
    time_iso: str | None = None
    revision_links: list = field(default_factory=list)


def extract_fixed_from_events(events: list[IssueEvent]) -> tuple[str | None, str | None]:
    """Latest-first scan for the fix notice (5_…py:198-228): either an
    explicit ``Fixed: http…/revisions`` line or a "is verified as fixed in"
    comment with a revisions link.  Returns (fixed_url, fixed_time_iso)."""
    for event in reversed(events):
        for line in event.text.split("\n"):
            stripped = line.strip()
            if stripped.startswith("Fixed: http") and "/revisions" in stripped:
                return stripped.split(" ", 1)[1], event.time_iso
        if "is verified as fixed in" in event.text and event.revision_links:
            return event.revision_links[0], event.time_iso
    return None, None


@dataclass
class RevisionTable:
    components: list
    revisions: list            # list of [rev] or [start, end] ranges
    buildtime: list | None = None


@dataclass
class RawIssuePage:
    """Structured capture of one issue page, produced by a client."""

    final_id: str
    url: str
    title: str | None = None
    reported_time_iso: str | None = None
    metadata: dict = field(default_factory=dict)   # label -> value
    events: list = field(default_factory=list)     # [IssueEvent]
    description: str = ""
    hotlists: list = field(default_factory=list)
    load_error: bool = False


class IssuePageClient(Protocol):
    def fetch_issue(self, issue_no: int) -> RawIssuePage: ...

    def fetch_revisions(self, url: str) -> RevisionTable | None: ...


def _fmt_minute(iso: str | None) -> str | None:
    if not iso:
        return None
    from datetime import datetime

    try:
        return (datetime.fromisoformat(iso.replace("Z", "+00:00"))
                .strftime("%Y-%m-%d %H:%M"))
    except ValueError:
        return None


def assemble_issue_record(page: RawIssuePage,
                          client: IssuePageClient) -> dict:
    """Page -> flat record, including the three revision sub-scrapes
    (5_…py:155-291).  Keys mirror the reference's CSV columns."""
    record: dict = {"id": page.final_id, "url": page.url,
                    "error": page.load_error}
    if page.load_error:
        record["title"] = "Failed to load page"
        return record
    record["title"] = page.title
    if page.hotlists:
        record["hotlists"] = page.hotlists
    rt = _fmt_minute(page.reported_time_iso)
    if rt:
        record["reported_time"] = rt
    for label, value in page.metadata.items():
        key = "Metadata_Reported_Date" if label == "Reported" else label
        record[key] = value

    fixed_url, fixed_iso = extract_fixed_from_events(page.events)
    if fixed_url:
        record["Fixed"] = fixed_url
        ft = _fmt_minute(fixed_iso)
        if ft:
            record["fixed_time"] = ft

    record.update(parse_description(page.description))

    for info_key, prefix in REVISION_SUBPAGES.items():
        sub_url = record.get(info_key)
        if not (isinstance(sub_url, str) and sub_url.startswith("http")):
            continue
        try:
            table = client.fetch_revisions(sub_url)
        except Exception as e:
            # Selenium raises arbitrary driver exceptions — stay broad,
            # but keep the fault plane visible through this seat.
            reraise_if_fault(e)
            log.warning("revision sub-scrape failed for %s: %s", sub_url, e)
            continue
        if table is None:
            continue
        record[f"{prefix}_components"] = table.components
        record[f"{prefix}_revisions"] = table.revisions
        record[f"{prefix}_buildtime"] = table.buildtime
    return record


def revision_buildtime_from_url(url: str) -> list | None:
    """The ``?range=<t1>:<t2>`` tail doubles as the build-time pair
    (5_…py:87)."""
    return url.split("=")[-1].split(":") if "=" in url else None


def save_issue_batch(records: list[dict], directory: str,
                     file_index: int) -> str | None:
    """Numbered CSV with every value JSON-encoded and a sorted union header
    (5_…py:293-309) — the format ``processed_ids_from_csvs`` and the filter
    DSL read back."""
    if not records:
        return None
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{file_index:03d}.csv")
    header = sorted({k for r in records for k in r})
    import csv

    # Atomic: a worker killed mid-batch must not leave a torn CSV that
    # plan_run later reads as "these ids are processed".
    with atomic_write(path, newline="") as f:
        w = csv.DictWriter(f, fieldnames=header)
        w.writeheader()
        for r in records:
            w.writerow({k: json.dumps(r.get(k), ensure_ascii=False)
                        for k in header})
    log.info("saved %d issues to %s", len(records), path)
    return path


def run_scraper_window(client_factory: Callable[[], IssuePageClient],
                       issue_numbers: list[int], window_index: int,
                       base_output_dir: str, save_interval: int = 50) -> int:
    """One worker: private output dir, checkpoint every ``save_interval``
    issues, client restart on unhandled errors (5_…py:311-340)."""
    out_dir = os.path.join(base_output_dir, f"window_{window_index}")
    client = client_factory()
    batch: list[dict] = []
    file_counter = 1
    done = 0
    for issue_no in issue_numbers:
        try:
            page = client.fetch_issue(issue_no)
            batch.append(assemble_issue_record(page, client))
            done += 1
        except Exception as e:
            reraise_if_fault(e)  # chaos plans must see through the restart
            log.error("window %d: unhandled error on issue %s: %s",
                      window_index, issue_no, e)
            if batch:
                save_issue_batch(batch, out_dir, file_counter)
                batch = []
                file_counter += 1
            close = getattr(client, "close", None)
            if close:
                try:
                    close()
                except Exception as ce:  # best-effort teardown of a dead client
                    reraise_if_fault(ce)
            client = client_factory()
        if len(batch) >= save_interval:
            save_issue_batch(batch, out_dir, file_counter)
            batch = []
            file_counter += 1
    if batch:
        save_issue_batch(batch, out_dir, file_counter)
    close = getattr(client, "close", None)
    if close:
        try:
            close()
        except Exception as ce:  # best-effort teardown at window end
            reraise_if_fault(ce)
    log.info("window %d finished: %d issues", window_index, done)
    return done


def scrape_issues(client_factory: Callable[[], IssuePageClient],
                  ids_to_process: list[int], output_dir: str,
                  num_workers: int = 8, save_interval: int = 50,
                  parallel: bool = True) -> None:
    """Fan the id list across worker processes (5_…py:486-497).  Each
    window owns a disjoint output dir, so concurrent runs cannot corrupt
    each other.  ``parallel=False`` runs the windows inline (tests, or
    clients that cannot cross a fork)."""
    if not ids_to_process:
        log.info("no issues to scrape")
        return
    workers = max(1, min(num_workers, len(ids_to_process)))
    chunk = math.ceil(len(ids_to_process) / workers)
    chunks = [ids_to_process[i:i + chunk]
              for i in range(0, len(ids_to_process), chunk)]
    if not parallel or len(chunks) == 1:
        for i, ids in enumerate(chunks):
            run_scraper_window(client_factory, ids, i, output_dir,
                               save_interval)
        return
    import multiprocessing

    procs = []
    for i, ids in enumerate(chunks):
        p = multiprocessing.Process(
            target=run_scraper_window,
            args=(client_factory, ids, i, output_dir, save_interval))
        procs.append(p)
        p.start()
    for p in procs:
        p.join()


def _to_int(text: str):
    """``pd.to_numeric(text, errors="coerce")`` as an int, or None."""
    try:
        v = float(text) if not re.fullmatch(r"\s*[+-]?\d+\s*", text) \
            else int(text)
    except ValueError:
        return None
    if isinstance(v, float) and (math.isnan(v) or math.isinf(v)):
        return None
    return int(v)


def select_rescrape_ids(df: table.Table, conditions: dict) -> list[int]:
    """The re-scrape filter DSL over the merged CSV (5_…py:364-454):
    ``True`` = column missing (blank or JSON ``null``), ``False`` =
    present, ``str`` = case-insensitive substring; conditions AND
    together."""
    if not len(df) or not conditions:
        return []
    mask = [True] * len(df)
    for column, cond in conditions.items():
        if column not in df:
            log.warning("filter column %r not in CSV; skipping", column)
            continue
        kind = df.kind(column)
        col = df.col(column)
        if cond is True:
            hit = [table.is_na(v) or v == "null" for v in col]
        elif cond is False:
            hit = [not table.is_na(v) and v != "null" for v in col]
        elif isinstance(cond, str):
            needle = cond.lower()
            hit = [not table.is_na(v) and
                   needle in table.astype_str(kind, v).lower() for v in col]
        else:
            log.warning("unsupported condition %r for %r", cond, column)
            continue
        mask = [m and h for m, h in zip(mask, hit)]
    if "id" not in df:
        return []
    kind = df.kind("id")
    out = []
    for m, v in zip(mask, df.col("id")):
        if not m or table.is_na(v):
            continue
        n = _to_int(table.astype_str(kind, v).strip('"'))
        if n is not None:
            out.append(n)
    return out


def plan_run(target_ids: set, results_dir: str,
             merged_csv: str | None = None,
             rescrape_conditions: dict | None = None) -> list[int]:
    """Resume plan (5_…py:457-466): targets minus already-processed ids,
    plus any re-scrape matches, newest first."""
    processed = processed_ids_from_csvs(results_dir, id_column="id",
                                        json_encoded=True)
    todo = set(target_ids) - processed
    if merged_csv and rescrape_conditions and os.path.exists(merged_csv):
        df = table.read_csv(merged_csv, json_cells=True)
        todo.update(select_rescrape_ids(df, rescrape_conditions))
    plan = sorted(todo, reverse=True)
    log.info("plan: %d targets, %d already processed, %d to scrape",
             len(target_ids), len(processed), len(plan))
    return plan


def merge_window_csvs(results_dir: str, merged_csv: str) -> int:
    """Union-merge every window CSV under ``results_dir`` (the reference
    reads these into ``merged_output.csv`` for the filter DSL)."""
    import csv

    frames = []
    for root, _, files in os.walk(results_dir):
        for name in sorted(files):
            if name.endswith(".csv"):
                try:
                    frames.append(table.read_csv(os.path.join(root, name),
                                                 json_cells=True))
                except (OSError, ValueError, csv.Error) as e:
                    log.warning("skipping %s: %s", name, e)
    if not frames:
        return 0
    merged = table.concat(frames)
    table.write_csv(merged, merged_csv)
    return len(merged)


__all__ = ["DESCRIPTION_KEYS", "IssueEvent", "IssuePageClient",
           "MONORAIL_THRESHOLD", "RawIssuePage", "RevisionTable",
           "assemble_issue_record", "extract_fixed_from_events",
           "issue_url", "merge_window_csvs", "parse_description",
           "plan_run", "revision_buildtime_from_url", "run_scraper_window",
           "save_issue_batch", "scrape_issues", "select_rescrape_ids",
           "split_revision_range"]
