"""Checkpoint and resume helpers of every collector: a port of
``tse1m_tpu/collect/checkpoint.py``.

The reference implements three patterns once per script:

- batch-CSV checkpointing: flush every N pages or 50 issues to numbered
  batch files, then merge and delete (``2_get_buildlog_metadata.py:
  141-147,24-68``; ``5_get_issue_reports.py:333-334,293-309``);
- processed-id resume: scan earlier output CSVs for ids already done
  (``4_get_buildlog_analysis.py:263-272``; ``5_…py:29-51``);
- resume from the last date: continue a per-project series from the day
  after its last recorded date (``3_get_coverage_data.py:255-259``).

Here each is one helper.  A batch is written to a temp file and renamed
at the ``checkpoint.csv.flush`` seat, under the retry engine; the merge
reads and writes through ``collect/table.py``, byte for byte as the JAX
package's pandas merge.
"""

from __future__ import annotations

import csv
import glob
import json
import logging
import os
from datetime import date, timedelta

from ..resilience.faults import fault_point
from ..utils.retry import io_retry_policy, retry_call
from . import table

log = logging.getLogger("tse1m_tpu_torch.collect.checkpoint")


class CsvBatchCheckpointer:
    """Accumulate records; flush to ``<prefix>_batch_<k>.csv`` every
    ``batch_size`` records; ``merge()`` concatenates the batches into the
    final CSV and removes them.  A crash between flushes loses at most one
    unflushed batch, the reference's durability contract."""

    def __init__(self, directory: str, prefix: str, batch_size: int,
                 fieldnames: list[str] | None = None):
        self.directory = directory
        self.prefix = prefix
        self.batch_size = batch_size
        self.fieldnames = fieldnames
        self._pending: list[dict] = []
        os.makedirs(directory, exist_ok=True)
        self._next_index = len(self._batch_files()) + 1

    def _batch_files(self) -> list[str]:
        return sorted(glob.glob(
            os.path.join(self.directory, f"{self.prefix}_batch_*.csv")))

    def add(self, record: dict) -> None:
        self._pending.append(record)
        if len(self._pending) >= self.batch_size:
            self.flush()

    def flush(self) -> str | None:
        if not self._pending:
            return None
        path = os.path.join(self.directory,
                            f"{self.prefix}_batch_{self._next_index}.csv")
        fields = self.fieldnames or sorted(
            {k for r in self._pending for k in r})

        def write_batch() -> None:
            # temp + rename: a crash or a torn write never shows as a
            # short batch, and a retried attempt rewrites the temp file
            # from the start.
            tmp = path + ".tmp"
            with open(tmp, "w", newline="", encoding="utf-8") as f:
                w = csv.DictWriter(f, fieldnames=fields,
                                   extrasaction="ignore")
                w.writeheader()
                w.writerows(self._pending)
            fault_point("checkpoint.csv.flush", path=tmp)
            os.replace(tmp, path)

        retry_call(write_batch, policy=io_retry_policy(),
                   site="checkpoint.csv.flush")
        log.info("checkpointed %d records to %s", len(self._pending), path)
        self._pending.clear()
        self._next_index += 1
        return path

    def merge(self, final_path: str, cleanup: bool = True) -> int:
        """Concatenate every batch into ``final_path``; returns the merged
        row count.  Batches are deleted only after the merged file is
        written (the reference deletes as it goes, 2_…py:61-67)."""
        self.flush()
        files = self._batch_files()
        if not files:
            log.info("no batch files to merge for %s", self.prefix)
            return 0
        frames = []
        for path in files:
            try:
                frames.append(table.read_csv(path))
            except (OSError, ValueError, csv.Error) as e:
                # A parse failure skips the batch; anything broader (an
                # injected fault too) surfaces.
                log.warning("skipping unreadable batch %s: %s", path, e)
        if not frames:
            return 0
        merged = table.concat(frames)
        table.write_csv(merged, final_path)
        log.info("merged %d records from %d batches into %s",
                 len(merged), len(files), final_path)
        if cleanup:
            for path in files:
                os.remove(path)
            # Temp files orphaned by a crash mid-flush.
            for path in glob.glob(os.path.join(
                    self.directory, f"{self.prefix}_batch_*.csv.tmp")):
                os.remove(path)
        return len(merged)


def processed_ids_from_csvs(base_dir: str, id_column: str = "id",
                            json_encoded: bool = False) -> set:
    """Ids already processed, from every CSV under ``base_dir``.
    ``json_encoded=True`` decodes each cell as JSON first: the issue
    scraper stores every value ``json.dumps``'d (``5_…py:303``)."""
    found: set = set()
    if not os.path.isdir(base_dir):
        return found
    for root, _, files in os.walk(base_dir):
        for name in files:
            if not name.endswith(".csv"):
                continue
            path = os.path.join(root, name)
            try:
                with open(path, newline="", encoding="utf-8") as f:
                    reader = csv.DictReader(f)
                    if (not reader.fieldnames
                            or id_column not in reader.fieldnames):
                        continue
                    for row in reader:
                        raw = row.get(id_column)
                        if raw in (None, ""):
                            continue
                        if json_encoded:
                            try:
                                raw = json.loads(raw)
                            except (json.JSONDecodeError, TypeError):
                                continue
                        if raw is None:
                            continue
                        s = str(raw)
                        found.add(int(s) if s.isdigit() else s)
            except (OSError, ValueError, csv.Error) as e:
                log.warning("could not scan %s: %s", path, e)
    return found


def last_date_in_csv(path: str, column: str = "date") -> date | None:
    """The last recorded date of a per-project CSV, or None if absent or
    empty.  Dates are read as the JAX package reads them: the column as
    text (``YYYYMMDD`` stamps read back as ints), parsed in mixed
    format."""
    if not os.path.exists(path):
        return None
    try:
        t = table.read_csv(path)
    except (OSError, ValueError, csv.Error):
        return None
    if column not in t or not len(t):
        return None
    kind = t.kind(column)
    return table.max_date([table.astype_str(kind, v) for v in t.col(column)])


def resume_start_date(csv_path: str, default_start: date,
                      column: str = "date") -> date:
    """The day after the last recorded date, no earlier than
    ``default_start`` (3_get_coverage_data.py:255-267)."""
    last = last_date_in_csv(csv_path, column)
    if last is None:
        return default_start
    return max(last + timedelta(days=1), default_start)


__all__ = ["CsvBatchCheckpointer", "last_date_in_csv",
           "processed_ids_from_csvs", "resume_start_date"]
