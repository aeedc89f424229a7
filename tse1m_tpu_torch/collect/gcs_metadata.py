"""C4, the build-log metadata pager (reference:
``2_get_buildlog_metadata.py``): a port of
``tse1m_tpu/collect/gcs_metadata.py``.

Pages the GCS JSON objects API for the ``oss-fuzz-gcb-logs`` bucket,
keeps only objects whose name has the ``log-<uuid>.txt`` shape, and
checkpoints every ``pages_per_batch`` pages through the shared
:class:`~.checkpoint.CsvBatchCheckpointer` before merging
into ``buildlog_metadata.csv``.

Deviation from the reference, documented: names are matched with a UUID
regex instead of an exact-length check (``2_…py:98,134-138``) — equal
acceptance on real names, but length-44 non-log objects no longer slip
through.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field

from ..resilience.faults import reraise_if_fault
from .checkpoint import CsvBatchCheckpointer
from .transport import Fetcher

log = logging.getLogger("tse1m_tpu_torch.collect.gcs")

BUCKET = "oss-fuzz-gcb-logs"
API_URL_TEMPLATE = "https://storage.googleapis.com/storage/v1/b/{bucket}/o"
TARGET_KEYS = ("name", "selfLink", "mediaLink", "size", "timeCreated")
LOG_NAME_RE = re.compile(
    r"^log-[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{12}\.txt$")


def is_build_log_name(name: str | None) -> bool:
    return bool(name) and LOG_NAME_RE.match(name) is not None


def extract_log_records(items: list[dict]) -> list[dict]:
    """Filter one API page's objects down to build-log records with the
    target metadata keys (2_…py:133-138)."""
    return [{key: item.get(key) for key in TARGET_KEYS}
            for item in items if is_build_log_name(item.get("name"))]


@dataclass
class GcsMetadataCollector:
    fetcher: Fetcher
    batch_dir: str
    pages_per_batch: int = 10
    max_pages: int | None = None   # safety valve for tests/partial runs
    bucket: str = BUCKET
    pages_fetched: int = field(default=0, init=False)

    def collect(self, final_csv: str) -> int:
        """Walk all pages, checkpoint batches, merge.  Returns the merged
        record count.  A transport failure stops the walk but still merges
        what was collected (the reference likewise breaks and finalises,
        2_…py:126-128)."""
        url = API_URL_TEMPLATE.format(bucket=self.bucket)
        ckpt = CsvBatchCheckpointer(self.batch_dir, "buildlog_metadata",
                                    # flush on page boundaries, not records
                                    batch_size=10 ** 9,
                                    fieldnames=list(TARGET_KEYS))
        params: dict = {}
        while True:
            if self.max_pages is not None and self.pages_fetched >= self.max_pages:
                log.info("page limit %d reached", self.max_pages)
                break
            try:
                resp = self.fetcher.get(url, params=params or None)
            except Exception as e:
                reraise_if_fault(e)  # retried upstream; faults stay visible
                log.error("page fetch failed (%s); finalising partial run", e)
                break
            self.pages_fetched += 1
            if resp is None:
                log.error("bucket listing returned 404; finalising")
                break
            data = resp.json()
            for record in extract_log_records(data.get("items", [])):
                ckpt.add(record)
            if self.pages_fetched % self.pages_per_batch == 0:
                ckpt.flush()
            token = data.get("nextPageToken")
            if not token:
                break
            params = {"pageToken": token}
        return ckpt.merge(final_csv)


__all__ = ["API_URL_TEMPLATE", "BUCKET", "GcsMetadataCollector",
           "TARGET_KEYS", "extract_log_records", "is_build_log_name"]
