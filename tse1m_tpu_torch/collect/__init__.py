"""The collection layer, a port of ``tse1m_tpu/collect``: the seat of the
reference's ``program/preparation/`` scripts (C3-C8, SURVEY.md §2.1).

Design: every collector splits into a *pure parser* (unit-testable against
recorded fixtures, no network) and a thin *driver* that wires the parser to
an injectable :class:`~.transport.Fetcher` plus the shared
checkpoint/resume helpers.  The reference interleaves IO with parsing inside
monolithic ``main()`` scripts; here the IO boundary is explicit so the whole
layer runs under tests with a directory-backed fake transport.

- ``transport``    HTTP fetch policy: retries w/ backoff, 404-as-absent,
                   politeness delays (reference: retry adapters in
                   ``2_get_buildlog_metadata.py:106-108``,
                   ``3_get_coverage_data.py:73-74``)
- ``checkpoint``   batch-CSV checkpointing, processed-id resume scans,
                   resume-from-last-date (``2_…py:141-147``, ``3_…py:255-267``,
                   ``4_…py:263-272``, ``5_…py:29-51``)
- ``projects``     C3: oss-fuzz clone + project.yaml flatten + first-commit
                   times (``1_get_projects_infos.py``)
- ``gcs_metadata`` C4: GCS JSON API pager for build-log object metadata
                   (``2_get_buildlog_metadata.py``)
- ``coverage``     C5: daily coverage-report scraping with per-language HTML
                   parsing rules (``3_get_coverage_data.py``)
- ``buildlogs``    C6: raw build-log -> structured record regex engine
                   (``4_get_buildlog_analysis.py``)
- ``issues``       C7: issue-tracker scraping — pure page parsing + a
                   process-parallel driver with resume/recovery
                   (``5_get_issue_reports.py``)
- ``corpus``       C8 collection half: git seed-corpus archaeology + GitHub
                   PR merge times (``user_corpus.py:102-240``)
- ``normalize``    adapters from collector outputs to the ``ingest_csv_dir``
                   table schemas (the reference's missing CSV->DB link)
- ``table``        the collectors' CSVs without pandas, cell for cell as
                   the JAX package's pandas round trips write them
- ``yaml_subset``  ``project.yaml`` without PyYAML, as ``yaml.safe_load``
                   reads the forms OSS-Fuzz uses

It computes nothing on a device and imports neither pandas, PyYAML nor
requests; selenium only inside ``issues_selenium``'s methods.
"""

from .transport import DirFetcher, FetchPolicy, Fetcher, HttpFetcher, Response
from .checkpoint import (CsvBatchCheckpointer, last_date_in_csv,
                         processed_ids_from_csvs)

__all__ = [
    "DirFetcher", "FetchPolicy", "Fetcher", "HttpFetcher", "Response",
    "CsvBatchCheckpointer", "last_date_in_csv", "processed_ids_from_csvs",
]
