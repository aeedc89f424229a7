"""C6, the raw build-log analyzer (reference:
``4_get_buildlog_analysis.py``): a port of
``tse1m_tpu/collect/buildlogs.py``.

Turns a raw GCB build log into the structured record behind the
``buildlog_data`` table: project name, build_type, result, and the
(path, type, url, revision) module tuples from ``jq_inplace`` lines and
embedded srcmap JSON blocks.

The parser is a pure function over the log text; the driver streams logs
through the injected transport with processed-id resume and batch-CSV
checkpoints.  Two documented deviations from the reference:

- build_type values are canonical ``Fuzzing/Coverage/Introspector/Error/
  Unknown`` — the reference emits mixed-case variants (``'coverage'`` at
  4_…py:109 vs ``'Coverage'`` at :131) that the shipped DB never contains;
- srcmap JSON blocks are delimited by brace depth; the reference ends a
  block at the first line ending in ``}`` (4_…py:196), which truncates any
  multi-module srcmap before parsing.
"""

from __future__ import annotations

import json
import logging
import re
from dataclasses import dataclass, field

from ..resilience.faults import reraise_if_fault
from . import table
from .checkpoint import CsvBatchCheckpointer, processed_ids_from_csvs
from .transport import Fetcher

log = logging.getLogger("tse1m_tpu_torch.collect.buildlogs")

PUBLIC_LOG_URL_TEMPLATE = ("https://oss-fuzz-build-logs.storage.googleapis"
                           ".com/log-{build_id}.txt")

# Log-format constants (4_…py:62-72).  The format is OSS-Fuzz's GCB output;
# the patterns describe that format, the classification logic around them is
# restructured as an ordered rule table.
_IMAGE_RE = re.compile(r"Already have image: gcr\.io/oss-fuzz/([^\s:]+)")
_GCS_RE = re.compile(
    r"No URLs matched: gs://oss-fuzz-coverage/([^/]+)/textcov_reports")
_STARTING_STEP_RE = re.compile(r"Starting Step #\d+\s*(.*)")
_PULL_BASE_RUNNER_RE = re.compile(
    r"Step #(\d+): Pulling image: gcr.io/oss-fuzz-base/base-runner")
_REPORT_HTML_RE = re.compile(r"/report/.*\.html")
_BASE_RUNNER_MISS_RE = re.compile(
    r"Unable to find image 'gcr.io/oss-fuzz-base/base-runner:latest' locally")
_COMPILE_RE = re.compile(r"compile-(.*)-(.*)-x86_64")
_PUSH_DONE_RE = re.compile(r"PUSH\s*DONE", re.DOTALL)
_JQ_INPLACE_RE = re.compile(r"jq_inplace [^ ]+ '(.*?)'")
_STEP_PAYLOAD_RE = re.compile(r"Step #\d+:\s?(.*)")

_FUZZ_SANITIZERS = ("address", "memory", "undefined", "none")
_STEP_SANITIZER_KEYWORDS = ("address-x86_64", "undefined-x86_64",
                            "memory-x86_64", "none-x86_64", "address-i386")
# Step index -> build type for the base-runner pull (4_…py:127-135).
_PULL_STEP_TYPES = {"0": "Introspector", "4": "Coverage", "5": "Fuzzing"}


@dataclass
class ModuleEntry:
    path: str
    type: str
    url: str
    revision: str

    @property
    def module(self) -> str:
        """Display name: last path component, capitalised (4_…py:219)."""
        return self.path.split("/")[-1].capitalize()


@dataclass
class BuildLogRecord:
    build_id: str
    project: str = ""
    build_type: str = ""
    result: str = ""
    modules: list = field(default_factory=list)        # display names
    paths: list = field(default_factory=list)
    types: list = field(default_factory=list)
    repo_urls: list = field(default_factory=list)
    revisions: list = field(default_factory=list)


def _classify_starting_step(text: str) -> str | None:
    """The 'Starting Step #N "<name>"' rule (4_…py:101-118): srcmap/build
    steps carry no signal; coverage/introspector by name; sanitizer
    suffixes mean a fuzzing step."""
    name = text.strip().replace('"', "")
    if not name or "srcmap" in name or "build" in name:
        return None
    if "coverage" in name:
        return "Coverage"
    if "introspector" in name:
        return "Introspector"
    if any(k in name for k in _STEP_SANITIZER_KEYWORDS):
        return "Fuzzing"
    return "Unknown"


def _classify_compile(sanitizer: str) -> str:
    if sanitizer in _FUZZ_SANITIZERS:
        return "Fuzzing"
    if sanitizer == "coverage":
        return "Coverage"
    if sanitizer == "introspector":
        return "Introspector"
    return "Unknown"


class _SrcmapCollector:
    """Accumulates ``Step #N: ...`` JSON payload lines into complete srcmap
    objects, delimited by brace depth."""

    def __init__(self):
        self._lines: list[str] = []
        self._depth = 0
        self.objects: list[dict] = []

    def feed(self, line: str) -> None:
        payload_m = _STEP_PAYLOAD_RE.search(line)
        if payload_m is None:
            return
        payload = payload_m.group(1)
        if not self._lines:
            if payload.strip() != "{":
                return
            self._lines = [payload]
            self._depth = 1
            return
        self._lines.append(payload)
        self._depth += payload.count("{") - payload.count("}")
        if self._depth <= 0:
            text = "".join(self._lines)
            self._lines = []
            self._depth = 0
            try:
                obj = json.loads(text)
            except json.JSONDecodeError:
                return
            if isinstance(obj, dict):
                self.objects.append(obj)


def _final_result(lines: list[str]) -> str:
    """Result from the tail of the log (4_…py:228-237): an ERROR in the
    second-to-last line or an exact ERROR/deadline line in the last 200
    means Error; exact PUSH and DONE lines mean Success."""
    tail = [t.strip() for t in lines[-200:]]
    if len(lines) >= 2 and "ERROR" in lines[-2]:
        return "Error"
    if "ERROR" in tail or "ERROR: context deadline exceeded" in tail:
        return "Error"
    if "PUSH" in tail and "DONE" in tail:
        return "Success"
    return "Unknown"


def parse_build_log(build_id: str, text: str) -> BuildLogRecord:
    """Pure log-text -> structured record (the body of 4_…py:54-246)."""
    rec = BuildLogRecord(build_id=build_id)
    lines = text.splitlines()
    if not lines:
        return rec

    entries: list[ModuleEntry] = []
    srcmaps = _SrcmapCollector()

    for line in lines:
        m = _IMAGE_RE.search(line)
        if m and not rec.project:
            rec.project = m.group(1)
        m = _GCS_RE.search(line)
        if m and not rec.project:
            rec.project = m.group(1)

        step_m = _STARTING_STEP_RE.match(line)
        if step_m:
            kind = _classify_starting_step(step_m.group(1))
            if kind:
                rec.build_type = kind
        else:
            # The remaining signals only fire on non-"Starting Step" lines
            # (the reference's else-branch, 4_…py:119-159); later signals
            # override earlier ones except where guarded.
            pull_m = _PULL_BASE_RUNNER_RE.search(line)
            if pull_m:
                rec.build_type = _PULL_STEP_TYPES.get(pull_m.group(1),
                                                      "Unknown")
            if _REPORT_HTML_RE.search(line):
                rec.build_type = "Coverage"
            if _BASE_RUNNER_MISS_RE.search(line):
                rec.build_type = "Fuzzing"
            compile_m = _COMPILE_RE.search(line)
            if compile_m:
                rec.build_type = _classify_compile(compile_m.group(2))
            if _PUSH_DONE_RE.search(line) and rec.build_type not in (
                    "Coverage", "Introspector"):
                rec.build_type = "Fuzzing"

        jq_m = _JQ_INPLACE_RE.search(line)
        if jq_m:
            content = jq_m.group(1)
            path_m = re.search(r'"(.+?)"\s*=', content)
            type_m = re.search(r'type:\s*"(.+?)"', content)
            url_m = re.search(r'url:\s*"(.+?)"', content)
            rev_m = re.search(r'rev:\s*"(.+?)"', content)
            if path_m and type_m and url_m and rev_m:
                entries.append(ModuleEntry(path=path_m.group(1),
                                           type=type_m.group(1),
                                           url=url_m.group(1),
                                           revision=rev_m.group(1)))

        srcmaps.feed(line)

    for obj in srcmaps.objects:
        for path, details in obj.items():
            if not isinstance(details, dict):
                continue
            entries.append(ModuleEntry(path=path,
                                       type=details.get("type", ""),
                                       url=details.get("url", ""),
                                       revision=details.get("rev", "")))

    rec.modules = [e.module for e in entries]
    rec.paths = [e.path for e in entries]
    rec.types = [e.type for e in entries]
    rec.repo_urls = [e.url for e in entries]
    rec.revisions = [e.revision for e in entries]
    rec.result = _final_result(lines)
    return rec


def _windowed_map(pool, fn, items, window: int):
    """Ordered map over ``pool`` with at most ``window`` tasks submitted at
    once, so neither futures nor completed-but-unconsumed results accumulate
    beyond the window (Executor.map submits everything eagerly)."""
    from collections import deque
    from itertools import islice

    it = iter(items)
    pending = deque(pool.submit(fn, item) for item in islice(it, window))
    while pending:
        yield pending.popleft().result()
        for item in islice(it, 1):
            pending.append(pool.submit(fn, item))


@dataclass
class BuildLogAnalyzer:
    """Streams raw logs through the parser with resume + checkpointing
    (4_…py:249-288).  ``limit`` bounds one run (the reference processes 10
    rows per invocation, 4_…py:281); None = all pending.

    ``workers > 1`` fans the log fetches out over a thread pool — the run
    is network-bound, so this is the lever that matters at the study's
    1.19M-log scale (the pure parse is microseconds per log).  Results are
    checkpointed in submission order either way, so resume state and batch
    CSVs are deterministic.  The fetcher must be thread-safe at
    ``workers > 1`` (``HttpFetcher`` is: its politeness pause takes a lock; the
    reference instead runs whole processes in parallel,
    5_get_issue_reports.py:486-497)."""

    fetcher: Fetcher
    batch_dir: str
    batch_size: int = 200
    limit: int | None = None
    workers: int = 1

    def pending(self, metadata: table.Table) -> table.Table:
        done = processed_ids_from_csvs(self.batch_dir, id_column="id")
        names = metadata.col("name")
        return metadata.take([i for i, v in enumerate(names)
                              if v not in done])

    def analyze(self, metadata: table.Table) -> int:
        """``metadata`` rows need name/mediaLink/size/timeCreated (C4's
        output, read by ``collect/table.py``).  Returns the number of
        logs analyzed this run."""
        todo = self.pending(metadata)
        if self.limit is not None:
            todo = todo.take(list(range(min(self.limit, len(todo)))))
        if not len(todo):
            log.info("no new build logs to analyze")
            return 0
        cols = {c.lower(): c for c in todo.columns}

        def col(key, default=None):
            # ``Series.tolist()``: a missing cell is a float NaN, which
            # the batch CSV spells ``nan`` as the JAX package's does.
            name = cols.get(key.lower(), key)
            return ([float("nan") if v is None else v for v in todo.col(name)]
                    if name in todo else [default] * len(todo))

        ids = col("name")
        links = col("mediaLink")
        sizes = col("size")
        created = col("timeCreated")
        urls = [link if isinstance(link, str) and link
                else PUBLIC_LOG_URL_TEMPLATE.format(build_id=bid)
                for bid, link in zip(ids, links)]

        def fetch_and_parse(task):
            build_id, url = task
            try:
                resp = self.fetcher.get(url)
            except Exception as e:
                # The fetcher already retried (transport.py); an injected
                # fault that survived it must still surface here.
                reraise_if_fault(e)
                log.warning("log fetch failed for %s: %s", build_id, e)
                resp = None
            return parse_build_log(
                build_id, resp.text if resp is not None else "")

        tasks = list(zip(ids, urls))
        ckpt = CsvBatchCheckpointer(self.batch_dir, "buildlog_analyzed",
                                    self.batch_size)
        # Stream results through the checkpointer so a crash loses at most
        # one unflushed batch (CsvBatchCheckpointer's contract) and memory
        # stays bounded at 1.19M-log scale.  Results are yielded in
        # submission order, so batch CSVs are identical to the serial
        # path's.  Submission is windowed (not Executor.map, which submits
        # every task — and so holds every future + parsed record — up
        # front): at most ``4 * workers`` fetches are in flight or awaiting
        # consumption at any time.
        if self.workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(self.workers)
            recs = _windowed_map(pool, fetch_and_parse, tasks,
                                 window=4 * self.workers)
        else:
            pool = None
            recs = map(fetch_and_parse, tasks)
        n = 0
        try:
            for rec, size, tc, url in zip(recs, sizes, created, urls):
                ckpt.add({
                    "id": rec.build_id,
                    "size": size,
                    "project": rec.project,
                    "build_type": rec.build_type,
                    "result": rec.result,
                    "timecreated": tc,
                    "modules": json.dumps(rec.modules),
                    "path": json.dumps(rec.paths),
                    "revisions": json.dumps(rec.revisions),
                    "types": json.dumps(rec.types),
                    "repo_urls": json.dumps(rec.repo_urls),
                    "download_link": url,
                })
                n += 1
        finally:
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        ckpt.flush()
        log.info("analyzed %d build logs", n)
        return n


__all__ = ["BuildLogAnalyzer", "BuildLogRecord", "ModuleEntry",
           "PUBLIC_LOG_URL_TEMPLATE", "parse_build_log"]
