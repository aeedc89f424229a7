"""Run-to-completion of multi-step commands (``all``, ``cluster``,
``scrub``, ``serve --status``): a trimmed copy of
``tse1m_tpu/resilience/runner.py:27-195`` without the retry policy, the
stage and span telemetry and the pod manifest merge.

Each step runs isolated: a failure is recorded (status, one-line error,
full traceback) and the remaining steps still run.  The degradation events
a step survived (``observability.record_degradation``: halved chunks,
quant drops, stall and device retries, quarantined shards) are popped into
its ``degradations``, and the manifest carries ``degradation_counts`` over
every step.  The manifest ``<result_dir>/run_manifest.json`` is rewritten
atomically after every step and before each one starts, so an interrupted
run leaves an accurate partial record that names the step it was in;
flight dumps land beside it unless a flight directory is set.
``exit_code()`` is non-zero when any step failed.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from dataclasses import asdict, dataclass

from .atomic import atomic_write


@dataclass
class StepRecord:
    name: str
    status: str = "pending"   # pending | running | ok | failed
    wall_s: float = 0.0
    error: str | None = None      # one-line summary
    traceback: str | None = None  # full text, failures only
    result: dict | None = None    # structured output (record_result)
    degradations: list | None = None  # events survived; None = ran clean


class StepRunner:
    """Run named steps to completion, recording each into a JSON manifest
    (none when ``manifest_path`` is None)."""

    def __init__(self, manifest_path: str | None):
        self.manifest_path = manifest_path
        self.steps: list[StepRecord] = []
        self.started_at = time.time()
        # Extra top-level manifest fields: the pod path's membership
        # "epoch", which the merge tags each fragment's steps with.
        self.meta: dict = {}
        if manifest_path:
            from ..observability.flight import get_flight_dir, set_flight_dir

            if get_flight_dir() is None:
                set_flight_dir(os.path.dirname(manifest_path) or ".")

    def run(self, name: str, fn, *args, **kwargs) -> StepRecord:
        """Run one step isolated; never raises, apart from a
        KeyboardInterrupt, which is recorded first (the record carries the
        failure)."""
        from ..observability import pop_degradation_events

        rec = StepRecord(name=name, status="running")
        self.steps.append(rec)
        self._write()  # a killed run shows the step it was in
        pop_degradation_events()  # only this step's events attach to it
        t0 = time.time()
        try:
            fn(*args, **kwargs)
            rec.status = "ok"
        # BaseException: a driver's SystemExit (a missing corpus CSV) is a
        # failed step too; an interrupt is recorded, then re-raised.
        except BaseException as e:  # noqa: BLE001 - isolation is the point
            rec.status = "failed"
            rec.error = f"{type(e).__name__}: {e}".strip().rstrip(":")
            rec.traceback = traceback.format_exc()
            if isinstance(e, KeyboardInterrupt):
                rec.wall_s = round(time.time() - t0, 3)
                rec.degradations = pop_degradation_events() or None
                self._write()
                raise
        rec.wall_s = round(time.time() - t0, 3)
        rec.degradations = pop_degradation_events() or None
        self._write()
        return rec

    def record_result(self, rec: StepRecord, result: dict) -> None:
        """Attach a step's structured output to its record (``serve
        --status`` records the daemon's status) and rewrite the
        manifest."""
        rec.result = dict(result)
        self._write()

    def set_meta(self, **fields) -> None:
        """Add top-level fields to the manifest (the pod epoch, once
        known)."""
        self.meta.update(fields)
        self._write()

    @property
    def failed(self) -> list[StepRecord]:
        return [s for s in self.steps if s.status == "failed"]

    def exit_code(self) -> int:
        return 1 if self.failed or not self.steps else 0

    def summary(self) -> dict:
        by: dict = {}
        for s in self.steps:
            by[s.status] = by.get(s.status, 0) + 1
        return by

    def _write(self) -> None:
        if not self.manifest_path:
            return
        from ..observability import degradation_counts

        events = [e for s in self.steps for e in (s.degradations or [])]
        payload = {
            "started_at": self.started_at,
            "wall_seconds": round(time.time() - self.started_at, 3),
            "ok": not self.failed,
            "summary": self.summary(),
            "degradation_counts": degradation_counts(events),
            "steps": [asdict(s) for s in self.steps],
            **self.meta,
        }
        with atomic_write(self.manifest_path) as f:
            json.dump(payload, f, indent=2, default=str)


__all__ = ["StepRecord", "StepRunner"]
