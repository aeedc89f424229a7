"""Watchdog supervision: a copy of
``tse1m_tpu/resilience/watchdog.py:49-66, 85-172, 160-326``.

- :func:`deadline_clock`: the one clock of every deadline, latency window
  and span in the port (monotonic; immune to NTP steps).
- :func:`run_with_deadline`: run a callable on a worker thread; past the
  budget the wait is cancelled and :class:`StallError` raised.  A thread
  cannot be killed, so the work runs on, detached, and its result is
  dropped: the deadline cancels the wait, not the work (CUDA work the
  thread queued runs to its end too).
- :class:`StageWatchdog`: adaptive per-stage budgets (an EWMA of each
  stage's measured bytes/s, seeded from the calibrated link rate) and
  ``guarded_call``, which cancels a stalled attempt, records a
  ``stall_retry`` degradation event and retries, a bounded number of
  times; past them it leaves a flight dump and raises.
- The failure classifiers the degradation ladder (``cluster/ladder.py``)
  climbs by: :func:`is_resource_exhausted` (``torch.cuda.
  OutOfMemoryError``, or the JAX package's ``RESOURCE_EXHAUSTED`` marker,
  so one fault plan drives both packages), :func:`is_device_loss` (JAX's
  markers, ``ConnectionError`` and ``StallError``) and
  :func:`is_sticky_cuda_error`: a CUDA error that leaves the context
  unusable, which no rung retries (:func:`terminal_device_error`).
- :func:`deadline_guard`: an absolute deadline over in-thread work with
  a cooperative cancel (the study database's statement deadline,
  ``db/connection.py``).
- :func:`request_budget_s`: the serving daemon's per-request-class budgets
  (``TSE1M_SERVE_<CLASS>_BUDGET_S``).

The JAX package's ``Deadline`` class is left out: nothing calls it.
"""

from __future__ import annotations

import contextvars
import logging
import os
import threading
import time
from contextlib import contextmanager
from typing import Callable

import torch

log = logging.getLogger("tse1m_tpu_torch.watchdog")


def deadline_clock() -> float:
    """The watchdog plane's one clock (seconds, monotonic)."""
    return time.monotonic()


class StallError(RuntimeError):
    """An attempt exceeded its watchdog deadline and was cancelled."""

    def __init__(self, site: str, budget_s: float):
        super().__init__(f"{site}: no heartbeat within {budget_s:.2f}s "
                         "budget; attempt cancelled")
        self.site = site
        self.budget_s = budget_s


def run_with_deadline(fn: Callable, budget_s: float, site: str):
    """Run ``fn()`` on a daemon worker thread; raise :class:`StallError`
    when it does not complete within ``budget_s`` (0 or None: call it
    here, unguarded).

    "Cancel" means *abandon*: the stalled attempt keeps running detached
    and its eventual result is discarded, so guard only work whose
    duplicate completion is harmless.  Exceptions from ``fn`` re-raise
    here unchanged.  The worker runs in a copy of the caller's
    contextvars, so it keeps the caller's active trace span."""
    if budget_s is None or budget_s <= 0:
        return fn()
    box: dict = {}
    ctx = contextvars.copy_context()

    def worker() -> None:
        try:
            box["result"] = ctx.run(fn)
        except BaseException as e:  # noqa: BLE001 - re-raised in the caller below
            box["error"] = e

    t = threading.Thread(target=worker, daemon=True,
                         name=f"tse1m-watchdog:{site}")
    t.start()
    t.join(budget_s)
    if t.is_alive():
        raise StallError(site, budget_s)
    if "error" in box:
        raise box["error"]
    return box.get("result")


@contextmanager
def deadline_guard(budget_s: float, on_timeout: Callable[[], None],
                   site: str = ""):
    """Absolute deadline for in-thread work with a cooperative cancel.

    Arms a timer that calls ``on_timeout()`` (e.g.
    ``sqlite3.Connection.interrupt``) once ``budget_s`` elapses while the
    body is still running; the interrupted operation then fails in-thread
    with its own exception, after a ``deadline_interrupt`` degradation
    event.  The hook never fires after the body completed (the completion
    flag is checked under a lock), so a near miss cannot interrupt a later
    statement.  0 or None: no deadline."""
    if budget_s is None or budget_s <= 0:
        yield
        return
    state = {"done": False}
    lock = threading.Lock()

    def fire() -> None:
        with lock:
            if state["done"]:
                return
        from ..observability import record_degradation

        record_degradation("deadline_interrupt", site=site,
                           detail={"budget_s": budget_s})
        log.warning("%s: deadline %.2fs exceeded; interrupting", site,
                    budget_s)
        on_timeout()

    timer = threading.Timer(budget_s, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        with lock:
            state["done"] = True
        timer.cancel()


# -- device-failure classification -------------------------------------------

# Message markers meaning "the device or its link is gone" (the JAX
# package's list, kept so one fault plan drives both packages).
_DEVICE_LOSS_MARKERS = (
    "device_lost", "device lost", "failed to connect", "socket closed",
    "connection reset", "connection refused", "broken pipe",
    "deadline exceeded", "unavailable", "rpc failed", "internal: stream",
)

# cudaGetErrorString texts of the errors that leave a CUDA context
# unusable (an illegal address, a launch failure, a device-side assert,
# ECC), as the kernels' own launch checks report them, and torch's prefix.
_STICKY_CUDA_MARKERS = (
    "cuda error", "illegal memory access", "illegal address",
    "unspecified launch failure", "device-side assert",
    "uncorrectable ecc", "misaligned address", "illegal instruction",
)


def is_device_loss(e: BaseException) -> bool:
    """True when the failure means the device or its link died, or a stage
    stalled past its budget: the ladder retries on the same card."""
    if isinstance(e, (ConnectionError, StallError)):
        return True
    msg = str(e).lower()
    return any(m in msg for m in _DEVICE_LOSS_MARKERS)


def is_resource_exhausted(e: BaseException) -> bool:
    """True for a torch out-of-memory (``isinstance``; the class exists in
    CPU builds too) and for the JAX package's ``RESOURCE_EXHAUSTED``
    marker, which the fault plane's injected faults carry."""
    return (isinstance(e, torch.cuda.OutOfMemoryError)
            or "RESOURCE_EXHAUSTED" in str(e))


def is_sticky_cuda_error(e: BaseException) -> bool:
    """True for a CUDA error that leaves the context unusable: every later
    call fails, so a retry is pointless.  By type where torch gives one
    (``torch.AcceleratorError``), else by the error's text; an
    out-of-memory is never sticky."""
    if is_resource_exhausted(e):
        return False
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if accelerator_error is not None and isinstance(e, accelerator_error):
        return True
    msg = str(e).lower()
    return any(m in msg for m in _STICKY_CUDA_MARKERS)


class StickyDeviceError(RuntimeError):
    """A sticky CUDA error, raised at once by the degradation ladder."""


def terminal_device_error(e: BaseException,
                          checkpoint_dir: str | None = None
                          ) -> StickyDeviceError:
    """The error the ladder raises for a sticky CUDA error: what failed,
    and how to carry on in a new process."""
    how = (f"resume in a new process with checkpoint_dir={checkpoint_dir!r}"
           " (finished chunks are kept there)" if checkpoint_dir else
           "rerun in a new process; cluster_sessions_resumable with a "
           "checkpoint_dir keeps finished chunks across such a failure")
    return StickyDeviceError(
        f"{type(e).__name__}: {e}"[:300]
        + f" -- the CUDA context is unusable, so nothing is retried; {how}")


def watchdog_enabled() -> bool:
    return os.environ.get("TSE1M_WATCHDOG", "1") not in ("0", "false", "")


class StageWatchdog:
    """Adaptive heartbeat budgets per pipeline stage.

    The budget for a payload of ``nbytes`` is ``max(min_budget, factor *
    nbytes / rate)``, ``rate`` an EWMA of the stage's measured bytes/s,
    seeded from the calibrated link rate when there is one and updated by
    every completed call.  Stages without bytes use ``min_budget``.

    Environment: ``TSE1M_WATCHDOG`` (0 disables the plane),
    ``TSE1M_WATCHDOG_MIN_BUDGET_S`` (30), ``TSE1M_WATCHDOG_FACTOR`` (8),
    ``TSE1M_WATCHDOG_MAX_STALLS`` (cancelled attempts a call before the
    ``StallError`` surfaces, 2)."""

    _EWMA_ALPHA = 0.5

    def __init__(self, min_budget_s: float | None = None,
                 factor: float | None = None,
                 max_stalls: int | None = None,
                 seed_rates: dict | None = None) -> None:
        env = os.environ.get
        self.enabled = watchdog_enabled()
        self.min_budget_s = float(
            env("TSE1M_WATCHDOG_MIN_BUDGET_S", 30.0)
            if min_budget_s is None else min_budget_s)
        self.factor = float(env("TSE1M_WATCHDOG_FACTOR", 8.0)
                            if factor is None else factor)
        self.max_stalls = int(env("TSE1M_WATCHDOG_MAX_STALLS", 2)
                              if max_stalls is None else max_stalls)
        self._lock = threading.Lock()
        self._rate: dict[str, float] = dict(seed_rates or {})  # bytes/s

    def observe(self, stage: str, seconds: float, nbytes: int) -> None:
        """Fold one completed call's measured rate into the stage EWMA."""
        if seconds <= 0 or nbytes <= 0:
            return
        rate = nbytes / seconds
        with self._lock:
            prev = self._rate.get(stage)
            self._rate[stage] = (rate if prev is None else
                                 self._EWMA_ALPHA * rate
                                 + (1 - self._EWMA_ALPHA) * prev)

    def budget_for(self, stage: str, nbytes: int = 0) -> float:
        """Seconds of heartbeat budget for one call; 0 = unguarded."""
        if not self.enabled:
            return 0.0
        with self._lock:
            rate = self._rate.get(stage)
        if nbytes > 0 and rate:
            return max(self.min_budget_s, self.factor * nbytes / rate)
        return self.min_budget_s

    def guarded_call(self, stage: str, fn: Callable, nbytes: int = 0,
                     site: str = ""):
        """``fn()`` under the stage deadline, with bounded stall retries:
        each cancelled attempt records a ``stall_retry`` degradation
        event; past ``max_stalls`` of them a flight dump is left and the
        ``StallError`` goes to the caller's ladder."""
        site = site or stage
        if not self.enabled:
            return fn()
        from ..observability import record_degradation

        stalls = 0
        while True:
            budget = self.budget_for(stage, nbytes)
            t0 = deadline_clock()
            try:
                result = run_with_deadline(fn, budget, site)
            except StallError as e:
                stalls += 1
                record_degradation(
                    "stall_retry", site=site,
                    detail={"budget_s": round(e.budget_s, 3),
                            "attempt": stalls, "nbytes": int(nbytes)})
                if stalls > self.max_stalls:
                    from ..observability.flight import dump_flight

                    dump_flight("deadline_breach", site=site,
                                extra={"budget_s": round(e.budget_s, 3),
                                       "stalls": stalls})
                    raise
                log.warning("%s: stalled attempt %d cancelled (budget "
                            "%.2fs); retrying", site, stalls, e.budget_s)
                continue
            self.observe(stage, deadline_clock() - t0, nbytes)
            return result


# The serving daemon answers two request classes from one process:
# queries must stay interactive (tens of ms) while ingest batches may take
# seconds, so each class carries its own budget, overridable per
# deployment via TSE1M_SERVE_<CLASS>_BUDGET_S.
_REQUEST_BUDGET_DEFAULTS_S = {
    "query": 0.25,    # 5x the 50 ms p99 SLO: a violation is a wedge
    "ingest": 120.0,  # covers a first batch that builds the kernels
    "status": 5.0,
}


def request_budget_s(request_class: str) -> float:
    """Watchdog budget (seconds) for one serve request class; 0 disables
    (``TSE1M_WATCHDOG=0`` disables them all)."""
    if not watchdog_enabled():
        return 0.0
    env = os.environ.get(f"TSE1M_SERVE_{request_class.upper()}_BUDGET_S")
    if env is not None:
        return float(env)
    return _REQUEST_BUDGET_DEFAULTS_S.get(request_class, 30.0)


__all__ = ["StageWatchdog", "StallError", "StickyDeviceError",
           "deadline_clock", "deadline_guard", "is_device_loss", "is_resource_exhausted",
           "is_sticky_cuda_error", "request_budget_s", "run_with_deadline",
           "terminal_device_error", "watchdog_enabled"]
