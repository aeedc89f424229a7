"""Watchdog deadlines and per-request-class budgets: a copy of
``tse1m_tpu/resilience/watchdog.py:49-66, 85-121, 193-194, 297-326``.

- :func:`deadline_clock`: the one clock of every deadline, latency window
  and span in the port (monotonic; immune to NTP steps).
- :func:`run_with_deadline`: run a callable on a worker thread; past the
  budget the wait is cancelled and :class:`StallError` raised.  A thread
  cannot be killed, so the work runs on, detached, and its result is
  dropped: the deadline cancels the wait, not the work (CUDA work the
  thread queued runs to its end too).
- :func:`request_budget_s`: the serving daemon's per-request-class budgets
  (``TSE1M_SERVE_<CLASS>_BUDGET_S``).

Left out until a path of the port calls them (ROADMAP.md Queue 1,
"Device-side resilience"): ``StageWatchdog`` (adaptive per-stage budgets
and stall retries), ``deadline_guard`` and ``Deadline``, and
``is_device_loss`` and ``is_resource_exhausted``, which will map
``torch.cuda.OutOfMemoryError`` onto the ladder's rungs.  The JAX
package's fault plane (its ``stall`` seats) is not ported.
"""

from __future__ import annotations

import contextvars
import os
import threading
import time
from typing import Callable


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


def watchdog_enabled() -> bool:
    return os.environ.get("TSE1M_WATCHDOG", "1") not in ("0", "false", "")


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


__all__ = ["StallError", "deadline_clock", "request_budget_s",
           "run_with_deadline", "watchdog_enabled"]
