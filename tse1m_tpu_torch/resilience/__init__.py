"""Watchdog deadlines and request budgets (``watchdog``): the part of
``tse1m_tpu/resilience`` the serving daemon uses.  The retry engine is
``utils/retry.py``; the fault plane, the coordinator and the device-side
degradation ladder are not ported (ROADMAP.md Queue 1)."""

from .watchdog import (StallError, deadline_clock, request_budget_s,
                       run_with_deadline, watchdog_enabled)

__all__ = ["StallError", "deadline_clock", "request_budget_s",
           "run_with_deadline", "watchdog_enabled"]
