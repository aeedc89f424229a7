"""The trace plane: the concurrency checks over the serve and store
planes' threads, a port of ``tse1m_tpu/trace/``.

1. **Deterministic schedule exploration** (``sched``, ``explore``): the
   seats (``hooks.trace_point``, ``hooks.shared_access``, ``sync.Lock``)
   become yield points under an installed tracer; the explorer
   serializes the scenario's threads onto one scheduler token and drives
   seeded PCT schedules plus bounded exhaustive interleavings, checking
   the scenario's invariants on every schedule.  Failures print a
   replayable ``v1:fix:...`` schedule string.
2. **Eraser-style lockset race detection** (``lockset``): ``traced()``
   wraps a block; every instrumented shared-state access is checked
   against the held-lock set, and a shared-modified location whose
   candidate lockset goes empty raises :class:`~.lockset.RaceError` with
   both access sites.

``sync`` also carries the profiler's lock-wait seat.
"""

from __future__ import annotations

import contextlib

from .hooks import (Tracer, active_tracer, clear_tracer, install_tracer,
                    shared_access, trace_point)
from .lockset import LocksetChecker, Race, RaceError
from .sched import DeterministicScheduler, Schedule, ScheduleError
from .sync import Lock, RLock, set_lock_wait_recorder


@contextlib.contextmanager
def traced(raise_on_race: bool = True):
    """Run the block under the lockset race detector: the code runs
    unmodified, every instrumented shared-state access is checked
    against the held-lock set, and on exit any detected race raises
    :class:`RaceError` (or is left on ``tracer.lockset.races`` when
    ``raise_on_race=False``)."""
    tracer = Tracer(lockset=LocksetChecker())
    install_tracer(tracer)
    try:
        yield tracer
    finally:
        clear_tracer()
    if raise_on_race and tracer.lockset.races:
        raise RaceError(tracer.lockset.races)


__all__ = ["DeterministicScheduler", "Lock", "LocksetChecker", "RLock",
           "Race", "RaceError", "Schedule", "ScheduleError", "Tracer",
           "active_tracer", "clear_tracer", "install_tracer",
           "set_lock_wait_recorder", "shared_access", "trace_point",
           "traced"]
