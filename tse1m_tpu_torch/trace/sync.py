"""Named locks with the trace plane's seat and a lock-wait seat: a copy
of ``tse1m_tpu/trace/sync.py``.

``Lock`` / ``RLock`` wrap the real ``threading`` primitives.  With no
tracer and no recorder installed (the default) an acquire is two global
reads, two ``None`` checks and the real acquire.

- With a tracer installed (``hooks.install_tracer``; ``trace.traced()``
  and the schedule explorer do it), every acquire and release updates the
  per-thread held-lock set, the lockset detector's input.  Under a
  deterministic scheduler an acquire becomes a yield point that never
  blocks the scheduler's token on a real mutex: the scheduler
  try-acquires and parks the thread instead, so a descheduled holder
  cannot deadlock the exploration.
- With no tracer but a recorder installed (:func:`set_lock_wait_recorder`,
  which ``observability/profiling.py``'s ``enable_lock_wait`` calls),
  every acquire routes through the recorder, so the profiler can
  histogram the time to acquire each lock by its name:
  ``lock_wait_seconds{site=<name>}``.

The port names its locks as the JAX package does, so both packages
report the same sites.  The trace plane's own internals stay raw
``threading`` primitives: instrumenting the instrumentation would
recurse.
"""

from __future__ import annotations

import threading

from . import hooks

# The recorder must never take a named lock without its own reentrancy
# guard, or recording a wait would recurse.
_lock_wait_recorder = None


def set_lock_wait_recorder(recorder) -> None:
    """Install (or clear, with ``None``) the lock-wait recorder:
    ``recorder(lock, acquire, blocking, timeout) -> bool`` wraps the raw
    acquire and owns the timing."""
    global _lock_wait_recorder
    _lock_wait_recorder = recorder


class Lock:
    """Named non-reentrant mutex (context-manager capable)."""

    _factory = staticmethod(threading.Lock)

    def __init__(self, name: str | None = None) -> None:
        self._real = self._factory()
        self.name = name or "anon"

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        t = hooks.active_tracer()
        if t is None:
            rec = _lock_wait_recorder
            if rec is None:
                return self._real.acquire(blocking, timeout)
            return rec(self, self._real.acquire, blocking, timeout)
        return t.lock_acquire(self, blocking, timeout)

    def release(self) -> None:
        t = hooks.active_tracer()
        if t is None:
            self._real.release()
            return
        t.lock_release(self)

    def locked(self) -> bool:
        return self._real.locked()

    def __enter__(self) -> "Lock":
        self.acquire()
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<trace.sync.{type(self).__name__} {self.name}>"


class RLock(Lock):
    """Named reentrant mutex.

    The real RLock handles reentrancy; the held set sees one entry per
    nesting level, which keeps the release bookkeeping symmetric."""

    _factory = staticmethod(threading.RLock)


__all__ = ["Lock", "RLock", "set_lock_wait_recorder"]
