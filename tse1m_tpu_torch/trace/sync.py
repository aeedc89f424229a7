"""Named locks with a lock-wait seat: a copy of
``tse1m_tpu/trace/sync.py``.

``Lock`` / ``RLock`` wrap the real ``threading`` primitives.  With no
recorder installed (the default) an acquire is one global read, a
``None`` check and the real acquire.  With a recorder installed
(:func:`set_lock_wait_recorder`, which ``observability/profiling.py``'s
``enable_lock_wait`` calls), every acquire routes through it, so the
profiler can histogram the time to acquire each lock by its name:
``lock_wait_seconds{site=<name>}``.  The port names its locks as the JAX
package does, so both packages report the same sites.

Left out: the JAX package's tracer branch (``hooks.active_tracer()``),
through which its schedule explorer (``tse1m_tpu/trace/explore.py``)
drives the locks; the explorer is not ported.  The trace plane's own
internals and every lock not named in the JAX package stay raw
``threading`` primitives.
"""

from __future__ import annotations

import threading

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
        rec = _lock_wait_recorder
        if rec is None:
            return self._real.acquire(blocking, timeout)
        return rec(self, self._real.acquire, blocking, timeout)

    def release(self) -> None:
        self._real.release()

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
    """Named reentrant mutex."""

    _factory = staticmethod(threading.RLock)


__all__ = ["Lock", "RLock", "set_lock_wait_recorder"]
