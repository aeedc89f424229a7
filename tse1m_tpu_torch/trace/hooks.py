"""The trace plane's seats: one global tracer slot, a copy of
``tse1m_tpu/trace/hooks.py``.

Concurrency seats in the serve and store planes call
:func:`trace_point` and :func:`shared_access`.  With no tracer installed
(the default) each call is a module-global read and a ``None`` check.
Installing a :class:`Tracer` (``trace.traced()`` and the schedule
explorer do) turns the same code paths into instrumented ones:

- ``trace_point("dotted.site")``: a scheduling yield point at a named
  seat (queue ops, snapshot swaps, store append, refresh and
  consolidation).  Under a deterministic scheduler the calling thread
  may be descheduled here; without one the seat is inert.
- ``shared_access(obj, field, write=...)``: an instrumented shared-state
  access for the lockset detector (``trace.lockset``), keyed per
  instance.  ``atomic=True`` marks one-reference snapshot swaps: those
  accesses are scheduling points but are exempt from lockset checking;
  the explorer's invariants check them instead.
- ``trace.sync.Lock`` / ``RLock`` report acquire and release through the
  same slot, so the detector knows the held-lock set at every access and
  the scheduler can interleave threads around lock boundaries without
  blocking the token on a real mutex.
- :func:`fan_out` runs a call per key on a thread pool, or, when a
  scheduler owns the caller, on child threads that it steps.

The seats carry the JAX package's site and field strings, so both
packages report the same names.  They are in ``serve/daemon.py``,
``serve/router.py``, ``serve/replicate.py``, ``serve/slo.py``,
``cluster/store.py``, ``cluster/observability.py`` and
``observability/`` (latency, metrics, tracing, profiling).
"""

from __future__ import annotations

import sys
import threading


class Tracer:
    """The installed instrumentation: an optional lockset checker, an
    optional deterministic scheduler, and the per-thread held-lock
    bookkeeping both share."""

    def __init__(self, lockset=None, scheduler=None) -> None:
        self.lockset = lockset
        self.scheduler = scheduler
        self._held = threading.local()

    def _held_list(self) -> list:
        lst = getattr(self._held, "locks", None)
        if lst is None:
            lst = []
            self._held.locks = lst
        return lst

    def held_keys(self) -> frozenset:
        return frozenset(k for k, _ in self._held_list())

    def held_names(self) -> tuple:
        return tuple(n for _, n in self._held_list())

    def on_point(self, site: str) -> None:
        if self.scheduler is not None:
            self.scheduler.yield_point(site)

    def on_shared_access(self, obj, field: str, write: bool,
                         atomic: bool) -> None:
        name = f"{type(obj).__name__}.{field}"
        if self.scheduler is not None:
            self.scheduler.yield_point(
                f"{'write' if write else 'read'}:{name}")
        if self.lockset is not None and not atomic:
            self.lockset.on_access(
                key=(id(obj), field), name=name, write=write,
                held=self.held_keys(), held_names=self.held_names(),
                site=_caller_site())

    def lock_acquire(self, lock, blocking: bool = True,
                     timeout: float = -1) -> bool:
        sched = self.scheduler
        if sched is not None and sched.owns_current_thread():
            sched.acquire(lock)
        else:
            if not lock._real.acquire(blocking, timeout):
                return False
        self._held_list().append((id(lock), lock.name))
        return True

    def lock_release(self, lock) -> None:
        lst = self._held_list()
        for i in range(len(lst) - 1, -1, -1):
            if lst[i][0] == id(lock):
                del lst[i]
                break
        lock._real.release()
        if self.scheduler is not None:
            self.scheduler.released(lock)


def _caller_site(skip_prefixes: tuple = ("tse1m_tpu_torch/trace/",)) -> str:
    """'path:line in func' of the nearest frame outside the trace plane:
    the access seat a race report points at."""
    f = sys._getframe(2)
    for _ in range(8):
        if f is None:
            break
        fname = f.f_code.co_filename.replace("\\", "/")
        if not any(p in fname for p in skip_prefixes):
            short = "/".join(fname.rsplit("/", 3)[-3:])
            return f"{short}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return "<unknown>"


_tracer: Tracer | None = None


def install_tracer(tracer: Tracer) -> None:
    global _tracer
    if _tracer is not None:
        raise RuntimeError("a graftrace tracer is already installed "
                           "(traced()/the explorer do not nest)")
    _tracer = tracer


def clear_tracer() -> None:
    global _tracer
    _tracer = None


def active_tracer() -> Tracer | None:
    return _tracer


def trace_point(site: str) -> None:
    """A scheduling seat.  No tracer: a global read and a None check."""
    t = _tracer
    if t is not None:
        t.on_point(site)


def shared_access(obj, field: str, write: bool = False,
                  atomic: bool = False) -> None:
    """An instrumented shared-state access (see the module docstring)."""
    t = _tracer
    if t is not None:
        t.on_shared_access(obj, field, write, atomic)


def fan_out(pool, fn, keys) -> dict:
    """``fn(key)`` for every key at once; answers by key, the first
    failure in key order re-raised.  Runs on ``pool`` (an executor),
    unless an installed scheduler owns the calling thread: then each call
    runs on a child thread ``<caller>.<key>`` that the scheduler steps,
    so the fan-out's interleavings are explored and replay by name."""
    keys = list(keys)
    t = _tracer
    sched = None if t is None else t.scheduler
    if sched is not None and sched.owns_current_thread():
        children = [sched.spawn(str(k), lambda k=k: fn(k)) for k in keys]
        return dict(zip(keys, sched.join(children)))
    futures = {k: pool.submit(fn, k) for k in keys}
    return {k: f.result() for k, f in futures.items()}


__all__ = ["Tracer", "active_tracer", "clear_tracer", "fan_out",
           "install_tracer", "shared_access", "trace_point"]
