"""Deterministic schedule control: serialize threads onto one token, a
copy of ``tse1m_tpu/trace/sched.py`` with child threads.

The scheduler owns a set of named threads (started by :meth:`run`) and
grants exactly one of them the run token at a time.  Every seat
(``hooks.trace_point``, ``hooks.shared_access``, a named lock's acquire
and release) is a yield point where the running thread re-enters the
ready pool and the schedule policy picks who runs next.  Because all
participating threads are serialized, a run is a pure function of
(program, schedule): the realized decision sequence replays exactly.

Two policies, both written as a schedule string (every failure prints
one, the way fault plans print ``TSE1M_FAULT_PLAN``):

- ``v1:pct:<seed>:<depth>``: PCT-style randomized priorities (Burckhardt
  et al., "A randomized scheduler with probabilistic guarantees of
  finding bugs").  Each thread draws a fixed priority from the seeded
  RNG, the highest-priority ready thread runs, and at ``depth`` random
  decision indices the current leader is demoted.
- ``v1:fix:a,b,a,...``: an explicit decision list (thread names); past
  its end, the lowest-name ready thread runs.  ``realized()`` turns any
  finished run into this form for exact replay, and the bounded
  exhaustive explorer (``trace/explore.py``) enumerates these prefixes.

Locks: a scheduled thread never blocks the token on a real mutex.  The
traced acquire try-acquires and, on failure, parks the thread as
*blocked* until the holder's release readies it again.  A schedule in
which every thread not done is blocked is reported as a deadlock (with
the replay string), not a hang.

Child threads (the port's addition): a scheduled thread can start
threads that the scheduler owns and steps, with :meth:`spawn`, and wait
for them with :meth:`join`, which parks the parent as *blocked* until
every child is done.  A child is named ``<parent>.<suffix>``, so its
name, and every schedule string that names it, replays.  The router's
read fan-out runs its per-shard forwards this way under a scheduler
(``serve/router.py:ShardRouter._broadcast``).
"""

from __future__ import annotations

import random
import threading

from ..resilience.watchdog import deadline_clock

_WAIT_SLICE_S = 0.02
# PCT change points are drawn from this many leading decisions; the
# explored scenarios realize ~15-50 decisions, so a change lands inside
# most runs (the d ordered context switches PCT's guarantee needs).
_PCT_HORIZON = 48


class ScheduleError(AssertionError):
    """An invariant, deadlock or hang under a specific schedule; the
    message carries the replay string."""

    def __init__(self, message: str, schedule_str: str = "") -> None:
        if schedule_str:
            message = f"{message}\n  replay: {schedule_str}"
        super().__init__(message)
        self.schedule_str = schedule_str


class _Abort(BaseException):
    """Internal unwind for threads parked when a run dies (BaseException
    so production ``except Exception`` seats cannot absorb it)."""


class Schedule:
    """A replayable scheduling policy (see the module docstring)."""

    def __init__(self, kind: str, seed: int = 0, depth: int = 3,
                 choices: tuple = ()) -> None:
        if kind not in ("pct", "fix"):
            raise ValueError(f"unknown schedule kind {kind!r}")
        self.kind = kind
        self.seed = int(seed)
        self.depth = int(depth)
        self.choices = tuple(choices)
        self._prio: dict[str, float] = {}
        self._rng = random.Random(self.seed)
        self._change_points = (
            frozenset(random.Random(self.seed ^ 0x5EED).sample(
                range(_PCT_HORIZON), min(self.depth, _PCT_HORIZON)))
            if kind == "pct" else frozenset())

    @classmethod
    def pct(cls, seed: int, depth: int = 3) -> "Schedule":
        return cls("pct", seed=seed, depth=depth)

    @classmethod
    def fixed(cls, choices) -> "Schedule":
        return cls("fix", choices=tuple(choices))

    @classmethod
    def from_string(cls, s: str) -> "Schedule":
        parts = s.strip().split(":")
        if len(parts) < 2 or parts[0] != "v1":
            raise ValueError(f"bad schedule string {s!r} (want "
                             "'v1:pct:<seed>:<depth>' or 'v1:fix:a,b,...')")
        if parts[1] == "pct":
            return cls.pct(int(parts[2]),
                           int(parts[3]) if len(parts) > 3 else 3)
        if parts[1] == "fix":
            names = parts[2].split(",") if len(parts) > 2 and parts[2] \
                else []
            return cls.fixed(n for n in names if n)
        raise ValueError(f"bad schedule string {s!r}")

    def to_string(self) -> str:
        if self.kind == "pct":
            return f"v1:pct:{self.seed}:{self.depth}"
        return "v1:fix:" + ",".join(self.choices)

    def choose(self, ready: list, idx: int) -> str:
        """Pick the next thread name from the (ordered) ready list."""
        if self.kind == "fix":
            if idx < len(self.choices) and self.choices[idx] in ready:
                return self.choices[idx]
            return min(ready)
        for name in ready:
            if name not in self._prio:
                self._prio[name] = self._rng.random()
        if idx % _PCT_HORIZON in self._change_points:
            leader = max(ready, key=lambda n: self._prio[n])
            self._prio[leader] -= 1.0
        return max(ready, key=lambda n: self._prio[n])


def fixed_schedule_string(names) -> str:
    """A decision-name sequence as a replayable ``v1:fix:...`` string.
    Names must be schedule-safe (no separator characters)."""
    names = tuple(names)
    for n in names:
        if not n or any(ch in n for ch in ",:\n "):
            raise ValueError(f"decision name {n!r} is not "
                             "schedule-safe (no ',', ':' or whitespace)")
    return Schedule.fixed(names).to_string()


class _TState:
    __slots__ = ("name", "status", "blocked_on", "thread")

    def __init__(self, name: str) -> None:
        self.name = name
        self.status = "ready"   # ready | running | blocked | done
        self.blocked_on = None  # lock id, or ("join", names), when blocked
        self.thread: threading.Thread | None = None


class _Child:
    """A child thread's handle: its name and, once done, its result or
    the exception it raised."""

    __slots__ = ("name", "result", "error")

    def __init__(self, name: str) -> None:
        self.name = name
        self.result = None
        self.error: BaseException | None = None


class DeterministicScheduler:
    """One controlled run of a set of named thread bodies."""

    def __init__(self, schedule: Schedule, timeout_s: float = 60.0,
                 max_decisions: int = 100_000) -> None:
        self.schedule = schedule
        self.timeout_s = float(timeout_s)
        self.max_decisions = int(max_decisions)
        self._cv = threading.Condition()
        self._states: dict[int, _TState] = {}     # thread ident -> state
        self._by_name: dict[str, _TState] = {}
        self._running: _TState | None = None
        self._error: BaseException | None = None
        self._decision_idx = 0
        self.decisions: list[str] = []      # realized choices
        self.alternatives: list[tuple] = []  # ready set at each decision
        self.sites: list[str] = []          # seat names, for diagnostics

    def realized(self) -> Schedule:
        """The finished run as an exact-replay fixed schedule."""
        return Schedule.fixed(self.decisions)

    def run(self, bodies: dict) -> None:
        """Execute ``{name: callable}`` to completion under the
        schedule; re-raises the first failure with the replay string."""
        for name in sorted(bodies):
            st = _TState(name)
            self._by_name[name] = st
            st.thread = threading.Thread(
                target=self._body, name=f"trace-{name}",
                args=(st, bodies[name], True), daemon=True)
        self._barrier = threading.Barrier(len(bodies) + 1)
        for st in self._by_name.values():
            st.thread.start()
        self._barrier.wait(timeout=10)  # all registered in _states
        with self._cv:
            self._grant_locked()
        limit = deadline_clock() + self.timeout_s
        with self._cv:
            while not all(s.status == "done"
                          for s in self._by_name.values()):
                if self._error is not None:
                    break
                if deadline_clock() > limit:
                    self._error = ScheduleError(
                        "scheduled run hung (" + ", ".join(
                            f"{s.name}={s.status}"
                            for s in self._by_name.values()) + ")",
                        self._replay_str())
                    break
                self._cv.wait(_WAIT_SLICE_S)
            err = self._error
            if err is not None:
                # Unpark everyone so the worker threads unwind via _Abort.
                self._cv.notify_all()
            threads = [s.thread for s in self._by_name.values()]
        for t in threads:
            t.join(timeout=5)
        if err is not None:
            if isinstance(err, ScheduleError):
                raise err
            raise ScheduleError(
                f"{type(err).__name__}: {err}", self._replay_str()) \
                from err

    def owns_current_thread(self) -> bool:
        return threading.get_ident() in self._states

    def spawn(self, suffix: str, fn) -> _Child:
        """Start ``fn`` on a child thread ``<parent>.<suffix>`` that the
        scheduler owns.  The child is ready at once and first runs when
        the parent yields; its result or exception is kept for
        :meth:`join`.  A name comes back for the parent's next fan-out
        once its last holder is done."""
        parent = self._states[threading.get_ident()]
        child = _Child(f"{parent.name}.{suffix}")
        st = _TState(child.name)

        def body() -> None:
            try:
                child.result = fn()
            except Exception as e:  # graftlint: disable=broad-except -- cross-thread relay: join() re-raises it in the parent (a child thread the port's scheduler spawns; JAX's spawns none)
                child.error = e

        with self._cv:
            prev = self._by_name.get(child.name)
            if prev is not None and prev.status != "done":
                raise ValueError(f"scheduled thread {child.name!r} is "
                                 "still running")
            self._by_name[child.name] = st
            st.thread = threading.Thread(
                target=self._body, name=f"trace-{child.name}",
                args=(st, body, False), daemon=True)
        st.thread.start()
        return child

    def join(self, children) -> list:
        """Park the calling thread until every child is done; their
        results in order, or the first child's exception re-raised."""
        children = list(children)
        names = tuple(c.name for c in children)
        st = self._states[threading.get_ident()]
        with self._cv:
            while not all(self._by_name[n].status == "done" for n in names):
                st.status = "blocked"
                st.blocked_on = ("join", names)
                if self._running is st:
                    self._running = None
                self._grant_locked()
                self._wait_for_token_locked(st)
        for c in children:
            if c.error is not None:
                raise c.error
        return [c.result for c in children]

    def yield_point(self, site: str) -> None:
        st = self._states.get(threading.get_ident())
        if st is None:
            return
        with self._cv:
            self.sites.append(site)
            st.status = "ready"
            if self._running is st:
                self._running = None
            self._grant_locked()
            self._wait_for_token_locked(st)

    def acquire(self, lock) -> None:
        """Traced-lock acquire for a scheduled thread: never blocks the
        token; try-acquire, else park as blocked until release."""
        st = self._states[threading.get_ident()]
        while True:
            self.yield_point(f"lock:{lock.name}")
            if lock._real.acquire(blocking=False):
                return
            with self._cv:
                st.status = "blocked"
                st.blocked_on = id(lock)
                if self._running is st:
                    self._running = None
                self._grant_locked()
                self._wait_for_token_locked(st)

    def released(self, lock) -> None:
        # Runs for ANY releasing thread (an unscheduled one must still
        # ready the scheduled waiters it unblocks).
        scheduled = threading.get_ident() in self._states
        with self._cv:
            for other in self._by_name.values():
                if other.blocked_on == id(lock):
                    other.blocked_on = None
                    other.status = "ready"
            if not scheduled:
                self._grant_locked()
            # A scheduled releaser keeps the token; its waiters are
            # granted at its next yield point.

    def _body(self, st: _TState, fn, at_start: bool) -> None:
        ident = threading.get_ident()
        with self._cv:
            self._states[ident] = st
        try:
            if at_start:
                self._barrier.wait(timeout=10)
            with self._cv:
                self._wait_for_token_locked(st)
            fn()
        except _Abort:
            pass
        except BaseException as e:  # graftlint: disable=broad-except -- cross-thread relay: re-raised on the main thread by run() with the replay string attached
            with self._cv:
                if self._error is None:
                    self._error = e
                self._cv.notify_all()
        finally:
            with self._cv:
                st.status = "done"
                # The OS reuses a finished thread's ident: an unowned
                # helper thread started later must not inherit this seat.
                self._states.pop(ident, None)
                if self._running is st:
                    self._running = None
                self._ready_joiners_locked()
                self._grant_locked()
                self._cv.notify_all()

    def _ready_joiners_locked(self) -> None:
        for other in self._by_name.values():
            on = other.blocked_on
            if (isinstance(on, tuple) and on[0] == "join"
                    and all(self._by_name[n].status == "done"
                            for n in on[1])):
                other.blocked_on = None
                other.status = "ready"

    def _replay_str(self) -> str:
        return Schedule.fixed(self.decisions).to_string()

    def _grant_locked(self) -> None:
        if self._running is not None or self._error is not None:
            return
        ready = [s.name for s in self._by_name.values()
                 if s.status == "ready"]
        if not ready:
            blocked = [s.name for s in self._by_name.values()
                       if s.status == "blocked"]
            if blocked:
                self._error = ScheduleError(
                    f"deadlock: thread(s) {blocked} blocked with no "
                    "runnable thread", self._replay_str())
                self._cv.notify_all()
            return
        if self._decision_idx >= self.max_decisions:
            self._error = ScheduleError(
                f"schedule exceeded {self.max_decisions} decisions",
                self._replay_str())
            self._cv.notify_all()
            return
        if len(ready) > 1:
            name = self.schedule.choose(sorted(ready), self._decision_idx)
            self.decisions.append(name)
            self.alternatives.append(tuple(sorted(ready)))
            self._decision_idx += 1
        else:
            name = ready[0]
        chosen = self._by_name[name]
        chosen.status = "running"
        self._running = chosen
        self._cv.notify_all()

    def _wait_for_token_locked(self, st: _TState) -> None:
        while st.status != "running":
            if self._error is not None:
                raise _Abort()
            if st.status == "done":  # pragma: no cover - defensive
                raise _Abort()
            self._cv.wait(_WAIT_SLICE_S)


__all__ = ["DeterministicScheduler", "Schedule", "ScheduleError",
           "fixed_schedule_string"]
