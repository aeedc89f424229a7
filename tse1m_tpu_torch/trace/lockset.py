"""Eraser-style lockset race detection over the instrumented seats, a
copy of ``tse1m_tpu/trace/lockset.py``.

The classic algorithm (Savage et al., "Eraser: a dynamic data race
detector for multithreaded programs"): every shared location starts
*virgin*; the first accessing thread owns it *exclusive* (single-thread
init is never a race); once a second thread touches it the location
turns *shared* (reads) or *shared-modified* (any write), and from then
on its **candidate lockset**, the intersection of the lock sets held at
every access, must stay non-empty.  A shared-modified location whose
candidate set goes empty has no lock that consistently guards it: a
data race, reported with both access sites (the one that emptied the
set and the previous access), thread names, and the locks each side
held.

Locations are the ``hooks.shared_access`` seats (keyed per instance, so
two StageRecorders never alias), and the held sets come from the named
``trace.sync`` locks.  One-reference snapshot swaps (the daemon's live
index, the store's probe index) are instrumented ``atomic=True`` and
exempt here: lock-free by design, checked by the schedule explorer's
invariants instead.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field


@dataclass
class Access:
    """One instrumented access, as the report shows it."""

    site: str
    thread: str
    write: bool
    held: tuple

    def __str__(self) -> str:
        kind = "WRITE" if self.write else "READ"
        locks = ", ".join(self.held) if self.held else "NO locks"
        return f"{kind} at {self.site} [thread {self.thread}, " \
               f"holding {locks}]"


@dataclass
class Race:
    """A shared-modified location whose candidate lockset went empty."""

    name: str
    current: Access
    previous: Access | None

    def describe(self) -> str:
        lines = [f"race on {self.name}: no lock consistently guards it",
                 f"  - {self.current}"]
        if self.previous is not None:
            lines.append(f"  - {self.previous}")
        return "\n".join(lines)


class RaceError(AssertionError):
    """Raised by ``traced()`` on exit when the lockset detector found
    races (carries them for programmatic inspection)."""

    def __init__(self, races: list) -> None:
        super().__init__(
            f"{len(races)} data race(s) detected:\n"
            + "\n".join(r.describe() for r in races))
        self.races = list(races)


@dataclass
class _Cell:
    state: str                       # exclusive | shared | shared_mod
    owner: int
    lockset: frozenset | None = None  # None = not yet shared
    last: Access | None = None
    last_write: Access | None = None
    reported: bool = field(default=False)


class LocksetChecker:
    """Process-wide Eraser state for one ``traced()`` window.

    Internals use raw ``threading`` locks — instrumenting the
    instrumentation would recurse through the tracer."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._cells: dict[tuple, _Cell] = {}
        self.races: list[Race] = []

    def on_access(self, key: tuple, name: str, write: bool,
                  held: frozenset, held_names: tuple, site: str) -> None:
        # Thread identity includes the (unique-per-process) name: raw
        # idents are reused by the OS after a join, which would alias a
        # dead writer with a fresh one and mask the shared transition.
        me = (threading.get_ident(), threading.current_thread().name)
        acc = Access(site=site, thread=threading.current_thread().name,
                     write=write, held=held_names)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                self._cells[key] = _Cell(
                    state="exclusive", owner=me, last=acc,
                    last_write=acc if write else None)
                return
            if cell.state == "exclusive" and cell.owner == me:
                cell.last = acc
                if write:
                    cell.last_write = acc
                return
            # Second thread: enter the shared states and start (or
            # continue) intersecting candidate locksets.
            cell.lockset = (held if cell.lockset is None
                            else cell.lockset & held)
            if write or cell.state == "shared_mod":
                cell.state = "shared_mod"
            else:
                cell.state = "shared"
            if (cell.state == "shared_mod" and not cell.lockset
                    and not cell.reported):
                cell.reported = True
                prev = cell.last_write if (not write and cell.last_write
                                           ) else cell.last
                self.races.append(Race(name=name, current=acc,
                                       previous=prev))
            cell.last = acc
            if write:
                cell.last_write = acc

    def summary(self) -> dict:
        with self._lock:
            return {"trace_cells": len(self._cells),
                    "trace_races_found": len(self.races)}


__all__ = ["Access", "LocksetChecker", "Race", "RaceError"]
