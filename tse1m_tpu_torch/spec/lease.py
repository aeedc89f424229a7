"""Protocol spec: epoch leases, membership re-deal, zombie
self-fencing (resilience/coordinator.py + the serve daemon's
fence-before-append seat).

The model: ``n_procs`` writer processes compete for one range lease.
The on-disk lease is ``(epoch, owner)``; a claim is advance-then-
acquire (``RangeLeaseGuard.claim``): the epoch is bumped whether or
not the previous holder is dead — which is exactly why a paused
("wedged") old holder can wake as a **zombie** believing a stale
epoch.  Every batch commit verifies the lease atomically with the
append (``verify_lease`` inside the ingest commit), so the zombie's
next write observes the advanced epoch and latches **fenced** instead
of appending.

Bounded scope (defaults): 2 writers x 3 epochs, append log capped at
2, 2 wedge/wake excursions.  ~300 states; exhaustive in milliseconds.

Safety: every recorded append carries ``believed == actual`` epoch
(the fence happened BEFORE the append, never after), and at most one
process holds a current view of the lease.  Liveness (weak fairness on
the commit action): a live zombie cannot persist — its continuously
enabled commit eventually runs and fences it.

The committed mutation ``fence-after-append`` reorders the commit
effect (append first, then fence on mismatch): the checker finds the
classic zombie double-write with a minimal replayable schedule.
"""

from __future__ import annotations

from .dsl import Action, Invariant, Liveness, Spec, tupset, upd

SPEC_NAME = "lease"

MUTANTS = ("fence-after-append",)


def _claim(p: int):
    def guard(s):
        return s["pstate"][p] == "idle" and s["epoch"] < s["max_epoch"]

    def effect(s):
        e = s["epoch"] + 1
        return upd(s, epoch=e, owner=p,
                   pstate=tupset(s["pstate"], p, "holder"),
                   pepoch=tupset(s["pepoch"], p, e))
    return guard, effect


def _wedge(p: int):
    def guard(s):
        return s["pstate"][p] == "holder" and s["wedges"] < s["max_wedges"]

    def effect(s):
        return upd(s, pstate=tupset(s["pstate"], p, "wedged"),
                   wedges=s["wedges"] + 1)
    return guard, effect


def _wake(p: int):
    def guard(s):
        return s["pstate"][p] == "wedged"

    def effect(s):
        return upd(s, pstate=tupset(s["pstate"], p, "holder"))
    return guard, effect


def _commit(p: int, mutant: str | None):
    def guard(s):
        return s["pstate"][p] == "holder"

    def effect(s):
        current = s["pepoch"][p] == s["epoch"] and s["owner"] == p
        if mutant == "fence-after-append":
            # BUG under test: the append lands before the fence check.
            out = s
            if len(s["log"]) < s["log_cap"]:
                out = upd(s, log=s["log"] + ((s["pepoch"][p],
                                              s["epoch"]),))
            if not current:
                out = upd(out, pstate=tupset(out["pstate"], p, "fenced"))
            return out
        if not current:
            return upd(s, pstate=tupset(s["pstate"], p, "fenced"))
        if len(s["log"]) < s["log_cap"]:
            return upd(s, log=s["log"] + ((s["pepoch"][p],
                                           s["epoch"]),))
        return dict(s)  # log saturated: the commit is a no-op
    return guard, effect


def build(n_procs: int = 2, max_epoch: int = 3, log_cap: int = 2,
          max_wedges: int = 2, mutant: str | None = None) -> Spec:
    if mutant is not None and mutant not in MUTANTS:
        raise ValueError(f"unknown lease mutant {mutant!r}")
    init = {"epoch": 1, "owner": 0,
            "pstate": ("holder",) + ("idle",) * (n_procs - 1),
            "pepoch": (1,) + (0,) * (n_procs - 1),
            "log": (), "wedges": 0,
            "max_epoch": max_epoch, "log_cap": log_cap,
            "max_wedges": max_wedges}
    actions = []
    for p in range(n_procs):
        g, e = _claim(p)
        actions.append(Action(f"claim_p{p}", g, e,
                              seat="call:acquire_lease"))
        g, e = _wedge(p)
        actions.append(Action(f"wedge_p{p}", g, e, seat="model:pause"))
        g, e = _wake(p)
        actions.append(Action(f"wake_p{p}", g, e, seat="model:pause"))
        g, e = _commit(p, mutant)
        actions.append(Action(f"commit_p{p}", g, e,
                              seat="call:verify_lease", fair=True))

    def _no_stale_append(s):
        return all(believed == actual for believed, actual in s["log"])

    def _single_current_holder(s):
        current = [p for p in range(n_procs)
                   if s["pstate"][p] == "holder"
                   and s["pepoch"][p] == s["epoch"]
                   and s["owner"] == p]
        return len(current) <= 1

    def _no_future_view(s):
        return all(pe <= s["epoch"] for pe in s["pepoch"])

    def _no_live_zombie(s):
        return not any(s["pstate"][p] == "holder"
                       and (s["pepoch"][p] != s["epoch"]
                            or s["owner"] != p)
                       for p in range(n_procs))

    return Spec(
        name="lease" if mutant is None else f"lease[{mutant}]",
        init=init,
        actions=tuple(actions),
        invariants=(
            Invariant("fence-before-append", _no_stale_append),
            Invariant("single-current-holder", _single_current_holder),
            Invariant("no-future-view", _no_future_view),
        ),
        liveness=(Liveness("zombie-eventually-fences", _no_live_zombie),),
        scope={"n_procs": n_procs, "max_epoch": max_epoch,
               "log_cap": log_cap, "max_wedges": max_wedges},
    )


__all__ = ["MUTANTS", "SPEC_NAME", "build"]
