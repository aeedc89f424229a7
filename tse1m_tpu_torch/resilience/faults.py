"""Deterministic, seeded fault-injection plane: a copy of
``tse1m_tpu/resilience/faults.py``.

Production seats call ``fault_point("dotted.site", path=...)``.  With no
plan active (the production default) that is one global read and a
return.  Tests, or an operator's game day, activate a :class:`FaultPlan`
in process (``install_plan``, ``with plan.active():``) or across a process
boundary through ``TSE1M_FAULT_PLAN=<plan.json>``, and the production
code paths then run under injected failures.  The plan JSON is the JAX
package's, so one plan file drives either package.

Seats of the port (grep for ``fault_point(``):

- ``pipeline.h2d``             one chunk's staged copy to the card
- ``pipeline.compute``         one chunk's compute wait
- ``checkpoint.cluster.save``  a cluster checkpoint shard write
- ``store.sig.save``           a signature-store shard append
- ``store.compact.save``       a store compaction's shard write
- ``store.state.save``         the store's LSH state write
- ``serve.ingest.commit``      an ingest batch's durability point, before
                               the lease check and the store append
- ``serve.router.forward``     a router's shard answer, before it is
                               passed up (the lost-ack window)
- ``serve.replica.stream``     a replica pull, before its manifest commit

Kinds, as the JAX package's: ``raise`` (:class:`InjectedFault`),
``connection_drop`` (:class:`InjectedConnectionDrop`, a
``ConnectionError``), ``delay`` (sleep ``delay_s``, pass through),
``torn_write`` (truncate the seat's file to ``truncate_fraction``, then
raise), ``kill`` (a flight dump, then ``SIGKILL`` of this process) and
``stall`` (sleep ``stall_s``, pass through: the hang the watchdog turns
into a recoverable cancellation).  ``hostloss`` and ``zombie`` need the pod
supervisor, which is not ported (``coordinator.py`` holds only the serving
plane's leases and heartbeats): a plan may name them, and they raise
NotImplementedError when they fire.

The seats fire on the stream's producer thread too, so a plan's counters
and its log take a lock.
"""

from __future__ import annotations

import fnmatch
import json
import logging
import os
import random
import signal
import threading
import time
from dataclasses import asdict, dataclass, field

log = logging.getLogger("tse1m_tpu_torch.faults")


class InjectedFault(Exception):
    """A transient failure injected by the fault plane."""


class InjectedConnectionDrop(ConnectionError, InjectedFault):
    """An injected dropped connection (classified like a real one)."""


_KINDS = ("raise", "connection_drop", "delay", "torn_write", "kill",
          "stall", "hostloss", "zombie")


@dataclass
class FaultRule:
    """One per-site rule.  ``site`` is an fnmatch pattern against the seat
    name; the rule fires for the matching calls numbered ``[after_calls,
    after_calls + times)`` (its own counter), each time with probability
    ``probability`` drawn from the plan's seeded RNG."""

    site: str
    kind: str = "raise"
    times: int = 1                 # how many calls fire; -1 = every call
    after_calls: int = 0           # skip this many matching calls first
    probability: float = 1.0       # per-eligible-call chance (seeded RNG)
    message: str = "injected fault"
    delay_s: float = 0.05          # kind=delay
    stall_s: float = 30.0          # kind=stall (a hang, not a hiccup)
    truncate_fraction: float = 0.5  # kind=torn_write
    wake_path: str | None = None   # kind=zombie (not ported)
    _seen: int = field(default=0, repr=False, compare=False)
    _fired: int = field(default=0, repr=False, compare=False)

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {_KINDS}")


class FaultPlan:
    """An ordered set of :class:`FaultRule` s and a seeded RNG.  The first
    matching, still eligible rule fires per call.  ``fired`` is the log of
    (site, kind) events."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.rules = list(rules)
        self.rng = random.Random(seed)
        self.seed = seed
        self.fired: list[tuple[str, str]] = []
        self._lock = threading.Lock()

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        rules = [FaultRule(**r) for r in d.get("rules", [])]
        return cls(rules, seed=int(d.get("seed", 0)))

    @classmethod
    def from_json(cls, path: str) -> "FaultPlan":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def to_dict(self) -> dict:
        rules = []
        for r in self.rules:
            d = asdict(r)
            d.pop("_seen"), d.pop("_fired")
            rules.append(d)
        return {"seed": self.seed, "rules": rules}

    def save(self, path: str) -> str:
        from ..utils.atomic import atomic_write

        with atomic_write(path) as f:
            json.dump(self.to_dict(), f, indent=2)
        return path

    def fire(self, site: str, path: str | None = None) -> None:
        with self._lock:
            rule = self._match(site)
        if rule is None:
            return
        log.warning("fault plane: %s at %s (fire %d)", rule.kind, site,
                    rule._fired)
        from ..observability import metrics

        metrics.counter("fault_injections_total", site=site,
                        kind=rule.kind).inc()
        self._apply(rule, site, path)

    def _match(self, site: str) -> FaultRule | None:
        """Count the call against the matching rules; the rule that fires,
        if any (at most one a call)."""
        for rule in self.rules:
            if not fnmatch.fnmatch(site, rule.site):
                continue
            rule._seen += 1
            if rule._seen <= rule.after_calls:
                continue
            if rule.times >= 0 and rule._fired >= rule.times:
                continue
            if rule.probability < 1.0 and \
                    self.rng.random() >= rule.probability:
                continue
            rule._fired += 1
            self.fired.append((site, rule.kind))
            return rule
        return None

    def _apply(self, rule: FaultRule, site: str, path: str | None) -> None:
        if rule.kind == "delay":
            time.sleep(rule.delay_s)
            return
        if rule.kind == "stall":
            time.sleep(rule.stall_s)
            return
        if rule.kind in ("hostloss", "zombie"):
            from ..cluster.pipeline import _not_ported

            raise _not_ported(f"the fault plane's {rule.kind!r} kind (the "
                              "pod supervisor)", "Multi-GPU")
        if rule.kind == "kill":
            # SIGKILL runs no handler: the flight dump goes first, its
            # terminal span naming this seat.
            from ..observability.flight import dump_flight

            dump_flight("fault.kill", site=site)
            os.kill(os.getpid(), signal.SIGKILL)
            # Delivery can be asynchronous: never fall through to another
            # kind while the signal is in flight.
            raise SystemExit(f"fault plane: SIGKILL at {site}")
        if rule.kind == "torn_write" and path and os.path.exists(path):
            size = os.path.getsize(path)
            keep = int(size * rule.truncate_fraction)
            with open(path, "rb+") as f:
                f.truncate(keep)
            log.warning("fault plane: tore %s to %d/%d bytes", path, keep,
                        size)
        if rule.kind == "connection_drop":
            raise InjectedConnectionDrop(f"{rule.message} at {site}")
        raise InjectedFault(f"{rule.message} at {site}")

    def active(self) -> "_Activation":
        """``with plan.active(): ...`` installs the plan in process."""
        return _Activation(self)


class _Activation:
    def __init__(self, plan: FaultPlan):
        self.plan = plan

    def __enter__(self) -> FaultPlan:
        install_plan(self.plan)
        return self.plan

    def __exit__(self, *exc) -> None:
        clear_plan()


_plan: FaultPlan | None = None
_env_loaded = False
_env_lock = threading.Lock()


def install_plan(plan: FaultPlan) -> None:
    global _plan, _env_loaded
    _plan = plan
    _env_loaded = True  # an explicit install wins over the env plan


def clear_plan() -> None:
    global _plan, _env_loaded
    _plan = None
    _env_loaded = True


def active_plan() -> FaultPlan | None:
    """The installed plan, loading ``TSE1M_FAULT_PLAN`` on first use."""
    global _plan, _env_loaded
    if _env_loaded:
        return _plan
    with _env_lock:
        if not _env_loaded:
            path = os.environ.get("TSE1M_FAULT_PLAN")
            if path:
                try:
                    _plan = FaultPlan.from_json(path)
                except (OSError, ValueError, TypeError) as e:
                    raise RuntimeError(
                        f"TSE1M_FAULT_PLAN={path!r} could not be loaded: "
                        f"{e}") from e
                log.warning("fault plan active from %s: %d rules", path,
                            len(_plan.rules))
            _env_loaded = True
    return _plan


def fault_point(site: str, path: str | None = None) -> None:
    """The hook production seats call.  No active plan: no-op."""
    plan = active_plan()
    if plan is not None:
        plan.fire(site, path=path)


def reraise_if_fault(exc: BaseException) -> None:
    """For a handler that must stay broad: injected faults still
    propagate through it, so the chaos tests see the seat."""
    if isinstance(exc, InjectedFault):
        raise exc


__all__ = ["FaultPlan", "FaultRule", "InjectedConnectionDrop",
           "InjectedFault", "active_plan", "clear_plan", "fault_point",
           "install_plan", "reraise_if_fault"]
