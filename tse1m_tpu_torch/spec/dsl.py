"""graftspec's executable-spec DSL: typed state machines as data.

A spec is a plain Python value: an initial state (a flat dict of
hashable variables), a set of guarded atomic :class:`Action`\\ s, a set
of :class:`Invariant`\\ s checked at every reachable state, and a set
of :class:`Liveness` goals checked against fair infinite behaviors and
terminal states.  The model checker (spec/mc.py) owns the semantics;
this module only owns the vocabulary, so a spec file reads like the
protocol's design note.

Every action carries a **seat** — the code location class it models —
in one of four forms, enforced against the real tree by the lint
conformance pass (``spec-conformance`` in lint/interproc.py):

- ``fault:<site>``  — a production ``fault_point("<site>")`` seat
- ``verb:<op>``     — a serve-plane dispatch verb handler
- ``call:<leaf>``   — a named protocol function/method (lease calls,
  stream/refresh entry points)
- ``model:<tag>``   — a pure environment action (crash, drop, wake)
  with deliberately no code seat

Effects are pure: an action's ``effect`` receives the current state
dict and returns a NEW dict (use :func:`upd`); mutating the input is a
spec bug.  Guards are pure predicates.  Determinism matters — the
checker canonicalizes and hashes states, so every state value must be
hashable after :func:`freeze` (scalars, strings, tuples).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable


class SpecError(Exception):
    """A malformed spec (non-hashable state, unknown action, effect
    mutated its input) — distinct from a property violation, which the
    checker reports as a :class:`~tse1m_tpu_torch.spec.mc.Violation`."""


def freeze(value):
    """Recursively convert a state value to a hashable canonical form
    (lists/tuples -> tuples, dicts -> sorted item tuples)."""
    if isinstance(value, (list, tuple)):
        return tuple(freeze(v) for v in value)
    if isinstance(value, dict):
        return tuple(sorted((k, freeze(v)) for k, v in value.items()))
    if isinstance(value, set):
        return tuple(sorted(freeze(v) for v in value))
    return value


def state_key(state: dict) -> tuple:
    """The canonical hashable encoding of one state dict."""
    try:
        out = tuple(sorted((k, freeze(v)) for k, v in state.items()))
        hash(out)  # fail HERE, not deep inside the checker's node map
        return out
    except TypeError as e:  # unhashable leaf
        raise SpecError(f"state has a non-freezable value: {e}") from e


def upd(state: dict, **changes) -> dict:
    """A new state with ``changes`` applied — the only sanctioned way
    for an effect to 'write'."""
    out = dict(state)
    out.update(changes)
    return out


def tupset(t: tuple, i: int, value) -> tuple:
    """``t`` with element ``i`` replaced (tuples model per-process
    variable arrays)."""
    return t[:i] + (value,) + t[i + 1:]


@dataclass(frozen=True)
class Action:
    """One guarded atomic step.  ``fair`` marks weak fairness: an
    action continuously enabled along an infinite behavior must
    eventually be taken (the checker rejects lassos that starve it)."""

    name: str
    guard: Callable[[dict], bool]
    effect: Callable[[dict], dict]
    seat: str = "model:env"
    fair: bool = False

    def __post_init__(self):
        if any(ch in self.name for ch in ",:\n "):
            raise SpecError(
                f"action name {self.name!r} is not schedule-safe "
                "(no ',', ':' or whitespace — names become "
                "v1:fix: schedule tokens)")
        kind = self.seat.split(":", 1)[0]
        if kind not in ("fault", "verb", "call", "model"):
            raise SpecError(f"action {self.name!r} has unknown seat "
                            f"kind {self.seat!r}")


@dataclass(frozen=True)
class Invariant:
    """A safety property: ``pred(state)`` must hold at EVERY reachable
    state."""

    name: str
    pred: Callable[[dict], bool]


@dataclass(frozen=True)
class Liveness:
    """A progress property in the ``[]<>goal`` shape: along every fair
    infinite behavior the goal holds infinitely often, and every
    terminal (deadlocked/quiescent) state satisfies it.  This covers
    both 'eventually acked' (goal stays true once reached) and
    response-style goals like 'no live zombie' (re-established after
    every excursion)."""

    name: str
    goal: Callable[[dict], bool]


@dataclass(frozen=True)
class Spec:
    """A bounded protocol model.

    ``symmetry``: optional ``(state, perm) -> state`` renaming states
    under a permutation of ``range(n_symmetric)`` process ids; the
    checker quotients the reachable graph by it (action names in
    counterexamples are then valid modulo that renaming — replay goes
    through :func:`~tse1m_tpu_torch.spec.mc.replay`, which canonicalizes the
    same way)."""

    name: str
    init: dict
    actions: tuple = ()
    invariants: tuple = ()
    liveness: tuple = ()
    symmetry: Callable[[dict, tuple], dict] | None = None
    n_symmetric: int = 0
    scope: dict = field(default_factory=dict)  # bound knobs, for display

    def __post_init__(self):
        names = [a.name for a in self.actions]
        if len(set(names)) != len(names):
            dup = sorted({n for n in names if names.count(n) > 1})
            raise SpecError(f"spec {self.name!r} has duplicate action "
                            f"names {dup}")

    def action(self, name: str) -> Action:
        for a in self.actions:
            if a.name == name:
                return a
        raise SpecError(f"spec {self.name!r} has no action {name!r}")

    def enabled(self, state: dict) -> list:
        return [a for a in self.actions if a.guard(state)]


__all__ = ["Action", "Invariant", "Liveness", "Spec", "SpecError",
           "freeze", "state_key", "tupset", "upd"]
