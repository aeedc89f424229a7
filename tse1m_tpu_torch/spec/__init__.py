"""graftspec: executable protocol specs + explicit-state model checking.

The serve plane's distributed obligations — epoch-lease fencing,
durable-once router acks, generation-ordered replica adoption — are
modeled as bounded-state machines (spec/dsl.py) and exhaustively
checked (spec/mc.py) against invariants and weak-fairness liveness;
counterexamples come out as replayable ``v1:fix:...`` graftrace
schedule strings.  The specs are load-bearing, not documentation: the
lint conformance passes (``spec-conformance`` / ``verb-dispatch-drift``
in lint/interproc.py) hold every spec action to a declared code seat
and every serve-plane fault seat / dispatch verb to a spec, and the
committed mutants (spec/mutants.py) prove the checker catches the
exact bug classes the chaos tests guard dynamically.

The port's counterpart of the JAX package's ``tse1m_tpu/spec/``, with
its names; the port's lint holds the port's code to these specs.

Entry points: ``python -m tse1m_tpu_torch spec {check,trace,mutants}``;
``all`` records a ``graftspec`` step in the run manifest.
"""

from __future__ import annotations

from . import ingest_ack, lease, replica
from .dsl import Action, Invariant, Liveness, Spec, SpecError
from .mc import CheckResult, Violation, check, replay
from .mutants import MUTANT_BUILDERS

SPEC_BUILDERS = {
    "lease": lease.build,
    "ingest_ack": ingest_ack.build,
    "replica": replica.build,
}


def build_spec(name: str) -> Spec:
    """The named protocol spec (or committed mutant) in its default
    bounded scope."""
    if name in SPEC_BUILDERS:
        return SPEC_BUILDERS[name]()
    if name in MUTANT_BUILDERS:
        return MUTANT_BUILDERS[name]()
    known = sorted(SPEC_BUILDERS) + sorted(MUTANT_BUILDERS)
    raise SpecError(f"unknown spec {name!r} (known: {', '.join(known)})")


def check_all(names=None, mode: str = "bfs",
              max_states: int | None = None) -> list:
    """CheckResults for the named real specs (all three by default)."""
    kwargs = {} if max_states is None else {"max_states": max_states}
    out = []
    for name in (names or sorted(SPEC_BUILDERS)):
        if name not in SPEC_BUILDERS:
            raise SpecError(f"unknown spec {name!r} (known: "
                            f"{', '.join(sorted(SPEC_BUILDERS))})")
        out.append(check(SPEC_BUILDERS[name](), mode=mode, **kwargs))
    return out


def mutant_selftest(mode: str = "bfs") -> dict:
    """Run every committed mutant; each MUST produce a violation whose
    counterexample replays back to the machine (the checker's own
    acceptance bar).  Returns per-mutant records; raises SpecError if
    any mutant slips through."""
    records = {}
    missed = []
    for name, builder in sorted(MUTANT_BUILDERS.items()):
        spec = builder()
        result = check(spec, mode=mode)
        rec = {"spec": spec.name, "caught": result.violation is not None,
               "states": result.states}
        if result.violation is None:
            missed.append(name)
        else:
            v = result.violation
            replay(builder(), v.trace + v.cycle)  # must not diverge
            rec.update(kind=v.kind, prop=v.prop,
                       schedule=v.schedule_str, replayed=True)
        records[name] = rec
    if missed:
        raise SpecError(
            f"mutant self-test FAILED: {', '.join(missed)} produced no "
            "violation — the checker does not catch the bug class it "
            "claims to")
    return records


__all__ = ["Action", "CheckResult", "Invariant", "Liveness",
           "MUTANT_BUILDERS", "SPEC_BUILDERS", "Spec", "SpecError",
           "Violation", "build_spec", "check", "check_all",
           "mutant_selftest", "replay"]
