"""The port's graftspec (``tse1m_tpu_torch/spec/``) against the JAX
package's (``tse1m_tpu/spec/``): the committed specs and mutants give the
same exploration and the same counterexamples under both checkers, every
counterexample replays in the port, toy specs built through both DSLs
agree on every checker outcome, and the ``spec`` command prints what the
JAX package's prints.
"""

from __future__ import annotations

import json

import pytest

from tse1m_tpu import spec as jspec
from tse1m_tpu.cli import main as jax_main
from tse1m_tpu.spec import dsl as jdsl
from tse1m_tpu.spec import mc as jmc
from tse1m_tpu_torch import spec as tspec
from tse1m_tpu_torch.__main__ import main as port_main
from tse1m_tpu_torch.spec import dsl as tdsl
from tse1m_tpu_torch.spec import mc as tmc
from tse1m_tpu_torch.trace.sched import Schedule

NAMES = sorted(tspec.SPEC_BUILDERS) + sorted(tspec.MUTANT_BUILDERS)


def _outcome(result) -> tuple:
    v = result.violation
    return (result.spec, result.ok, result.states, result.transitions,
            result.depth, result.complete, result.mode, result.scope,
            None if v is None else (v.kind, v.prop, v.schedule_str, v.trace,
                                    v.cycle))


def test_the_same_specs_and_mutants():
    assert NAMES == sorted(jspec.SPEC_BUILDERS) + sorted(
        jspec.MUTANT_BUILDERS)
    assert NAMES == ["ingest_ack", "lease", "replica", "ack-before-journal",
                     "fence-after-append", "manifest-first"]


@pytest.mark.parametrize("mode", ["bfs", "dfs"])
@pytest.mark.parametrize("name", NAMES)
def test_check_equals_jax(name, mode):
    port = tmc.check(tspec.build_spec(name), mode=mode)
    ref = jmc.check(jspec.build_spec(name), mode=mode)
    assert _outcome(port) == _outcome(ref)
    assert port.ok == (name in tspec.SPEC_BUILDERS)
    if port.violation is not None:
        assert port.violation.state == ref.violation.state


@pytest.mark.parametrize("mode", ["bfs", "dfs"])
@pytest.mark.parametrize("name", sorted(tspec.MUTANT_BUILDERS))
def test_every_counterexample_replays(name, mode):
    spec = tspec.build_spec(name)
    v = tmc.check(spec, mode=mode).violation
    assert v.schedule_str.startswith("v1:fix:")
    assert Schedule.from_string(v.schedule_str).choices == v.trace + v.cycle
    states = tmc.replay(tspec.build_spec(name), v.schedule_str)
    assert len(states) == len(v.trace + v.cycle) + 1
    # The replay ends in the witness state, which breaks the property.
    assert states[len(v.trace)] == v.state
    inv = {i.name: i for i in spec.invariants}[v.prop]
    assert not inv.pred(states[-1])


def test_mutant_selftest_equals_jax():
    assert tspec.mutant_selftest() == jspec.mutant_selftest()
    assert tspec.mutant_selftest(mode="dfs") == jspec.mutant_selftest(
        mode="dfs")


def test_check_all_equals_jax():
    for mode in ("bfs", "dfs"):
        port = [r.summary() for r in tspec.check_all(mode=mode)]
        ref = [r.summary() for r in jspec.check_all(mode=mode)]
        for p in port + ref:
            p.pop("wall_s")
        assert port == ref
        assert [p["states"] for p in port] == [78, 93, 53]


# -- toy specs through both DSLs ---------------------------------------------

def _counter(d, bound=3, bad_at=None):
    invs = ()
    if bad_at is not None:
        invs = (d.Invariant("below-bad", lambda s: s["x"] != bad_at),)
    return d.Spec(
        "counter", init={"x": 0},
        actions=(d.Action("inc", guard=lambda s: s["x"] < bound,
                          effect=lambda s: d.upd(s, x=s["x"] + 1)),),
        invariants=invs,
        liveness=(d.Liveness("saturates", lambda s: s["x"] == bound),))


def _stuck(d):
    return d.Spec("stuck", init={"x": 0},
                  actions=(d.Action("inc", guard=lambda s: s["x"] < 1,
                                    effect=lambda s: d.upd(s, x=s["x"] + 1)),),
                  liveness=(d.Liveness("reaches-two",
                                       lambda s: s["x"] == 2),))


def _pingpong(d, always_finish: bool):
    def finish_guard(s):
        return not s["done"] and (always_finish or s["at"] == 0)

    return d.Spec(
        "pingpong", init={"at": 0, "done": False},
        actions=(
            d.Action("hop", fair=True, guard=lambda s: not s["done"],
                     effect=lambda s: d.upd(s, at=1 - s["at"])),
            d.Action("finish", fair=True, guard=finish_guard,
                     effect=lambda s: d.upd(s, done=True)),
        ),
        liveness=(d.Liveness("eventually-done", lambda s: s["done"]),))


def _flags(d, symmetric: bool, never_both: bool = False):
    def sym(s, perm):
        return d.upd(s, flags=tuple(s["flags"][perm[i]] for i in range(2)))

    invs = ((d.Invariant("never-both", lambda s: sum(s["flags"]) < 2),)
            if never_both else ())
    return d.Spec(
        "flags", init={"flags": (0, 0)},
        actions=tuple(
            d.Action(f"raise_p{p}",
                     guard=lambda s, p=p: s["flags"][p] == 0,
                     effect=lambda s, p=p: d.upd(
                         s, flags=d.tupset(s["flags"], p, 1)))
            for p in range(2)),
        invariants=invs,
        symmetry=sym if symmetric else None,
        n_symmetric=2 if symmetric else 0)


TOYS = {
    "invariant": (lambda d: _counter(d, bound=5, bad_at=3), {}),
    "clean": (lambda d: _counter(d, bound=3), {}),
    "terminal-liveness": (_stuck, {}),
    "fair-lasso": (lambda d: _pingpong(d, always_finish=False), {}),
    "weak-fairness-excludes": (lambda d: _pingpong(d, always_finish=True),
                               {}),
    "max-states": (lambda d: _counter(d, bound=100), {"max_states": 10}),
    "asymmetric": (lambda d: _flags(d, symmetric=False), {}),
    "symmetry-quotient": (lambda d: _flags(d, symmetric=True), {}),
    "symmetry-violation": (lambda d: _flags(d, True, never_both=True), {}),
}


@pytest.mark.parametrize("mode", ["bfs", "dfs"])
@pytest.mark.parametrize("toy", sorted(TOYS))
def test_toy_specs_agree_with_jax(toy, mode):
    build, kw = TOYS[toy]
    port = tmc.check(build(tdsl), mode=mode, **kw)
    ref = jmc.check(build(jdsl), mode=mode, **kw)
    assert _outcome(port) == _outcome(ref)
    if port.violation is not None:
        tmc.replay(build(tdsl), port.violation.schedule_str)


def test_toy_outcomes_are_the_claimed_ones():
    """What each toy holds, so the agreement above is not vacuous."""
    def run(toy, mode="bfs"):
        build, kw = TOYS[toy]
        return tmc.check(build(tdsl), mode=mode, **kw)

    r = run("invariant")
    assert (r.violation.kind, r.violation.trace) == ("invariant",
                                                     ("inc",) * 3)
    assert run("clean").ok and run("clean").states == 4
    r = run("terminal-liveness")
    assert r.violation.kind == "liveness" and not r.violation.cycle
    r = run("fair-lasso")
    assert r.violation.kind == "liveness" and set(r.violation.cycle) == {
        "hop"}
    assert run("weak-fairness-excludes").ok
    r = run("max-states")
    assert (r.complete, r.ok, r.violation, r.states) == (False, False,
                                                         None, 10)
    assert run("asymmetric").states == 4
    assert run("symmetry-quotient").states == 3
    assert len(run("symmetry-violation").violation.trace) == 2


# -- the DSL's own checks, as the JAX package's ------------------------------

def test_dsl_rejects_what_jax_rejects():
    for d in (tdsl, jdsl):
        for bad in ("a,b", "a:b", "a b", "a\nb"):
            with pytest.raises(d.SpecError, match="schedule-safe"):
                d.Action(bad, guard=lambda s: True, effect=dict)
        with pytest.raises(d.SpecError, match="seat"):
            d.Action("ok", guard=lambda s: True, effect=dict, seat="oops:x")
        a = d.Action("step", guard=lambda s: True, effect=dict)
        with pytest.raises(d.SpecError, match="duplicate"):
            d.Spec("toy", init={"x": 0}, actions=(a, a))
        with pytest.raises(d.SpecError, match="no action"):
            d.Spec("toy", init={"x": 0}, actions=(a,)).action("nope")
        with pytest.raises(d.SpecError, match="non-freezable"):
            d.state_key({"x": bytearray(b"nope")})
    assert tdsl.freeze({"b": 2, "a": {1, 3, 2}}) == jdsl.freeze(
        {"b": 2, "a": {1, 3, 2}})
    s = {"x": 1, "t": (0, 0)}
    assert tdsl.upd(s, x=2, t=tdsl.tupset(s["t"], 1, 9)) == {"x": 2,
                                                            "t": (0, 9)}
    assert s == {"x": 1, "t": (0, 0)}


def test_checker_errors():
    with pytest.raises(tdsl.SpecError, match="mode"):
        tmc.check(_counter(tdsl), mode="random")
    with pytest.raises(tdsl.SpecError, match="diverged"):
        tmc.replay(_counter(tdsl, bound=1), ["inc", "inc"])
    with pytest.raises(tdsl.SpecError, match="no action"):
        tmc.replay(_counter(tdsl, bound=1), ["nope"])
    with pytest.raises(tdsl.SpecError, match="lease"):
        tspec.build_spec("leese")
    with pytest.raises(tdsl.SpecError, match="unknown spec"):
        tspec.check_all(["leese"])


def test_the_specs_seat_the_ports_code():
    """Every seat the specs name is one the port's lint resolves
    (tests/test_torch_lint_interproc.py holds the tree side)."""
    seats = sorted({a.seat for b in tspec.SPEC_BUILDERS.values()
                    for a in b().actions})
    assert seats == sorted({a.seat for b in jspec.SPEC_BUILDERS.values()
                            for a in b().actions})
    assert [s for s in seats if not s.startswith("model:")] == [
        "call:_forward", "call:acquire_lease", "call:refresh",
        "call:stream_shards", "call:verify_lease",
        "fault:serve.ingest.commit", "fault:serve.replica.stream",
        "fault:serve.router.forward", "verb:ingest"]


# -- the command ---------------------------------------------------------------

def _run(main, argv, capsys) -> tuple:
    capsys.readouterr()
    rc = main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["spec", "check", "--json"],
    ["spec", "check", "--json", "--mode", "dfs"],
    ["spec", "check", "fence-after-append", "manifest-first", "--json"],
    ["spec", "check", "lease", "--json", "--max-states", "20"],
])
def test_spec_check_json_equals_jax(argv, capsys):
    rc, out = _run(port_main, argv, capsys)
    jrc, jout = _run(jax_main, argv, capsys)
    assert rc == jrc
    port, ref = json.loads(out), json.loads(jout)
    for rec in port + ref:
        rec.pop("wall_s")
    assert port == ref


@pytest.mark.parametrize("argv", [
    ["spec", "mutants"],
    ["spec", "mutants", "--json"],
    ["spec", "mutants", "--mode", "dfs"],
    ["spec", "trace", "fence-after-append"],
    ["spec", "trace", "lease", "ack-before-journal"],
])
def test_spec_output_equals_jax(argv, capsys):
    assert _run(port_main, argv, capsys) == _run(jax_main, argv, capsys)


def test_spec_exit_codes(capsys):
    assert port_main(["spec", "check"]) == 0
    assert port_main(["spec", "mutants"]) == 0
    assert port_main(["spec", "trace", "fence-after-append"]) == 1
    out = capsys.readouterr().out
    assert "lease" in out and "replay: v1:fix:" in out
    assert port_main(["spec", "check", "nosuch"]) == 2
    with pytest.raises(SystemExit):
        port_main(["spec", "trace"])
