"""graftspec's explicit-state model checker (the TLC tradition, sized
for bounded protocol scopes).

Exploration is exhaustive over the spec's reachable states under a
bounded scope: BFS by default (shortest counterexamples), DFS on
request.  States are canonicalized (:func:`~.dsl.state_key`) and, when
the spec declares a process-id symmetry, quotiented by the minimal
encoding over all id permutations — the classic symmetry reduction:
sound for safety because permuted states have isomorphic futures, and
the representative kept per class makes guards/effects well-defined.

Properties:

- **Invariants** are checked at every state as it is discovered; a
  violation reports the shortest (BFS) action path from the initial
  state.
- **Liveness** (``[]<>goal`` under weak fairness) is checked on the
  complete reachability graph: a violation is either a terminal state
  where the goal fails, or a *fair lasso* — a reachable cycle on which
  the goal never holds and no weakly-fair action is starved (every
  fair action is disabled somewhere on the cycle or taken by it).
  SCCs come from an iterative Tarjan pass over the goal-false
  subgraph.

Counterexamples are emitted as replayable graftrace schedule strings
(``v1:fix:action,action,...`` via trace/sched.py's export hook);
:func:`replay` re-executes one deterministically through the same
canonical machinery, so a reported trace is checkable by construction
(tests replay every mutant counterexample back to its violating
state).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from itertools import permutations

from ..resilience.watchdog import deadline_clock
from ..trace.sched import fixed_schedule_string
from .dsl import Spec, SpecError, state_key

_DEFAULT_MAX_STATES = 200_000


@dataclass(frozen=True)
class Violation:
    """One property violation with its replayable counterexample."""

    kind: str            # "invariant" | "liveness"
    prop: str            # property name
    trace: tuple         # action names, initial state -> witness state
    state: dict          # witness state (terminal / cycle entry)
    cycle: tuple = ()    # liveness only: the starved cycle's actions

    @property
    def schedule_str(self) -> str:
        return fixed_schedule_string(self.trace + self.cycle)

    def describe(self) -> str:
        lines = [f"{self.kind} violation: {self.prop}",
                 f"  trace ({len(self.trace)} steps): "
                 + (" -> ".join(self.trace) or "<initial state>")]
        if self.cycle:
            lines.append(f"  starved cycle: {' -> '.join(self.cycle)}"
                         " -> (repeat)")
        lines.append("  state: " + ", ".join(
            f"{k}={v!r}" for k, v in sorted(self.state.items())))
        lines.append(f"  replay: {self.schedule_str}")
        return "\n".join(lines)


@dataclass
class CheckResult:
    spec: str
    ok: bool
    states: int
    transitions: int
    depth: int
    complete: bool
    mode: str
    wall_s: float
    violation: Violation | None = None
    scope: dict = field(default_factory=dict)

    def summary(self) -> dict:
        out = {"spec": self.spec, "ok": bool(self.ok),
               "states": self.states, "transitions": self.transitions,
               "depth": self.depth, "complete": self.complete,
               "mode": self.mode, "wall_s": round(self.wall_s, 3)}
        if self.violation is not None:
            out["violation"] = {
                "kind": self.violation.kind,
                "prop": self.violation.prop,
                "schedule": self.violation.schedule_str}
        return out


def _identity(n: int) -> tuple:
    return tuple(range(n))


def _canon(spec: Spec, state: dict) -> tuple:
    """(canonical key, representative state) for one concrete state."""
    if spec.symmetry is None or spec.n_symmetric <= 1:
        return state_key(state), state
    best_key, best_state = None, None
    for perm in permutations(range(spec.n_symmetric)):
        s2 = state if perm == _identity(spec.n_symmetric) \
            else spec.symmetry(state, perm)
        k2 = state_key(s2)
        if best_key is None or k2 < best_key:
            best_key, best_state = k2, s2
    return best_key, best_state


def _trace_to(nodes: dict, key) -> tuple:
    names: list = []
    while True:
        parent, action, _state, _depth = nodes[key]
        if parent is None:
            break
        names.append(action)
        key = parent
    return tuple(reversed(names))


def _explore(spec: Spec, mode: str, max_states: int):
    """Reachability: nodes, edges, and an invariant violation if one
    exists (None otherwise).  nodes: key -> (parent_key, action_name,
    representative_state, depth); edges: key -> [(action, child_key)]."""
    ikey, istate = _canon(spec, spec.init)
    nodes = {ikey: (None, None, istate, 0)}
    edges: dict = {ikey: []}
    frontier = deque([ikey])
    transitions = 0
    max_depth = 0

    def _check_invariants(key, state):
        for inv in spec.invariants:
            if not inv.pred(state):
                return Violation(kind="invariant", prop=inv.name,
                                 trace=_trace_to(nodes, key),
                                 state=state)
        return None

    bad = _check_invariants(ikey, istate)
    if bad is not None:
        return nodes, edges, transitions, 0, True, bad

    while frontier:
        key = frontier.popleft() if mode == "bfs" else frontier.pop()
        _p, _a, state, depth = nodes[key]
        for action in spec.actions:
            if not action.guard(state):
                continue
            nxt = action.effect(state)
            ckey, cstate = _canon(spec, nxt)
            transitions += 1
            edges[key].append((action.name, ckey))
            if ckey in nodes:
                continue
            nodes[ckey] = (key, action.name, cstate, depth + 1)
            edges[ckey] = []
            max_depth = max(max_depth, depth + 1)
            bad = _check_invariants(ckey, cstate)
            if bad is not None:
                return nodes, edges, transitions, max_depth, True, bad
            if len(nodes) >= max_states:
                return nodes, edges, transitions, max_depth, False, None
            frontier.append(ckey)
    return nodes, edges, transitions, max_depth, True, None


def _sccs(keys: set, edges: dict) -> list:
    """Tarjan's SCCs (iterative) over the subgraph induced by ``keys``."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    out: list = []
    counter = [0]

    for root in keys:
        if root in index:
            continue
        work = [(root, iter([c for _a, c in edges[root] if c in keys]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            v, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on_stack.add(w)
                    work.append(
                        (w, iter([c for _a, c in edges[w]
                                  if c in keys])))
                    advanced = True
                    break
                if w in on_stack:
                    low[v] = min(low[v], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                pv = work[-1][0]
                low[pv] = min(low[pv], low[v])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                out.append(comp)
    return out


def _path(src, dst, members: set, edges: dict) -> tuple:
    """(action names, nodes touched) for a BFS path src -> dst inside
    ``members`` (empty path when src == dst).  Both are in one SCC, so
    the path exists."""
    if src == dst:
        return [], {src}
    parent: dict = {}
    seen = {src}
    queue = [src]
    while queue:
        v = queue.pop(0)
        for action, w in edges[v]:
            if w not in members or w in seen:
                continue
            seen.add(w)
            parent[w] = (v, action)
            if w == dst:
                names: list = []
                touched = {dst}
                while w != src:
                    pv, pa = parent[w]
                    names.append(pa)
                    touched.add(pv)
                    w = pv
                return list(reversed(names)), touched
            queue.append(w)
    raise SpecError("SCC path not found (checker bug)")


def _fair_tour(entry, members: set, edges: dict,
               need_edges: list) -> tuple:
    """A cycle entry -> ... -> entry that traverses every SCC state
    (so every somewhere-disabled fair action is disabled on it) and
    every edge in ``need_edges`` (so every everywhere-enabled fair
    action is taken on it) — a genuine weak-fairness witness, not just
    any cycle."""
    names: list = []
    visited = {entry}
    cur = entry
    for (v, action, w) in need_edges:
        seg, touched = _path(cur, v, members, edges)
        names += seg + [action]
        visited |= touched | {w}
        cur = w
    for m in sorted(members):
        if m in visited:
            continue
        seg, touched = _path(cur, m, members, edges)
        names += seg
        visited |= touched
        cur = m
    seg, _touched = _path(cur, entry, members, edges)
    names += seg
    if not names:  # single-state SCC: the self-loop IS the cycle
        action = next(a for a, w in edges[entry] if w == entry)
        names = [action]
    return tuple(names)


def _liveness_violation(spec: Spec, nodes: dict, edges: dict
                        ) -> Violation | None:
    fair = [a for a in spec.actions if a.fair]
    for prop in spec.liveness:
        # Terminal states: a quiescent protocol must have reached the
        # goal — nothing will ever re-establish it.
        for key, (_p, _a, state, _d) in nodes.items():
            if not edges[key] and not prop.goal(state):
                return Violation(kind="liveness", prop=prop.name,
                                 trace=_trace_to(nodes, key),
                                 state=state)
        # Fair lassos through the goal-false subgraph.
        bad_keys = {k for k, (_p, _a, s, _d) in nodes.items()
                    if not prop.goal(s)}
        for comp in _sccs(bad_keys, edges):
            members = set(comp)
            internal = [(v, a, w) for v in comp
                        for a, w in edges[v] if w in members]
            if not internal:
                continue  # trivial SCC, no cycle
            need_edges: list = []
            unfair = False
            for fa in fair:
                if not all(fa.guard(nodes[v][2]) for v in comp):
                    continue  # disabled somewhere: the tour covers it
                edge = next(((v, a, w) for v, a, w in internal
                             if a == fa.name), None)
                if edge is None:
                    unfair = True  # continuously enabled, never taken
                    break
                need_edges.append(edge)
            if unfair:
                continue
            entry = min(comp, key=lambda k: nodes[k][3])
            cycle = _fair_tour(entry, members, edges, need_edges)
            return Violation(kind="liveness", prop=prop.name,
                             trace=_trace_to(nodes, entry),
                             state=nodes[entry][2], cycle=cycle)
    return None


def check(spec: Spec, mode: str = "bfs",
          max_states: int = _DEFAULT_MAX_STATES) -> CheckResult:
    """Model-check one spec in its bounded scope."""
    if mode not in ("bfs", "dfs"):
        raise SpecError(f"unknown exploration mode {mode!r}")
    t0 = deadline_clock()
    nodes, edges, transitions, depth, complete, bad = _explore(
        spec, mode, max_states)
    if bad is None and complete:
        bad = _liveness_violation(spec, nodes, edges)
    return CheckResult(spec=spec.name, ok=bad is None and complete,
                       states=len(nodes), transitions=transitions,
                       depth=depth, complete=complete, mode=mode,
                       wall_s=deadline_clock() - t0, violation=bad,
                       scope=dict(spec.scope))


def replay(spec: Spec, schedule) -> list:
    """Re-execute a counterexample (a ``v1:fix:...`` string or an
    action-name sequence) through the canonical state machinery;
    returns the visited representative states.  Raises SpecError if a
    scheduled action is disabled — i.e. the trace is not a real run."""
    if isinstance(schedule, str):
        from ..trace.sched import Schedule
        names = Schedule.from_string(schedule).choices
    else:
        names = tuple(schedule)
    _key, state = _canon(spec, spec.init)
    states = [state]
    for name in names:
        action = spec.action(name)
        if not action.guard(state):
            raise SpecError(
                f"replay diverged: action {name!r} disabled after "
                f"{len(states) - 1} steps")
        _key, state = _canon(spec, action.effect(state))
        states.append(state)
    return states


__all__ = ["CheckResult", "Violation", "check", "replay"]
