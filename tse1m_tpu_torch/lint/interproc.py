"""graftlint's interprocedural passes over the port: the pod-protocol
verifier (the JAX package's eight project passes, under their names,
retargeted at the port's files).

Whole-program analyses over the :mod:`graph` ProjectGraph, each a
fixed-point dataflow over the resolved call graph.  Every finding
carries a **witness chain** — the call path that proves it — surfaced
by ``python -m tse1m_tpu_torch.lint --why RULE:path:line``.

- **taint** (extends ``sql-interp`` / ``retry-bypass``): SQL text and
  cursor/HTTP capability follow calls across files.  A parameter that
  flows into an ``execute``-family sink (in any callee, any file) makes
  its function a SQL sink too, so an f-string built two calls away from
  ``cursor.execute`` is flagged at the point the taint enters the
  chain.  A cursor passed into a helper makes the helper's
  ``p.execute(...)`` a raw seat even when the parameter isn't named
  ``cur``; internals of the blessed DB/transport files reached from
  outside their public wrappers (``DB.*`` / ``HttpFetcher.*``) are
  retry bypasses.
- **lease-fence**: every call path that reaches a per-range
  ``SignatureStore.append`` / ``_append_rows`` under a sharded root
  (receiver obtained via ``range_store``) must be dominated by a
  ``verify_lease`` / ``acquire_lease``-providing call; every
  ``membership.json`` / ``lease_*`` / ``hb_*`` mutation must go through
  ``MembershipLedger._write`` / ``write_lease`` /
  ``HeartbeatWriter.beat_once``; and ``LeaseSupersededError`` must
  PROPAGATE — a broad handler over a may-raise body absorbs the fence
  signal unless the original exception provably escapes (bare ``raise``
  or ``raise e``; ``raise X(...) from e`` converts the signal away and
  does not count).
- **lock-order**: the global lock-acquisition graph (``with self._lock``
  sites, canonicalized per class/module, closed over resolved calls)
  must be acyclic, and a non-reentrant Lock must never be re-acquired
  under itself.
- **fault-seat-drift**: the ``fault_point(...)`` seats declared in
  production code, the fault kinds in ``resilience/faults.py``, and the
  ``PRODUCTION_SEATS`` inventory in ``resilience/fault_matrix.py`` must
  agree — a new seat without a matrix entry, a dead matrix entry, or an
  unknown fault kind fails lint.
- **spec-conformance** / **verb-dispatch-drift** (graftspec's static
  layer, see the section comment above their passes): every protocol
  spec action maps to a declared code seat and vice versa, and the
  four serve dispatch surfaces agree exactly with the spec's verb
  alphabets.

Dynamic calls (``fn()`` on a bare callable parameter) stay opaque: the
passes never guess, so a finding here is a real protocol hole, not a
resolution artifact.
"""

from __future__ import annotations

import ast
import os

from .engine import Finding
from .graph import ProjectGraph

# The port's own seat inventory (the JAX package keeps its inventory in
# tests/ci_fault_matrix.py, which names the JAX package's seats).
MATRIX_BASENAME = "fault_matrix.py"
MATRIX_DEFAULT = os.path.join("tse1m_tpu_torch", "resilience",
                              MATRIX_BASENAME)

# Blessed wrapper classes: calls INTO their methods are the sanctioned
# way to perform HTTP / DB I/O, so capability propagation stops there.
_BOUNDARY_CLASSES = ("DB", "HttpFetcher")
# The HTTP seat: its ``urlopen`` is the port's counterpart of the JAX
# transport's ``requests``.
_TRANSPORT = ("tse1m_tpu_torch/collect/transport.py",)
_DB_LAYER = ("tse1m_tpu_torch/db/connection.py",
             "tse1m_tpu_torch/db/pglib.py")
_BLESSED_IO_FILES = _TRANSPORT + _DB_LAYER

# The only functions allowed to mutate the pod's protocol files.
_PROTOCOL_MUTATORS = ("write_lease", "MembershipLedger._write",
                      "HeartbeatWriter.beat_once")

_FENCE_LEAVES = ("verify_lease", "acquire_lease")
_SINK_LEAVES = ("append", "_append_rows")


def _leaf(qual: str) -> str:
    return qual.rsplit(".", 1)[-1]


def _cls_leaf(qual: str) -> str:
    """'pkg.mod.Cls.meth' -> 'Cls.meth' (best effort)."""
    parts = qual.split(".")
    return ".".join(parts[-2:]) if len(parts) >= 2 else qual


def _fmt_edge(graph: ProjectGraph, caller: str, call: dict,
              callee: str) -> str:
    return f"{graph.site(caller, call)} {_cls_leaf(caller)} -> " \
        f"{_cls_leaf(callee)}"


def _chain_witness(graph: ProjectGraph, chain: list) -> list:
    return [_fmt_edge(graph, q, c, t) for q, c, t in chain]


def _finding(graph: ProjectGraph, rule: str, qual: str, line: int,
             col: int, message: str, witness: list | None = None
             ) -> Finding:
    f = Finding(rule=rule, path=graph.fn_file.get(qual, "?"), line=line,
                col=col, message=message)
    f.witness = list(witness or [])
    return f


def _effective_params(fn: dict) -> list:
    params = list(fn["params"])
    if params and params[0] == "self" and (fn.get("cls")
                                           or "." in fn["qual"]):
        return params[1:]
    return params


def _arg_for_param(fn_callee: dict, call: dict, param: str):
    """The arg fact bound to ``param`` at this call site, or None."""
    kw = call.get("kwargs", {})
    if param in kw:
        return kw[param]
    params = _effective_params(fn_callee)
    args = call.get("args", [])
    try:
        i = params.index(param)
    except ValueError:
        return None
    return args[i] if i < len(args) else None


# -- taint: sql-interp + retry-bypass across calls ---------------------------


def _is_cursor_expr(fact: dict) -> bool:
    if fact.get("kind") == "call":
        return fact.get("callee", "").rsplit(".", 1)[-1] == "cursor"
    if fact.get("kind") == "var":
        return fact.get("type", "").rsplit(".", 1)[-1] == "cursor"
    return False


def _is_boundary(graph: ProjectGraph, qual: str) -> bool:
    """A blessed wrapper entry: DB.* / HttpFetcher.* methods (including
    their nested closures)."""
    fn = graph.functions.get(qual)
    while fn is not None:
        if fn.get("cls") in _BOUNDARY_CLASSES:
            return True
        parent = fn.get("parent")
        fn = graph.functions.get(parent) if parent else None
    return False


def taint_pass(graph: ProjectGraph) -> list:
    findings: list[Finding] = []

    # ---- SQL-text parameter summaries (backward fixed point) ----
    # sql_params[qual][param] = (sink description, next hop) for witness
    sql_params: dict[str, dict] = {}
    for qual, fn in graph.functions.items():
        for call in fn["calls"]:
            if "exec_recv" not in call:
                continue
            args = call.get("args", [])
            if args and args[0].get("kind") == "param":
                sql_params.setdefault(qual, {})[args[0]["name"]] = {
                    "line": call["line"], "next": None,
                    "seat": f"{graph.site(qual, call)} "
                            f"{call['callee']}(...)"}
    changed = True
    while changed:
        changed = False
        for qual, fn in graph.functions.items():
            for target, call in graph.calls.get(qual, ()):
                tparams = sql_params.get(target)
                if not tparams:
                    continue
                callee_fn = graph.functions.get(target)
                if callee_fn is None:
                    continue
                for tparam in list(tparams):
                    fact = _arg_for_param(callee_fn, call, tparam)
                    if fact and fact.get("kind") == "param":
                        mine = sql_params.setdefault(qual, {})
                        if fact["name"] not in mine:
                            mine[fact["name"]] = {
                                "line": call["line"],
                                "next": (target, tparam),
                                "seat": None}
                            changed = True

    def sql_witness(start_qual: str, param: str) -> list:
        out = []
        qual, p = start_qual, param
        for _ in range(12):
            info = sql_params.get(qual, {}).get(p)
            if info is None:
                break
            if info["next"] is None:
                out.append(f"{info['seat']}  [raw SQL execution]")
                break
            nq, np_ = info["next"]
            out.append(f"{graph.fn_file.get(qual, '?')}:{info['line']} "
                       f"{_cls_leaf(qual)} passes `{p}` -> "
                       f"{_cls_leaf(nq)}(`{np_}`)")
            qual, p = nq, np_
        return out

    # Tainted SQL entering a cross-function sink: flag at the entry.
    for qual, fn in graph.functions.items():
        for target, call in graph.calls.get(qual, ()):
            tparams = sql_params.get(target)
            if not tparams:
                continue
            callee_fn = graph.functions.get(target)
            if callee_fn is None:
                continue
            for tparam in tparams:
                fact = _arg_for_param(callee_fn, call, tparam)
                if fact and fact.get("kind") == "tainted-sql":
                    wit = [f"{graph.site(qual, call)} {_cls_leaf(qual)} "
                           f"passes interpolated SQL -> "
                           f"{_cls_leaf(target)}(`{tparam}`)"]
                    wit += sql_witness(target, tparam)
                    findings.append(_finding(
                        graph, "sql-interp", qual, call["line"],
                        call["col"],
                        "interpolated SQL flows into "
                        f"`{_cls_leaf(target)}({tparam}=...)`, which "
                        "executes it "
                        f"{len(wit) - 1} call(s) away — route "
                        "identifiers through db/ident.py or bind values "
                        "as parameters (--why shows the chain)",
                        witness=wit))

    # ---- cursor capability (forward fixed point) ----
    cursor_params: dict[str, set] = {}
    changed = True
    while changed:
        changed = False
        for qual, fn in graph.functions.items():
            for target, call in graph.calls.get(qual, ()):
                callee_fn = graph.functions.get(target)
                if callee_fn is None:
                    continue
                for param in _effective_params(callee_fn):
                    fact = _arg_for_param(callee_fn, call, param)
                    if fact is None:
                        continue
                    is_cur = _is_cursor_expr(fact) or (
                        fact.get("kind") == "param"
                        and fact["name"] in cursor_params.get(qual, ()))
                    if is_cur and param not in cursor_params.setdefault(
                            target, set()):
                        cursor_params[target].add(param)
                        changed = True
    for qual, params in cursor_params.items():
        fn = graph.functions[qual]
        path = graph.fn_file[qual]
        if path in _DB_LAYER:
            continue
        for call in fn["calls"]:
            if call.get("exec_recv") in params:
                rev = graph.rev_calls.get(qual, [])
                wit = [_fmt_edge(graph, cq, cc, qual)
                       for cq, cc in rev[:3]]
                findings.append(_finding(
                    graph, "retry-bypass", qual, call["line"],
                    call["col"],
                    f"laundered raw cursor execute: `{call['exec_recv']}`"
                    " is a DB cursor passed in by a caller — this "
                    "bypasses the DB retry/reconnect engine; use "
                    "DB.execute/query/run_transaction",
                    witness=wit))

    # ---- raw-I/O internals of blessed files reached from outside ----
    raw: set = set()
    raw_seat: dict[str, str] = {}
    for qual, fn in graph.functions.items():
        path = graph.fn_file[qual]
        for call in fn["calls"]:
            callee = call["callee"]
            leaf = _leaf(callee)
            head = callee.split(".", 1)[0]
            seat = None
            if head == "requests" and path not in _TRANSPORT:
                seat = f"requests.{leaf}"
            elif leaf == "urlopen" and path not in _TRANSPORT:
                seat = "urlopen"
            elif "exec_recv" in call and path in _DB_LAYER:
                seat = f"{call['exec_recv']}.{leaf}"
            if seat is not None:
                raw.add(qual)
                raw_seat.setdefault(
                    qual, f"{graph.site(qual, call)} {seat}(...)")
    changed = True
    while changed:
        changed = False
        for qual in list(graph.functions):
            if qual in raw or _is_boundary(graph, qual):
                continue
            for target, call in graph.calls.get(qual, ()):
                if target in raw and not _is_boundary(graph, target):
                    raw.add(qual)
                    raw_seat[qual] = raw_seat.get(target, "?")
                    changed = True
                    break
    for qual, fn in graph.functions.items():
        path = graph.fn_file[qual]
        if path in _BLESSED_IO_FILES:
            continue
        for target, call in graph.calls.get(qual, ()):
            if graph.fn_file.get(target) in _BLESSED_IO_FILES \
                    and target in raw and not _is_boundary(graph, target):
                findings.append(_finding(
                    graph, "retry-bypass", qual, call["line"],
                    call["col"],
                    f"`{_cls_leaf(target)}` is a raw-I/O internal of "
                    f"{graph.fn_file.get(target)} — calling it directly "
                    "bypasses the retry engine's public wrappers "
                    "(DB.* / HttpFetcher.*)",
                    witness=[_fmt_edge(graph, qual, call, target),
                             raw_seat.get(target, "?")]))
    return findings


# -- lease-fence: protocol dominance + exception flow ------------------------


def _fence_providers(graph: ProjectGraph) -> set:
    providers = {q for q in graph.functions if _leaf(q) in _FENCE_LEAVES}
    changed = True
    while changed:
        changed = False
        for qual in graph.functions:
            if qual in providers:
                continue
            for target, _ in graph.calls.get(qual, ()):
                if target in providers:
                    providers.add(qual)
                    changed = True
                    break
    return providers


def _range_store_sinks(graph: ProjectGraph, fn: dict) -> list:
    """Call sites in ``fn`` that append to a per-range store of a
    sharded root: ``self.range_store(r).append`` (one-level receiver
    call) or ``st.append`` where ``st`` was assigned from a
    ``range_store`` call."""
    sinks = []
    for call in fn["calls"]:
        callee = call["callee"]
        leaf = _leaf(callee)
        if leaf not in _SINK_LEAVES:
            continue
        if callee.startswith("<call:"):
            inner = callee[6:].partition(">.")[0]
            if _leaf(inner) == "range_store":
                sinks.append(call)
            continue
        head = callee.split(".", 1)[0]
        vt = fn["var_types"].get(head, "")
        if _leaf(vt) == "range_store":
            sinks.append(call)
    return sinks


def _locally_fenced(fn: dict, graph: ProjectGraph, providers: set,
                    sink_call: dict) -> bool:
    for call in fn["calls"]:
        if call["idx"] >= sink_call["idx"]:
            continue
        target = call.get("resolved")
        if target in providers or _leaf(call["callee"]) in _FENCE_LEAVES:
            return True
    return False


def _callers_fenced(graph: ProjectGraph, providers: set, qual: str,
                    seen: set, trail: list) -> list | None:
    """None when every caller path is fenced before calling into
    ``qual``; otherwise one unfenced witness path (list of edges)."""
    if qual in seen:
        return None  # cycle: treat as fenced (some acyclic path decides)
    seen = seen | {qual}
    rev = graph.rev_calls.get(qual, [])
    if not rev:
        return list(trail)  # an entry point reached with no fence
    for caller, call in rev:
        fenced_here = False
        cfn = graph.functions[caller]
        for c in cfn["calls"]:
            if c["idx"] < call["idx"] and (
                    c.get("resolved") in providers
                    or _leaf(c["callee"]) in _FENCE_LEAVES):
                fenced_here = True
                break
        if fenced_here:
            continue
        bad = _callers_fenced(graph, providers, caller, seen,
                              [(caller, call, qual)] + trail)
        if bad is not None:
            return bad
    return None


def lease_fence_pass(graph: ProjectGraph) -> list:
    findings: list[Finding] = []
    providers = _fence_providers(graph)

    # (a) unfenced per-range appends
    for qual, fn in graph.functions.items():
        for sink in _range_store_sinks(graph, fn):
            if _locally_fenced(fn, graph, providers, sink):
                continue
            bad = _callers_fenced(graph, providers, qual, set(), [])
            wit = _chain_witness(graph, bad or [])
            wit.append(f"{graph.site(qual, sink)} {_cls_leaf(qual)} "
                       f"appends via `{sink['callee']}` UNFENCED")
            findings.append(_finding(
                graph, "lease-fence", qual, sink["line"], sink["col"],
                "per-range store append not dominated by verify_lease/"
                "acquire_lease — a superseded writer could double-write "
                "its re-dealt range; verify tenure first "
                "(store._check_lease idiom)", witness=wit))

    # (b) protocol-file mutations outside the blessed seats
    for qual, fn in graph.functions.items():
        blessed = any(qual.endswith(m) for m in _PROTOCOL_MUTATORS)
        if blessed:
            continue
        for call in fn["calls"]:
            toks = call.get("path_tokens")
            if not toks:
                continue
            writes = call.get("open_write") or \
                _leaf(call["callee"]) == "atomic_write"
            if not writes:
                continue
            findings.append(_finding(
                graph, "lease-fence", qual, call["line"], call["col"],
                f"direct mutation of pod protocol file(s) {toks} — "
                "membership/lease/heartbeat state must route through "
                "MembershipLedger / write_lease / "
                "HeartbeatWriter.beat_once so epochs stay monotonic and "
                "writes atomic",
                witness=[f"{graph.site(qual, call)} "
                         f"{_cls_leaf(qual)} writes {sorted(toks)}"]))

    # (c) LeaseSupersededError must escape broad handlers
    may_raise: dict[str, list] = {}
    for qual, fn in graph.functions.items():
        for r in fn["raises"]:
            if r["name"] == "LeaseSupersededError":
                may_raise[qual] = [
                    f"{graph.fn_file[qual]}:{r['line']} "
                    f"{_cls_leaf(qual)} raises LeaseSupersededError"]
    flagged: set = set()
    changed = True
    while changed:
        changed = False
        for qual, fn in graph.functions.items():
            for target, call in graph.calls.get(qual, ()):
                if target not in may_raise:
                    continue
                handlers = [fn["broad_handlers"][h]
                            for h in call.get("handlers", ())]
                if any(h.get("explicit_lse") for h in handlers):
                    continue  # deliberately handled in place
                absorbing = [h for h in handlers
                             if not h.get("lse_escapes")]
                if absorbing:
                    h = absorbing[0]
                    key = (qual, h["line"])
                    if key not in flagged:
                        flagged.add(key)
                        wit = [_fmt_edge(graph, qual, call, target)] + \
                            may_raise[target]
                        findings.append(_finding(
                            graph, "lease-fence", qual, h["line"], 0,
                            "broad except can absorb LeaseSupersededError"
                            " raised inside its try body — the zombie "
                            "fence signal must propagate (bare `raise` / "
                            "`raise e`; `raise X from e` converts it "
                            "away), or narrow the handler",
                            witness=wit))
                    continue
                if qual not in may_raise:
                    may_raise[qual] = [
                        _fmt_edge(graph, qual, call, target)
                    ] + may_raise[target][:4]
                    changed = True
    return findings


# -- lock-order --------------------------------------------------------------


def lock_order_pass(graph: ProjectGraph) -> list:
    findings: list[Finding] = []
    # transitive lock-acquisition summaries
    acquires: dict[str, set] = {}
    for qual, fn in graph.functions.items():
        acquires[qual] = {s["token"] for s in fn["lock_sites"]}
    changed = True
    while changed:
        changed = False
        for qual in graph.functions:
            for target, _ in graph.calls.get(qual, ()):
                extra = acquires.get(target, set()) - acquires[qual]
                if extra:
                    acquires[qual] |= extra
                    changed = True
    # edges held -> acquired (with a witness site per edge)
    edges: dict[tuple, str] = {}
    for qual, fn in graph.functions.items():
        for site in fn["lock_sites"]:
            for held in site["held"]:
                edges.setdefault(
                    (held, site["token"]),
                    f"{graph.fn_file[qual]}:{site['line']} "
                    f"{_cls_leaf(qual)} takes {site['token']} while "
                    f"holding {held}")
        for target, call in graph.calls.get(qual, ()):
            if not call["locks"]:
                continue
            for acq in acquires.get(target, ()):
                for held in call["locks"]:
                    edges.setdefault(
                        (held, acq),
                        f"{graph.site(qual, call)} {_cls_leaf(qual)} "
                        f"holds {held} and calls {_cls_leaf(target)} "
                        f"which acquires {acq}")
    # self-deadlock: re-acquiring a non-reentrant Lock under itself
    kinds: dict[str, str] = {}
    for cls_qual, crec in graph.classes.items():
        for attr in crec.get("locks", []):
            kinds[f"{cls_qual}.{attr}"] = \
                crec.get("lock_kinds", {}).get(attr, "Lock")
    for (a, b), site in sorted(edges.items()):
        if a == b and kinds.get(a, "Lock") != "RLock":
            findings.append(_lock_finding(
                graph, site, f"non-reentrant lock {a} re-acquired while "
                f"already held — guaranteed deadlock", [site]))
    # cycle detection among distinct locks
    adj: dict[str, list] = {}
    for (a, b), site in edges.items():
        if a != b:
            adj.setdefault(a, []).append((b, site))
    seen_cycles: set = set()
    for start in sorted(adj):
        stack = [(start, [start], [])]
        while stack:
            node, path, sites = stack.pop()
            for nxt, site in adj.get(node, ()):
                if nxt == start:
                    cyc = tuple(sorted(path))
                    if cyc in seen_cycles:
                        continue
                    seen_cycles.add(cyc)
                    findings.append(_lock_finding(
                        graph, sites[0] if sites else site,
                        "lock-order cycle: " + " -> ".join(
                            path + [start]) + " — two threads taking "
                        "these locks in opposite orders deadlock; pick "
                        "one global order", sites + [site]))
                elif nxt not in path and len(path) < 6:
                    stack.append((nxt, path + [nxt], sites + [site]))
    return findings


def _lock_finding(graph: ProjectGraph, anchor_site: str, message: str,
                  witness: list) -> Finding:
    path, _, line = anchor_site.split(" ", 1)[0].rpartition(":")
    f = Finding(rule="lock-order", path=path, line=int(line or 1), col=0,
                message=message)
    f.witness = witness
    return f


# -- fault-seat-drift --------------------------------------------------------


def _matrix_inventory(matrix_abspath: str):
    """(seats dict name -> {kinds, line}, parse error or None)."""
    try:
        with open(matrix_abspath, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=matrix_abspath)
    except (OSError, SyntaxError) as e:
        return None, str(e)
    for node in tree.body:
        if not (isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "PRODUCTION_SEATS"
                and isinstance(node.value, ast.Dict)):
            continue
        seats = {}
        for k, v in zip(node.value.keys, node.value.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            kinds: list = []
            if isinstance(v, ast.Dict):
                for vk, vv in zip(v.keys, v.values):
                    if (isinstance(vk, ast.Constant)
                            and vk.value == "kinds"
                            and isinstance(vv, (ast.Tuple, ast.List))):
                        kinds = [e.value for e in vv.elts
                                 if isinstance(e, ast.Constant)]
            seats[k.value] = {"kinds": kinds, "line": k.lineno}
        return seats, None
    return None, "no PRODUCTION_SEATS dict"


def _declared_kinds(graph: ProjectGraph) -> set:
    """The fault kinds ``resilience/faults.py`` (or a fixture ``faults``
    module) declares in its ``_KINDS`` tuple."""
    for path, facts in graph.facts.items():
        if facts["module"].split(".")[-1] != "faults":
            continue
        kinds = facts["constants"].get("_KINDS")
        if isinstance(kinds, list):
            return set(kinds)
    return set()


def _production_sites(graph: ProjectGraph):
    """site -> (qual, call) for every fault_point seat; plus findings
    for seats whose name cannot be resolved to literals."""
    sites: dict[str, tuple] = {}
    findings: list[Finding] = []
    for qual, fn in graph.functions.items():
        for call in fn["calls"]:
            if "fault_site" in call:
                sites.setdefault(call["fault_site"], (qual, call))
            elif "fault_site_param" in call:
                param = call["fault_site_param"]
                values = set()
                # The seat name may be a parameter of an ENCLOSING
                # function (the retry-closure idiom: fault_point(site)
                # inside attempt() inside _statement(site=...)).
                owner, ofn = qual, fn
                while ofn is not None and param not in ofn["params"]:
                    owner = ofn.get("parent")
                    ofn = graph.functions.get(owner) if owner else None
                if ofn is not None:
                    default = ofn["param_defaults"].get(param)
                    if isinstance(default, str):
                        values.add(default)
                    for caller, ccall in graph.rev_calls.get(owner, ()):
                        fact = _arg_for_param(ofn, ccall, param)
                        if fact is None:
                            continue  # caller uses the default
                        if fact.get("kind") == "const" \
                                and isinstance(fact.get("value"), str):
                            values.add(fact["value"])
                        else:
                            values.add("<dynamic>")
                if not values or "<dynamic>" in values:
                    findings.append(_finding(
                        graph, "fault-seat-drift", qual, call["line"],
                        call["col"],
                        f"fault_point seat `{param}` does not resolve "
                        "to string literals — seats must be statically "
                        "enumerable for the fault matrix"))
                for v in values - {"<dynamic>"}:
                    sites.setdefault(v, (qual, call))
    return sites, findings


def fault_seat_drift_pass(graph: ProjectGraph,
                          matrix_path: str | None = None) -> list:
    matrix_rel = matrix_path or MATRIX_DEFAULT
    matrix_abs = matrix_rel if os.path.isabs(matrix_rel) \
        else os.path.join(graph.root, matrix_rel)
    matrix_disp = os.path.relpath(matrix_abs, graph.root).replace(
        os.sep, "/")
    sites, findings = _production_sites(graph)
    if not sites:
        return findings  # nothing to check (fixture set without seats)
    seats, err = _matrix_inventory(matrix_abs)
    if seats is None:
        f = Finding(rule="fault-seat-drift", path=matrix_disp, line=1,
                    col=0,
                    message="PRODUCTION_SEATS inventory missing from "
                            f"{matrix_disp} ({err}) — the fault matrix "
                            "has no machine-checked seat list")
        f.witness = []
        return findings + [f]
    kinds = _declared_kinds(graph)
    for site, (qual, call) in sorted(sites.items()):
        if site not in seats:
            findings.append(_finding(
                graph, "fault-seat-drift", qual, call["line"],
                call["col"],
                f"fault_point seat `{site}` has no PRODUCTION_SEATS "
                f"entry in {matrix_disp} — add the seat with its fault "
                "kinds and covering test so the matrix stays the source "
                "of truth",
                witness=[f"{graph.site(qual, call)} fault_point"
                         f"(\"{site}\")"]))
    for seat, rec in sorted(seats.items()):
        if seat not in sites:
            f = Finding(rule="fault-seat-drift", path=matrix_disp,
                        line=rec["line"], col=0,
                        message=f"dead matrix seat `{seat}`: no "
                                "fault_point in production code declares "
                                "it — remove the entry or restore the "
                                "seat")
            f.witness = []
            findings.append(f)
        bad_kinds = [k for k in rec["kinds"] if kinds and k not in kinds]
        if bad_kinds:
            f = Finding(rule="fault-seat-drift", path=matrix_disp,
                        line=rec["line"], col=0,
                        message=f"matrix seat `{seat}` lists unknown "
                                f"fault kind(s) {bad_kinds} — not in "
                                "resilience/faults.py _KINDS")
            f.witness = []
            findings.append(f)
    return findings


# -- graftspec conformance: the specs are load-bearing -----------------------
#
# A protocol spec (tse1m_tpu_torch/spec/*.py, marked by a module-level
# ``SPEC_NAME`` constant) declares one ``seat`` per action:
# ``fault:<site>`` / ``verb:<op>`` / ``call:<leaf>`` / ``model:<tag>``.
# ``spec-conformance`` holds both directions over the FileFacts graph:
# every non-model seat must resolve to real code (a production
# fault_point, a dispatch verb, a named function), and every fault
# seat in a module that binds itself to specs via ``SPEC_MODELS``
# must be claimed by one of them — dead spec actions and unmodeled
# fault seats both fail lint.  ``verb-dispatch-drift`` is the verb
# alphabet's exact-agreement check across all four serve surfaces.

_VERB_SURFACES = (
    # (alphabet constant, class leaf, method, how verbs are read)
    ("SERVER_VERBS", "ServeServer", "_dispatch_op", "str_eqs"),
    ("ROUTER_VERBS", "RouterServer", "_dispatch_op", "str_eqs"),
    ("FORWARD_VERBS", "LocalTransport", "__call__", "str_eqs"),
    ("CLIENT_VERBS", "ServeClient", None, "request"),
)


def _spec_modules(graph: ProjectGraph) -> dict:
    """spec name -> (path, facts) for every module declaring a
    ``SPEC_NAME`` string constant."""
    out: dict = {}
    for path, facts in sorted(graph.facts.items()):
        name = facts["constants"].get("SPEC_NAME")
        if isinstance(name, str):
            out.setdefault(name, (path, facts))
    return out


def _spec_actions(facts: dict) -> list:
    """(qual, call, action_name or None, seat) for every ``Action(...)``
    construction in one spec module's facts."""
    out = []
    for fn in facts["functions"]:
        for call in fn["calls"]:
            if call["callee"].rsplit(".", 1)[-1] != "Action":
                continue
            args = call.get("args", [])
            name = None
            if args and args[0].get("kind") == "const":
                name = args[0].get("value")
            seat_fact = call.get("kwargs", {}).get("seat")
            out.append((fn["qual"], call, name, seat_fact))
    return out


def _dispatch_verbs(graph: ProjectGraph):
    """surface alphabet-constant name -> list of (qual, fn, verbs)."""
    surfaces: dict = {name: [] for name, _c, _m, _h in _VERB_SURFACES}
    for const, cls, meth, how in _VERB_SURFACES:
        for qual, fn in sorted(graph.functions.items()):
            if how == "str_eqs":
                if fn.get("cls") != cls or fn["name"] != meth:
                    continue
                verbs = set(fn.get("str_eqs", {}).get("op", []))
                surfaces[const].append((qual, fn, verbs))
            else:  # ServeClient: const first arg of self.request(...)
                if fn.get("cls") != cls:
                    continue
                verbs = set()
                for call in fn["calls"]:
                    if call["callee"] != "self.request":
                        continue
                    args = call.get("args", [])
                    if args and args[0].get("kind") == "const" \
                            and isinstance(args[0].get("value"), str):
                        verbs.add(args[0]["value"])
                if verbs:
                    surfaces[const].append((qual, fn, verbs))
    # A client's verbs live one per method: merge them per class.
    merged = []
    client = surfaces["CLIENT_VERBS"]
    if client:
        anchor = min(client, key=lambda t: t[1]["line"])
        allverbs = set().union(*(v for _q, _f, v in client))
        merged.append((anchor[0], anchor[1], allverbs))
    surfaces["CLIENT_VERBS"] = merged
    return surfaces


def _verbs_alphabets(graph: ProjectGraph):
    """(path, constants) of the spec verb-alphabet module, or None."""
    for path, facts in sorted(graph.facts.items()):
        if isinstance(facts["constants"].get("SERVER_VERBS"), list):
            return path, facts["constants"]
    return None


def verb_dispatch_drift_pass(graph: ProjectGraph) -> list:
    findings: list[Finding] = []
    surfaces = _dispatch_verbs(graph)
    if not any(surfaces.values()):
        return findings  # fixture set without serve surfaces
    alphabets = _verbs_alphabets(graph)
    if alphabets is None:
        qual, fn, _v = next(s for lst in surfaces.values()
                            for s in lst)
        return [_finding(
            graph, "verb-dispatch-drift", qual, fn["line"], 0,
            "serve dispatch surfaces exist but no spec verb alphabet "
            "module (SERVER_VERBS/...) is in the linted set — the "
            "verb protocol has no machine-checked source of truth")]
    alpha_path, consts = alphabets
    for const, _cls, _meth, _how in _VERB_SURFACES:
        alphabet = consts.get(const)
        for qual, fn, verbs in surfaces[const]:
            if not isinstance(alphabet, list):
                findings.append(_finding(
                    graph, "verb-dispatch-drift", qual, fn["line"], 0,
                    f"dispatch surface `{_cls_leaf(qual)}` has no "
                    f"`{const}` alphabet in {alpha_path}"))
                continue
            missing = sorted(set(alphabet) - verbs)
            extra = sorted(verbs - set(alphabet))
            if not missing and not extra:
                continue
            drift = []
            if missing:
                drift.append("missing " + ", ".join(missing))
            if extra:
                drift.append("handles undeclared "
                             + ", ".join(extra))
            findings.append(_finding(
                graph, "verb-dispatch-drift", qual, fn["line"], 0,
                f"`{_cls_leaf(qual)}` drifted from the spec verb "
                f"alphabet `{const}`: {'; '.join(drift)} — change "
                f"{alpha_path} and every surface together",
                witness=[f"{graph.site(qual)} handles: "
                         + (", ".join(sorted(verbs)) or "<none>"),
                         f"{alpha_path} {const}: "
                         + ", ".join(alphabet)]))
    return findings


def spec_conformance_pass(graph: ProjectGraph) -> list:
    findings: list[Finding] = []
    specs = _spec_modules(graph)
    if not specs:
        return findings  # no spec modules in the linted set
    sites, _seat_findings = _production_sites(graph)
    surfaces = _dispatch_verbs(graph)
    dispatch_verbs = set()
    for lst in surfaces.values():
        for _q, _f, verbs in lst:
            dispatch_verbs |= verbs
    code_leaves = {_leaf(q) for q in graph.functions}
    claimed: dict[str, set] = {}  # spec name -> fault sites it models

    def _label(name, call):
        return f"action {name!r}" if name else \
            f"action at col {call['col']}"

    for spec_name, (_path, facts) in sorted(specs.items()):
        claimed[spec_name] = set()
        for qual, call, name, seat_fact in _spec_actions(facts):
            if seat_fact is None:
                continue  # defaulted seat (model:env)
            if seat_fact.get("kind") != "const" \
                    or not isinstance(seat_fact.get("value"), str):
                findings.append(_finding(
                    graph, "spec-conformance", qual, call["line"],
                    call["col"],
                    f"spec `{spec_name}` {_label(name, call)}: seat "
                    "must be a string literal — conformance needs "
                    "statically enumerable seats"))
                continue
            seat = seat_fact["value"]
            kind, _sep, ref = seat.partition(":")
            if kind == "model":
                continue
            if kind == "fault":
                claimed[spec_name].add(ref)
                if ref not in sites:
                    findings.append(_finding(
                        graph, "spec-conformance", qual, call["line"],
                        call["col"],
                        f"dead spec action: `{spec_name}` "
                        f"{_label(name, call)} claims fault seat "
                        f"`{ref}` but no production fault_point "
                        "declares it"))
            elif kind == "verb":
                if ref not in dispatch_verbs:
                    findings.append(_finding(
                        graph, "spec-conformance", qual, call["line"],
                        call["col"],
                        f"dead spec action: `{spec_name}` "
                        f"{_label(name, call)} models verb `{ref}` "
                        "but no dispatch surface handles it"))
            elif kind == "call":
                if ref not in code_leaves:
                    findings.append(_finding(
                        graph, "spec-conformance", qual, call["line"],
                        call["col"],
                        f"dead spec action: `{spec_name}` "
                        f"{_label(name, call)} references "
                        f"`{ref}` but no such function exists"))
            else:  # unknown kind (the DSL would reject it at runtime)
                findings.append(_finding(
                    graph, "spec-conformance", qual, call["line"],
                    call["col"],
                    f"spec `{spec_name}` {_label(name, call)} has "
                    f"unknown seat kind `{kind}:` (want fault:/verb:/"
                    "call:/model:)"))

    # Reverse direction: modules that bind themselves to specs must
    # have every fault seat claimed by one of them.
    for path, facts in sorted(graph.facts.items()):
        models = facts["constants"].get("SPEC_MODELS")
        if not isinstance(models, list):
            continue
        mod_claimed: set = set()
        anchor = facts["functions"][0]
        for m in models:
            if m not in specs:
                findings.append(_finding(
                    graph, "spec-conformance", anchor["qual"], 1, 0,
                    f"{path} declares SPEC_MODELS spec `{m}` but no "
                    "module carries SPEC_NAME = "
                    f"{m!r}"))
                continue
            mod_claimed |= claimed.get(m, set())
        for fn in facts["functions"]:
            for call in fn["calls"]:
                site = call.get("fault_site")
                if site is None or site in mod_claimed:
                    continue
                findings.append(_finding(
                    graph, "spec-conformance", fn["qual"],
                    call["line"], call["col"],
                    f"fault seat `{site}` is absent from every spec "
                    f"this module declares ({', '.join(models)}) — "
                    "model the failure or drop the SPEC_MODELS "
                    "binding",
                    witness=[f"{graph.site(fn['qual'], call)} "
                             f"fault_point(\"{site}\")"]))
    return findings


# -- snapshot-publish / atomic-swap (graftrace's static layer) ---------------
#
# The serve/store planes' lock-free reads are safe only under a
# publish-then-never-mutate discipline: a snapshot (LiveClusterIndex,
# the store's _IndexSnapshot) is fully constructed, published by ONE
# reference store, and never touched again.  The runtime layers
# (trace/explore.py schedules, the lockset detector) validate what a
# run happens to execute; these passes prove the discipline statically:
#
# - ``snapshot-publish``: classes marked immutable-after-publish
#   (``@dataclass(frozen=True)`` or ``__immutable_after_publish__``)
#   must never be mutated outside their own constructors — no attribute
#   store, no in-place array op (``obj.arr[i] = ...``, ``+=``), no
#   mutating method call (``.sort()``/``.append()``/``.fill()``), no
#   numpy in-place sink (``np.minimum.at(obj.arr, ...)``, ``out=``).
#   Mutation through a helper is chased across calls: a function that
#   mutates a parameter makes every call site passing a protected
#   object a finding, with the witness chain down to the mutation seat.
# - ``atomic-swap``: attributes declared ``__publish_slots__`` (or
#   holding a protected class) may only be REBOUND whole — never
#   ``.append``-ed, item-assigned, aug-assigned, multi-target-assigned,
#   or mutated through an alias (``d = self._snap; d.base = ...``).

_INPLACE_MUTATORS = frozenset((
    "append", "extend", "insert", "remove", "clear", "sort", "reverse",
    "fill", "put", "itemset", "resize", "partition", "setdefault",
    "update", "popitem", "add", "discard", "setflags"))
_NP_HEADS = ("np", "numpy", "jnp")


def _protected_classes(graph: ProjectGraph) -> set:
    return {cq for cq, crec in graph.classes.items()
            if crec.get("frozen") or crec.get("immutable_after_publish")}


def _class_of_ctor(graph: ProjectGraph, module: str,
                   dotted: str) -> str | None:
    """Resolve a constructor / classmethod-constructor dotted expression
    (``LiveClusterIndex(...)``, ``LiveClusterIndex.empty(...)``) to the
    class qual it instantiates."""
    q = graph._resolve_dotted(module, dotted)
    if q is None:
        return None
    if q in graph.classes:
        return q
    owner = q.rsplit(".", 1)[0]
    return owner if owner in graph.classes else None


def _own_class(graph: ProjectGraph, fn: dict) -> str | None:
    cls = fn.get("cls")
    if cls is None and fn.get("parent"):
        cls = graph.functions.get(fn["parent"], {}).get("cls")
    if cls is None:
        return None
    return f"{graph.module_of(fn['qual'])}.{cls}"


def _recv_class(graph: ProjectGraph, fn: dict, recv: str,
                depth: int = 0) -> str | None:
    """Class qual of the object a dotted receiver expression denotes
    (best effort: self, self.attr, annotated params, ctor-typed vars,
    one alias hop)."""
    if depth > 3 or not recv:
        return None
    module = graph.module_of(fn["qual"])
    head, _, rest = recv.partition(".")
    if rest and rest.count(".") >= 1:
        return None  # deeper chains stay opaque
    if head == "self":
        own = _own_class(graph, fn)
        if own is None:
            return None
        if not rest:
            return own
        at = graph.classes.get(own, {}).get("attr_types", {}).get(rest)
        if at:
            return _class_of_ctor(graph, own.rsplit(".", 1)[0], at)
        return None
    if rest:
        base = _recv_class(graph, fn, head, depth + 1)
        if base is None:
            return None
        at = graph.classes.get(base, {}).get("attr_types", {}).get(rest)
        if at:
            return _class_of_ctor(graph, base.rsplit(".", 1)[0], at)
        return None
    ann = fn.get("param_annotations", {}).get(head)
    if ann:
        c = _class_of_ctor(graph, module, ann)
        if c:
            return c
    vt = fn["var_types"].get(head)
    if vt:
        c = _class_of_ctor(graph, module, vt)
        if c:
            return c
    alias = fn.get("var_aliases", {}).get(head)
    if alias and alias != recv:
        return _recv_class(graph, fn, alias, depth + 1)
    return None


def _is_ctor(qual: str, cls_qual: str) -> bool:
    return qual in {f"{cls_qual}.{m}"
                    for m in ("__init__", "__post_init__", "__new__")}


def _mut_call_targets(fn: dict):
    """(call, obj_expr, attr) for in-place mutator calls: ``obj.attr
    .sort()`` -> (obj, attr); ``obj.update()`` -> (obj, '')."""
    for call in fn["calls"]:
        callee = call["callee"]
        if callee.startswith("<call:"):
            continue
        parts = callee.split(".")
        if len(parts) < 2 or parts[-1] not in _INPLACE_MUTATORS:
            continue
        if len(parts) >= 3:
            yield call, ".".join(parts[:-2]), parts[-2]
        yield call, ".".join(parts[:-1]), ""


def snapshot_publish_pass(graph: ProjectGraph) -> list:
    findings: list[Finding] = []
    protected = _protected_classes(graph)
    if not protected:
        return findings

    def flag(qual, line, col, what, witness):
        findings.append(_finding(
            graph, "snapshot-publish", qual, line, col,
            f"{what} — this class is immutable-after-publish (lock-free "
            "readers hold references to published snapshots); build new "
            "arrays and publish a fresh instance by one reference swap",
            witness=witness))

    # ---- direct mutations + per-function param-mutation summaries ----
    # mut_params[qual][param] = {"seat": ..., "next": (target, param)}
    mut_params: dict[str, dict] = {}
    for qual, fn in graph.functions.items():
        eff = set(_effective_params(fn))

        def note_param(recv: str, seat: str) -> None:
            head = recv.split(".")[0]
            if head in eff:
                mut_params.setdefault(qual, {}).setdefault(
                    head, {"seat": seat, "next": None})

        for w in fn["attr_writes"]:
            recv, attr, kind = w["recv"], w["attr"], w["kind"]
            target = recv if not attr else f"{recv}.{attr}"
            seat = f"{graph.fn_file[qual]}:{w['line']} " \
                f"{_cls_leaf(qual)} {kind}-writes `{target}`"
            cls = _recv_class(graph, fn, recv)
            if cls in protected and not _is_ctor(qual, cls):
                what = {"store": f"attribute store on published "
                                 f"`{recv}.{attr}`",
                        "item": f"in-place element write to "
                                f"`{target}[...]`",
                        "aug": f"in-place augmented write to `{target}`"}
                flag(qual, w["line"], w["col"], what[kind], [seat])
            if attr and kind in ("store", "item", "aug"):
                note_param(recv, seat)
        for call, obj, attr in _mut_call_targets(fn):
            cls = _recv_class(graph, fn, obj)
            if cls in protected and not _is_ctor(qual, cls):
                tgt = f"{obj}.{attr}" if attr else obj
                flag(qual, call["line"], call["col"],
                     f"mutating call `{call['callee']}(...)` on "
                     f"published `{tgt}`",
                     [f"{graph.site(qual, call)} {_cls_leaf(qual)} calls "
                      f"{call['callee']}(...)"])
            if attr:
                note_param(obj, f"{graph.site(qual, call)} "
                                f"{_cls_leaf(qual)} calls "
                                f"{call['callee']}(...)")
        # numpy in-place sinks: ufunc .at(...) and out= kwargs
        for call in fn["calls"]:
            callee = call["callee"]
            facts = []
            if callee.split(".")[0] in _NP_HEADS \
                    and callee.rsplit(".", 1)[-1] == "at" \
                    and call.get("args"):
                facts.append(call["args"][0])
            out_fact = call.get("kwargs", {}).get("out")
            if out_fact is not None and (callee.split(".")[0] in _NP_HEADS
                                         or "." in callee):
                facts.append(out_fact)
            for fact in facts:
                if fact.get("kind") != "attr":
                    continue
                expr = fact["expr"]
                obj = expr.rsplit(".", 1)[0] if "." in expr else expr
                cls = _recv_class(graph, fn, obj)
                if cls in protected and not _is_ctor(qual, cls):
                    flag(qual, call["line"], call["col"],
                         f"numpy in-place op `{callee}` targets "
                         f"published `{expr}`",
                         [f"{graph.site(qual, call)} {_cls_leaf(qual)} "
                          f"calls {callee}(...)"])

    # ---- interprocedural: protected objects entering mutating params ----
    changed = True
    while changed:
        changed = False
        for qual, fn in graph.functions.items():
            for target, call in graph.calls.get(qual, ()):
                tparams = mut_params.get(target)
                callee_fn = graph.functions.get(target)
                if not tparams or callee_fn is None:
                    continue
                for tparam in list(tparams):
                    fact = _arg_for_param(callee_fn, call, tparam)
                    if fact is None:
                        continue
                    if fact.get("kind") == "param":
                        mine = mut_params.setdefault(qual, {})
                        if fact["name"] not in mine:
                            mine[fact["name"]] = {
                                "seat": None,
                                "next": (target, tparam, call)}
                            changed = True

    def mut_witness(start_qual: str, param: str) -> list:
        out: list = []
        qual, p = start_qual, param
        for _ in range(12):
            info = mut_params.get(qual, {}).get(p)
            if info is None:
                break
            if info["next"] is None:
                out.append(info["seat"])
                break
            nq, np_, ncall = info["next"]
            out.append(f"{graph.site(qual, ncall)} {_cls_leaf(qual)} "
                       f"passes `{p}` -> {_cls_leaf(nq)}(`{np_}`)")
            qual, p = nq, np_
        return out

    for qual, fn in graph.functions.items():
        for target, call in graph.calls.get(qual, ()):
            tparams = mut_params.get(target)
            callee_fn = graph.functions.get(target)
            if not tparams or callee_fn is None:
                continue
            for tparam in tparams:
                fact = _arg_for_param(callee_fn, call, tparam)
                if fact is None:
                    continue
                expr = None
                if fact.get("kind") == "attr":
                    expr = fact["expr"]
                elif fact.get("kind") == "var":
                    expr = fact["name"]
                if expr is None:
                    continue
                cls = _recv_class(graph, fn, expr)
                if cls in protected and not _is_ctor(qual, cls):
                    wit = [f"{graph.site(qual, call)} {_cls_leaf(qual)} "
                           f"passes published `{expr}` -> "
                           f"{_cls_leaf(target)}(`{tparam}`)"]
                    wit += mut_witness(target, tparam)
                    flag(qual, call["line"], call["col"],
                         f"published `{expr}` flows into "
                         f"`{_cls_leaf(target)}({tparam}=...)`, which "
                         f"mutates it {len(wit) - 1} call(s) away",
                         wit)
    return findings


def _publish_slots(graph: ProjectGraph) -> dict:
    """class qual -> slot attr set: declared ``__publish_slots__`` plus
    attrs whose constructor-assigned type is a protected class."""
    protected = _protected_classes(graph)
    slots: dict[str, set] = {}
    for cq, crec in graph.classes.items():
        s = set(crec.get("publish_slots", []))
        module = cq.rsplit(".", 1)[0]
        for attr, t in crec.get("attr_types", {}).items():
            if _class_of_ctor(graph, module, t) in protected:
                s.add(attr)
        if s:
            slots[cq] = s
    return slots


def atomic_swap_pass(graph: ProjectGraph) -> list:
    findings: list[Finding] = []
    slots = _publish_slots(graph)
    if not slots:
        return findings

    def flag(qual, line, col, what, witness):
        findings.append(_finding(
            graph, "atomic-swap", qual, line, col,
            f"{what} — published references are updated by rebinding "
            "the one attribute to a freshly built value (`self.x = "
            "new`), never read-modify-write: a concurrent reader must "
            "see the old snapshot or the new one, nothing in between",
            witness=witness))

    def slot_of(fn: dict, expr: str):
        """(owner class, slot, via-alias) when ``expr`` denotes a
        publish slot: 'self._snap', 'obj._snap', or an alias var."""
        resolved = expr
        via = None
        head = expr.split(".")[0]
        if "." not in expr:
            alias = fn.get("var_aliases", {}).get(head)
            if alias:
                resolved, via = alias, expr
        if "." not in resolved:
            return None
        base, attr = resolved.rsplit(".", 1)
        cls = _recv_class(graph, fn, base)
        if cls in slots and attr in slots[cls]:
            return cls, attr, via
        return None

    for qual, fn in graph.functions.items():
        for w in fn["attr_writes"]:
            recv, attr, kind = w["recv"], w["attr"], w["kind"]
            target = recv if not attr else f"{recv}.{attr}"
            seat = f"{graph.fn_file[qual]}:{w['line']} " \
                f"{_cls_leaf(qual)} {kind}-writes `{target}`"
            # (a) non-atomic update OF the slot itself
            owner = _recv_class(graph, fn, recv) if attr else None
            if owner in slots and attr in slots[owner]:
                if kind in ("aug", "item"):
                    flag(qual, w["line"], w["col"],
                         f"in-place {kind} update of published "
                         f"reference `{target}`", [seat])
                elif w.get("multi"):
                    flag(qual, w["line"], w["col"],
                         f"multi-target assignment publishes `{target}` "
                         "non-atomically", [seat])
            # (b) mutation THROUGH the slot (or an alias of it)
            hit = slot_of(fn, recv)
            if hit is not None:
                cls, slot, via = hit
                wit = [seat]
                if via is not None:
                    wit.append(f"`{via}` aliases "
                               f"`{_cls_leaf(cls)}.{slot}` "
                               "(published reference)")
                flag(qual, w["line"], w["col"],
                     f"mutation through published reference "
                     f"`{_cls_leaf(cls)}.{slot}`", wit)
        seen_mut: set = set()
        for call, obj, attr in _mut_call_targets(fn):
            # mutator on the slot (`self._snap.append(...)`), through it
            # (`self._snap.deltas.append(...)`), or via an alias var.
            hit = slot_of(fn, obj)
            if hit is None and attr:
                hit = slot_of(fn, f"{obj}.{attr}")
            if hit is None:
                continue
            cls, slot, via = hit
            key = (call["line"], cls, slot)
            if key in seen_mut:
                continue
            seen_mut.add(key)
            wit = [f"{graph.site(qual, call)} {_cls_leaf(qual)} calls "
                   f"{call['callee']}(...)"]
            if via is not None:
                wit.append(f"`{via}` aliases `{_cls_leaf(cls)}.{slot}` "
                           "(published reference)")
            flag(qual, call["line"], call["col"],
                 f"in-place mutator `{call['callee'].rsplit('.', 1)[-1]}"
                 f"()` on published reference `{_cls_leaf(cls)}.{slot}`",
                 wit)
    return findings


# -- registry ----------------------------------------------------------------

# pass name -> (rules it emits, callable(graph, matrix_path) -> findings)
PROJECT_PASSES = {
    "taint": (("sql-interp", "retry-bypass"),
              lambda graph, matrix_path=None: taint_pass(graph)),
    "lease-fence": (("lease-fence",),
                    lambda graph, matrix_path=None:
                    lease_fence_pass(graph)),
    "lock-order": (("lock-order",),
                   lambda graph, matrix_path=None:
                   lock_order_pass(graph)),
    "fault-seat-drift": (("fault-seat-drift",),
                         fault_seat_drift_pass),
    "snapshot-publish": (("snapshot-publish",),
                         lambda graph, matrix_path=None:
                         snapshot_publish_pass(graph)),
    "atomic-swap": (("atomic-swap",),
                    lambda graph, matrix_path=None:
                    atomic_swap_pass(graph)),
    "spec-conformance": (("spec-conformance",),
                         lambda graph, matrix_path=None:
                         spec_conformance_pass(graph)),
    "verb-dispatch-drift": (("verb-dispatch-drift",),
                            lambda graph, matrix_path=None:
                            verb_dispatch_drift_pass(graph)),
}

PROJECT_RULES = ("sql-interp", "retry-bypass", "lease-fence",
                 "lock-order", "fault-seat-drift", "snapshot-publish",
                 "atomic-swap", "spec-conformance",
                 "verb-dispatch-drift")


def run_project_passes(graph: ProjectGraph,
                       wanted_rules: set | None = None,
                       matrix_path: str | None = None) -> list:
    """Run every project pass whose emitted rules intersect
    ``wanted_rules`` (all of them when None)."""
    findings: list[Finding] = []
    for _name, (emits, fn) in PROJECT_PASSES.items():
        if wanted_rules is not None and not (set(emits) & wanted_rules):
            continue
        out = fn(graph, matrix_path=matrix_path)
        if wanted_rules is not None:
            out = [f for f in out if f.rule in wanted_rules]
        findings.extend(out)
    return findings


__all__ = ["MATRIX_DEFAULT", "PROJECT_PASSES", "PROJECT_RULES",
           "atomic_swap_pass", "fault_seat_drift_pass",
           "lease_fence_pass", "lock_order_pass", "run_project_passes",
           "snapshot_publish_pass", "spec_conformance_pass",
           "taint_pass", "verb_dispatch_drift_pass"]
