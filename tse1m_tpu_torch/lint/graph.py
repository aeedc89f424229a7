"""graftlint's whole-program layer: the project import/call graph (the
port's counterpart of ``tse1m_tpu/lint/graph.py``).

The per-file rules (rules.py) are pure AST visitors — fast, but blind
past a file boundary, which is exactly where the pod plane's protocol
bugs live (a wrapper two calls away laundering an f-string into
``cursor.execute``, an append reached on a path nobody fenced).  This
module builds the shared substrate the interprocedural passes
(interproc.py) run on:

- **FileFacts** — one JSON-serializable summary per target file: module
  name, import table, per-function call sites (with receiver/arg facts,
  lock context, try/except context, statement order), class symbol
  tables (methods, lock attrs, ``self.x = ClassName(...)`` types,
  publication markers: ``frozen=True`` dataclasses,
  ``__immutable_after_publish__``, ``__publish_slots__``), attribute
  writes (store/item/aug, multi-target), name->attribute aliases,
  parameter annotations, direct raises, and ``fault_point(...)``
  seats.  Facts are everything the fixed-point passes need; the AST
  itself is never kept.
- **Symbol resolution** — dotted call strings resolve to fully
  qualified function names across modules: plain names through the
  import table (following one re-export hop), ``self.meth`` through the
  class and its bases, ``var.meth`` through constructor-assignment
  types, ``self.attr.meth`` through ``__init__``-assigned attribute
  types, and one level of ``self.helper(...).meth`` through the
  helper's return type (the ``range_store(r).append`` shape).
- **Digest cache** — facts are cached per file keyed by a blake2b
  content digest (the ``cluster/store.py`` content-addressing idiom):
  an incremental ``lint`` re-extracts only edited files, and
  ``--changed`` mode uses the import graph's reverse-dependency closure
  to pick which files need their per-file rules re-run.

The graph is deliberately approximate where Python is dynamic: calls
through bare callables (``fn()`` on a parameter) stay unresolved and
the passes treat them as opaque.  Soundness here means "no false
finding on the real tree"; coverage comes from the resolution cases the
codebase actually uses.
"""

from __future__ import annotations

import ast
import contextlib
import hashlib
import json
import os
from dataclasses import dataclass, field

# A file of its own: the JAX package's lint keeps ``.graftlint_cache.json``
# beside it, and the two must never overwrite each other's facts.
CACHE_BASENAME = ".graftlint_torch_cache.json"
_CACHE_VERSION = 4  # bump when the FileFacts shape changes

_SQL_EXEC_ATTRS = ("execute", "executemany", "executescript")
_SQL_TOKENS = ("SELECT", "INSERT", "UPDATE", "DELETE", "CREATE", "DROP",
               "ALTER", "COPY", "PRAGMA", "SET")


def content_digest(data: bytes) -> str:
    """16-hex blake2b content digest (store.py's digest idiom)."""
    return hashlib.blake2b(data, digest_size=8).hexdigest()


def module_name(relpath: str) -> str:
    """'tse1m_tpu_torch/cluster/store.py' -> 'tse1m_tpu_torch.cluster.store';
    package ``__init__.py`` files name the package itself."""
    p = relpath[:-3] if relpath.endswith(".py") else relpath
    parts = [x for x in p.split("/") if x]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _dotted(node: ast.AST) -> str:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _literal_text(node: ast.AST) -> str:
    """Concatenated literal fragments of a string expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        return "".join(v.value for v in node.values
                       if isinstance(v, ast.Constant)
                       and isinstance(v.value, str))
    if isinstance(node, ast.BinOp):
        return _literal_text(node.left) + _literal_text(node.right)
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
        return _literal_text(node.func.value)  # "...".format(...)
    return ""


def _looks_sql(node: ast.AST) -> bool:
    text = _literal_text(node).upper()
    return any(f"{t} " in text or text.startswith(t) for t in _SQL_TOKENS)


def _is_interpolated(node: ast.AST) -> bool:
    """The expression composes a string from non-literal parts."""
    if isinstance(node, ast.JoinedStr):
        return any(isinstance(v, ast.FormattedValue) for v in node.values)
    if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                  (ast.Add, ast.Mod)):
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
            and node.func.attr == "format"):
        return bool(node.args or node.keywords)
    return False


def _all_params(args: ast.arguments) -> list:
    return [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]


def _ann_dotted(node: ast.AST) -> str:
    """Best-effort dotted name of a parameter annotation: plain names,
    quoted forward refs, and the useful half of ``X | None``."""
    if node is None:
        return ""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.strip()
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        left = _ann_dotted(node.left)
        return left or _ann_dotted(node.right)
    if isinstance(node, ast.Subscript):  # Optional[X] / list[X]: outer
        return _dotted(node.value)
    return _dotted(node)


def _attr_write_of(target: ast.AST):
    """Decompose an assignment target into (recv dotted, attr, kind):
    ``obj.attr = ...`` -> (obj, attr, 'store'); ``obj.attr[...] = ...``
    -> (obj, attr, 'item'); ``name[...] = ...`` -> (name, '', 'item')
    — the alias shape the atomic-swap pass resolves.  None otherwise."""
    node = target
    kind = "store"
    while isinstance(node, ast.Starred):
        node = node.value
    while isinstance(node, ast.Subscript):
        kind = "item"
        node = node.value
    if isinstance(node, ast.Attribute):
        recv = _dotted(node.value)
        if recv:
            return recv, node.attr, kind
    elif isinstance(node, ast.Name) and kind == "item":
        return node.id, "", kind
    return None


class _FactsVisitor:
    """Source-order DFS over one parsed file, extracting FileFacts.

    Tracks, per call site: the enclosing function, the lock tokens held
    (lexically enclosing ``with <lock>`` items), and the enclosing
    broad/explicit-LSE try handlers (for the exception-flow pass)."""

    def __init__(self, relpath: str, tree: ast.AST):
        self.path = relpath
        self.module = module_name(relpath)
        self.imports: dict[str, str] = {}
        self.constants: dict[str, object] = {}
        self.module_locks: list[str] = []
        self.classes: dict[str, dict] = {}
        self.functions: list[dict] = []
        self._fn_stack: list[dict] = []
        self._cls_stack: list[str] = []
        self._locks_held: list[str] = []
        self._try_stack: list[list] = []
        self._call_idx = 0
        self._module_fn = self._new_fn("<module>", None, 0, [], [], {})
        self.functions.append(self._module_fn)
        self._visit_body(tree.body)

    # -- helpers ------------------------------------------------------------

    def _new_fn(self, name: str, cls: str | None, lineno: int,
                params: list, decorators: list, env: dict) -> dict:
        qual = ".".join(x for x in (self.module, cls, name) if x)
        return {"qual": qual, "name": name, "cls": cls, "line": lineno,
                "params": params, "decorators": decorators, "calls": [],
                "raises": [], "broad_handlers": [], "lock_sites": [],
                "var_types": {}, "returns_call": None,
                "param_defaults": {}, "param_annotations": {},
                "attr_writes": [], "var_aliases": {}, "str_eqs": {},
                "_env": env}

    def _fn(self) -> dict:
        return self._fn_stack[-1] if self._fn_stack else self._module_fn

    def _lock_token(self, expr: ast.AST) -> str | None:
        """Canonical cross-instance lock identity for a with-item, or
        None when the context manager is not a known lock."""
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and self._cls_stack):
            cls = self._cls_stack[-1]
            if expr.attr in self.classes.get(cls, {}).get("locks", []):
                return f"{self.module}.{cls}.{expr.attr}"
        if isinstance(expr, ast.Name) and expr.id in self.module_locks:
            return f"{self.module}.{expr.id}"
        return None

    # -- traversal ----------------------------------------------------------

    def _visit_body(self, body: list) -> None:
        for node in body:
            self._visit(node)

    def _visit(self, node: ast.AST) -> None:
        meth = getattr(self, f"_v_{type(node).__name__}", None)
        if meth is not None:
            meth(node)
        else:
            self._generic(node)

    def _generic(self, node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            self._visit(child)

    # imports ---------------------------------------------------------------

    def _v_Import(self, node: ast.Import) -> None:
        for alias in node.names:
            self.imports[alias.asname or alias.name.split(".")[0]] = \
                alias.name

    def _v_ImportFrom(self, node: ast.ImportFrom) -> None:
        if node.level:
            base_parts = self.module.split(".")
            base_parts = base_parts[:max(len(base_parts) - node.level, 0)]
            base = ".".join(base_parts)
            target = ".".join(x for x in (base, node.module or "") if x)
        else:
            target = node.module or ""
        for alias in node.names:
            if alias.name == "*":
                continue
            self.imports[alias.asname or alias.name] = \
                ".".join(x for x in (target, alias.name) if x)

    # defs ------------------------------------------------------------------

    def _v_ClassDef(self, node: ast.ClassDef) -> None:
        bases = [_dotted(b) for b in node.bases if _dotted(b)]
        entry = self.classes.setdefault(
            node.name, {"methods": [], "bases": bases, "locks": [],
                        "lock_kinds": {}, "attr_types": {},
                        "line": node.lineno})
        entry["bases"] = bases
        # Publication-discipline markers (graftrace's static layer):
        # @dataclass(frozen=True), __immutable_after_publish__, and the
        # __publish_slots__ tuple (lint/interproc.py snapshot-publish /
        # atomic-swap passes).
        for dec in node.decorator_list:
            if isinstance(dec, ast.Call) and _dotted(dec.func).rsplit(
                    ".", 1)[-1] == "dataclass":
                for kw in dec.keywords:
                    if (kw.arg == "frozen"
                            and isinstance(kw.value, ast.Constant)
                            and kw.value.value is True):
                        entry["frozen"] = True
        for stmt in node.body:
            if not (isinstance(stmt, ast.Assign)
                    and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            tname = stmt.targets[0].id
            if tname == "__immutable_after_publish__" and isinstance(
                    stmt.value, ast.Constant):
                entry["immutable_after_publish"] = bool(stmt.value.value)
            elif tname == "__publish_slots__" and isinstance(
                    stmt.value, (ast.Tuple, ast.List)):
                entry["publish_slots"] = [
                    e.value for e in stmt.value.elts
                    if isinstance(e, ast.Constant)
                    and isinstance(e.value, str)]
        # Pre-scan lock/type attrs so every method sees them regardless
        # of definition order relative to __init__.
        for inner in ast.walk(node):
            if not (isinstance(inner, ast.Assign)
                    and isinstance(inner.value, ast.Call)):
                continue
            callee = _dotted(inner.value.func)
            leaf = callee.rsplit(".", 1)[-1]
            for t in inner.targets:
                if not (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    continue
                if leaf in ("Lock", "RLock"):
                    entry["locks"].append(t.attr)
                    entry["lock_kinds"][t.attr] = leaf
                elif callee and callee[:1].isalpha():
                    entry["attr_types"].setdefault(t.attr, callee)
        self._cls_stack.append(node.name)
        self._visit_body(node.body)
        self._cls_stack.pop()

    def _v_FunctionDef(self, node) -> None:
        cls = self._cls_stack[-1] if self._cls_stack else None
        env = {}
        for n in ast.walk(node):
            if isinstance(n, ast.Assign) and len(n.targets) == 1 \
                    and isinstance(n.targets[0], ast.Name):
                env[n.targets[0].id] = n.value
        params = _all_params(node.args)
        decorators = [_dotted(d) or _dotted(getattr(d, "func", d))
                      for d in node.decorator_list]
        fn = self._new_fn(node.name, cls if not self._fn_stack else None,
                          node.lineno, params, decorators, env)
        if self._fn_stack:
            # Nested function: qualify under the parent so boundary
            # classification (the DB wrappers' inner op()) inherits.
            parent = self._fn_stack[-1]
            fn["qual"] = parent["qual"] + "." + node.name
            fn["parent"] = parent["qual"]
        elif cls is not None:
            self.classes.setdefault(
                cls, {"methods": [], "bases": [], "locks": [],
                      "attr_types": {}, "line": node.lineno})
            self.classes[cls]["methods"].append(node.name)
        args = node.args
        pos = args.posonlyargs + args.args
        for a, d in zip(pos[len(pos) - len(args.defaults):],
                        args.defaults):
            if isinstance(d, ast.Constant):
                fn["param_defaults"][a.arg] = d.value
        for a, d in zip(args.kwonlyargs, args.kw_defaults):
            if isinstance(d, ast.Constant):
                fn["param_defaults"][a.arg] = d.value
        for a in pos + args.kwonlyargs:
            ann = _ann_dotted(a.annotation)
            if ann:
                fn["param_annotations"][a.arg] = ann
        self.functions.append(fn)
        for dec in node.decorator_list:
            self._visit(dec)
        self._fn_stack.append(fn)
        held, self._locks_held = self._locks_held, []
        trys, self._try_stack = self._try_stack, []
        self._visit_body(node.body)
        self._locks_held, self._try_stack = held, trys
        self._fn_stack.pop()

    _v_AsyncFunctionDef = _v_FunctionDef

    # statements ------------------------------------------------------------

    def _record_attr_writes(self, node, targets: list,
                            kind_override: str | None = None) -> None:
        fn = self._fn()
        multi = len(targets) > 1
        flat = []
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                multi = True
                flat.extend(t.elts)
            else:
                flat.append(t)
        for t in flat:
            rec = _attr_write_of(t)
            if rec is None:
                continue
            recv, attr, kind = rec
            fn["attr_writes"].append(
                {"recv": recv, "attr": attr,
                 "kind": kind_override or kind, "multi": multi,
                 "line": node.lineno, "col": node.col_offset})

    def _v_AugAssign(self, node: ast.AugAssign) -> None:
        self._record_attr_writes(node, [node.target], kind_override="aug")
        self._generic(node)

    def _v_Assign(self, node: ast.Assign) -> None:
        fn = self._fn()
        self._record_attr_writes(node, node.targets)
        if len(node.targets) == 1 and isinstance(node.targets[0],
                                                 ast.Name) \
                and isinstance(node.value, ast.Attribute):
            src = _dotted(node.value)
            if src:
                # Alias fact: `idx = self._index` — the snapshot-publish
                # and atomic-swap passes chase mutations through it.
                fn["var_aliases"][node.targets[0].id] = src
        if isinstance(node.value, ast.Call):
            callee = _dotted(node.value.func)
            for t in node.targets:
                if isinstance(t, ast.Name) and callee:
                    fn["var_types"][t.id] = callee
            if not self._fn_stack and callee.rsplit(".", 1)[-1] in (
                    "Lock", "RLock"):
                self.module_locks += [t.id for t in node.targets
                                      if isinstance(t, ast.Name)]
        elif len(node.targets) == 1 and isinstance(node.targets[0],
                                                   ast.Name):
            t = node.targets[0]
            if not self._fn_stack:
                if isinstance(node.value, ast.Constant):
                    self.constants[t.id] = node.value.value
                elif isinstance(node.value, (ast.Tuple, ast.List)) and all(
                        isinstance(e, ast.Constant)
                        for e in node.value.elts):
                    self.constants[t.id] = [e.value
                                            for e in node.value.elts]
            if isinstance(node.value, ast.Name):
                src = fn["var_types"].get(node.value.id)
                if src:
                    fn["var_types"][t.id] = src
        self._generic(node)

    def _v_Compare(self, node: ast.Compare) -> None:
        # `name == "literal"` (either side): the dispatch-table fact
        # the verb-dispatch-drift pass reads off `_dispatch_op`-style
        # functions.  Chained comparisons stay opaque on purpose.
        if len(node.ops) == 1 and isinstance(node.ops[0], ast.Eq):
            left, right = node.left, node.comparators[0]
            name = value = None
            if isinstance(left, ast.Name) \
                    and isinstance(right, ast.Constant) \
                    and isinstance(right.value, str):
                name, value = left.id, right.value
            elif isinstance(right, ast.Name) \
                    and isinstance(left, ast.Constant) \
                    and isinstance(left.value, str):
                name, value = right.id, left.value
            if name is not None:
                eqs = self._fn()["str_eqs"].setdefault(name, [])
                if value not in eqs:
                    eqs.append(value)
        self._generic(node)

    def _v_Return(self, node: ast.Return) -> None:
        fn = self._fn()
        if node.value is not None:
            if isinstance(node.value, ast.Call):
                callee = _dotted(node.value.func)
                if callee:
                    fn["returns_call"] = callee
            elif isinstance(node.value, ast.Name):
                src = fn["var_types"].get(node.value.id)
                if src:
                    fn["returns_call"] = src
        self._generic(node)

    def _v_Raise(self, node: ast.Raise) -> None:
        fn = self._fn()
        name = ""
        if node.exc is not None:
            name = _dotted(node.exc) or _dotted(
                getattr(node.exc, "func", node.exc))
        fn["raises"].append({"name": name.rsplit(".", 1)[-1],
                             "line": node.lineno,
                             "bare": node.exc is None,
                             "handlers": [h for t in self._try_stack
                                          for h in t]})
        self._generic(node)

    def _v_With(self, node: ast.With) -> None:
        fn = self._fn()
        tokens = []
        for item in node.items:
            self._visit(item.context_expr)
            tok = self._lock_token(item.context_expr)
            if tok is not None:
                tokens.append(tok)
                fn["lock_sites"].append(
                    {"token": tok, "line": node.lineno,
                     "held": list(self._locks_held)})
        self._locks_held.extend(tokens)
        self._visit_body(node.body)
        if tokens:
            del self._locks_held[-len(tokens):]

    _v_AsyncWith = _v_With

    def _v_Try(self, node: ast.Try) -> None:
        fn = self._fn()
        ids = []
        for h in node.handlers:
            if self._is_broad(h.type):
                hid = len(fn["broad_handlers"])
                fn["broad_handlers"].append({
                    "id": hid, "line": h.lineno,
                    "reraises": self._handler_reraises(h),
                    "lse_escapes": self._handler_lse_escapes(h)})
                ids.append(hid)
            elif self._catches_lse(h.type) \
                    and not self._handler_reraises(h):
                # Explicit LeaseSupersededError handler that does NOT
                # re-raise: deliberate handling — it also stops upward
                # may-raise propagation for the calls in this try body.
                hid = len(fn["broad_handlers"])
                fn["broad_handlers"].append(
                    {"id": hid, "line": h.lineno, "reraises": False,
                     "lse_escapes": False, "explicit_lse": True})
                ids.append(hid)
        self._try_stack.append(ids)
        self._visit_body(node.body)
        self._try_stack.pop()
        for h in node.handlers:
            self._visit_body(h.body)
        self._visit_body(node.orelse)
        self._visit_body(node.finalbody)

    _v_TryStar = _v_Try

    @staticmethod
    def _is_broad(type_node) -> bool:
        if type_node is None:
            return True
        if isinstance(type_node, ast.Tuple):
            return any(_FactsVisitor._is_broad(e) for e in type_node.elts)
        return _dotted(type_node).rsplit(".", 1)[-1] in ("Exception",
                                                         "BaseException")

    @staticmethod
    def _catches_lse(type_node) -> bool:
        if type_node is None:
            return True
        if isinstance(type_node, ast.Tuple):
            return any(_FactsVisitor._catches_lse(e)
                       for e in type_node.elts)
        return _dotted(type_node).rsplit(".", 1)[-1] == \
            "LeaseSupersededError"

    @staticmethod
    def _handler_reraises(handler: ast.ExceptHandler) -> bool:
        for n in ast.walk(handler):
            if isinstance(n, ast.Raise) and (n.exc is None
                                             or n.cause is not None):
                return True
        return False

    @staticmethod
    def _handler_lse_escapes(handler: ast.ExceptHandler) -> bool:
        """Does LeaseSupersededError itself provably escape this broad
        handler?  A bare ``raise`` / ``raise e`` (the caught name)
        re-raises the original; ``raise X(...) from e`` does NOT — it
        converts the fence signal into another type, which is exactly
        the masking the lease protocol forbids."""
        caught = handler.name
        for n in ast.walk(handler):
            if isinstance(n, ast.Raise):
                if n.exc is None:
                    return True
                if (caught and isinstance(n.exc, ast.Name)
                        and n.exc.id == caught and n.cause is None):
                    return True
        return False

    # calls -----------------------------------------------------------------

    def _v_Call(self, node: ast.Call) -> None:
        fn = self._fn()
        callee = _dotted(node.func)
        recv_call = None
        if isinstance(node.func, ast.Attribute) and isinstance(
                node.func.value, ast.Call):
            # one-level receiver-call: self.range_store(r).append(...)
            recv_call = _dotted(node.func.value.func)
            if recv_call:
                callee = f"<call:{recv_call}>.{node.func.attr}"
        call: dict = {"callee": callee, "line": node.lineno,
                      "col": node.col_offset, "idx": self._call_idx,
                      "locks": list(self._locks_held),
                      "handlers": [h for t in self._try_stack for h in t]}
        self._call_idx += 1
        call["args"] = [self._arg_fact(a, fn) for a in node.args]
        call["kwargs"] = {kw.arg: self._arg_fact(kw.value, fn)
                          for kw in node.keywords if kw.arg}
        tail = callee.rsplit(".", 1)[-1]
        if tail == "fault_point" and node.args:
            site = node.args[0]
            if isinstance(site, ast.Constant) and isinstance(
                    site.value, str):
                call["fault_site"] = site.value
            elif isinstance(site, ast.Name):
                call["fault_site_param"] = site.id
            else:
                call["fault_site_param"] = "<expr>"
        if tail in _SQL_EXEC_ATTRS and isinstance(node.func,
                                                  ast.Attribute):
            call["exec_recv"] = _dotted(node.func.value) or (
                f"<call:{recv_call}>" if recv_call else "<expr>")
        if tail == "open":
            mode = node.args[1] if len(node.args) >= 2 else None
            for kw in node.keywords:
                if kw.arg == "mode":
                    mode = kw.value
            call["open_write"] = bool(
                isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
                and any(c in mode.value for c in "wa+x"))
        if tail in ("open", "atomic_write") and node.args:
            toks = self._path_tokens(node.args[0], fn)
            if toks:
                call["path_tokens"] = sorted(toks)
        fn["calls"].append(call)
        self._generic(node)

    def _arg_fact(self, a: ast.AST, fn: dict) -> dict:
        fact: dict = {"kind": "other"}
        if isinstance(a, ast.Constant):
            fact = {"kind": "const"}
            if isinstance(a.value, str):
                fact["value"] = a.value
        elif isinstance(a, ast.Name):
            if a.id in fn["params"]:
                fact = {"kind": "param", "name": a.id}
            else:
                fact = {"kind": "var", "name": a.id}
                vt = fn["var_types"].get(a.id)
                if vt:
                    fact["type"] = vt
        elif isinstance(a, ast.Attribute):
            expr = _dotted(a)
            if expr:
                fact = {"kind": "attr", "expr": expr}
        elif isinstance(a, ast.Call):
            fact = {"kind": "call", "callee": _dotted(a.func)}
        if self._sql_tainted(a, fn):
            fact["kind"] = "tainted-sql"
        return fact

    def _sql_tainted(self, a: ast.AST, fn: dict) -> bool:
        """A string expression interpolating non-blessed parts into SQL
        text (reuses the per-file rule's blessing logic over this
        function's local name->binding env)."""
        from .rules import _blessed_expr

        env = fn.get("_env", {})
        node = env.get(a.id) if isinstance(a, ast.Name) else a
        if node is None or not _looks_sql(node) \
                or not _is_interpolated(node):
            return False
        if isinstance(node, ast.JoinedStr):
            return any(not _blessed_expr(v.value, env)
                       for v in node.values
                       if isinstance(v, ast.FormattedValue))
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            return not all(_blessed_expr(x, env) for x in node.args)
        if isinstance(node, ast.BinOp):
            if isinstance(node.op, ast.Mod):
                right = (node.right.elts
                         if isinstance(node.right, ast.Tuple)
                         else [node.right])
                return not all(_blessed_expr(r, env) for r in right)
            return not (_blessed_expr(node.left, env)
                        and _blessed_expr(node.right, env))
        return False

    def _path_tokens(self, a: ast.AST, fn: dict) -> set:
        """Protocol-file tokens mentioned by a path expression (one
        level of name/constant resolution): membership.json / lease_* /
        hb_* or the coordinator path helpers."""
        toks: set = set()
        env = fn.get("_env", {})

        def scan(node, depth=0):
            if node is None or depth > 4:
                return
            if isinstance(node, ast.Constant) and isinstance(node.value,
                                                             str):
                self._token_match(node.value, toks)
            elif isinstance(node, ast.JoinedStr):
                for v in node.values:
                    scan(v.value if isinstance(v, ast.FormattedValue)
                         else v, depth + 1)
            elif isinstance(node, ast.Name):
                const = self.constants.get(node.id)
                if isinstance(const, str):
                    self._token_match(const, toks)
                else:
                    scan(env.get(node.id), depth + 1)
            elif isinstance(node, ast.Call):
                tail = _dotted(node.func).rsplit(".", 1)[-1]
                if tail in ("lease_path", "heartbeat_path"):
                    toks.add(tail)
                for x in node.args:
                    scan(x, depth + 1)
            elif isinstance(node, ast.BinOp):
                scan(node.left, depth + 1)
                scan(node.right, depth + 1)
            elif isinstance(node, ast.Attribute):
                # self.path-style: typed through the class attr table
                if (isinstance(node.value, ast.Name)
                        and node.value.id == "self" and self._cls_stack):
                    crec = self.classes.get(self._cls_stack[-1], {})
                    src = crec.get("attr_paths", {}).get(node.attr)
                    if src:
                        self._token_match(src, toks)

        scan(a)
        return toks

    @staticmethod
    def _token_match(text: str, toks: set) -> None:
        low = text.lower()
        if "membership.json" in low:
            toks.add("membership.json")
        if "lease_" in low:
            toks.add("lease_")
        if "hb_" in low:
            toks.add("hb_")


def extract_facts(relpath: str, text: str,
                  tree: ast.AST | None = None) -> dict:
    """FileFacts for one file (parses ``text`` unless ``tree`` given)."""
    if tree is None:
        tree = ast.parse(text, filename=relpath)
    v = _FactsVisitor(relpath, tree)
    for fn in v.functions:
        fn.pop("_env", None)
    return {"path": relpath, "module": v.module, "imports": v.imports,
            "constants": v.constants, "module_locks": v.module_locks,
            "classes": v.classes, "functions": v.functions}


# -- the project graph -------------------------------------------------------


@dataclass
class ProjectGraph:
    """Resolved whole-program view over a set of FileFacts."""

    root: str
    facts: dict[str, dict] = field(default_factory=dict)   # path -> facts
    functions: dict[str, dict] = field(default_factory=dict)  # qual -> fn
    fn_file: dict[str, str] = field(default_factory=dict)   # qual -> path
    modules: dict[str, str] = field(default_factory=dict)   # module -> path
    classes: dict[str, dict] = field(default_factory=dict)  # mod.Cls -> rec
    calls: dict[str, list] = field(default_factory=dict)    # qual -> edges
    rev_calls: dict[str, list] = field(default_factory=dict)
    cache_files: int = 0
    cache_hits: int = 0
    extracted: list[str] = field(default_factory=list)  # paths re-parsed

    # ---- construction ----

    def add_file(self, facts: dict) -> None:
        path = facts["path"]
        self.facts[path] = facts
        self.modules[facts["module"]] = path
        for cname, crec in facts["classes"].items():
            self.classes[f"{facts['module']}.{cname}"] = crec
        for fn in facts["functions"]:
            self.functions[fn["qual"]] = fn
            self.fn_file[fn["qual"]] = path

    def finalize(self) -> None:
        """Resolve every call site to a qualified callee (where
        possible) and build forward/reverse call-edge tables."""
        for qual, fn in self.functions.items():
            edges = []
            for call in fn["calls"]:
                target = self.resolve_call(qual, call)
                if target is not None:
                    call["resolved"] = target
                    edges.append((target, call))
            self.calls[qual] = edges
            for target, call in edges:
                self.rev_calls.setdefault(target, []).append((qual, call))

    def module_of(self, qual: str) -> str:
        path = self.fn_file.get(qual)
        return self.facts[path]["module"] if path else ""

    # ---- symbol resolution ----

    def _module_symbol(self, module: str, name: str,
                       depth: int = 0) -> str | None:
        """``module.name`` resolved to a function/class qual, following
        up to three import hops (re-exports)."""
        if depth > 3:
            return None
        path = self.modules.get(module)
        if path is None:
            return None
        qual = f"{module}.{name}"
        if qual in self.functions or qual in self.classes:
            return qual
        target = self.facts[path]["imports"].get(name)
        if target and target != qual:
            mod, _, leaf = target.rpartition(".")
            if mod:
                return self._module_symbol(mod, leaf, depth + 1)
        return None

    def _class_method(self, cls_qual: str, meth: str,
                      depth: int = 0) -> str | None:
        if depth > 4:
            return None
        crec = self.classes.get(cls_qual)
        if crec is None:
            return None
        if meth in crec["methods"]:
            return f"{cls_qual}.{meth}"
        mod = cls_qual.rsplit(".", 1)[0]
        for base in crec.get("bases", []):
            base_qual = self._resolve_dotted(mod, base)
            if base_qual:
                found = self._class_method(base_qual, meth, depth + 1)
                if found:
                    return found
        return None

    def _resolve_dotted(self, module: str, dotted: str) -> str | None:
        """Resolve a dotted expression *as written in ``module``* to a
        function or class qual."""
        if not dotted:
            return None
        head, _, rest = dotted.partition(".")
        path = self.modules.get(module)
        imports = self.facts.get(path or "", {}).get("imports", {})
        target = imports.get(head)
        if target is None:
            local = self._module_symbol(module, head)
            if local is None:
                return None
            if not rest:
                return local
            if local in self.classes:
                return self._class_method(local, rest.split(".")[0])
            return None
        if rest:
            # imported module (import x.y as z; z.fn) or imported class
            full_mod = target
            parts = rest.split(".")
            while len(parts) > 1 and f"{full_mod}.{parts[0]}" \
                    in self.modules:
                full_mod = f"{full_mod}.{parts[0]}"
                parts = parts[1:]
            if full_mod in self.modules:
                sym = self._module_symbol(full_mod, parts[0])
                if sym is not None and len(parts) > 1 \
                        and sym in self.classes:
                    return self._class_method(sym, parts[1])
                return sym
            tmod, _, tleaf = target.rpartition(".")
            sym = self._module_symbol(tmod, tleaf) if tmod else None
            if sym and sym in self.classes:
                return self._class_method(sym, parts[0])
            return None
        # plain imported symbol
        mod, _, leaf = target.rpartition(".")
        if mod:
            return self._module_symbol(mod, leaf)
        return None

    def resolve_call(self, caller_qual: str, call: dict) -> str | None:
        callee = call["callee"]
        fn = self.functions.get(caller_qual)
        if fn is None or not callee:
            return None
        path = self.fn_file[caller_qual]
        module = self.facts[path]["module"]
        if callee.startswith("<call:"):
            inner, _, meth = callee[6:].partition(">.")
            inner_qual = self.resolve_call(caller_qual,
                                           {"callee": inner})
            if inner_qual is None:
                return None
            if inner_qual in self.classes:  # Ctor().meth(...)
                return self._class_method(inner_qual, meth)
            ret = self.functions.get(inner_qual, {}).get("returns_call")
            if not ret:
                return None
            ret_module = self.module_of(inner_qual)
            cls_qual = self._resolve_dotted(ret_module, ret)
            if cls_qual and cls_qual in self.classes:
                return self._class_method(cls_qual, meth)
            return None
        head, _, rest = callee.partition(".")
        if head == "self":
            cls = fn.get("cls")
            if cls is None and fn.get("parent"):
                cls = self.functions.get(fn["parent"], {}).get("cls")
            if cls is None or not rest:
                return None
            cls_qual = f"{module}.{cls}"
            meth, _, trail = rest.partition(".")
            if trail:
                crec = self.classes.get(cls_qual, {})
                attr_t = crec.get("attr_types", {}).get(meth)
                if attr_t:
                    tq = self._resolve_dotted(module, attr_t)
                    if tq and tq in self.classes:
                        return self._class_method(tq, trail.split(".")[0])
                return None
            return self._class_method(cls_qual, meth)
        if rest:
            vt = fn["var_types"].get(head)
            if vt:
                tq = self._resolve_dotted(module, vt)
                if tq and tq in self.classes:
                    return self._class_method(tq, rest.split(".")[0])
                if tq and tq in self.functions:
                    ret = self.functions[tq].get("returns_call")
                    if ret:
                        rq = self._resolve_dotted(self.module_of(tq), ret)
                        if rq and rq in self.classes:
                            return self._class_method(rq,
                                                      rest.split(".")[0])
                return None
        return self._resolve_dotted(module, callee)

    # ---- import graph ----

    def import_edges(self) -> dict[str, set]:
        """path -> set of project paths it imports."""
        out: dict[str, set] = {p: set() for p in self.facts}
        for path, facts in self.facts.items():
            for target in facts["imports"].values():
                mod = target
                while mod:
                    if mod in self.modules:
                        if self.modules[mod] != path:
                            out[path].add(self.modules[mod])
                        break
                    mod = mod.rpartition(".")[0]
        return out

    def reverse_closure(self, paths: set) -> set:
        """``paths`` plus every file that (transitively) imports one."""
        rev: dict[str, set] = {}
        for src, dsts in self.import_edges().items():
            for d in dsts:
                rev.setdefault(d, set()).add(src)
        out = set(paths)
        work = list(paths)
        while work:
            p = work.pop()
            for dep in rev.get(p, ()):
                if dep not in out:
                    out.add(dep)
                    work.append(dep)
        return out

    # ---- witness chains ----

    def call_chain(self, start: str, goal: str) -> list | None:
        """Shortest resolved-call path start -> ... -> goal as a list of
        (caller_qual, call, callee_qual) edges, or None."""
        if start == goal:
            return []
        prev: dict[str, tuple] = {}
        seen = {start}
        frontier = [start]
        while frontier:
            nxt = []
            for q in frontier:
                for target, call in self.calls.get(q, ()):
                    if target in seen:
                        continue
                    seen.add(target)
                    prev[target] = (q, call)
                    if target == goal:
                        chain = []
                        node = goal
                        while node != start:
                            q2, c2 = prev[node]
                            chain.append((q2, c2, node))
                            node = q2
                        return list(reversed(chain))
                    nxt.append(target)
            frontier = nxt
        return None

    def site(self, qual: str, call: dict | None = None) -> str:
        path = self.fn_file.get(qual, "?")
        line = (call or {}).get("line") or \
            self.functions.get(qual, {}).get("line", 0)
        return f"{path}:{line}"


# -- build + cache -----------------------------------------------------------


def cache_path(root: str) -> str:
    return os.path.join(root, CACHE_BASENAME)


def load_cache(root: str) -> dict:
    """The cached facts by path; {} (a cold run) when the file is absent,
    of another version, or unreadable in any way."""
    try:
        with open(cache_path(root), encoding="utf-8") as f:
            data = json.load(f)
        files = data.get("files") if data.get("version") == _CACHE_VERSION \
            else None
    except (OSError, ValueError, AttributeError):
        return {}
    if not isinstance(files, dict):
        return {}
    return {rel: e for rel, e in files.items()
            if isinstance(e, dict) and isinstance(e.get("facts"), dict)}


def save_cache(root: str, files: dict) -> None:
    payload = {"version": _CACHE_VERSION, "files": files}
    # One temp file per process: processes linting at once (test workers,
    # the ranks of a world) each replace the cache whole, never write
    # into one shared temp file.
    tmp = f"{cache_path(root)}.{os.getpid()}.tmp"
    try:
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(payload, f)
        os.replace(tmp, cache_path(root))
    except OSError:
        with contextlib.suppress(OSError):
            os.remove(tmp)  # a read-only checkout just runs cold


def build_graph(paths: list[str], root: str,
                sources: dict | None = None,
                use_cache: bool = True) -> ProjectGraph:
    """Build the ProjectGraph over ``paths``.

    ``sources`` optionally maps abspath -> (relpath, text, tree) for
    files the engine already parsed (one parse per run).  The digest
    cache short-circuits fact extraction for unchanged files."""
    graph = ProjectGraph(root=root)
    cached = load_cache(root) if use_cache else {}
    new_cache: dict = {}
    for abspath in paths:
        abspath = os.path.abspath(abspath)
        rel = os.path.relpath(abspath, root).replace(os.sep, "/")
        pre = (sources or {}).get(abspath)
        if pre is not None:
            text = pre[1]
        else:
            try:
                with open(abspath, encoding="utf-8") as f:
                    text = f.read()
            except OSError:
                continue
        digest = content_digest(text.encode("utf-8"))
        graph.cache_files += 1
        entry = cached.get(rel)
        if entry is not None and entry.get("digest") == digest:
            graph.cache_hits += 1
            facts = entry["facts"]
        else:
            try:
                facts = extract_facts(rel, text,
                                      tree=pre[2] if pre else None)
            except (SyntaxError, RecursionError, ValueError):
                continue
            graph.extracted.append(rel)
        new_cache[rel] = {"digest": digest, "facts": facts}
        graph.add_file(facts)
    if use_cache and graph.extracted:
        # Merge over the existing cache: an explicit-path or fixture run
        # must not evict the full-target entries.  An all-hit run has
        # nothing new to write.
        save_cache(root, {**cached, **new_cache})
    graph.finalize()
    return graph


__all__ = ["CACHE_BASENAME", "ProjectGraph", "build_graph", "cache_path",
           "content_digest", "extract_facts", "load_cache", "module_name",
           "save_cache"]
