"""The graftlint rule catalog over the port: the JAX package's 13 per-file
rules under their names (rationale per rule in the JAX package's
LINTING.md), each path constant retargeted at the port's counterpart.

Every rule is a pure function ``FileSource -> list[Finding]`` over the
parsed AST; the engine resolves suppressions and the baseline.  Rules are
tuned to THIS repo's failure modes — they prefer a small number of
high-signal findings over generic-linter breadth, and each encodes an
invariant the code relies on:

- ``broad-except``        fault transparency (resilience plane)
- ``nonatomic-write``     atomic tmp+rename writes (checkpointers)
- ``sql-interp``          validated SQL identifiers (db/ident.py)
- ``host-in-jit``         no host ops / traced-value control flow in
                          traced bodies: jit/shard_map/pallas, and in the
                          port ``torch.compile`` / ``torch.jit.*``
                          (silent recompiles, graph breaks or
                          device->host syncs)
- ``wire-layer``          host<->device transfers only in the blessed
                          wire layer (cluster/encode.py + pipeline.py):
                          ``device_put``/``device_get``, and in the port
                          the explicit copies ``.to(<device>)``,
                          ``.cuda()``, ``.cpu()``, and
                          ``torch.as_tensor``/``torch.tensor`` with
                          ``device=``
- ``unlocked-shared-state``  lock-owning classes/modules must mutate
                          shared state under their lock (producer-thread
                          overlap)
- ``retry-bypass``        all HTTP/DB I/O through the retry engine
- ``nondeterminism``      no wall-clock/global-RNG in chaos-replayed
                          planes (seeded fault plans must replay)
- ``watchdog-clock``      the supervision plane reads time only through
                          resilience.watchdog.deadline_clock (one
                          monotonic time base for every deadline)
- ``span-discipline``     tracing spans close deterministically: ``with
                          span(...)`` (or enter_context), and manual
                          ``start_span`` only under a finally-``.end()``
"""

from __future__ import annotations

import ast
import re

from .engine import FileSource, Finding


def _f(src: FileSource, node: ast.AST, message: str) -> Finding:
    return Finding(rule="", path=src.path, line=getattr(node, "lineno", 1),
                   col=getattr(node, "col_offset", 0), message=message)


def _nodes(src: FileSource) -> list:
    """Every node of the file in ``ast.walk`` order, listed once per
    parsed file (kept on the tree: the rules share one walk)."""
    out = getattr(src.tree, "_graftlint_nodes", None)
    if out is None:
        out = list(ast.walk(src.tree))
        src.tree._graftlint_nodes = out
    return out


def _parents(tree: ast.AST) -> dict:
    """child -> parent over ``tree``, built once per parsed file (kept on
    the tree: every rule that needs it shares one map)."""
    out = getattr(tree, "_graftlint_parents", None)
    if out is None:
        out = {}
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                out[child] = node
        tree._graftlint_parents = out
    return out


def _dotted(node: ast.AST) -> str:
    """'torch.as_tensor' for Attribute chains, 'open' for Names, '' else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _enclosing_function(node: ast.AST, parents: dict):
    while node is not None:
        node = parents.get(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return node
    return None


# -- 1. broad-except ---------------------------------------------------------

_BROAD = {"Exception", "BaseException"}
_FAULT_GUARDS = {"reraise_if_fault"}


def _is_broad(type_node) -> bool:
    if type_node is None:  # bare `except:` — also swallows KeyboardInterrupt
        return True
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(e) for e in type_node.elts)
    name = _dotted(type_node)
    return name.rsplit(".", 1)[-1] in _BROAD


def _handler_reraises(handler: ast.ExceptHandler) -> bool:
    """The handler is fault-transparent: it re-raises (bare ``raise``,
    conditionally is fine — that is exactly the prescribed
    ``if isinstance(e, InjectedFault): raise`` guard), chains a new
    exception (``raise X(...) from e`` propagates loudly), or routes
    through ``resilience.reraise_if_fault``."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise) and (node.exc is None
                                            or node.cause is not None):
            return True
        if isinstance(node, ast.Call):
            if _dotted(node.func).rsplit(".", 1)[-1] in _FAULT_GUARDS:
                return True
    return False


def broad_except(src: FileSource) -> list[Finding]:
    out = []
    for node in _nodes(src):
        if not isinstance(node, ast.Try):
            continue
        for h in node.handlers:
            if _is_broad(h.type) and not _handler_reraises(h):
                kind = ("bare except" if h.type is None
                        else f"except {_dotted(h.type) or '...'}")
                out.append(_f(src, h,
                              f"{kind} can swallow resilience.InjectedFault"
                              " — narrow it, re-raise faults (`if "
                              "isinstance(e, InjectedFault): raise` / "
                              "resilience.reraise_if_fault(e)), or "
                              "suppress with a reason"))
    return out


# -- 2. nonatomic-write ------------------------------------------------------

def _is_tmp_target(arg: ast.AST) -> bool:
    """The open() target is already a tmp-file the caller will rename."""
    if isinstance(arg, ast.Name) and "tmp" in arg.id.lower():
        return True
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value.endswith(".tmp")
    if isinstance(arg, ast.BinOp):  # path + ".tmp"
        return _is_tmp_target(arg.right) or _is_tmp_target(arg.left)
    if isinstance(arg, ast.Attribute) and "tmp" in arg.attr.lower():
        return True
    if isinstance(arg, ast.Call):  # tmp_path(...), .with_suffix(".tmp")
        inner = _dotted(arg.func).rsplit(".", 1)[-1].lower()
        if "tmp" in inner:
            return True
        return any(_is_tmp_target(a) for a in arg.args)
    return False


def nonatomic_write(src: FileSource) -> list[Finding]:
    parents = _parents(src.tree)
    out = []
    for node in _nodes(src):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "open" and len(node.args) >= 2):
            continue
        mode = node.args[1]
        if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
                and "w" in mode.value):
            continue
        if _is_tmp_target(node.args[0]):
            continue
        fn = _enclosing_function(node, parents)
        scope = fn if fn is not None else src.tree
        renames = any(
            isinstance(n, ast.Call)
            and _dotted(n.func) in ("os.replace", "os.rename")
            for n in ast.walk(scope))
        if renames:
            continue
        out.append(_f(src, node,
                      "non-atomic write-mode open() — a crash mid-write "
                      "leaves a torn file; write to `path + \".tmp\"` then "
                      "os.replace (see utils/atomic.py), or suppress "
                      "with a reason"))
    return out


# -- 3. sql-interp -----------------------------------------------------------

_SQL_RE = re.compile(
    r"\b(SELECT|INSERT|UPDATE|DELETE|CREATE|DROP|ALTER|COPY|PRAGMA|SET)\b")
# Interpolations that cannot inject: the db/ident.py helpers, integer
# coercion, and db/queries.py's qmark placeholder-list builder.
_SQL_BLESSED = {"quote_ident", "validate_ident", "col_list", "int", "_in"}


def _blessed_expr(node: ast.AST, env: dict, depth: int = 0) -> bool:
    """True when the interpolated expression cannot inject: constants,
    the blessed helpers, placeholder-list composition (``",".join("?" *
    len(cols))``), and names assigned (in the same scope) from blessed
    expressions."""
    if depth > 6:
        return False
    if isinstance(node, ast.Constant):
        return True
    if isinstance(node, ast.Name):
        bound = env.get(node.id)
        return bound is not None and _blessed_expr(bound, env, depth + 1)
    if isinstance(node, ast.Call):
        name = _dotted(node.func).rsplit(".", 1)[-1]
        if name in _SQL_BLESSED or name == "len":
            return True
        if (isinstance(node.func, ast.Attribute) and node.func.attr == "join"
                and isinstance(node.func.value, ast.Constant)):
            return all(_blessed_expr(a, env, depth + 1) for a in node.args)
        return False
    if isinstance(node, ast.BinOp):
        return (_blessed_expr(node.left, env, depth + 1)
                and _blessed_expr(node.right, env, depth + 1))
    if isinstance(node, ast.IfExp):
        return (_blessed_expr(node.body, env, depth + 1)
                and _blessed_expr(node.orelse, env, depth + 1))
    if isinstance(node, (ast.GeneratorExp, ast.ListComp)):
        return _blessed_expr(node.elt, env, depth + 1)
    if isinstance(node, ast.JoinedStr):
        return all(_blessed_expr(v.value, env, depth + 1)
                   for v in node.values
                   if isinstance(v, ast.FormattedValue))
    return False


def _scope_env(scope: ast.AST) -> dict:
    """name -> assigned expression, for single-name assignments in the
    scope (simple local dataflow; reassignment keeps the LAST binding,
    which is the common builder pattern here)."""
    env: dict = {}
    for node in ast.walk(scope):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            env[node.targets[0].id] = node.value
        elif isinstance(node, ast.AugAssign) \
                and isinstance(node.target, ast.Name):
            env[node.target.id] = None  # composed further — unknown
    return env


_SQL_MSG = ("SQL string built by interpolation — route identifiers through "
            "db/ident.py (quote_ident/validate_ident/col_list) or bind "
            "values as parameters")


def sql_interp(src: FileSource) -> list[Finding]:
    parents = _parents(src.tree)
    envs: dict = {}

    def env_for(node: ast.AST) -> dict:
        scope = _enclosing_function(node, parents) or src.tree
        if id(scope) not in envs:
            envs[id(scope)] = _scope_env(scope)
        return envs[id(scope)]

    out = []
    for node in _nodes(src):
        if isinstance(node, ast.JoinedStr):
            literal = "".join(v.value for v in node.values
                              if isinstance(v, ast.Constant)
                              and isinstance(v.value, str))
            if not _SQL_RE.search(literal):
                continue
            env = env_for(node)
            bad = [v for v in node.values
                   if isinstance(v, ast.FormattedValue)
                   and not _blessed_expr(v.value, env)]
            if bad:
                out.append(_f(src, node, _SQL_MSG))
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "format"
              and isinstance(node.func.value, ast.Constant)
              and isinstance(node.func.value.value, str)
              and _SQL_RE.search(node.func.value.value)):
            env = env_for(node)
            if not all(_blessed_expr(a, env) for a in node.args) or not all(
                    _blessed_expr(k.value, env) for k in node.keywords):
                out.append(_f(src, node, _SQL_MSG))
        elif (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mod)
              and isinstance(node.left, ast.Constant)
              and isinstance(node.left.value, str)
              and _SQL_RE.search(node.left.value)):
            env = env_for(node)
            right = (node.right.elts if isinstance(node.right, ast.Tuple)
                     else [node.right])
            if not all(_blessed_expr(r, env) for r in right):
                out.append(_f(src, node, _SQL_MSG))
    return out


# -- 4. host-in-jit ----------------------------------------------------------

# The bodies torch traces: ``torch.compile`` and the TorchScript entry
# points.  The port has none today; the rule reads them as JAX's reads
# jit bodies, so the first one added is checked.
_TORCH_TRACERS = {"torch.compile", "torch.jit.script", "torch.jit.trace",
                  "torch.jit.script_method", "jit.script", "jit.trace",
                  "jit.script_method"}


def _traces(node: ast.AST) -> bool:
    """A decorator/callee that traces its function: jax.jit / jit, or one
    of torch's tracers."""
    name = _dotted(node)
    return name.rsplit(".", 1)[-1] == "jit" or name in _TORCH_TRACERS


def _jit_call_target(call: ast.Call):
    """(is_jit_wrap, static_argnames) for jax.jit(...) / jit(...) /
    partial(jax.jit, ...) / torch.compile(...) / torch.jit.script(...)
    call nodes."""
    if _traces(call.func):
        return True, _static_argnames(call)
    name = _dotted(call.func).rsplit(".", 1)[-1]
    if name == "partial" and call.args:
        inner = call.args[0]
        if _traces(inner):
            return True, _static_argnames(call)
    return False, ()


def _static_argnames(call: ast.Call) -> tuple:
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, str):
                return (v.value,)
            if isinstance(v, (ast.Tuple, ast.List)):
                return tuple(e.value for e in v.elts
                             if isinstance(e, ast.Constant))
    return ()


def _collect_traced_functions(src: FileSource) -> dict:
    """name -> static_argnames for functions whose BODY is traced:
    jit-decorated (or torch.compile / torch.jit-decorated), wrapped so at
    module level, shard_map-decorated, or passed as a pallas_call
    kernel."""
    traced: dict[str, tuple] = {}
    for node in _nodes(src):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                name = _dotted(dec).rsplit(".", 1)[-1]
                if name == "shard_map" or _traces(dec):
                    traced[node.name] = ()
                elif isinstance(dec, ast.Call):
                    is_jit, statics = _jit_call_target(dec)
                    dec_name = _dotted(dec.func).rsplit(".", 1)[-1]
                    if is_jit or dec_name == "shard_map":
                        traced[node.name] = statics
        elif isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            call = node.value
            is_jit, statics = _jit_call_target(call)
            inner = None
            if _traces(call.func) and call.args:
                inner = call.args[0]
            elif (_dotted(call.func).rsplit(".", 1)[-1] == "partial"
                  and len(call.args) >= 2):
                inner = call.args[1]
            if is_jit and isinstance(inner, ast.Name):
                traced[inner.id] = statics
        elif isinstance(node, ast.Call):
            if _dotted(node.func).rsplit(".", 1)[-1] == "pallas_call":
                if node.args:
                    kern = node.args[0]
                    if isinstance(kern, ast.Name):
                        traced.setdefault(kern.id, ())
                    elif (isinstance(kern, ast.Call) and kern.args
                          and isinstance(kern.args[0], ast.Name)):
                        traced.setdefault(kern.args[0].id, ())
    return traced


def host_in_jit(src: FileSource) -> list[Finding]:
    traced = _collect_traced_functions(src)
    if not traced:
        return []
    out = []
    for node in _nodes(src):
        if not (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                and node.name in traced):
            continue
        statics = set(traced[node.name])
        args = node.args
        params = {a.arg for a in (args.posonlyargs + args.args
                                  + args.kwonlyargs)}
        # Keyword-only params default to static in this codebase's idiom
        # (block_n/interpret style knobs); positional params are traced
        # unless named in static_argnames.
        dyn = params - statics - {a.arg for a in args.kwonlyargs} - {"self"}
        for inner in ast.walk(node):
            if isinstance(inner, ast.Attribute):
                base = inner.value
                if isinstance(base, ast.Name) and base.id in ("np", "numpy"):
                    out.append(_f(src, inner,
                                  f"host numpy (`np.{inner.attr}`) inside "
                                  f"traced body `{node.name}` — runs at "
                                  "trace time / forces a host sync; use "
                                  "device ops or hoist to the call site"))
            elif isinstance(inner, ast.Call):
                fn_name = _dotted(inner.func)
                if (fn_name in ("float", "int", "bool") and inner.args
                        and not isinstance(inner.args[0], ast.Constant)
                        and not (isinstance(inner.args[0], ast.Name)
                                 and inner.args[0].id in statics)):
                    out.append(_f(src, inner,
                                  f"host `{fn_name}()` on a value inside "
                                  f"traced body `{node.name}` — implicit "
                                  "device->host transfer (or a tracer "
                                  "error); keep it on device or mark the "
                                  "arg static"))
                elif (isinstance(inner.func, ast.Attribute)
                      and inner.func.attr == "item"):
                    out.append(_f(src, inner,
                                  f"`.item()` inside traced body "
                                  f"`{node.name}` — blocking device->host "
                                  "transfer"))
            elif isinstance(inner, (ast.If, ast.While)):
                names = {n.id for n in ast.walk(inner.test)
                         if isinstance(n, ast.Name)}
                hot = names & dyn
                if hot:
                    out.append(_f(src, inner,
                                  "Python control flow on traced value(s) "
                                  f"{sorted(hot)} inside `{node.name}` — "
                                  "recompiles per value (or tracer error); "
                                  "use a select (jnp.where / torch.where) "
                                  "or mark static"))
    return out


# -- 5. wire-layer -----------------------------------------------------------

# The blessed wire layer: the ONLY seats allowed to move bytes across the
# host<->device link.  Everything else must feed through them so wire
# accounting (StageRecorder h2d/d2h bytes) and the adaptive encoder can't
# be bypassed.  Wire v3 admits the entropy codec and the host prefilter
# as the only new seats (their frames/masks ARE wire format; the format
# modules are part of the plane they define).  The batched scoring plane
# (kernels/score.py) is the one kernel module with its own seat: its
# double-buffered chunk staging IS the topk scan's transfer path (the
# other kernels/ modules stay transfer-free and keep firing).
_WIRE_LAYER = ("tse1m_tpu_torch/cluster/encode.py",
               "tse1m_tpu_torch/cluster/pipeline.py",
               "tse1m_tpu_torch/cluster/entropy.py",
               "tse1m_tpu_torch/cluster/prefilter.py",
               "tse1m_tpu_torch/cluster/kernels/score.py")

# The rule's subject in torch idiom.  JAX moves bytes by ``device_put`` /
# ``device_get``; torch by an explicit copy: ``.to(<device>)``,
# ``.cuda()``, ``.cpu()``, and a tensor built from host data with
# ``device=`` (``torch.as_tensor``/``torch.tensor``).  A ``.to(...)`` is
# a copy across the link only when it names a device: a dtype cast
# (``.to(torch.int64)``) stays on its side.
_TORCH_FACTORIES = {"as_tensor", "tensor"}


def _names_device(node: ast.AST) -> bool:
    """The expression denotes a device: a 'cuda'/'cpu' string, a
    ``torch.device(...)`` call, or a name/attribute naming one (``dev``,
    ``device``, ``self.device``, ``x.device``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":", 1)[0] in ("cuda", "cpu")
    if isinstance(node, ast.Call):
        return _dotted(node.func).rsplit(".", 1)[-1] == "device"
    if isinstance(node, ast.BoolOp):  # `device or "cpu"`
        return any(_names_device(v) for v in node.values)
    if isinstance(node, ast.IfExp):
        return _names_device(node.body) or _names_device(node.orelse)
    leaf = _dotted(node).rsplit(".", 1)[-1].lower()
    return "dev" in leaf


def _torch_transfer(node: ast.Call) -> str | None:
    """How this call copies across the host<->device link, or None."""
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in ("cuda", "cpu"):
        return f".{func.attr}()"
    if func.attr == "to":
        if any(kw.arg == "device" for kw in node.keywords) or (
                node.args and _names_device(node.args[0])):
            return ".to(<device>)"
        return None
    if (func.attr in _TORCH_FACTORIES and _dotted(func.value) == "torch"
            and any(kw.arg == "device" for kw in node.keywords)):
        return f"torch.{func.attr}(..., device=)"
    return None


def wire_layer(src: FileSource) -> list[Finding]:
    if src.path in _WIRE_LAYER:
        return []
    out = []
    for node in _nodes(src):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name.rsplit(".", 1)[-1] in ("device_put", "device_get"):
                what = f"`{name}`"
            else:
                what = _torch_transfer(node)
                if what is None:
                    continue
                what = f"host<->device copy `{what}`"
            out.append(_f(src, node,
                          f"{what} outside the wire layer "
                          f"({', '.join(_WIRE_LAYER)}) — transfers "
                          "bypass wire accounting and the adaptive "
                          "encoder; route through the pipeline or "
                          "suppress with a reason"))
    return out


# -- 5b. scheme-parity -------------------------------------------------------

# The signature-scheme registry (cluster/schemes.py) is the ONLY dispatch
# point for signature computation: every consumer routes through it so
# host oracle, device reference, pallas variant, prefilter and serve-side
# MinHash can never disagree about which kernel family a run uses — the
# bit-parity contract the store/checkpoint policy tuple pins.  The raw
# kernels are implementation detail of these modules alone.  The port's
# counterpart of the JAX package's minhash_pallas.py is its kernel
# modules (cluster/kernels/): the CUDA wrappers and their plain versions.
_SCHEME_KERNEL_MODULES = (
    "tse1m_tpu_torch/cluster/schemes.py",
    "tse1m_tpu_torch/cluster/minhash.py",
    "tse1m_tpu_torch/cluster/host.py",
    "tse1m_tpu_torch/cluster/kernels/minhash.py",
    "tse1m_tpu_torch/cluster/kernels/cminhash.py",
    "tse1m_tpu_torch/cluster/kernels/score.py",
    "tse1m_tpu_torch/cluster/kernels/rans.py",
)
_SCHEME_KERNEL_CALLS = {
    "minhash_signatures", "cminhash_signatures",
    "host_signatures", "host_cminhash_signatures",
    "minhash_and_keys", "minhash_and_keys_pallas",
    "minhash_and_keys_packed", "cminhash_and_keys",
    # the port's kernel wrappers and plain versions
    "minhash_and_keys_plain", "minhash_and_keys_packed_plain",
    "cminhash_and_keys_plain", "cminhash_binmin", "cminhash_binmin_plain",
}


def scheme_parity(src: FileSource) -> list[Finding]:
    if src.path in _SCHEME_KERNEL_MODULES:
        return []
    out = []
    for node in _nodes(src):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            if name.rsplit(".", 1)[-1] in _SCHEME_KERNEL_CALLS:
                out.append(_f(src, node,
                              f"raw signature kernel call `{name}` "
                              "outside the scheme registry "
                              "(cluster/schemes.py) — a module that "
                              "hard-codes one kernel family silently "
                              "breaks bit-parity the moment a run "
                              "selects another scheme; dispatch through "
                              "schemes.scheme_sig_and_keys / "
                              "scheme_host_signatures / "
                              "scheme_signatures_traced, or baseline "
                              "with a reason"))
    return out


# -- 6. unlocked-shared-state ------------------------------------------------

def _is_lock_ctor(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and _dotted(node.func).rsplit(".", 1)[-1] in ("Lock", "RLock"))


def _self_attr_written(target: ast.AST) -> str | None:
    """'x' for targets self.x / self.x[...] — the shared attr mutated."""
    node = target
    while isinstance(node, (ast.Subscript, ast.Starred)):
        node = node.value
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name) and node.value.id == "self"):
        return node.attr
    return None


def _under_lock(node: ast.AST, parents: dict, lock_names: set) -> bool:
    while node is not None:
        node = parents.get(node)
        if isinstance(node, ast.With):
            for item in node.items:
                expr = item.context_expr
                attr = None
                if isinstance(expr, ast.Attribute):
                    attr = expr.attr
                elif isinstance(expr, ast.Name):
                    attr = expr.id
                elif isinstance(expr, ast.Call):
                    attr = _dotted(expr.func).rsplit(".", 1)[-1]
                if attr in lock_names:
                    return True
    return False


def unlocked_shared_state(src: FileSource) -> list[Finding]:
    parents = _parents(src.tree)
    out = []
    # Class-owned locks: any self-attribute mutation outside __init__ must
    # hold the lock (the class declared its state shared by creating one).
    for cls in _nodes(src):
        if not isinstance(cls, ast.ClassDef):
            continue
        locks = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    name = _self_attr_written(t)
                    if name:
                        locks.add(name)
        if not locks:
            continue
        for meth in cls.body:
            if not isinstance(meth, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if meth.name == "__init__":
                continue
            for node in ast.walk(meth):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    attr = _self_attr_written(t)
                    if attr and attr not in locks and not _under_lock(
                            node, parents, locks):
                        out.append(_f(src, node,
                                      f"`self.{attr}` mutated outside "
                                      f"`with self.{next(iter(locks))}` in "
                                      f"lock-owning class {cls.name} — "
                                      "racy with the producer thread"))
    # Module-level locks guarding globals.
    mod_locks = set()
    guarded: set = set()
    for node in src.tree.body:
        if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
            mod_locks |= {t.id for t in node.targets
                          if isinstance(t, ast.Name)}
    if mod_locks:
        for node in _nodes(src):
            if isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names = {t.id for t in targets if isinstance(t, ast.Name)}
                if names and _under_lock(node, parents, mod_locks):
                    guarded |= names
        for fn in _nodes(src):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            for node in ast.walk(fn):
                if isinstance(node, (ast.Assign, ast.AugAssign)):
                    targets = (node.targets if isinstance(node, ast.Assign)
                               else [node.target])
                    names = {t.id for t in targets
                             if isinstance(t, ast.Name)} & guarded
                    if names and not _under_lock(node, parents, mod_locks):
                        out.append(_f(src, node,
                                      f"global(s) {sorted(names)} mutated "
                                      "outside the module lock that guards "
                                      "them elsewhere"))
    return out


# -- 7. retry-bypass ---------------------------------------------------------

# The one HTTP seat: the transport's ``urlopen`` is the port's
# counterpart of the JAX transport's ``requests``.  Anywhere else either
# bypasses the retry engine.
_TRANSPORT = ("tse1m_tpu_torch/collect/transport.py",)
_DB_LAYER = ("tse1m_tpu_torch/db/connection.py",
             "tse1m_tpu_torch/db/pglib.py")
_HTTP_FNS = {"get", "post", "put", "head", "delete", "request", "Session"}


def retry_bypass(src: FileSource) -> list[Finding]:
    out = []
    for node in _nodes(src):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        if not isinstance(func, ast.Attribute):
            continue
        base = func.value
        if (src.path not in _TRANSPORT
                and isinstance(base, ast.Name) and base.id == "requests"
                and func.attr in _HTTP_FNS):
            out.append(_f(src, node,
                          f"direct `requests.{func.attr}` bypasses the "
                          "retry engine (utils/retry.py: backoff, "
                          "Retry-After, fault injection seats)"))
        if func.attr == "urlopen" and src.path not in _TRANSPORT:
            out.append(_f(src, node,
                          "`urlopen` bypasses the retry engine "
                          "(utils/retry.py)"))
        if (src.path not in _DB_LAYER
                and func.attr in ("execute", "executemany", "executescript")):
            is_cursor = (
                (isinstance(base, ast.Attribute) and base.attr == "cursor")
                or (isinstance(base, ast.Name)
                    and base.id in ("cursor", "cur")))
            if is_cursor:
                out.append(_f(src, node,
                              "raw cursor execute bypasses the DB retry/"
                              "reconnect engine — use DB.execute/query/"
                              "executeMany/run_transaction"))
    return out


# -- 8. nondeterminism -------------------------------------------------------

# Planes replayed under seeded fault plans / chaos tests: wall-clock and
# global-RNG reads there make a replay diverge from the recorded run.
_REPLAY_PLANES = ("tse1m_tpu_torch/resilience/", "tse1m_tpu_torch/db/",
                  "tse1m_tpu_torch/cluster/", "tse1m_tpu_torch/collect/")
_RANDOM_OK = {"Random", "SystemRandom", "getstate", "seed"}


def nondeterminism(src: FileSource) -> list[Finding]:
    if not src.path.startswith(_REPLAY_PLANES):
        return []
    out = []
    for node in _nodes(src):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func)
        if name in ("time.time", "time.time_ns"):
            out.append(_f(src, node,
                          f"wall clock `{name}()` in a chaos-replayed "
                          "plane — use time.monotonic for intervals, or "
                          "suppress if this is pure telemetry"))
        elif name in ("datetime.now", "datetime.utcnow", "date.today",
                      "datetime.datetime.now", "datetime.date.today"):
            out.append(_f(src, node,
                          f"`{name}()` in a chaos-replayed plane — pass "
                          "the date in from the caller so a replay sees "
                          "the recorded value"))
        elif (name.startswith("random.")
              and name.split(".", 1)[1] not in _RANDOM_OK
              and name.count(".") == 1):
            out.append(_f(src, node,
                          f"global-RNG `{name}()` in a chaos-replayed "
                          "plane — draw from a seeded random.Random "
                          "(resilience.faults idiom)"))
        elif (name.startswith("np.random.") or name.startswith(
                "numpy.random.")) and not name.endswith("default_rng"):
            out.append(_f(src, node,
                          f"legacy global `{name}()` — use a seeded "
                          "np.random.default_rng"))
    return out


# -- 9. watchdog-clock -------------------------------------------------------
#
# The supervision plane's invariant: every deadline, budget
# and stall decision reads time through resilience.watchdog.deadline_clock
# — one monotonic clock for the whole plane.  A raw clock call in deadline
# logic forks the time base: a wall-clock seat can jump with NTP/DST and
# fire (or starve) a watchdog, and even a second monotonic seat makes the
# plane's arithmetic unauditable.  Scope: the watchdog module itself plus
# any function whose name claims deadline/watchdog/stall — or
# heartbeat/lease — semantics.
#
# The lease extension adds a second check in the same scope: lease files
# (the pod's zombie fence, resilience/coordinator.py) must only ever be
# mutated through the atomic-write helper — a raw `open(..., "w")` in a
# lease/heartbeat function can leave a TORN lease that a reader
# misparses as absent and re-acquires, letting two writers hold one
# range.  Wall-clock time in a lease is the same class of bug (clocks
# are not comparable across hosts; fencing is by epoch only), and the
# clock half of this rule already covers it once the name markers do.

_WATCHDOG_PLANE = ("tse1m_tpu_torch/resilience/watchdog.py",
                   "tse1m_tpu_torch/resilience/coordinator.py",
                   "tse1m_tpu_torch/observability/latency.py",
                   # graftprof: the sampler timestamps stacks and the
                   # lock-wait recorder times acquires on the same axis
                   # the SLO math compares against.  A second clock
                   # makes profile/flight timelines unalignable.  (The
                   # JAX package's regress.py has no port counterpart
                   # yet.)
                   "tse1m_tpu_torch/observability/profiling.py")
# The serving plane lives in the clock discipline wholesale: its SLO
# decisions, latency histograms and admission windows all compare
# against watchdog budgets, so a raw clock anywhere in
# tse1m_tpu_torch/serve/ forks the time base the p99 is measured on.
_WATCHDOG_PLANE_PREFIXES = ("tse1m_tpu_torch/serve/",)
_CLOCK_CALLS = {"time.time", "time.time_ns", "time.monotonic",
                "time.monotonic_ns", "time.perf_counter",
                "time.perf_counter_ns", "time.clock_gettime"}
_WATCHDOG_NAME_MARKERS = ("deadline", "watchdog", "stall", "heartbeat",
                          "lease", "slo", "admission")
_LEASE_NAME_MARKERS = ("lease", "heartbeat")


def _open_write_mode(node: ast.Call) -> bool:
    """True when this is an `open(...)` call with a writable mode."""
    if _dotted(node.func) != "open":
        return False
    mode = None
    if len(node.args) >= 2:
        mode = node.args[1]
    for kw in node.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if not (isinstance(mode, ast.Constant) and isinstance(mode.value, str)):
        return False
    return any(c in mode.value for c in "wa+x")


def watchdog_clock(src: FileSource) -> list[Finding]:
    out = []
    parents = None
    in_plane = (src.path in _WATCHDOG_PLANE
                or src.path.startswith(_WATCHDOG_PLANE_PREFIXES))
    for node in _nodes(src):
        if not isinstance(node, ast.Call):
            continue
        is_clock = _dotted(node.func) in _CLOCK_CALLS
        is_write = _open_write_mode(node)
        if not (is_clock or is_write):
            continue
        if parents is None:
            parents = _parents(src.tree)
        fn = _enclosing_function(node, parents)
        fname = fn.name if fn is not None else ""
        if is_clock:
            if fname == "deadline_clock":
                continue  # THE helper — the plane's one blessed raw-clock seat
            if in_plane or any(m in fname.lower()
                               for m in _WATCHDOG_NAME_MARKERS):
                out.append(_f(src, node,
                              f"raw clock `{_dotted(node.func)}()` in the "
                              "watchdog plane — read time through "
                              "resilience.watchdog.deadline_clock so every "
                              "deadline shares one monotonic time base"))
        elif in_plane or any(m in fname.lower()
                             for m in _LEASE_NAME_MARKERS):
            out.append(_f(src, node,
                          "raw writable `open()` in lease/heartbeat code "
                          "— every lease or heartbeat mutation goes "
                          "through utils.atomic.atomic_write (see "
                          "resilience.coordinator.write_lease) so a "
                          "reader never sees a torn file"))
    return out


# -- 11. span-discipline (telemetry plane) -----------------------------------
#
# A span that never closes is worse than no span: it sits in the ring
# forever "in flight", its duration is garbage, and every span opened
# after it misparents under a context that should have popped.  The
# tracing API is shaped so this cannot happen — ``span()`` is a context
# manager — and this rule keeps call sites on that shape: ``span(...)``
# must be the context expression of a ``with`` (or handed to an
# ExitStack via ``enter_context``), and the manual escape hatch
# ``start_span(...)`` is legal only inside a function that guarantees
# ``.end()`` in a ``finally`` (the shape tracing.span itself uses).

_SPAN_CALL_NAMES = {"span", "start_span"}


def _fn_finalizes_end(fn: ast.AST) -> bool:
    """True when ``fn`` contains a Try whose finalbody calls ``.end()``."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Try) or not node.finalbody:
            continue
        for fin in node.finalbody:
            for sub in ast.walk(fin):
                if (isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Attribute)
                        and sub.func.attr == "end"):
                    return True
    return False


def span_discipline(src: FileSource) -> list[Finding]:
    out = []
    parents = None
    for node in _nodes(src):
        if not isinstance(node, ast.Call):
            continue
        name = _dotted(node.func).rsplit(".", 1)[-1]
        if name not in _SPAN_CALL_NAMES:
            continue
        if parents is None:
            parents = _parents(src.tree)
        if name == "span":
            par = parents.get(node)
            if isinstance(par, ast.withitem):
                continue
            if (isinstance(par, ast.Call)
                    and _dotted(par.func).rsplit(".", 1)[-1]
                    == "enter_context"):
                continue
            out.append(_f(src, node,
                          "`span(...)` outside a `with` — a span object "
                          "that escapes its context can stay open forever "
                          "(garbage duration, misparented children); use "
                          "`with span(...)` or "
                          "`stack.enter_context(span(...))`"))
        else:
            fn = _enclosing_function(node, parents)
            if fn is not None and _fn_finalizes_end(fn):
                continue
            out.append(_f(src, node,
                          "manual `start_span(...)` without a guaranteed "
                          "close — the enclosing function must call "
                          "`.end()` in a `finally` (or use `with "
                          "span(...)`, which cannot leak)"))
    return out


# -- 12. prof-overhead (profiling plane) --------------------------------------
#
# A profiler must never be able to hang or outlive the process it
# observes.  Two checkable shapes enforce that:
# (a) every thread the profiling plane spawns is constructed with a
# literal ``daemon=True`` — a non-daemon sampler blocks interpreter
# exit, so the observed process cannot die until its observer does, and
# a computed daemon flag is an unauditable maybe; (b) a plane file that
# spawns threads must reference the ``TSE1M_PROFILING`` kill switch
# somewhere, so an operator can amputate ALL sampling with one env var
# when the profiler itself becomes the problem.  Scope: the profiling
# module, plus any function or class whose name claims sampler/profiler
# semantics anywhere in the tree.

_PROF_PLANE = ("tse1m_tpu_torch/observability/profiling.py",)
_PROF_NAME_MARKERS = ("sampler", "profiler")
_PROF_KILL_SWITCH = "TSE1M_PROFILING"


def _enclosing_names(node: ast.AST, parents: dict) -> str:
    """Lowercased, space-joined names of every enclosing function and
    class — the scope a profiling-plane thread spawn is judged by."""
    names = []
    while node is not None:
        node = parents.get(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name.lower())
    return " ".join(names)


def prof_overhead(src: FileSource) -> list[Finding]:
    out = []
    in_plane = src.path in _PROF_PLANE
    parents = None
    plane_spawns = []
    for node in _nodes(src):
        if not isinstance(node, ast.Call):
            continue
        if _dotted(node.func).rsplit(".", 1)[-1] != "Thread":
            continue
        if parents is None:
            parents = _parents(src.tree)
        if not (in_plane or any(m in _enclosing_names(node, parents)
                                for m in _PROF_NAME_MARKERS)):
            continue
        plane_spawns.append(node)
        daemon_literal_true = any(
            kw.arg == "daemon" and isinstance(kw.value, ast.Constant)
            and kw.value.value is True
            for kw in node.keywords)
        if not daemon_literal_true:
            out.append(_f(src, node,
                          "profiling-plane `Thread(...)` without a literal "
                          "`daemon=True` — a non-daemon sampler thread "
                          "blocks interpreter exit, so the observed "
                          "process cannot die until its observer does"))
    if plane_spawns and _PROF_KILL_SWITCH not in src.text:
        out.append(_f(src, plane_spawns[0],
                      "profiling code spawns threads but never consults "
                      f"the `{_PROF_KILL_SWITCH}` kill switch — the "
                      "operator must be able to amputate all sampling "
                      "with one env var when the profiler itself becomes "
                      "the problem"))
    return out


# -- 13. serve-write-plane (sharded serve topology) ---------------------------
#
# The sharded serve plane's zero-lost-ack proof is only auditable if the
# write plane has exactly one kind of inhabitant: the shard writer
# daemon.  Two path-scoped checks hold that shape:
#
# (a) the ROUTER (serve/router.py) is STATELESS — it never constructs a
#     ``SignatureStore``, never calls a store mutator, and never opens a
#     file writable.  A router that spills state grows a second
#     durability seat the failover contract does not cover: an ingest is
#     acked iff the OWNING SHARD's manifest committed, and the router
#     must be killable/replaceable at any instant with no recovery step.
#     (The one file a router writes — its own port file — goes through
#     ``utils.atomic.atomic_write``, which this rule does not flag.)
#
# (b) a READ REPLICA (serve/replicate.py) joins the read plane only: its
#     store handle is constructed with a literal ``read_only=True``, it
#     never calls a store mutator, and the served view advances ONLY
#     through the adoption path — ``refresh()`` and the ``__init__``/
#     ``_rebuild`` seats it drives.  An adoption write anywhere else
#     (a ``_generation_adopted`` assignment or a ``_rebuild()`` call in
#     query/status/ad-hoc code) could publish a generation whose
#     manifest has not committed, turning a bounded-STALENESS replica
#     into a torn-VIEW one.  (Writable ``open()`` is legal here: the
#     shard streamer legitimately copies frames into the replica's
#     directory — CRC-verified, manifest committed last.)

_ROUTER_WRITE_PLANE = ("tse1m_tpu_torch/serve/router.py",)
_REPLICA_WRITE_PLANE = ("tse1m_tpu_torch/serve/replicate.py",)
_STORE_MUTATORS = {"append", "save_state", "journal_record", "commit_state",
                   "evict", "scrub", "quarantine", "compact"}
_ADOPTION_SEATS = {"__init__", "_rebuild", "refresh"}


def serve_write_plane(src: FileSource) -> list[Finding]:
    in_router = src.path in _ROUTER_WRITE_PLANE
    in_replica = src.path in _REPLICA_WRITE_PLANE
    if not (in_router or in_replica):
        return []
    out = []
    parents = _parents(src.tree)
    for node in _nodes(src):
        if isinstance(node, ast.Call):
            name = _dotted(node.func)
            leaf = name.rsplit(".", 1)[-1]
            recv = name.rsplit(".", 1)[0] if "." in name else ""
            if leaf == "SignatureStore":
                if in_router:
                    out.append(_f(src, node,
                                  "the router opens a store — the router is "
                                  "STATELESS: durability lives entirely at "
                                  "the shard writers (an ack is durable iff "
                                  "the owning shard's manifest committed), "
                                  "and a router-side store is a durability "
                                  "seat the failover proof does not cover"))
                elif not any(kw.arg == "read_only"
                             and isinstance(kw.value, ast.Constant)
                             and kw.value.value is True
                             for kw in node.keywords):
                    out.append(_f(src, node,
                                  "replica store handle without a literal "
                                  "`read_only=True` — a replica is excluded "
                                  "from the write plane BY CONSTRUCTION; a "
                                  "writable handle here could append to a "
                                  "range the lease plane dealt to a writer"))
            elif leaf in _STORE_MUTATORS and "store" in recv.lower():
                out.append(_f(src, node,
                              f"store mutator `{name}()` in the "
                              f"{'router' if in_router else 'replica'} — "
                              "only the range's single writer daemon may "
                              "mutate store state; the read plane serves "
                              "streamed committed generations only"))
            elif in_router and _open_write_mode(node):
                out.append(_f(src, node,
                              "writable `open()` in the router — the router "
                              "holds no durable state (its port file goes "
                              "through utils.atomic.atomic_write); spilled "
                              "router state breaks the kill-anytime "
                              "failover contract"))
            elif in_replica and leaf == "_rebuild":
                fn = _enclosing_function(node, parents)
                if fn is None or fn.name not in _ADOPTION_SEATS:
                    out.append(_f(src, node,
                                  "`_rebuild()` outside the adoption path — "
                                  "replica state advances only via "
                                  "refresh() (or __init__), after the "
                                  "streamed manifest committed; adopting "
                                  "elsewhere can publish a torn view"))
        elif in_replica and isinstance(node, (ast.Assign, ast.AugAssign,
                                              ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            if any((isinstance(t, ast.Attribute)
                    and t.attr == "_generation_adopted")
                   or (isinstance(t, ast.Name)
                       and t.id == "_generation_adopted")
                   for t in targets):
                fn = _enclosing_function(node, parents)
                if fn is None or fn.name not in _ADOPTION_SEATS:
                    out.append(_f(src, node,
                                  "`_generation_adopted` assigned outside "
                                  "refresh()/__init__/_rebuild — the "
                                  "adopted generation may only move when "
                                  "every file its manifest references is "
                                  "in place (the stream commits the "
                                  "manifest LAST)"))
    return out


RULES = {
    "broad-except": broad_except,
    "nonatomic-write": nonatomic_write,
    "sql-interp": sql_interp,
    "host-in-jit": host_in_jit,
    "wire-layer": wire_layer,
    "scheme-parity": scheme_parity,
    "unlocked-shared-state": unlocked_shared_state,
    "retry-bypass": retry_bypass,
    "nondeterminism": nondeterminism,
    "watchdog-clock": watchdog_clock,
    "span-discipline": span_discipline,
    "prof-overhead": prof_overhead,
    "serve-write-plane": serve_write_plane,
}

__all__ = ["RULES"]
