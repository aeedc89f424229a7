"""The runtime sanitizer: a counterpart of ``tse1m_tpu/lint/runtime.py``,
with the JAX package's names.

Two checks around a warm hot loop:

- :class:`CompileCounter`: the port's builds inside the block.  The port
  compiles nothing through XLA; its builds are the CUDA extension's load
  (``cluster/kernels/_build.py``) and the native layer's g++ builds
  (``native/__init__.py``), each reported to :func:`record_build`, plus
  any ``torch._dynamo`` graph compiled in the process.  A warm
  steady-state run builds nothing, and ``sanitized(0)`` raises
  :class:`SanitizerViolation` when it does, as the JAX package's does for
  an XLA compile.
- :func:`no_implicit_transfers`: here the guard differs in kind.  JAX's
  guard makes implicit host-to-device staging raise.  Torch has no such
  staging: a host tensor mixed into a CUDA op raises already.  The torch
  form of the same hazard is a hidden host wait inside the hot loop.  So
  on a CUDA device the block runs under
  ``torch.cuda.set_sync_debug_mode("warn")`` (process-wide, so other
  threads' waits count too; the previous mode comes back on exit), and
  each synchronizing call is counted by its innermost ``tse1m_tpu_torch/``
  frame into the report's ``sanitizer_sync_sites`` (``{site: count}``,
  ``file.py:line``).  A wait raises nothing: the port's label fetches wait
  by design.  Without a card the guard yields False, as JAX's does where
  it is unavailable.

    with sanitized(compile_budget=0) as san:
        cluster_sessions(items, params)        # a warm run
    san.as_dict()["sanitizer_sync_sites"]

A sync is seen where torch turns its C++ warning into a Python warning:
an op called from Python, on any thread.  A wait inside the port's own
C++ binding would print to stderr instead; the binding launches kernels
and waits for none.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import warnings

_state_lock = threading.Lock()
_builds_total = 0
_build_listeners: list = []

_SYNC_MESSAGE = "called a synchronizing CUDA operation"
_PACKAGE = "tse1m_tpu_torch/"


class SanitizerViolation(AssertionError):
    """The hot loop broke a runtime invariant (the build budget)."""


def record_build(event: str, seconds: float) -> None:
    """One build finished (``event`` names it, e.g. the extension's or a
    native library's name): counted for :class:`CompileCounter` and handed
    to the listeners (``profiling.install_compile_listener``)."""
    global _builds_total
    with _state_lock:
        _builds_total += 1
        listeners = list(_build_listeners)
    for fn in listeners:
        fn(event, float(seconds))


def add_build_listener(fn) -> None:
    """``fn(event, seconds)`` on every later build (no removal, as
    jax.monitoring's listeners)."""
    with _state_lock:
        _build_listeners.append(fn)


def _dynamo_graphs() -> int:
    """Graphs ``torch._dynamo`` compiled in this process; 0 when it was
    never imported (then nothing was compiled through it)."""
    utils = sys.modules.get("torch._dynamo.utils")
    if utils is None:
        return 0
    return int(utils.counters["stats"]["unique_graphs"])


def compiles_so_far() -> int:
    """Process-lifetime build count: the port's builds and the dynamo
    graphs."""
    with _state_lock:
        builds = _builds_total
    return builds + _dynamo_graphs()


class CompileCounter:
    """Context manager: builds that happened inside the block."""

    def __init__(self) -> None:
        self.count: int | None = None
        self._start: int | None = None

    def __enter__(self) -> "CompileCounter":
        self._start = compiles_so_far()
        return self

    def __exit__(self, *exc) -> None:
        self.count = compiles_so_far() - self._start


def _sync_site() -> str:
    """``file.py:line`` of the innermost ``tse1m_tpu_torch/`` frame of
    the calling thread, else of its innermost frame outside the warnings
    machinery."""
    f = sys._getframe(2)
    outer = None
    while f is not None:
        name = f.f_code.co_filename.replace("\\", "/")
        i = name.rfind(_PACKAGE)
        if i >= 0:
            return f"{name[i + len(_PACKAGE):]}:{f.f_lineno}"
        if outer is None and not name.endswith("/warnings.py"):
            outer = f"{name.rsplit('/', 1)[-1]}:{f.f_lineno}"
        f = f.f_back
    return outer or "?"


@contextlib.contextmanager
def no_implicit_transfers():
    """Count the host's waits on the card inside the block by site (see
    the module docstring).  Yields the ``{site: count}`` dict where a card
    is available (the guard is on), False where none is."""
    import torch

    if not torch.cuda.is_available():
        yield False
        return
    sites: dict = {}
    lock = threading.Lock()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=_SYNC_MESSAGE)
        shown = warnings.showwarning

        def _show(message, category, filename, lineno, file=None,
                  line=None):
            if str(message).startswith(_SYNC_MESSAGE):
                site = _sync_site()
                with lock:
                    sites[site] = sites.get(site, 0) + 1
            else:
                shown(message, category, filename, lineno, file, line)

        warnings.showwarning = _show
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield sites
        finally:
            torch.cuda.set_sync_debug_mode(prev)


class SanitizerReport:
    """What the sanitized block observed: the JAX package's keys and the
    sync sites."""

    def __init__(self) -> None:
        self.transfer_guard_active = False
        self.compile_count: int | None = None
        self.compile_budget: int | None = None
        self.sync_sites: dict = {}

    def as_dict(self) -> dict:
        return {
            "sanitizer_transfer_guard": self.transfer_guard_active,
            "sanitizer_compile_count": self.compile_count,
            "sanitizer_compile_budget": self.compile_budget,
            "sanitizer_sync_sites": dict(sorted(self.sync_sites.items())),
        }


@contextlib.contextmanager
def sanitized(compile_budget: int | None = None):
    """Run the block under the sanitizer: host waits on the card counted
    by site, and on exit the build count checked against
    ``compile_budget`` (None = record only).  Yields a
    :class:`SanitizerReport`; raises :class:`SanitizerViolation` when the
    budget is exceeded."""
    report = SanitizerReport()
    report.compile_budget = compile_budget
    with no_implicit_transfers() as guard:
        report.transfer_guard_active = guard is not False
        if guard is not False:
            report.sync_sites = guard
        with CompileCounter() as counter:
            yield report
    report.compile_count = counter.count
    if compile_budget is not None and counter.count > compile_budget:
        raise SanitizerViolation(
            f"compile budget exceeded: {counter.count} builds in a "
            f"sanitized block budgeted for {compile_budget}: a warm hot "
            "loop should build nothing")


def self_check(device=None) -> dict:
    """Proof that the sanitizer works on this process's device: a tiny
    torch op on the resolved device under the guard, build budget 0.  On
    a card, a wait from the calling thread and one from a second thread
    must both be seen (``sanitizer_sync_seen``)."""
    import torch

    from ..device import resolve_device

    dev = resolve_device(device)
    x = torch.arange(8, dtype=torch.int32, device=dev)
    (x * 2 + 1).sum().item()  # first touch of the device outside
    with sanitized(compile_budget=0) as report:
        y = x * 2 + 1
        total = int(y.sum().item())
        box = []
        th = threading.Thread(target=lambda: box.append(
            int((x + 1).sum().item())), name="tse1m-sanitizer-check",
            daemon=True)
        th.start()
        th.join(30.0)
    out = report.as_dict()
    out["sanitizer_available"] = total == 64 and box == [36]
    if dev.type == "cuda":
        out["sanitizer_sync_seen"] = (
            sum(report.sync_sites.values()) >= 2)
    return out


__all__ = ["CompileCounter", "SanitizerReport", "SanitizerViolation",
           "add_build_listener", "compiles_so_far", "no_implicit_transfers",
           "record_build", "sanitized", "self_check"]
