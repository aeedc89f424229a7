"""Span-based tracing on the watchdog plane's clock: a copy of
``tse1m_tpu/observability/tracing.py``.

A trace is a tree of timed spans sharing one 16-hex trace id
(``deadline_clock``, so a span and the budget that would reap it share a
time axis).  Propagation is explicit and JSON-friendly:
``current_trace()`` returns ``{"t": trace_id, "s": span_id}``, which rides
the serve envelope or an ingest ticket, and ``continue_trace(ctx)`` adopts
it on the far side.  The envelope is the JAX package's, so a trace crosses
from either package's client to the other's server.  ``adopt_trace`` pins
a process-wide trace id.

Completed spans land in a bounded ring (:class:`SpanRing`): the flight
recorder's span source and the TCP ``trace`` verb's store.  Open spans
with ``with span(name): ...``; the manual ``start_span``/``Span.end`` pair
belongs in a ``try/finally``.  The ring carries the trace plane's seats
with the JAX package's names (``tracing.ring.append``, ``SpanRing.buf``).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import threading

from ..resilience.watchdog import deadline_clock
from ..trace import sync as tsync
from ..trace.hooks import shared_access, trace_point

_DEFAULT_RING = 512


def _hex_id() -> str:
    return os.urandom(8).hex()


class SpanRing:
    """Bounded ring of completed span records (thread-safe, overwrite
    oldest).  Records are JSON-safe dicts."""

    def __init__(self, capacity: int | None = None) -> None:
        if capacity is None:
            capacity = int(os.environ.get("TSE1M_TRACE_RING",
                                          _DEFAULT_RING))
        self.capacity = max(1, int(capacity))
        self._lock = tsync.Lock("SpanRing")
        self._buf: list = [None] * self.capacity
        self._next = 0
        self._total = 0

    def append(self, record: dict) -> None:
        trace_point("tracing.ring.append")
        with self._lock:
            shared_access(self, "buf", write=True)
            self._buf[self._next] = record
            self._next = (self._next + 1) % self.capacity
            self._total += 1

    def recent(self, n: int | None = None) -> list:
        """Last ``n`` completed spans, oldest first."""
        with self._lock:
            shared_access(self, "buf", write=False)
            if self._total < self.capacity:
                out = list(self._buf[:self._next])
            else:
                out = self._buf[self._next:] + self._buf[:self._next]
        if n is not None:
            out = out[-int(n):]
        return out

    def total(self) -> int:
        with self._lock:
            shared_access(self, "buf", write=False)
            return self._total

    def clear(self) -> None:
        with self._lock:
            shared_access(self, "buf", write=True)
            self._buf = [None] * self.capacity
            self._next = 0
            self._total = 0


_ring = SpanRing()


def recent_spans(n: int | None = None) -> list:
    return _ring.recent(n)


def spans_recorded() -> int:
    return _ring.total()


def clear_spans() -> None:
    return _ring.clear()


_enabled = os.environ.get("TSE1M_TRACING", "1") != "0"
_pinned: str | None = None


def set_tracing(on: bool) -> None:
    """Runtime gate: disabled, ``span()`` hands back a shared no-op and
    nothing touches the ring."""
    global _enabled
    _enabled = bool(on)


def adopt_trace(trace_id: str | None) -> None:
    """Pin a process-wide trace id: root spans opened with no active
    parent join this trace instead of minting their own."""
    global _pinned
    _pinned = str(trace_id) if trace_id else None


def pinned_trace() -> str | None:
    return _pinned


_current: contextvars.ContextVar = contextvars.ContextVar(
    "tse1m_torch_current_span", default=None)

# Thread id -> stack of (trace, span_id, name) of OPEN spans, keyed by
# thread because the contextvar above is invisible from other threads.
# Each thread only mutates its own entry (one dict store or pop under the
# GIL).
_thread_spans: dict = {}


def thread_span(tid: int):
    """Innermost open span of thread ``tid`` as ``(trace, span_id,
    name)``, or None: the sampler tags each sampled thread with it."""
    stack = _thread_spans.get(tid)
    return stack[-1] if stack else None


def thread_span_chain(tid: int | None = None) -> list:
    """Open-span names outermost first for ``tid`` (default: the calling
    thread)."""
    if tid is None:
        tid = threading.get_ident()
    stack = _thread_spans.get(tid)
    return [entry[2] for entry in stack] if stack else []


def current_trace() -> dict | None:
    """``{"t": trace_id, "s": span_id}`` of the innermost active span, or
    None outside any span."""
    cur = _current.get()
    if cur is None:
        return None
    return {"t": cur[0], "s": cur[1]}


class Span:
    """One in-flight span.  ``end()`` is idempotent; the record reaches
    the ring on the first call."""

    __slots__ = ("trace", "span_id", "parent", "name", "tags",
                 "_start", "_token", "_done", "_tid")

    def __init__(self, trace: str, span_id: str, parent: str,
                 name: str, tags: dict, token) -> None:
        self.trace = trace
        self.span_id = span_id
        self.parent = parent
        self.name = name
        self.tags = tags
        self._start = deadline_clock()
        self._token = token
        self._done = False
        self._tid = threading.get_ident()
        _thread_spans.setdefault(self._tid, []).append(
            (trace, span_id, name))

    def set_tag(self, key: str, value) -> None:
        self.tags[str(key)] = value

    def end(self, ok: bool = True) -> None:
        if self._done:
            return
        self._done = True
        dur = deadline_clock() - self._start
        if self._token is not None:
            with contextlib.suppress(ValueError):
                _current.reset(self._token)
        stack = _thread_spans.get(self._tid)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][1] == self.span_id:
                    del stack[i]
                    break
            if not stack:
                _thread_spans.pop(self._tid, None)
        _ring.append({"trace": self.trace, "span": self.span_id,
                      "parent": self.parent, "name": self.name,
                      "start_s": round(self._start, 6),
                      "dur_s": round(dur, 6), "ok": bool(ok),
                      "tags": dict(self.tags), "pid": os.getpid()})


class _NoopSpan:
    __slots__ = ()

    def set_tag(self, key: str, value) -> None:
        pass

    def end(self, ok: bool = True) -> None:
        pass


_NOOP = _NoopSpan()


def start_span(name: str, **tags):
    """Open a span manually; pair with ``end()`` in a ``finally``."""
    if not _enabled:
        return _NOOP
    cur = _current.get()
    if cur is not None:
        trace, parent = cur
    else:
        trace, parent = (_pinned or _hex_id()), ""
    span_id = _hex_id()
    token = _current.set((trace, span_id))
    return Span(trace, span_id, parent, str(name), dict(tags), token)


@contextlib.contextmanager
def span(name: str, **tags):
    """Open a span that closes on every exit path, marked failed when the
    body raised."""
    sp = start_span(name, **tags)
    ok = True
    try:
        yield sp
    except BaseException:
        ok = False
        raise
    finally:
        sp.end(ok=ok)


@contextlib.contextmanager
def continue_trace(ctx: dict | None):
    """Adopt a remote propagation context: spans opened inside become
    children of the remote span.  A falsy ctx is a no-op."""
    if not ctx or not ctx.get("t"):
        yield
        return
    token = _current.set((str(ctx["t"]), str(ctx.get("s") or "")))
    try:
        yield
    finally:
        with contextlib.suppress(ValueError):
            _current.reset(token)


__all__ = ["Span", "SpanRing", "adopt_trace", "clear_spans",
           "continue_trace", "current_trace", "pinned_trace",
           "recent_spans", "set_tracing", "span", "spans_recorded",
           "start_span", "thread_span", "thread_span_chain"]
