"""Host sampling profiler with span and lock-wait attribution, the
slow-request log, build-time histograms and the device trace: a copy of
``tse1m_tpu/observability/profiling.py``.

A daemon thread samples ``sys._current_frames()`` at ``TSE1M_PROF_HZ``
(default 97 Hz, prime, so it never phase-locks to a periodic workload)
and tags each sampled thread with its innermost open span
(``tracing.thread_span``).  Samples aggregate three ways: per-plane
self-time (the subpackage of ``tse1m_tpu_torch/`` that owns the leaf
frame), per-span self-time, and collapsed stacks (``a;b;c count``, the
flamegraph input), readable while the process runs and dumped atomically
into ``profile_NNN.json`` next to the flight files.

Lock-wait attribution rides the named locks of :mod:`..trace.sync`:
when enabled, every acquire of a named lock is timed on
``deadline_clock`` and lands in the metrics registry as
``lock_wait_seconds{site=<lock name>}``, under the JAX package's site
names.  The recorder never touches the registry directly: the acquire it
just timed may be the registry's own lock, still held by the caller, so
observations buffer in a GIL-atomic dict and :func:`flush_lock_waits`
folds them into the histograms from lock-free entry points.

:func:`capture_slow_request` freezes the evidence of a request that blew
its SLO budget (open-span chain, completed spans of the same trace, the
sampler's stacks over the request's window, the lock waits the request's
thread just suffered, the daemon's in-flight absorb state) into a bounded
ring, read by the TCP ``slowlog`` verb.

The port compiles nothing through XLA.  Its builds are the CUDA
extension's load (``cluster/kernels/_build.py``) and the g++ builds of
the native host layer (``native/__init__.py``); each reports to
``lint/runtime.py:record_build``, and :func:`install_compile_listener`
routes them into ``jit_compile_seconds{event=<build>}`` (the JAX
package's metric name).  :func:`device_trace` wraps a block in
``torch.profiler`` and writes a Chrome trace: CPU and CUDA activity where
a card is available, CPU activity only where none is.

Overhead discipline: the sampler is a ``daemon=True`` thread named
``tse1m-prof-sampler``, and the whole plane sits behind one kill switch:
``TSE1M_PROFILING=0`` (or :func:`set_profiling`) refuses to start
samplers, detaches the lock-wait recorder, makes a running sampler loop
exit and turns :func:`device_trace` into a no-op.

The sampler's and the slow-request log's state carry the trace plane's
seats (``shared_access``, ``profiling.slowlog.append``) with the JAX
package's names, so ``trace.traced()`` audits them.
"""

from __future__ import annotations

import collections
import contextlib
import json
import logging
import os
import sys
import threading

from ..resilience.watchdog import deadline_clock
from ..trace import sync as tsync
from ..trace.hooks import shared_access, trace_point
from ..utils.atomic import atomic_write
from . import tracing
from .flight import get_flight_dir
from .metrics import counter, get_registry, histogram

log = logging.getLogger("tse1m_tpu_torch.profiling")

_DEFAULT_HZ = 97.0
_STACK_DEPTH = 48
_STACK_CAP = 5000
_RECENT_SAMPLES = 4096
_DEFAULT_SLOWLOG = 64
_WAIT_FLOOR_MS = 0.5      # per-thread recent-wait floor (noise gate)
_WAIT_KEEP = 16           # per-thread recent waits kept for capture
_PROFILE_FMT = "profile_{:03d}.json"
_TRACE_FMT = "trace_{:03d}.json"
_SAMPLER_THREAD_NAME = "tse1m-prof-sampler"
_PACKAGE = "tse1m_tpu_torch/"


# -- kill switch --------------------------------------------------------------

_override: bool | None = None


def profiling_enabled() -> bool:
    """``TSE1M_PROFILING=0`` wins unless :func:`set_profiling` overrode
    it.  Checked on sampler start and inside the sampler loop, so setting
    the variable ends a live sampler within one period."""
    if _override is not None:
        return _override
    return os.environ.get("TSE1M_PROFILING", "1") != "0"


def set_profiling(on: bool | None) -> None:
    """Runtime override of the kill switch (``None`` restores the env
    var's verdict).  Turning profiling off stops and joins the sampler
    and detaches the lock-wait recorder: "off" means no sampling thread
    exists."""
    global _override
    _override = None if on is None else bool(on)
    if on is not None and not on:
        stop_sampler()
        tsync.set_lock_wait_recorder(None)


# -- sample attribution helpers ----------------------------------------------

def _plane_of(filename: str) -> str:
    """Map a frame's file to its plane: the subpackage under
    ``tse1m_tpu_torch/`` (``serve``, ``cluster``, ...), a top-level
    module's own name, or ``ext`` for everything outside the package.
    The same names as the JAX package's planes for the same files."""
    p = filename.replace("\\", "/")
    i = p.rfind(_PACKAGE)
    if i < 0:
        return "ext"
    rest = p[i + len(_PACKAGE):]
    j = rest.find("/")
    return rest[:j] if j >= 0 else rest.rsplit(".", 1)[0]


def _frame_label(code) -> str:
    base = os.path.basename(code.co_filename)
    return f"{base.rsplit('.', 1)[0]}:{code.co_name}"


# -- the sampler --------------------------------------------------------------

class Sampler:
    """Periodic whole-process stack sampler (one daemon thread).

    One named lock guards the state; the sampler thread is the only
    writer, and readers (``snapshot``, ``stacks_between``, the dump) see
    a consistent cut.  The thread never samples itself."""

    def __init__(self, hz: float | None = None) -> None:
        if hz is None:
            hz = float(os.environ.get("TSE1M_PROF_HZ", _DEFAULT_HZ))
        self.hz = max(1.0, float(hz))
        self._period = 1.0 / self.hz
        self._lock = tsync.Lock("Sampler")
        self._stop_evt = threading.Event()
        self._thread: threading.Thread | None = None
        self._samples = 0
        self._plane_self: dict = {}
        self._span_self: dict = {}
        self._stacks: dict = {}
        self._recent: collections.deque = collections.deque(
            maxlen=_RECENT_SAMPLES)
        self._started_at = deadline_clock()

    def start(self) -> bool:
        """Spawn the sampler thread; False (and no thread) when the kill
        switch is off."""
        if not profiling_enabled():
            return False
        with self._lock:
            shared_access(self, "thread", write=True)
            if self._thread is not None and self._thread.is_alive():
                return True
            self._stop_evt = threading.Event()
            th = threading.Thread(target=self._loop,
                                  name=_SAMPLER_THREAD_NAME, daemon=True)
            self._thread = th
            self._started_at = deadline_clock()
        th.start()
        return True

    def stop(self, timeout: float = 2.0) -> None:
        with self._lock:
            shared_access(self, "thread", write=True)
            th = self._thread
            evt = self._stop_evt
            self._thread = None
        evt.set()
        if th is not None and th.is_alive():
            th.join(timeout)

    def alive(self) -> bool:
        with self._lock:
            shared_access(self, "thread", write=False)
            th = self._thread
        return th is not None and th.is_alive()

    def _loop(self) -> None:
        evt = self._stop_evt
        while not evt.wait(self._period):
            if not profiling_enabled():
                break
            self._sample_once()

    def _sample_once(self) -> None:
        now = deadline_clock()
        me = threading.get_ident()
        frames = sys._current_frames()
        with self._lock:
            shared_access(self, "stacks", write=True)
            for tid, frame in frames.items():
                if tid == me:
                    continue
                leaf_plane = _plane_of(frame.f_code.co_filename)
                entry = tracing.thread_span(tid)
                span_name = entry[2] if entry else "(no-span)"
                parts = []
                f = frame
                depth = 0
                while f is not None and depth < _STACK_DEPTH:
                    parts.append(_frame_label(f.f_code))
                    f = f.f_back
                    depth += 1
                parts.reverse()
                collapsed = ";".join(parts)
                self._samples += 1
                self._plane_self[leaf_plane] = (
                    self._plane_self.get(leaf_plane, 0) + 1)
                self._span_self[span_name] = (
                    self._span_self.get(span_name, 0) + 1)
                if collapsed in self._stacks or len(
                        self._stacks) < _STACK_CAP:
                    self._stacks[collapsed] = (
                        self._stacks.get(collapsed, 0) + 1)
                else:
                    self._stacks["(other)"] = (
                        self._stacks.get("(other)", 0) + 1)
                self._recent.append((now, tid, span_name, collapsed))

    def snapshot(self) -> dict:
        """JSON-safe aggregate: total samples, per-plane and per-span
        self-time, and how long the sampler has run."""
        with self._lock:
            shared_access(self, "stacks", write=False)
            samples = self._samples
            planes = dict(self._plane_self)
            spans = dict(self._span_self)
            t0 = self._started_at
        return {
            "hz": self.hz,
            "samples": samples,
            "window_s": round(deadline_clock() - t0, 3),
            "plane_self": dict(sorted(planes.items(),
                                      key=lambda kv: -kv[1])),
            "span_self": dict(sorted(spans.items(),
                                     key=lambda kv: -kv[1])[:32]),
        }

    def collapsed(self, limit: int | None = None) -> list:
        """Flamegraph lines ``frame;frame;frame count``, hottest first."""
        with self._lock:
            shared_access(self, "stacks", write=False)
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
        if limit is not None:
            items = items[:int(limit)]
        return [f"{stack} {count}" for stack, count in items]

    def stacks_between(self, t0: float, t1: float,
                       tid: int | None = None) -> list:
        """Samples whose timestamp falls in ``[t0, t1]`` (deadline_clock
        axis), optionally of one thread."""
        with self._lock:
            shared_access(self, "stacks", write=False)
            recent = list(self._recent)
        out = []
        for t, sample_tid, span_name, collapsed in recent:
            if t < t0 or t > t1:
                continue
            if tid is not None and sample_tid != tid:
                continue
            out.append({"t_s": round(t, 4), "tid": sample_tid,
                        "span": span_name, "stack": collapsed})
        return out


_sampler: Sampler | None = None


def start_sampler(hz: float | None = None) -> Sampler | None:
    """Start (or return the running) process-wide sampler; None when the
    kill switch is off."""
    global _sampler
    if not profiling_enabled():
        return None
    s = _sampler
    if s is None:
        s = Sampler(hz)
        _sampler = s
    if not s.start():
        return None
    return s


def get_sampler() -> Sampler | None:
    return _sampler


def stop_sampler(timeout: float = 2.0) -> None:
    global _sampler
    s = _sampler
    _sampler = None
    if s is not None:
        s.stop(timeout)


# -- lock-wait attribution ----------------------------------------------------

_wait_state = threading.local()

# Pending wait samples a site, folded into the registry's
# ``lock_wait_seconds`` histograms by flush_lock_waits().  The recorder
# cannot observe into the registry itself: the acquire it just timed may
# be the registry's own lock, and observing would take that non-reentrant
# lock again on the same thread.  setdefault and append are GIL-atomic,
# so this buffer needs no lock of its own.
_pending_waits: dict = {}
_PENDING_CAP = 4096


def _record_lock_wait(lock, acquire, blocking: bool = True,
                      timeout: float = -1) -> bool:
    """The recorder installed into trace.sync: time the raw acquire, buffer
    it by lock site, and keep notable waits a thread for slow-request
    capture.  The ``busy`` flag keeps acquires made while recording out
    of the recorder."""
    st = _wait_state
    if getattr(st, "busy", False):
        return acquire(blocking, timeout)
    st.busy = True
    try:
        t0 = deadline_clock()
        ok = acquire(blocking, timeout)
        dt = deadline_clock() - t0
        pend = _pending_waits.setdefault(lock.name, [])
        if len(pend) < _PENDING_CAP:
            pend.append(dt)
        if dt * 1e3 >= _WAIT_FLOOR_MS:
            waits = getattr(st, "waits", None)
            if waits is None:
                waits = st.waits = []
            waits.append((lock.name, round(dt * 1e3, 3)))
            del waits[:-_WAIT_KEEP]
        return ok
    finally:
        st.busy = False


def flush_lock_waits() -> None:
    """Fold the pending wait samples into the registry's
    ``lock_wait_seconds`` histograms.  Callers hold no named lock.  A
    sample appended between the pop and a concurrent setdefault is
    dropped: profiling data, not accounting."""
    st = _wait_state
    st.busy = True  # the registry's own acquires below are not recorded
    try:
        for site in list(_pending_waits):
            samples = _pending_waits.pop(site, [])
            if samples:
                h = histogram("lock_wait_seconds", site=site)
                for dt in samples:
                    h.observe(dt)
    finally:
        st.busy = False


def enable_lock_wait(on: bool = True) -> bool:
    """Attach (or detach) the lock-wait recorder to the named locks.
    Refuses to attach when the kill switch is off."""
    if on and not profiling_enabled():
        return False
    tsync.set_lock_wait_recorder(_record_lock_wait if on else None)
    return bool(on)


def drain_lock_waits() -> list:
    """``(site, wait_ms)`` pairs the calling thread accumulated since its
    last drain."""
    waits = getattr(_wait_state, "waits", None)
    if not waits:
        return []
    out = list(waits)
    del waits[:]
    return out


def lock_wait_summary(top: int | None = None) -> list:
    """Per-site wait stats from the registry's ``lock_wait_seconds``
    histograms, worst p99 first: ``{site, count, p99_ms, max_ms}``."""
    flush_lock_waits()
    out = []
    for m in get_registry().collect():
        if m.name != "lock_wait_seconds" or not hasattr(m, "snapshot"):
            continue
        snap = m.snapshot()
        if not snap.get("count"):
            continue
        out.append({"site": m.labels.get("site", "?"),
                    "count": snap["count"],
                    "p99_ms": snap["p99_ms"],
                    "max_ms": snap["max_ms"]})
    out.sort(key=lambda r: (-r["p99_ms"], r["site"]))
    if top is not None:
        out = out[:int(top)]
    return out


# -- slow-request log ---------------------------------------------------------

class SlowRequestLog:
    """Bounded ring of SLO-violation captures (thread-safe, overwrite
    oldest), JSON-safe records."""

    def __init__(self, capacity: int | None = None) -> None:
        if capacity is None:
            capacity = int(os.environ.get("TSE1M_SLOWLOG_CAP",
                                          _DEFAULT_SLOWLOG))
        self.capacity = max(1, int(capacity))
        self._lock = tsync.Lock("SlowRequestLog")
        self._buf: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._total = 0

    def append(self, record: dict) -> None:
        trace_point("profiling.slowlog.append")
        with self._lock:
            shared_access(self, "buf", write=True)
            self._buf.append(record)
            self._total += 1

    def recent(self, n: int | None = None) -> list:
        with self._lock:
            shared_access(self, "buf", write=False)
            out = list(self._buf)
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
            self._buf.clear()
            self._total = 0


_slowlog = SlowRequestLog()


def slow_request_log() -> SlowRequestLog:
    return _slowlog


def recent_slow_requests(n: int | None = None) -> list:
    return _slowlog.recent(n)


def slow_requests_total() -> int:
    return _slowlog.total()


def capture_slow_request(kind: str, wall_s: float, budget_ms: float,
                         t0: float | None = None,
                         absorb: dict | None = None, **tags) -> dict:
    """Freeze the evidence for one budget-blowing request.  Call from the
    request's own thread right after it finishes: the open-span chain,
    the thread's lock waits, the sampler's window (``t0`` on the
    deadline_clock axis, default ``wall_s`` ago) and the in-flight absorb
    state are read relative to the caller."""
    now = deadline_clock()
    if t0 is None:
        t0 = now - wall_s
    trace = tracing.current_trace()
    record = {
        "kind": str(kind),
        "wall_ms": round(wall_s * 1e3, 3),
        "budget_ms": round(float(budget_ms), 3),
        "at_s": round(now, 3),
        "trace": trace,
        "span_chain": tracing.thread_span_chain(),
        "lock_waits_ms": drain_lock_waits(),
        "absorb": dict(absorb) if absorb else None,
    }
    sampler = _sampler
    record["stacks"] = (sampler.stacks_between(t0, now)[-8:]
                        if sampler is not None else [])
    if trace:
        record["trace_spans"] = [
            s for s in tracing.recent_spans(64)
            if s and s.get("trace") == trace["t"]][-8:]
    if tags:
        record["tags"] = {str(k): v for k, v in tags.items()}
    _slowlog.append(record)
    counter("slow_requests_total", kind=str(kind)).inc()
    return record


# -- build-time histograms and the device trace -------------------------------

_compile_listener_installed = False


def _on_build(event: str, seconds: float) -> None:
    histogram("jit_compile_seconds", event=event).observe(seconds)


def install_compile_listener() -> bool:
    """Idempotently route the port's builds (the CUDA extension's load, a
    native g++ build) into ``jit_compile_seconds{event=<build>}``; one
    process-lifetime listener, as the JAX package's.  Returns True."""
    global _compile_listener_installed
    if not _compile_listener_installed:
        from ..lint import runtime

        runtime.add_build_listener(_on_build)
        _compile_listener_installed = True
    return True


@contextlib.contextmanager
def device_trace(outdir: str | None):
    """``torch.profiler`` around a block, written on exit as a Chrome
    trace ``trace_NNN.json`` into ``outdir``; yields a dict whose
    ``path`` names that file after the block.  CPU and CUDA activity
    where a card is available (a profiler without CUDA activity there
    raises: a trace with no device side would hide the card), CPU
    activity only where none is.  A no-op when ``outdir`` is falsy or
    the kill switch is off."""
    out: dict = {"path": None}
    if not outdir or not profiling_enabled():
        yield out
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    on_card = torch.cuda.is_available()
    if on_card:
        if (torch.profiler.ProfilerActivity.CUDA
                not in torch.profiler.supported_activities()):
            raise RuntimeError("torch.profiler cannot trace the CUDA "
                               "device: a device trace needs CUPTI")
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(outdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield out
        if on_card:
            torch.cuda.synchronize()
    path = _next_numbered(outdir, _TRACE_FMT)
    tmp = f"{path}.{os.getpid()}.tmp"
    prof.export_chrome_trace(tmp)
    os.replace(tmp, path)
    out["path"] = path
    log.info("device trace written to %s", path)


# -- artifact + status --------------------------------------------------------

def _next_numbered(d: str, fmt: str) -> str:
    prefix, suffix = fmt.split("{")[0], ".json"
    n = 0
    for name in os.listdir(d):
        if name.startswith(prefix) and name.endswith(suffix):
            try:
                n = max(n, int(name[len(prefix):-len(suffix)]) + 1)
            except ValueError:
                continue
    return os.path.join(d, fmt.format(n))


def dump_profile(extra: dict | None = None,
                 d: str | None = None) -> str | None:
    """Write ``profile_NNN.json`` (atomic, numbered like the flight files)
    into ``d`` or the flight directory; returns the path, or None when no
    directory is configured."""
    if d is None:
        d = get_flight_dir()
    if not d:
        return None
    sampler = _sampler
    payload = {
        "pid": os.getpid(),
        "uptime_s": round(deadline_clock(), 3),
        "trace_id": tracing.pinned_trace(),
        "profiling_enabled": profiling_enabled(),
        "sampler": sampler.snapshot() if sampler is not None else None,
        "collapsed_stacks": (sampler.collapsed(200)
                             if sampler is not None else []),
        "lock_wait_sites": lock_wait_summary(),
        "slow_requests": _slowlog.recent(32),
        "slow_requests_total": _slowlog.total(),
    }
    if extra:
        payload["extra"] = dict(extra)
    os.makedirs(d, exist_ok=True)
    path = _next_numbered(d, _PROFILE_FMT)
    with atomic_write(path) as f:
        json.dump(payload, f, indent=2, default=str)
    log.info("profile dumped to %s", path)
    return path


def profile_status() -> dict:
    """The ``profile`` verb's answer: kill-switch state, the sampler's
    aggregate, the worst lock sites, the slow-request tally."""
    sampler = _sampler
    return {
        "profiling_enabled": profiling_enabled(),
        "sampler_alive": bool(sampler is not None and sampler.alive()),
        "sampler": sampler.snapshot() if sampler is not None else None,
        "lock_wait_top": lock_wait_summary(top=3),
        "slow_requests_total": _slowlog.total(),
    }


__all__ = ["Sampler", "SlowRequestLog", "capture_slow_request",
           "device_trace", "drain_lock_waits", "dump_profile",
           "enable_lock_wait", "flush_lock_waits", "get_sampler",
           "install_compile_listener", "lock_wait_summary",
           "profile_status", "profiling_enabled", "recent_slow_requests",
           "set_profiling", "slow_request_log", "slow_requests_total",
           "start_sampler", "stop_sampler"]
