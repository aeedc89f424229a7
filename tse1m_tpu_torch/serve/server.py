"""JSON-over-TCP front end of the serving daemon: a port of
``tse1m_tpu/serve/server.py``, the same wire bytes.

A 4-byte big-endian length prefix, then one UTF-8 JSON object, each way;
stdlib only.  Vectors travel as JSON lists or as base64 raw little-endian
uint32 with an explicit shape (``vectors_b64``/``shape``).  A client of
either package drives a server of the other.

Request classes map to watchdog budgets (``request_budget_s``): ingest,
quiesce and status run under ``run_with_deadline`` (a wedged batch gives
the client a structured error instead of a hang; the batch's thread runs
on); queries are bounded at the client's socket and SLO-tracked here.
Errors become ``{"ok": false, "error": ...}`` responses.
"""

from __future__ import annotations

import base64
import json
import logging
import socket
import socketserver
import struct
import threading

import numpy as np

from ..observability import profiling
from ..observability.export import flat_metrics, prometheus_text
from ..observability.tracing import (continue_trace, recent_spans, span,
                                     spans_recorded)
from ..resilience.faults import reraise_if_fault
from ..resilience.watchdog import request_budget_s, run_with_deadline
from ..utils.atomic import atomic_write
from .daemon import IngestRejected, ServeDaemon

log = logging.getLogger("tse1m_tpu_torch.serve.server")

_LEN = struct.Struct(">I")
_MAX_MSG = 1 << 30


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def read_msg(sock: socket.socket) -> dict:
    (n,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if n > _MAX_MSG:
        raise ValueError(f"message of {n} bytes exceeds the 1 GiB bound")
    return json.loads(_recv_exact(sock, n).decode("utf-8"))


def write_msg(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj).encode("utf-8")
    sock.sendall(_LEN.pack(len(payload)) + payload)


def decode_vectors(msg: dict) -> np.ndarray:
    if "vectors_b64" in msg:
        k, s = (int(x) for x in msg["shape"])
        raw = base64.b64decode(msg["vectors_b64"])
        if len(raw) != k * s * 4:
            raise ValueError(f"vectors_b64 carries {len(raw)} bytes; "
                             f"shape {(k, s)} needs {k * s * 4}")
        return np.frombuffer(raw, dtype="<u4").reshape(k, s)
    return np.asarray(msg.get("vectors", []), dtype=np.uint32)


def encode_vectors(vectors: np.ndarray) -> dict:
    v = np.ascontiguousarray(vectors, dtype="<u4")
    return {"vectors_b64": base64.b64encode(v.tobytes()).decode("ascii"),
            "shape": list(v.shape)}


class _Handler(socketserver.BaseRequestHandler):
    def handle(self) -> None:
        server: ServeServer = self.server  # type: ignore[assignment]
        try:
            while True:
                try:
                    msg = read_msg(self.request)
                except (ConnectionError, struct.error):
                    return  # the client went away between requests
                resp = server.dispatch(msg)
                write_msg(self.request, resp)
                if msg.get("op") == "shutdown":
                    return
        except Exception as e:  # one connection fails, the server goes on
            reraise_if_fault(e)
            log.warning("serve: connection handler failed (%s: %s)",
                        type(e).__name__, e)


class ServeServer(socketserver.ThreadingTCPServer):
    """One daemon, many concurrent client connections (a thread a
    connection; requests on one connection are served in order)."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, daemon: ServeDaemon,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__((host, port), _Handler)
        self.daemon = daemon

    @property
    def port(self) -> int:
        return int(self.server_address[1])

    def dispatch(self, msg: dict) -> dict:
        """Route one request.  The envelope's ``trace`` key is adopted
        before the per-op span opens, so the daemon's work lands in the
        caller's trace; the trace id is echoed on the response."""
        op = str(msg.get("op", ""))
        ctx = msg.pop("trace", None)
        try:
            with continue_trace(ctx):
                with span(f"serve.{op}"):
                    resp = self._dispatch_op(op, msg)
        except IngestRejected as e:
            resp = {"ok": False, "error": "backpressure",
                    "retry_after_s": round(e.retry_after_s, 3),
                    "depth": e.depth}
        except Exception as e:  # a structured error answer
            reraise_if_fault(e)
            log.error("serve: %s request failed (%s: %s)", op,
                      type(e).__name__, e)
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if ctx and isinstance(ctx, dict) and ctx.get("t"):
            resp.setdefault("trace", str(ctx["t"]))
        return resp

    def _dispatch_op(self, op: str, msg: dict) -> dict:
        if op == "ping":
            return {"ok": True, "op": "ping",
                    "generation": self.daemon._index.generation,
                    "rows": self.daemon._index.n_rows}
        if op == "status":
            return {"ok": True, **self._guarded(
                "status", self.daemon.status)}
        if op == "query":
            vectors = decode_vectors(msg)
            res = self.daemon.query(vectors)
            return {"ok": True,
                    "labels": res["labels"].astype(int).tolist(),
                    "known": res["known"].astype(bool).tolist(),
                    "generation": int(res["generation"])}
        if op == "topk":
            vectors = decode_vectors(msg)
            return self.daemon.topk(vectors,
                                    k=int(msg.get("k", 10)),
                                    mode=str(msg.get("mode",
                                                     "candidates")))
        if op == "ingest":
            vectors = decode_vectors(msg)
            rid = msg.get("request_id")
            return self._guarded(
                "ingest", lambda: self.daemon.ingest(
                    vectors, timeout=request_budget_s("ingest") or None,
                    request_id=str(rid) if rid else None))
        if op == "quiesce":
            return self._guarded(
                "ingest", lambda: self.daemon.quiesce(
                    timeout=request_budget_s("ingest") or None))
        if op == "metrics":
            return {"ok": True, "prometheus": prometheus_text(),
                    "metrics": flat_metrics()}
        if op == "trace":
            n = msg.get("n")
            return {"ok": True,
                    "spans": recent_spans(int(n) if n else None),
                    "spans_recorded": spans_recorded()}
        if op == "slowlog":
            n = msg.get("n")
            return {"ok": True,
                    "slow_requests": profiling.recent_slow_requests(
                        int(n) if n else None),
                    "slow_requests_total":
                        profiling.slow_requests_total()}
        if op == "profile":
            # ``dump: true`` also writes profile_NNN.json next to the
            # flight files.
            resp = {"ok": True, **profiling.profile_status()}
            if msg.get("dump"):
                resp["profile_path"] = profiling.dump_profile()
            return resp
        if op == "shutdown":
            threading.Thread(target=self.shutdown,
                             daemon=True).start()
            return {"ok": True, "op": "shutdown"}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def _guarded(self, request_class: str, fn):
        """A control-plane request under its class's watchdog budget."""
        return run_with_deadline(fn, request_budget_s(request_class),
                                 f"serve.{request_class}")

    def serve_until_shutdown(self, port_file: str | None = None) -> None:
        if port_file:
            with atomic_write(port_file) as f:
                f.write(str(self.port))
        log.info("serve: listening on %s:%d (store rows=%d gen=%d)",
                 self.server_address[0], self.port,
                 self.daemon._index.n_rows,
                 self.daemon._index.generation)
        self.serve_forever(poll_interval=0.1)


__all__ = ["ServeServer", "decode_vectors", "encode_vectors", "read_msg",
           "write_msg"]
