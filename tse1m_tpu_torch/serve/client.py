"""Client of the serving daemon: a port of ``tse1m_tpu/serve/client.py``.

One TCP connection, requests in order, reconnected lazily.  Timeouts come
from the per-request-class budgets (``request_budget_s``): the query class
is enforced here at the socket.  Connection failures go through the
retry engine (``utils/retry.py``), so a daemon mid-restart answers after
a reconnect.  It drives a server of either package.
"""

from __future__ import annotations

import os
import socket

import numpy as np

from ..observability.tracing import current_trace, span
from ..resilience.watchdog import request_budget_s
from ..utils.retry import RetryPolicy, retry_call
from .server import decode_vectors, encode_vectors, read_msg, write_msg

_CONNECT_TIMEOUT_S = 5.0


class ServeError(RuntimeError):
    """The daemon answered with a structured error."""

    def __init__(self, resp: dict) -> None:
        super().__init__(str(resp.get("error", "serve request failed")))
        self.resp = resp


class Backpressure(ServeError):
    """Ingest admission refused the batch; retry after ``retry_after_s``."""

    def __init__(self, resp: dict) -> None:
        super().__init__(resp)
        self.retry_after_s = float(resp.get("retry_after_s", 0.1))


class ServeClient:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 retry: RetryPolicy | None = None) -> None:
        self.host = host
        self.port = int(port)
        self._sock: socket.socket | None = None
        self._retry = retry or RetryPolicy(max_attempts=3, base_delay=0.05,
                                           max_delay=1.0)

    # -- transport -----------------------------------------------------------

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self.port),
                                         timeout=_CONNECT_TIMEOUT_S)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._sock = s
        return self._sock

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            finally:
                self._sock = None

    def __enter__(self) -> "ServeClient":
        return self

    def __exit__(self, et, ev, tb) -> None:
        self.close()

    def request(self, op: str, timeout_s: float | None = None,
                **payload) -> dict:
        """One request and its response on the pinned connection; a
        connection failure drops the socket and retries.  The exchange
        runs inside a ``client.<op>`` span whose context rides the
        envelope, so the daemon's spans land in the same trace."""
        with span(f"client.{op}") as sp:
            msg = {"op": op, **payload}
            ctx = current_trace()
            if ctx:
                msg["trace"] = ctx

            def attempt() -> dict:
                sock = self._connect()
                sock.settimeout(timeout_s or _CONNECT_TIMEOUT_S)
                try:
                    write_msg(sock, msg)
                    return read_msg(sock)
                except (ConnectionError, socket.timeout, OSError):
                    self.close()
                    raise

            resp = retry_call(attempt, policy=self._retry,
                              site=f"serve.client.{op}")
            sp.set_tag("ok", bool(resp.get("ok", False)))
        if not resp.get("ok", False):
            if resp.get("error") == "backpressure":
                raise Backpressure(resp)
            raise ServeError(resp)
        return resp

    # -- API -----------------------------------------------------------------

    def ping(self) -> dict:
        return self.request("ping", timeout_s=request_budget_s("status")
                            or None)

    def status(self) -> dict:
        return self.request("status", timeout_s=request_budget_s("status")
                            or None)

    def query(self, vectors: np.ndarray,
              timeout_s: float | None = None) -> dict:
        resp = self.request(
            "query",
            timeout_s=timeout_s or request_budget_s("query") or None,
            **encode_vectors(vectors))
        resp["labels"] = np.asarray(resp["labels"], np.int64)
        resp["known"] = np.asarray(resp["known"], bool)
        return resp

    def topk(self, vectors: np.ndarray, k: int = 10,
             mode: str = "candidates",
             timeout_s: float | None = None) -> dict:
        """The k nearest stored sessions per vector: ``scores`` and
        ``labels`` as [Q, k] int arrays (-1 padded), ``ids`` a [Q][k] list
        of digest hex strings ("" padded).  ``mode="scan"`` is budgeted as
        an ingest-class (bulk) request."""
        cls = "query" if mode == "candidates" else "ingest"
        resp = self.request(
            "topk",
            timeout_s=timeout_s or request_budget_s(cls) or None,
            k=int(k), mode=str(mode), **encode_vectors(vectors))
        resp["scores"] = np.asarray(resp["scores"], np.int64)
        resp["labels"] = np.asarray(resp["labels"], np.int64)
        return resp

    def ingest(self, vectors: np.ndarray,
               timeout_s: float | None = None,
               request_id: str | None = None) -> dict:
        """Durable ingest: the response means every row is committed to
        the store.  Raises :class:`Backpressure` under admission control.
        One request id is minted per call and rides every retry of it, so
        a retry after a lost answer replays the ack."""
        return self.request(
            "ingest",
            timeout_s=timeout_s or request_budget_s("ingest") or None,
            request_id=request_id or os.urandom(8).hex(),
            **encode_vectors(vectors))

    def metrics(self) -> dict:
        """``prometheus`` (text exposition) and the flat ``metrics_*``."""
        return self.request("metrics", timeout_s=request_budget_s("status")
                            or None)

    def trace(self, n: int | None = None) -> dict:
        """Recent completed spans from the daemon's ring."""
        payload = {"n": int(n)} if n else {}
        return self.request("trace", timeout_s=request_budget_s("status")
                            or None, **payload)

    def slowlog(self, n: int | None = None) -> dict:
        """Recent slow-request captures."""
        payload = {"n": int(n)} if n else {}
        return self.request("slowlog",
                            timeout_s=request_budget_s("status") or None,
                            **payload)

    def profile(self, dump: bool = False) -> dict:
        """Profiler summary; ``dump=True`` also writes profile_NNN.json
        daemon-side and returns its path."""
        payload = {"dump": True} if dump else {}
        return self.request("profile",
                            timeout_s=request_budget_s("status") or None,
                            **payload)

    def quiesce(self, timeout_s: float | None = None) -> dict:
        return self.request(
            "quiesce",
            timeout_s=timeout_s or request_budget_s("ingest") or None)

    def shutdown(self) -> dict:
        return self.request("shutdown", timeout_s=5.0)


__all__ = ["Backpressure", "ServeClient", "ServeError", "decode_vectors",
           "encode_vectors"]
