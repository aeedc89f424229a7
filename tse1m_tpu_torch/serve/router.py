"""Stateless fan-out router of the sharded serving plane: a port of
``tse1m_tpu/serve/router.py:75-519``.

One router fronts N shard daemons, each a single-writer ``ServeDaemon``
over the ``range_NNNN/`` slice of a sharded serve root that it holds
under an epoch lease (``resilience.coordinator.RangeLeaseGuard``).  The
router speaks the single daemon's JSON-over-TCP verbs, so ``ServeClient``
and ``serve-client`` work unchanged against either topology:

- **ingest** splits a batch by digest range (``digest_range_ids``),
  forwards each slice to its owner in range order under a per-shard
  request id, and acks only after every owner's manifest commit.  When a
  shard writer dies mid-window the forward retries against the
  replacement (which claimed the next epoch) with the same request id: a
  slice that committed replays its ack from the shard's journal (zero
  rows absorbed twice), a slice that did not ingests afresh (zero acked
  rows lost).
- **query** broadcasts to every shard (a near-duplicate can live in any
  range; only exact duplicates co-shard by digest) and min-merges: the
  membership comes from the digest's owner, the label is the smallest
  routed global id any shard proposes.  **topk** broadcasts and merges
  the shards' answers in their wire order (-count, digest hex).
- The router holds no durable state: its one soft state is the per-shard
  local-row -> global-row map, rebuilt from the acks' ``rows`` fields.

The router holds no device, never opens a store directory and never
writes a store file; of the store module it uses only
``digest_range_ids`` and ``row_digests``.  The read verbs (query, topk,
ping, status) fan out to the shards in parallel, one thread a shard, and
ingest forwards one slice at a time in range order, as the JAX package's
router does.  A lock around each TCP exchange keeps two concurrent
requests from interleaving their frames on a shard's one connection.
Left out against the JAX package: the schedule explorer's trace points
and lock recorder (ROADMAP.md Queue 1, "Serve plane").
"""

from __future__ import annotations

import logging
import socket
import socketserver
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..cluster.store import digest_range_ids, row_digests
from ..observability import metrics as obs_metrics
from ..observability.export import flat_metrics, prometheus_text
from ..observability.latency import LatencyRecorder
from ..observability.tracing import (continue_trace, recent_spans, span,
                                     spans_recorded)
from ..resilience.coordinator import heartbeat_timeout_s
from ..resilience.faults import fault_point
from ..resilience.watchdog import request_budget_s
from ..utils.atomic import atomic_write
from ..utils.retry import RetryPolicy, retry_call
from .daemon import IngestRejected
from .server import (_Handler, decode_vectors, encode_vectors, read_msg,
                     write_msg)

log = logging.getLogger("tse1m_tpu_torch.serve.router")

_CONNECT_TIMEOUT_S = 5.0

# Label space of cluster representatives the router never acked (rows put
# into a shard store outside this router): each (shard, local row) gets
# one deterministic global label below -1, never a routed global row id.
_FOREIGN_BASE = -2
_NONE = np.iinfo(np.int64).max


def failover_policy() -> RetryPolicy:
    """How a forward retries a shard that does not answer: until a
    deadline of three heartbeat timeouts (30 s at the default), the
    window a dead writer's replacement has to start, claim the next epoch
    and rebind behind the same port file.  One timeout lets a supervisor
    see the writer lost by its heartbeat; two cover the replacement's
    start, which took 13.0-15.5 s from the kill to its first ack on an
    H100 80GB HBM3 at 700.00 W (``chip_smoke.py`` phase 3e).  The JAX
    package's router gives up after 8 attempts, about 4.5 s of backoff.
    The attempt cap, one per ``base_delay`` of the window, leaves the
    deadline to end the retries."""
    window = 3.0 * heartbeat_timeout_s()
    return RetryPolicy(max_attempts=max(8, int(window / 0.1)),
                       base_delay=0.1, max_delay=2.0, deadline=window)


class TcpTransport:
    """One pinned connection to one shard daemon, reconnected lazily; the
    port file is read again on every reconnect, so a replacement writer
    under a fresh port publishes itself by rewriting the same file."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 port_file: str | None = None) -> None:
        self.host = host
        self.port = int(port)
        self.port_file = port_file
        self._sock: socket.socket | None = None
        self._lock = threading.Lock()

    def _resolve_port(self) -> int:
        if self.port_file:
            with open(self.port_file, encoding="utf-8") as f:
                return int(f.read().strip())
        return self.port

    def _connect(self) -> socket.socket:
        if self._sock is None:
            s = socket.create_connection((self.host, self._resolve_port()),
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

    def __call__(self, msg: dict, timeout_s: float | None = None) -> dict:
        with self._lock:
            sock = self._connect()
            sock.settimeout(timeout_s or _CONNECT_TIMEOUT_S)
            try:
                write_msg(sock, msg)
                return read_msg(sock)
            except (ConnectionError, socket.timeout, OSError):
                self.close()
                raise


class LocalTransport:
    """In-process transport over a ``ServeDaemon`` or ``ServeReplica``:
    the same message dicts the TCP servers dispatch, without sockets."""

    def __init__(self, daemon) -> None:
        self.daemon = daemon

    def __call__(self, msg: dict, timeout_s: float | None = None) -> dict:
        op = str(msg.get("op", ""))
        if op == "ingest":
            rid = msg.get("request_id")
            return self.daemon.ingest(decode_vectors(msg),
                                      request_id=str(rid) if rid else None)
        if op == "query":
            res = self.daemon.query(decode_vectors(msg))
            return {"ok": True,
                    "labels": res["labels"].astype(int).tolist(),
                    "known": res["known"].astype(bool).tolist(),
                    "generation": int(res["generation"])}
        if op == "topk":
            return self.daemon.topk(
                decode_vectors(msg), k=int(msg.get("k", 10)),
                mode=str(msg.get("mode", "candidates")))
        if op == "ping":
            idx = self.daemon._index
            return {"ok": True, "op": "ping",
                    "generation": idx.generation, "rows": idx.n_rows}
        if op == "status":
            return {"ok": True, **self.daemon.status()}
        if op == "quiesce":
            return self.daemon.quiesce()
        return {"ok": False, "error": f"unknown op {op!r}"}


class ShardRouter:
    """Fan ``query``/``ingest``/``topk`` over the shard owners and merge
    the answers.  Thread-safe: the per-shard row map and the request
    counter live under one lock; forwards happen outside it."""

    def __init__(self, transports: dict[int, object],
                 monitor=None,
                 retry: RetryPolicy | None = None) -> None:
        if not transports:
            raise ValueError("router needs at least one shard transport")
        self.transports = dict(transports)
        self.n_shards = len(self.transports)
        if sorted(self.transports) != list(range(self.n_shards)):
            raise ValueError(
                f"shard transports must cover ranges 0..{self.n_shards - 1} "
                f"densely, got {sorted(self.transports)}")
        # Optional coordinator.PeerMonitor over the shard daemons'
        # heartbeat files (peers = range ids): ``status`` names the lost
        # writers without waiting for a forward to time out.
        self.monitor = monitor
        self.retry = retry or failover_policy()
        self._lock = threading.Lock()
        # shard id -> {local index row -> global row id}; global ids go in
        # submission order, so the smallest global id is the first ingest.
        self._gmap: dict[int, dict[int, int]] = {
            sid: {} for sid in self.transports}
        self._next_row = 0
        self._seq = 0
        self._replayed = 0
        self.lat_forward = LatencyRecorder("serve_router_forward")
        self._pool = ThreadPoolExecutor(max_workers=self.n_shards,
                                        thread_name_prefix="tse1m-router")

    # -- forwarding -----------------------------------------------------------

    def _forward(self, sid: int, msg: dict,
                 timeout_s: float | None = None) -> dict:
        """One shard exchange under the retry engine: a connection failure
        (a dying or restarting writer) re-sends the same message, the same
        request id, so a committed slice is answered by the replacement's
        journal replay, not a second absorb."""

        def attempt() -> dict:
            with span("serve.router.forward", shard=int(sid),
                      op=str(msg.get("op", ""))):
                with self.lat_forward.time():
                    resp = self.transports[sid](msg, timeout_s=timeout_s)
            # The lost-ack window: the shard committed and answered, this
            # process has not passed the answer up yet.
            fault_point("serve.router.forward")
            return resp

        resp = retry_call(attempt, policy=self.retry,
                          site="serve.router.forward")
        if not resp.get("ok", False):
            if resp.get("error") == "backpressure":
                raise IngestRejected(int(resp.get("depth", 0)),
                                     float(resp.get("retry_after_s", 0.1)))
            raise RuntimeError(
                f"shard {sid} refused {msg.get('op')}: {resp.get('error')}")
        return resp

    def _broadcast(self, msg: dict,
                   timeout_s: float | None = None) -> dict[int, dict]:
        """The same message to every shard at once; answers by shard."""
        futures = {sid: self._pool.submit(self._forward, sid, msg, timeout_s)
                   for sid in sorted(self.transports)}
        return {sid: f.result() for sid, f in futures.items()}

    def _map_label(self, sid: int, local: int) -> int:
        """Shard-local label (an index row id) -> global label, under the
        caller's lock; unrouted representatives get a stable synthetic id
        below -1."""
        g = self._gmap[sid].get(int(local))
        if g is not None:
            return g
        return _FOREIGN_BASE - (int(local) * self.n_shards + int(sid))

    def _map_labels(self, sid: int, local: np.ndarray) -> np.ndarray:
        """``_map_label`` over an array of non-negative local labels."""
        uniq, inv = np.unique(local, return_inverse=True)
        mapped = np.array([self._map_label(sid, int(u)) for u in uniq],
                          np.int64)
        return mapped[inv.reshape(-1)]

    # -- verbs ----------------------------------------------------------------

    def ingest(self, vectors: np.ndarray, timeout: float | None = None,
               request_id: str | None = None) -> dict:
        vectors = np.ascontiguousarray(vectors, np.uint32)
        k = int(vectors.shape[0])
        rid_in = str(request_id) if request_id else None
        with self._lock:
            self._seq += 1
            rid = rid_in or f"r{self._seq:08d}"
            g0 = self._next_row
            self._next_row += k
        if k == 0:
            return {"ok": True, "acked": 0, "novel": 0, "generation": 0,
                    "labels": [], "rows": [], "shards": {}}
        rows_sid = digest_range_ids(row_digests(vectors), self.n_shards)
        per_shard = {int(sid): np.flatnonzero(rows_sid == sid)
                     for sid in np.unique(rows_sid)}
        acked = novel = 0
        replayed = False
        gens: dict[int, int] = {}
        glabels = np.empty(k, np.int64)
        # One slice outstanding a shard, forwarded in range order.
        resps: dict[int, dict] = {}
        for sid in sorted(per_shard):
            sel = per_shard[sid]
            msg = {"op": "ingest", "request_id": f"{rid}/{sid}",
                   **encode_vectors(vectors[sel])}
            resps[sid] = self._forward(sid, msg, timeout_s=timeout)
        with self._lock:
            for sid in sorted(per_shard):
                sel = per_shard[sid]
                resp = resps[sid]
                acked += int(resp.get("acked", 0))
                novel += int(resp.get("novel", 0))
                gens[sid] = int(resp.get("generation", 0))
                if resp.get("replayed"):
                    replayed = True
                    self._replayed += 1
                gmap = self._gmap[sid]
                # Map this slice's rows first (the smallest global id
                # wins), then translate its labels: a cluster's
                # representative may be in the slice itself.
                for i, local in zip(sel.tolist(), resp["rows"]):
                    # A replayed ack can carry -1 for a row whose store
                    # copy was since evicted: never map a sentinel.
                    if int(local) >= 0:
                        gmap.setdefault(int(local), g0 + int(i))
                for i, local in zip(sel.tolist(), resp["labels"]):
                    glabels[i] = (self._map_label(sid, int(local))
                                  if int(local) >= 0 else -1)
        out = {"ok": True, "acked": acked, "novel": novel,
               "generation": max(gens.values()),
               "labels": glabels.tolist(),
               "rows": (g0 + np.arange(k, dtype=np.int64)).tolist(),
               "shards": {str(s): g for s, g in sorted(gens.items())}}
        if replayed:
            out["replayed"] = True
        return out

    def query(self, vectors: np.ndarray) -> dict:
        """Broadcast membership: ``known`` from the digest's owner, the
        label the smallest routed global id any shard proposes (else the
        smallest synthetic foreign id, else -1)."""
        vectors = np.ascontiguousarray(vectors, np.uint32)
        n = int(vectors.shape[0])
        owner = digest_range_ids(row_digests(vectors), self.n_shards)
        resps = self._broadcast({"op": "query", **encode_vectors(vectors)})
        gens = {sid: int(r.get("generation", 0))
                for sid, r in resps.items()}
        known = np.zeros(n, bool)
        best = np.full(n, _NONE, np.int64)
        foreign = np.full(n, _NONE, np.int64)
        with self._lock:
            for sid, resp in resps.items():
                mine = owner == sid
                known[mine] = np.asarray(resp["known"], bool)[mine]
                local = np.asarray(resp["labels"], np.int64).reshape(n)
                sel = np.flatnonzero(local >= 0)
                if sel.size == 0:
                    continue
                g = self._map_labels(sid, local[sel])
                routed = g >= 0
                best[sel[routed]] = np.minimum(best[sel[routed]], g[routed])
                foreign[sel[~routed]] = np.minimum(foreign[sel[~routed]],
                                                   g[~routed])
        out = np.where(best != _NONE, best,
                       np.where(foreign != _NONE, foreign, -1))
        return {"labels": out.astype(np.int64), "known": known,
                "generation": max(gens.values()),
                "shard_generations": gens}

    def topk(self, vectors: np.ndarray, k: int = 10,
             mode: str = "candidates",
             timeout: float | None = None) -> dict:
        """Broadcast top-k: every shard ranks its own rows, the router
        merges the answers under the shards' wire order (-count, digest
        hex) and keeps the global k.  A digest lives in exactly one range,
        so in scan mode the merged list is what one unsharded daemon over
        the union of the rows answers.  ``timeout`` bounds each shard's
        answer (the server gives a scan the ingest class's budget)."""
        vectors = np.ascontiguousarray(vectors, np.uint32)
        n = int(vectors.shape[0])
        k = int(k)
        resps = self._broadcast({"op": "topk", "k": k, "mode": str(mode),
                                 **encode_vectors(vectors)}, timeout)
        gens = {sid: int(r.get("generation", 0))
                for sid, r in resps.items()}
        out_s = np.full((n, k), -1, np.int64)
        out_l = np.full((n, k), -1, np.int64)
        out_i = [[""] * k for _ in range(n)]
        with self._lock:
            for i in range(n):
                cand = []
                for sid, resp in resps.items():
                    sc = resp["scores"][i]
                    ids = resp["ids"][i]
                    lb = resp["labels"][i]
                    for j in range(len(sc)):
                        if int(sc[j]) < 0:
                            continue
                        lab = int(lb[j])
                        cand.append((int(sc[j]), str(ids[j]),
                                     self._map_label(sid, lab)
                                     if lab >= 0 else -1))
                cand.sort(key=lambda t: (-t[0], t[1]))
                for t, (sc, hx, g) in enumerate(cand[:k]):
                    out_s[i, t] = sc
                    out_i[i][t] = hx
                    out_l[i, t] = g
        return {"ok": True, "k": k, "mode": str(mode),
                "generation": max(gens.values()),
                "shard_generations": gens,
                "scores": out_s.tolist(), "ids": out_i,
                "labels": out_l.tolist()}

    def ping(self) -> dict:
        resps = self._broadcast({"op": "ping"})
        return {"ok": True, "op": "ping",
                "rows": sum(int(r.get("rows", 0)) for r in resps.values()),
                "generation": max(int(r.get("generation", 0))
                                  for r in resps.values()),
                "shards": self.n_shards}

    def quiesce(self, timeout: float | None = None) -> dict:
        resps = {sid: self._forward(sid, {"op": "quiesce"},
                                    timeout_s=timeout)
                 for sid in sorted(self.transports)}
        return {"ok": True,
                "generation": max(int(r.get("generation", 0))
                                  for r in resps.values()),
                "shards": {str(s): int(r.get("generation", 0))
                           for s, r in sorted(resps.items())}}

    def _shard_status(self, sid: int) -> dict:
        try:
            return self._forward(sid, {"op": "status"})
        except (ConnectionError, OSError, RuntimeError) as e:
            return {"ok": False, "error": f"{type(e).__name__}: {e}"}

    def status(self) -> dict:
        futures = {sid: self._pool.submit(self._shard_status, sid)
                   for sid in sorted(self.transports)}
        shard_status = {str(sid): f.result() for sid, f in futures.items()}
        lost = self.monitor.poll() if self.monitor is not None else []
        with self._lock:
            mapped = sum(len(m) for m in self._gmap.values())
            stats = {"router_rows": self._next_row,
                     "router_requests": self._seq,
                     "router_replayed_acks": self._replayed,
                     "router_mapped_rows": mapped}
        obs_metrics.gauge("serve_router_rows").set(stats["router_rows"])
        return {"ok": all(s.get("ok", False)
                          for s in shard_status.values()),
                "topology": "sharded",
                "shards": self.n_shards,
                "shards_lost": [int(p) for p in lost],
                **stats,
                **self.lat_forward.summary(),
                "shard_status": shard_status}

    def close(self) -> None:
        """Stop the fan-out threads and drop the TCP connections."""
        self._pool.shutdown(wait=True)
        for t in self.transports.values():
            if isinstance(t, TcpTransport):
                t.close()


class RouterServer(socketserver.ThreadingTCPServer):
    """The router's JSON-over-TCP face: the framing, verbs and error
    envelope of ``ServeServer``, so a ``ServeClient`` cannot tell the two
    topologies apart."""

    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, router: ShardRouter,
                 host: str = "127.0.0.1", port: int = 0) -> None:
        super().__init__((host, port), _Handler)
        self.router = router
        self._shutdown_requested = threading.Event()

    @property
    def port(self) -> int:
        return int(self.server_address[1])

    def dispatch(self, msg: dict) -> dict:
        op = str(msg.get("op", ""))
        ctx = msg.pop("trace", None)
        try:
            with continue_trace(ctx):
                with span(f"serve.router.{op}"):
                    resp = self._dispatch_op(op, msg)
        except IngestRejected as e:
            resp = {"ok": False, "error": "backpressure",
                    "retry_after_s": round(e.retry_after_s, 3),
                    "depth": e.depth}
        except Exception as e:  # noqa: BLE001 - a structured error answer
            log.error("router: %s request failed (%s: %s)", op,
                      type(e).__name__, e)
            resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if ctx and isinstance(ctx, dict) and ctx.get("t"):
            resp.setdefault("trace", str(ctx["t"]))
        return resp

    def _dispatch_op(self, op: str, msg: dict) -> dict:
        if op == "ping":
            return self.router.ping()
        if op == "status":
            return self.router.status()
        if op == "query":
            res = self.router.query(decode_vectors(msg))
            return {"ok": True,
                    "labels": res["labels"].astype(int).tolist(),
                    "known": res["known"].astype(bool).tolist(),
                    "generation": int(res["generation"])}
        if op == "topk":
            mode = str(msg.get("mode", "candidates"))
            # A scan is a bulk request, as the client budgets it: a shard
            # scan that outlasts the connect timeout must not be re-sent
            # while it still runs.
            return self.router.topk(
                decode_vectors(msg), k=int(msg.get("k", 10)), mode=mode,
                timeout=(request_budget_s("ingest") or None)
                if mode == "scan" else None)
        if op == "ingest":
            rid = msg.get("request_id")
            return self.router.ingest(
                decode_vectors(msg),
                timeout=request_budget_s("ingest") or None,
                request_id=str(rid) if rid else None)
        if op == "quiesce":
            return self.router.quiesce(
                timeout=request_budget_s("ingest") or None)
        if op == "metrics":
            return {"ok": True, "prometheus": prometheus_text(),
                    "metrics": flat_metrics()}
        if op == "trace":
            n = msg.get("n")
            return {"ok": True,
                    "spans": recent_spans(int(n) if n else None),
                    "spans_recorded": spans_recorded()}
        if op == "shutdown":
            self._shutdown_requested.set()
            threading.Thread(target=self.shutdown, daemon=True).start()
            return {"ok": True, "op": "shutdown"}
        return {"ok": False, "error": f"unknown op {op!r}"}

    def serve_until_shutdown(self, port_file: str | None = None) -> None:
        if port_file:
            with atomic_write(port_file) as f:
                f.write(str(self.port))
        log.info("router: listening on %s:%d (%d shard(s))",
                 self.server_address[0], self.port, self.router.n_shards)
        self.serve_forever(poll_interval=0.1)


__all__ = ["LocalTransport", "RouterServer", "ShardRouter", "TcpTransport"]
