"""Long-lived near-duplicate serving daemon (ingest loop + query path): a
port of ``tse1m_tpu/serve/daemon.py``.

The batch pipeline answers "cluster these N sessions" once a day; this
daemon answers "which cluster does THIS coverage vector belong to?" and
"which k stored sessions are nearest?" continuously, over the persistent
signature store:

- **Ingest** (one writer thread): batches of coverage vectors are
  digested, probed against the store, and only the content-novel rows are
  MinHashed on the card (``cluster.pipeline.minhash_novel_rows``: the
  scheme's kernel on row counts padded to a power of two, under the
  degradation ladder: an out-of-memory halves the batch's chunk, a stall
  is retried under the daemon's own stage watchdog, and the events land
  in ``degradations_total``; the store's width is never dropped).  Novel
  signatures append to the store; a batch is acknowledged only after the
  store's manifest commit, so an acknowledged row survives a kill.
- **Query** (any thread, no lock): each ingest generation publishes a new
  immutable ``cluster.incremental.LiveClusterIndex`` by swapping one
  reference; a query takes the reference once.  Old signatures are read
  through a read-only store handle refreshed per generation.  ``query``
  and ``topk(mode="candidates")`` are host-only: no device work at all.
  ``topk(mode="scan")`` scores every committed store row on the card
  (``bulk_topk_store``, one top-k launch a 16,384-column chunk).
- **SLO** (``serve/slo.py``): admission control refuses ingest past the
  backlog bound; latency histograms per verb and the queue depth flow
  into ``status()``.

Crash recovery: the daemon adopts the store's persisted LSH state as
generation 0, then absorbs, in (shard, row) order, every store row the
state does not cover: the rows whose append committed (and was acked)
but whose state commit the crash outran.

Device work: the ingest thread launches MinHash kernels and request
threads launch the top-k kernel, each on its own thread's current stream
of ``device``, each call with its own buffers.  Only the ingest thread
writes the store.

Shard mode: a daemon serving one digest range of a sharded serve root
behind ``serve.router.ShardRouter`` holds a
``resilience.coordinator.RangeLeaseGuard`` (``lease_guard=``) and proves
its tenure at the JAX package's two fence points: before each state
commit, and in each ingest batch after the seat
``fault_point("serve.ingest.commit")`` and before the append.  A writer
whose range was claimed at a later epoch raises ``LeaseSupersededError``
there with zero rows written, and refuses ingest from then on.  Left out
against the JAX package: the schedule explorer's trace points (ROADMAP.md
Queue 1, "Serve plane").
"""

from __future__ import annotations

import json
import logging
import os
import queue
import threading
from dataclasses import replace

import numpy as np
import torch

from ..cluster.encode import quantize_ids
from ..cluster.host import host_band_keys
from ..cluster.incremental import LiveClusterIndex, _delta_max_runs
from ..cluster.kernels.score import bulk_topk_store, store_scan_locator
from ..cluster.observability import StageRecorder
from ..cluster.pipeline import ClusterParams, _store_policy, minhash_novel_rows
from ..cluster.schemes import make_params, scheme_host_signatures
from ..cluster.store import SignatureStore, is_sharded_root, row_digests
from ..device import resolve_device
from ..observability import metrics as obs_metrics
from ..observability import profiling, record_degradation
from ..observability.flight import dump_flight, get_flight_dir, set_flight_dir
from ..observability.latency import LatencyRecorder
from ..observability.tracing import continue_trace, current_trace, span
from ..resilience.coordinator import LeaseSupersededError
from ..resilience.faults import fault_point
from ..resilience.watchdog import StageWatchdog, deadline_clock
from .slo import AdmissionController, SloPolicy, SloTracker

log = logging.getLogger("tse1m_tpu_torch.serve.daemon")

_RECOVER_CHUNK = 65536
_CONTROL_COMMIT = "commit_state"


def _labels_by_locator(index, loc: np.ndarray,
                       ok: np.ndarray) -> np.ndarray:
    """Reverse-map (shard, row) store locators to index labels: the scan
    ranks STORE rows, which may include rows appended but not yet absorbed
    into the published snapshot; those answer -1, never a stale label."""
    labels = np.full(loc.shape[0], -1, np.int64)
    sel = np.flatnonzero(ok)
    if sel.size == 0 or int(index.n_rows) == 0:
        return labels
    big = np.int64(2**31)
    ikey = (index.locator[:, 0].astype(np.int64) * big
            + index.locator[:, 1].astype(np.int64))
    order = np.argsort(ikey, kind="stable")
    skey = ikey[order]
    q = loc[sel, 0].astype(np.int64) * big + loc[sel, 1].astype(np.int64)
    pos = np.searchsorted(skey, q)
    inb = pos < skey.shape[0]
    hit = np.zeros(q.shape[0], bool)
    hit[inb] = skey[pos[inb]] == q[inb]
    labels[sel[hit]] = index.labels[order[pos[hit]]].astype(np.int64)
    return labels


def _topk_answer(srv, index, store, gather, vectors: np.ndarray,
                 k: int, mode: str) -> dict:
    """The ``topk`` verb's body: host signatures, then either the band
    candidate probe (``LiveClusterIndex.topk``, host only, recall bounded
    by the hub structure) or the exact scan of every committed store row
    on ``srv.device`` (``bulk_topk_store``, recall 1.0).

    Wire contract: per query exactly ``k`` slots, hits sorted by
    (-agreement count, digest hex ascending), padded with ``("", -1,
    -1)``.  The digest tiebreak makes the order independent of how the
    rows are sharded."""
    if mode not in ("candidates", "scan"):
        raise ValueError(f"unknown topk mode {mode!r}; expected "
                         "'candidates' or 'scan'")
    k = int(k)
    vectors = np.ascontiguousarray(vectors, np.uint32)
    nq = int(vectors.shape[0])
    base = {"ok": True, "generation": int(index.generation),
            "mode": mode, "k": k}
    if nq == 0 or k == 0:
        empty = [[] for _ in range(nq)]
        return {**base, "scores": [list(e) for e in empty],
                "ids": [list(e) for e in empty], "labels": empty}
    rows_in = vectors
    if srv.qbits:
        rows_in = quantize_ids(rows_in, srv.qbits)
    sigs = scheme_host_signatures(rows_in, srv._hp)
    if mode == "scan":
        counts, srows = bulk_topk_store(store, sigs, k, device=srv.device)
        flat = srows.ravel().astype(np.int64)
        ok = flat >= 0
        loc = np.full((flat.shape[0], 2), -1, np.int32)
        if ok.any():
            loc[ok] = store_scan_locator(store, flat[ok])
        labels = _labels_by_locator(index, loc, ok)
    else:
        keys = host_band_keys(sigs, srv.params.n_bands)
        counts, irows = index.topk(sigs, keys, gather, k)
        flat = irows.ravel().astype(np.int64)
        ok = flat >= 0
        loc = np.full((flat.shape[0], 2), -1, np.int32)
        labels = np.full(flat.shape[0], -1, np.int64)
        if ok.any():
            loc[ok] = index.locator[flat[ok]]
            labels[ok] = index.labels[flat[ok]].astype(np.int64)
    counts = np.ascontiguousarray(counts, np.int32).reshape(-1).copy()
    ids = np.full(flat.shape[0], "", object)
    sel = np.flatnonzero(ok)
    if sel.size:
        try:
            dg = store.load_digests(loc[sel, 0], loc[sel, 1])
        except (OSError, ValueError) as e:
            # An evicted or compacted shard raced the gather: hits degrade
            # to misses, never a wrong id.
            log.warning("serve: topk digest gather degraded (%s); "
                        "dropping %d hits", e, sel.size)
            counts[sel] = -1
            labels[sel] = -1
        else:
            ids[sel] = ["%016x%016x" % (int(a), int(b)) for a, b in dg]
    counts = counts.reshape(nq, k)
    labels = labels.reshape(nq, k)
    ids = ids.reshape(nq, k)
    out_s, out_i, out_l = [], [], []
    for qi in range(nq):
        c, hx, lb = counts[qi], ids[qi], labels[qi]
        valid = sorted(np.flatnonzero(c >= 0).tolist(),
                       key=lambda j: (-int(c[j]), hx[j]))
        pad = k - len(valid)
        out_s.append([int(c[j]) for j in valid] + [-1] * pad)
        out_i.append([str(hx[j]) for j in valid] + [""] * pad)
        out_l.append([int(lb[j]) for j in valid] + [-1] * pad)
    return {**base, "scores": out_s, "ids": out_i, "labels": out_l}


class IngestRejected(RuntimeError):
    """Admission control refused the batch (backpressure)."""

    def __init__(self, depth: int, retry_after_s: float) -> None:
        super().__init__(
            f"ingest backlog at {depth} batches; retry in "
            f"~{retry_after_s:.2f}s")
        self.depth = depth
        self.retry_after_s = retry_after_s


class _Ticket:
    __slots__ = ("items", "op", "event", "result", "error", "trace",
                 "request_id")

    def __init__(self, items=None, op: str = "ingest",
                 request_id: str | None = None) -> None:
        self.items = items
        self.op = op
        self.request_id = request_id
        self.event = threading.Event()
        self.result: dict | None = None
        self.error: BaseException | None = None
        # The submitter's trace context: the ingest thread adopts it, so
        # the store append lands in the client's trace.
        self.trace: dict | None = current_trace()

    def fail(self, e: BaseException) -> None:
        self.error = e
        self.event.set()

    def done(self, result: dict) -> None:
        self.result = result
        self.event.set()

    def wait(self, timeout: float | None = None) -> dict:
        if not self.event.wait(timeout):
            raise TimeoutError("ingest batch not acknowledged in time")
        if self.error is not None:
            raise self.error
        return self.result or {}


class ServeDaemon:
    """The serving plane's single-process core: one writer thread, any
    number of reader threads, one store directory.

    ``submit``/``ingest``/``query``/``topk``/``status`` are safe from any
    thread; everything that WRITES (store appends, state commits, index
    swaps) happens on the one ingest thread.

    ``device`` is where content-novel rows are MinHashed and where the
    scan runs: the card unless the caller asks for the CPU (the kernels'
    plain versions); without a card the constructor raises.  The JAX
    package's ``signer="host"`` option (novel rows signed on the host while
    a card is present) has no caller here and is left out.

    ``lease_guard`` (a ``RangeLeaseGuard``) makes this daemon a fenced
    shard writer: see the module docstring."""

    def __init__(self, store_dir: str,
                 params: ClusterParams | None = None,
                 slo: SloPolicy | None = None,
                 state_commit_every: int = 8,
                 device: str | torch.device = "cuda",
                 lease_guard=None) -> None:
        self.device = resolve_device(device)
        self.lease_guard = lease_guard
        if is_sharded_root(store_dir):
            raise ValueError(
                f"{store_dir} is a pod-sharded store root; the serving "
                "daemon is single-host — serve one range directory, or "
                "run one daemon per range owner")
        self.params = params or ClusterParams()
        self.slo = slo or SloPolicy.from_env()
        self.state_commit_every = max(1, int(state_commit_every))
        if self.slo.live_delta_runs is not None:
            # The index reads the LSM delta-run bound at absorb time; the
            # policy field is the serving plane's surface for it.
            os.environ["TSE1M_LIVE_DELTA_RUNS"] = str(
                int(self.slo.live_delta_runs))
        policy = self._resolve_policy(store_dir)
        self.qbits = int(policy["quant_bits"])
        # The store's scheme wins (a manifest without one is kminhash),
        # and novel rows are MinHashed under it.
        scheme = str(policy.get("scheme", self.params.scheme))
        if scheme != self.params.scheme:
            self.params = replace(self.params, scheme=scheme)
        self.store = SignatureStore(store_dir, policy)
        self.reader = SignatureStore(store_dir, policy, read_only=True)
        self._hp = make_params(self.params.scheme, self.params.n_hashes,
                               self.params.seed)
        self.rec = StageRecorder()
        self.watchdog = StageWatchdog()
        self.admission = AdmissionController(self.slo)
        self.tracker = SloTracker(self.slo)
        self.lat_query = LatencyRecorder("serve_query")
        self.lat_topk = LatencyRecorder("serve_topk")
        self.lat_ingest = LatencyRecorder("serve_ingest")
        self.last_scrub: dict = {
            "store_scrub_shards": len(self.store.shards),
            "store_scrub_corrupt": len(self.store.quarantined_at_open)}
        self._digest_parts: list[np.ndarray] = []
        self._index = LiveClusterIndex.empty(self.params.n_bands)
        self._recover()
        self._q: queue.Queue[_Ticket] = queue.Queue()
        self._stop = threading.Event()
        self._busy = False
        # In-flight absorb state for slow-request attribution: the ingest
        # thread replaces the whole dict at each phase (one reference
        # store), a slow query copies it.
        self._inflight: dict = {}
        self._last_committed_gen = self._index.generation
        self._ingest_error: BaseException | None = None
        self._thread: threading.Thread | None = None
        # Crash dumps land next to the data they describe (an explicit
        # set_flight_dir or TSE1M_FLIGHT_DIR wins).
        if get_flight_dir() is None:
            set_flight_dir(store_dir)

    # -- lifecycle -----------------------------------------------------------

    def _resolve_policy(self, store_dir: str) -> dict:
        """An existing store's manifest policy wins; a fresh directory
        takes the policy from params."""
        path = os.path.join(store_dir, "store_manifest.json")
        if os.path.exists(path):
            try:
                with open(path, encoding="utf-8") as f:
                    return dict(json.load(f)["policy"])
            except (OSError, ValueError, KeyError) as e:
                log.warning("unreadable store manifest (%s); opening "
                            "fresh", e)
        qb = self.params.wire_quant_bits
        return _store_policy(self.params, qb if qb and qb > 0 else 0)

    def start(self) -> "ServeDaemon":
        self._thread = threading.Thread(target=self._ingest_loop,
                                        name="tse1m-serve-ingest",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self, commit: bool = True) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        if commit and self._ingest_error is None:
            # The ingest thread is gone; committing from here keeps one
            # live writer.
            self._commit_state()

    # -- recovery ------------------------------------------------------------

    def _recover(self) -> None:
        state = self.store.load_state(self.params.n_bands,
                                      self.params.threshold)
        if state is not None:
            digests = np.empty((state.n_rows, 2), np.uint64)
            loc = state.locator
            for sid in np.unique(loc[:, 0]):
                sel = np.flatnonzero(loc[:, 0] == sid)
                digests[sel] = np.asarray(
                    self.store._key_mmap(int(sid))[loc[sel, 1]])
            self._index = LiveClusterIndex.from_state(state, digests)
            self._digest_parts = [digests]
        # Absorb acked rows the state does not cover (the append outran
        # the state commit), in (shard id, row) order.
        absorbed = 0
        for entry in sorted(self.store.shards, key=lambda e: int(e["id"])):
            sid = int(entry["id"])
            keys = np.asarray(self.store._key_mmap(sid))
            for lo in range(0, keys.shape[0], _RECOVER_CHUNK):
                d = keys[lo:lo + _RECOVER_CHUNK]
                hit, _ = self._index.lookup_digests(d)
                fresh = np.flatnonzero(~hit)
                if fresh.size == 0:
                    continue
                sigs = np.asarray(
                    self.store._sig_mmap(sid)[lo + fresh])
                locator = np.stack(
                    [np.full(fresh.size, sid, np.int32),
                     (lo + fresh).astype(np.int32)], axis=1)
                self._absorb(d[fresh], sigs, locator)
                absorbed += int(fresh.size)
        if absorbed:
            log.warning("serve: recovered %d acked row(s) the persisted "
                        "state did not cover (crash between append and "
                        "state commit)", absorbed)
        self._inflight = {}

    # -- index mutation (ingest thread only) ---------------------------------

    def _gather_writer_sigs(self, index: LiveClusterIndex,
                            uniq: np.ndarray) -> np.ndarray:
        loc = index.locator[uniq]
        try:
            return self.store.load_signatures(loc[:, 0], loc[:, 1])
        except (OSError, ValueError):
            # An evicted shard raced an old locator: a hub whose signature
            # is gone gets a sentinel that never reaches the agreement
            # threshold, so its candidate edge drops (the miss-and-
            # recompute semantics eviction already means).
            h = self.params.n_hashes
            out = np.full((int(uniq.size), h), 0xFFFFFFFF, np.uint32)
            lost = 0
            for sid in np.unique(loc[:, 0]):
                sel = np.flatnonzero(loc[:, 0] == sid)
                try:
                    out[sel] = self.store.load_signatures(loc[sel, 0],
                                                          loc[sel, 1])
                except (OSError, ValueError):
                    lost += int(sel.size)
            record_degradation(
                "serve_evicted_gather", site="serve.ingest",
                detail={"rows": lost})
            log.warning("serve: %d hub signature(s) evicted from the "
                        "store; their candidate edges drop and the new "
                        "rows recompute", lost)
            return out

    def _absorb(self, digests: np.ndarray, sigs: np.ndarray,
                locator: np.ndarray) -> None:
        self._inflight = {"site": "serve.index.swap",
                          "rows": int(digests.shape[0]),
                          "since_s": round(deadline_clock(), 3)}
        index = self._index
        keys = host_band_keys(sigs, self.params.n_bands)
        new_index = index.absorb(
            keys, sigs, lambda u: self._gather_writer_sigs(index, u),
            self.params.n_hashes, self.params.threshold,
            new_locator=locator, new_digests=digests)
        self._digest_parts.append(
            np.ascontiguousarray(digests, np.uint64))
        # THE publication point: one reference swap; concurrent queries
        # keep whichever snapshot they already took.
        self._index = new_index
        obs_metrics.gauge("serve_store_generation").set(
            self.store.generation)
        obs_metrics.gauge("serve_store_rows").set(self.store.n_rows)

    def _all_digests(self) -> np.ndarray:
        if len(self._digest_parts) > 1:
            self._digest_parts = [np.concatenate(self._digest_parts)]
        return (self._digest_parts[0] if self._digest_parts
                else np.empty((0, 2), np.uint64))

    def _commit_state(self) -> None:
        index = self._index
        if index.n_rows == 0:
            return
        if self.lease_guard is not None:
            self.lease_guard.verify()
        self.store.save_state(
            index.labels, index.locator,
            index.band_tables(),
            self._all_digests(), self.params.n_bands,
            self.params.threshold)
        self._last_committed_gen = index.generation

    # -- ingest --------------------------------------------------------------

    def submit(self, items: np.ndarray,
               request_id: str | None = None) -> _Ticket:
        """Admission-checked enqueue; raises IngestRejected under
        backpressure.  The ticket's ``wait()`` blocks until the batch is
        durably acknowledged (store append committed).  ``request_id``
        makes the batch idempotent: a retry carrying the id of an ingest
        that already committed replays the original ack."""
        if self._ingest_error is not None:
            raise RuntimeError("serve ingest loop is down") \
                from self._ingest_error
        depth = self._q.qsize()
        obs_metrics.gauge("serve_queue_depth").set(depth)
        admitted, retry_after = self.admission.try_admit(depth)
        if not admitted:
            raise IngestRejected(depth, retry_after)
        t = _Ticket(np.ascontiguousarray(items, np.uint32),
                    request_id=request_id)
        self._q.put(t)
        return t

    def ingest(self, items: np.ndarray,
               timeout: float | None = None,
               request_id: str | None = None) -> dict:
        return self.submit(items, request_id=request_id).wait(timeout)

    def _ingest_loop(self) -> None:
        while not self._stop.is_set():
            try:
                t = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._busy = True
            try:
                self._run_ticket(t)
            except LeaseSupersededError as e:
                # Self-fence: the check ran before the append, so zero rows
                # were written.  Latch the error (further submits are
                # refused) and keep the thread for the query path.
                t.fail(e)
                self._ingest_error = e
                log.error("serve: shard writer fenced (%s); ingest refused "
                          "from here on", e)
            except Exception as e:  # noqa: BLE001 - one failed batch; the daemon goes on
                t.fail(e)
                log.error("serve: ingest batch failed (%s: %s); daemon "
                          "continues", type(e).__name__, e)
            except BaseException as e:
                t.fail(e)
                self._ingest_error = e
                dump_flight("serve.ingest_exit", site="serve.ingest",
                            extra={"error": type(e).__name__})
                raise
            finally:
                self._busy = False
                self._inflight = {}

    def _run_ticket(self, t: _Ticket) -> None:
        if t.op == _CONTROL_COMMIT:
            self._commit_state()
            t.done({"ok": True, "generation": self._index.generation})
            return
        with continue_trace(t.trace):
            with span("serve.ingest.batch", rows=int(t.items.shape[0])):
                ti = deadline_clock()
                with self.lat_ingest.time():
                    t.done(self._ingest_batch(t.items,
                                              request_id=t.request_id))
                wall_i = deadline_clock() - ti
                if wall_i > self.slo.ingest_budget_s > 0:
                    profiling.capture_slow_request(
                        "ingest", wall_i, self.slo.ingest_budget_s * 1e3,
                        absorb=self._inflight,
                        rows=int(t.items.shape[0]))
        gen = self._index.generation
        if gen - self._last_committed_gen >= self.state_commit_every:
            self._commit_state()

    def _acked_rows(self, digests: np.ndarray) -> np.ndarray | None:
        """The index rows the acked batch of these digests took: a batch
        appends its k rows at once, so the last block of k consecutive
        index rows holding exactly these digests in order; None when no
        block does (a restart absorbed the rows in store order)."""
        k = int(digests.shape[0])
        every = self._all_digests()
        if k == 0 or every.shape[0] < k:
            return None
        starts = np.flatnonzero((every[:, 0] == digests[0, 0])
                                & (every[:, 1] == digests[0, 1]))
        for p in starts[::-1]:
            if p + k <= every.shape[0] and np.array_equal(every[p:p + k],
                                                          digests):
                return p + np.arange(k, dtype=np.int64)
        return None

    def _replay_ack(self, request_id: str, items: np.ndarray) -> dict:
        """The idempotent retry's answer: this request id already
        committed (its journal entry rode the append's manifest write), so
        the rows are in the index; answer from there, with the rows the
        original ack named.  (The JAX package answers each row with the
        first index row of its content, which a router then maps to the
        batch's global ids: a row that repeats earlier content moves that
        earlier row's global label.)  Where the batch's block is gone, the
        first row of each content, as the JAX package answers."""
        entry = self.store.serve_journal[request_id]
        index = self._index
        digests = row_digests(items)
        rows = self._acked_rows(digests)
        if rows is None:
            hit, row = index.lookup_digests(digests)
        else:
            hit, row = np.ones(rows.shape[0], bool), rows.astype(np.int32)
        labels = np.full(int(items.shape[0]), -1, np.int64)
        labels[hit] = index.labels[row[hit]].astype(np.int64)
        record_degradation(
            "serve_ingest_replayed", site="serve.ingest",
            detail={"request_id": request_id,
                    "acked": int(entry.get("acked", 0))})
        return {"ok": True, "acked": int(entry.get("acked", 0)),
                "novel": int(entry.get("novel", 0)),
                "generation": index.generation,
                "labels": labels.astype(int).tolist(),
                "rows": row.astype(int).tolist(),
                "replayed": True}

    def _ingest_batch(self, items: np.ndarray,
                      request_id: str | None = None) -> dict:
        """One acknowledged batch: every row becomes a new index row (the
        batch pipeline keeps content duplicates as distinct rows), while
        the store stays content-addressed: cached contents gather their
        signature, only the content-novel rows go to the device."""
        k = int(items.shape[0])
        self._inflight = {"site": "serve.ingest.batch", "rows": k,
                          "since_s": round(deadline_clock(), 3)}
        if request_id is not None and request_id in self.store.serve_journal:
            return self._replay_ack(request_id, items)
        index = self._index
        n_old = index.n_rows
        if k == 0:
            return {"ok": True, "acked": 0, "novel": 0,
                    "generation": index.generation,
                    "labels": [], "rows": []}
        digests = row_digests(items)
        h = self.params.n_hashes
        sigs = np.empty((k, h), np.uint32)
        s_hit, sh, rw = self.store.bulk_probe(digests)
        if s_hit.any():
            sigs[s_hit] = self.store.load_signatures(sh[s_hit], rw[s_hit])
        miss = ~s_hit
        novel = int(miss.sum())
        if novel:
            sigs[miss] = self._sign_novel(items[miss])
        # Durability point: the ack is sent only after this commit (tmp +
        # rename shard, then manifest).
        fault_point("serve.ingest.commit")
        if self.lease_guard is not None:
            # Fence point: tenure proven after the seat and before the
            # append, so a superseded writer raises with zero rows written.
            self.lease_guard.verify()
        if request_id is not None:
            # Staged under the id, so the append's manifest write commits
            # the ack atomically with the rows it acknowledges.
            self.store.journal_record(request_id,
                                      {"acked": k, "novel": novel})
        self.store.append(digests[miss], sigs[miss])
        _, sh2, rw2 = self.store.bulk_probe(digests)
        locator = np.stack([sh2, rw2], axis=1).astype(np.int32)
        # Refresh the query-side reader BEFORE publishing the new index
        # generation, so no published locator outruns the reader's view.
        self.reader.refresh()
        self._absorb(digests, sigs, locator)
        new_index = self._index
        gr = n_old + np.arange(k, dtype=np.int64)
        return {"ok": True, "acked": k, "novel": novel,
                "generation": new_index.generation,
                "labels": new_index.labels[gr].astype(int).tolist(),
                "rows": gr.tolist()}

    def _sign_novel(self, rows: np.ndarray) -> np.ndarray:
        """[K, S] raw rows -> [K, H] uint32 signatures under the store
        policy, on ``self.device``."""
        return minhash_novel_rows(rows, self.params, self.qbits,
                                  rec=self.rec, wd=self.watchdog,
                                  device=self.device)

    # -- queries (any thread) ------------------------------------------------

    def _gather_reader_sigs(self, index: LiveClusterIndex,
                            uniq: np.ndarray) -> np.ndarray | None:
        loc = index.locator[uniq]
        try:
            return self.reader.load_signatures(loc[:, 0], loc[:, 1])
        except (OSError, ValueError) as e:
            # An evicted or compacted shard raced this gather: candidates
            # degrade to misses (the vector reads as novel), never a wrong
            # label.
            log.warning("serve: query gather degraded (%s); treating "
                        "candidates as misses", e)
            return None

    def query(self, vectors: np.ndarray) -> dict:
        """Cluster membership for [K, S] uint32 coverage vectors, host
        only: known vectors (content digest already ingested) answer from
        the snapshot's labels; novel vectors are MinHashed on the host
        (bit-identical to the kernels), probed against the snapshot's band
        tables and verified with the exact agreement rule.  Label -1 means
        a new singleton cluster."""
        t0 = deadline_clock()
        vectors = np.ascontiguousarray(vectors, np.uint32)
        index = self._index  # ONE snapshot reference for the whole query
        n = int(vectors.shape[0])
        digests = row_digests(vectors)
        hit, row = index.lookup_digests(digests)
        out = np.full(n, -1, np.int64)
        if hit.any():
            out[hit] = index.labels[row[hit]].astype(np.int64)
        miss = np.flatnonzero(~hit)
        if miss.size:
            rows = vectors[miss]
            if self.qbits:
                rows = quantize_ids(rows, self.qbits)
            sigs = scheme_host_signatures(rows, self._hp)
            keys = host_band_keys(sigs, self.params.n_bands)
            out[miss] = index.query_labels(
                sigs, keys, lambda u: self._gather_reader_sigs(index, u),
                self.params.n_hashes, self.params.threshold)
        wall = deadline_clock() - t0
        self.lat_query.add(wall)
        self.tracker.observe_query(wall)
        if wall * 1e3 > self.slo.query_p99_target_ms:
            profiling.capture_slow_request(
                "query", wall, self.slo.query_p99_target_ms,
                absorb=self._inflight if self._busy else None,
                rows=n, generation=int(index.generation))
        return {"labels": out, "known": hit,
                "generation": index.generation}

    def topk(self, vectors: np.ndarray, k: int = 10,
             mode: str = "candidates") -> dict:
        """The k nearest stored sessions per [K, S] coverage vector, by
        exact signature agreement: ``mode="candidates"`` probes the
        snapshot's band tables on the host, ``mode="scan"`` scores every
        committed store row on the card.  See ``_topk_answer`` for the
        wire contract."""
        t0 = deadline_clock()
        vectors = np.ascontiguousarray(vectors, np.uint32)
        index = self._index  # ONE snapshot reference for the whole call
        res = _topk_answer(self, index, self.reader,
                           lambda u: self._gather_reader_sigs(index, u),
                           vectors, k, mode)
        wall = deadline_clock() - t0
        self.lat_topk.add(wall)
        if mode == "candidates" and (wall * 1e3
                                     > self.slo.query_p99_target_ms):
            # Only the interactive candidate path is held to the query
            # SLO; the scan is a bulk job.
            profiling.capture_slow_request(
                "topk", wall, self.slo.query_p99_target_ms,
                absorb=self._inflight if self._busy else None,
                rows=int(vectors.shape[0]),
                generation=int(index.generation))
        return res

    # -- control -------------------------------------------------------------

    def quiesce(self, timeout: float | None = None) -> dict:
        """Drain the ingest queue and commit the LSH state.  After
        quiesce, a cold batch run over the same session sequence gives
        the index labels element for element."""
        t = _Ticket(op=_CONTROL_COMMIT)
        self._q.put(t)
        return t.wait(timeout)

    def status(self) -> dict:
        index = self._index
        return {
            "ok": self._ingest_error is None,
            "rows": int(index.n_rows),
            "generation": int(index.generation),
            "store_generation": int(self.store.generation),
            "store_rows": int(self.store.n_rows),
            "queue_depth": int(self._q.qsize()),
            # Registry history, not a point-in-time read: a backpressure
            # episode that drained still shows.
            "queue_depth_hwm": int(obs_metrics.gauge(
                "serve_ingest_backlog_max").value),
            "ingest_rejected_total": int(obs_metrics.counter(
                "serve_ingest_rejected_total").value),
            "uncommitted_generations": int(index.generation
                                           - self._last_committed_gen),
            "slow_requests_total": profiling.slow_requests_total(),
            "lock_wait_top": profiling.lock_wait_summary(top=3),
            "last_scrub": dict(self.last_scrub),
            "policy": dict(self.store.policy),
            "live_delta_runs": _delta_max_runs(),
            **self.admission.stats(),
            **self.tracker.stats(),
            **self.lat_query.summary(),
            **self.lat_topk.summary(),
            **self.lat_ingest.summary(),
            "latency_by_verb": {
                "query": self.lat_query.snapshot(),
                "topk": self.lat_topk.snapshot(),
                "ingest": self.lat_ingest.snapshot(),
            },
        }


__all__ = ["IngestRejected", "ServeDaemon"]
