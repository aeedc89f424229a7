"""Read replicas of the serving plane over streamed shard copies: a port of
``tse1m_tpu/serve/replicate.py:63-407``.

A replica answers ``query`` and ``topk`` from a streamed copy of one
writer's store directory and never joins the write plane: its store
handle is ``read_only=True``, so it cannot append, commit state or stamp a
manifest.  One pull (:func:`stream_shards`) copies only artifacts that are
already safe to copy, each against the frame its manifest promises:

1. read the writer's committed manifest;
2. copy every shard file the replica does not hold yet, checking its CRC
   (a torn copy, or the writer evicting mid-read, fails the frame and the
   pull retries);
3. copy the current LSH state blob and its pointer the same way;
4. commit the manifest last, atomically: ``refresh()`` adopts a
   generation only once every file it names is in place.

Staleness is bounded and observable: :func:`replica_staleness` is the
writer's manifest generation minus the replica's.  ``query`` and
``topk(mode="candidates")`` stay on the host, as the JAX package's do;
``topk(mode="scan")`` scores every streamed row on ``device`` through
``bulk_topk_store`` (the top-k kernel on the card).  The write-plane verbs
refuse with the JAX package's messages.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
from dataclasses import replace

import numpy as np
import torch

from ..cluster.encode import quantize_ids
from ..cluster.host import host_band_keys
from ..cluster.incremental import LiveClusterIndex
from ..cluster.pipeline import ClusterParams, _store_policy
from ..cluster.schemes import make_params, scheme_host_signatures
from ..cluster.store import SignatureStore, file_crc, row_digests
from ..device import resolve_device
from ..observability import metrics as obs_metrics
from ..observability.latency import LatencyRecorder
from ..resilience.faults import fault_point
from ..resilience.watchdog import deadline_clock
from ..utils.atomic import atomic_write
from .daemon import _topk_answer

log = logging.getLogger("tse1m_tpu_torch.serve.replicate")

_MANIFEST = "store_manifest.json"
_STATE = "state.json"
_RECOVER_CHUNK = 65536


def _copy_framed(src_path: str, dst_path: str,
                 want_crc: int | None) -> int:
    """Copy one committed artifact and check the copy against the frame
    its manifest promises; returns the bytes copied (0: the replica holds
    a frame-identical file already)."""
    if want_crc is not None and os.path.exists(dst_path):
        try:
            if int(file_crc(dst_path)) == int(want_crc):
                return 0  # immutable once committed: nothing to pull again
        except OSError:
            pass
    tmp = dst_path + ".tmp.npy"
    shutil.copyfile(src_path, tmp)
    if want_crc is not None and int(file_crc(tmp)) != int(want_crc):
        os.remove(tmp)
        raise OSError(
            f"streamed copy of {os.path.basename(src_path)} failed its "
            "CRC frame (torn read under the writer)")
    os.replace(tmp, dst_path)
    return os.path.getsize(dst_path)


def _stream_once(src: str, dst: str) -> dict:
    try:
        with open(os.path.join(src, _MANIFEST), encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return {"generation": 0, "shards_copied": 0, "state_copied": False,
                "bytes_copied": 0}
    shards_copied = 0
    bytes_copied = 0
    for entry in manifest.get("shards", []):
        sid = int(entry["id"])
        copied = 0
        for crc_key, name in (("sig_crc", f"sig_{sid:05d}.npy"),
                              ("key_crc", f"key_{sid:05d}.npy")):
            copied += _copy_framed(os.path.join(src, name),
                                   os.path.join(dst, name),
                                   entry.get(crc_key))
        if copied:
            shards_copied += 1
            bytes_copied += copied
    state_copied = False
    try:
        with open(os.path.join(src, _STATE), encoding="utf-8") as f:
            smeta = json.load(f)
    except (OSError, ValueError):
        smeta = None
    if smeta and smeta.get("file"):
        bytes_copied += _copy_framed(
            os.path.join(src, str(smeta["file"])),
            os.path.join(dst, str(smeta["file"])), smeta.get("crc"))
        with atomic_write(os.path.join(dst, _STATE)) as f:
            json.dump(smeta, f)
        state_copied = True
    # The adoption point: every file the manifest names is in place.  A
    # kill before this line leaves the replica on its previous generation
    # with pre-staged files the next pull CRC-skips, never a torn view.
    manifest.pop("serve_journal", None)  # write-plane state stays behind
    fault_point("serve.replica.stream", path=os.path.join(dst, _MANIFEST))
    with atomic_write(os.path.join(dst, _MANIFEST)) as f:
        json.dump(manifest, f)
    return {"generation": int(manifest.get("generation", 0)),
            "shards_copied": shards_copied, "state_copied": state_copied,
            "bytes_copied": bytes_copied}


def stream_shards(src: str, dst: str, max_attempts: int = 3) -> dict:
    """One replication pull from a writer's store directory into the
    replica's (see the module docstring), retried a bounded number of
    times when the writer's eviction or compaction races the copy."""
    os.makedirs(dst, exist_ok=True)
    for attempt in range(max_attempts):
        try:
            out = _stream_once(src, dst)
            obs_metrics.counter("serve_replica_pulls_total").inc()
            return out
        except OSError as e:
            if attempt == max_attempts - 1:
                raise
            log.warning("replica pull raced the writer (%s); retrying "
                        "from the manifest", e)
    raise AssertionError("unreachable")  # pragma: no cover


def replica_staleness(src: str, replica: "ServeReplica") -> int:
    """Writer generations the replica has not adopted yet (0 = fresh); an
    absent or torn writer manifest reads as 0, never negative."""
    try:
        with open(os.path.join(src, _MANIFEST), encoding="utf-8") as f:
            gen = int(json.load(f).get("generation", 0))
    except (OSError, ValueError):
        return 0
    return max(0, gen - int(replica.store.generation))


class ServeReplica:
    """Read-only query plane over a streamed store copy.

    Answers the verbs ``ServeServer`` dispatches (``query``, ``topk``,
    ``status``, and ``ping`` through ``_index``), so a replica serves the
    same TCP protocol as a writer daemon; ``ingest`` and ``quiesce``
    refuse.  The index is rebuilt from the streamed LSH state and store
    rows at each adopted generation and published by one reference swap,
    as the writer daemon publishes its snapshots.

    ``device`` is where the scan runs: the card unless the caller asks
    for the CPU (the top-k kernel's plain version); without a card the
    constructor raises."""

    def __init__(self, directory: str,
                 params: ClusterParams | None = None,
                 device: str | torch.device = "cuda") -> None:
        self.device = resolve_device(device)
        self.params = params or ClusterParams()
        self.directory = directory
        policy = self._resolve_policy(directory)
        self.qbits = int(policy["quant_bits"])
        # The streamed store's policy wins wholesale: a replica answers in
        # the signature universe the writer's rows were computed under.
        adopt = {"scheme": str(policy.get("scheme", self.params.scheme)),
                 "n_hashes": int(policy.get("n_hashes",
                                            self.params.n_hashes)),
                 "seed": int(policy.get("seed", self.params.seed))}
        if any(getattr(self.params, f) != v for f, v in adopt.items()):
            self.params = replace(self.params, **adopt)
        self.store = SignatureStore(directory, policy, read_only=True)
        self._hp = make_params(self.params.scheme, self.params.n_hashes,
                               self.params.seed)
        self.read_only = True
        self.lat_query = LatencyRecorder("serve_replica_query")
        self.lat_topk = LatencyRecorder("serve_replica_topk")
        self._index = LiveClusterIndex.empty(self.params.n_bands)
        self._generation_adopted = -1
        self._rebuild()

    def _resolve_policy(self, directory: str) -> dict:
        try:
            with open(os.path.join(directory, _MANIFEST),
                      encoding="utf-8") as f:
                return dict(json.load(f)["policy"])
        except (OSError, ValueError, KeyError):
            qb = self.params.wire_quant_bits
            return _store_policy(self.params, qb if qb and qb > 0 else 0)

    # -- adoption -------------------------------------------------------------

    def _rebuild(self) -> None:
        """Adopt the store's current generation: the streamed LSH state
        first (row identity as the writer's for every row it covers),
        then every store row it does not cover, in (shard, row) order, as
        the writer daemon recovers."""
        index = LiveClusterIndex.empty(self.params.n_bands)
        state = self.store.load_state(self.params.n_bands,
                                      self.params.threshold)
        if state is not None:
            digests = np.empty((state.n_rows, 2), np.uint64)
            loc = state.locator
            for sid in np.unique(loc[:, 0]):
                sel = np.flatnonzero(loc[:, 0] == sid)
                digests[sel] = np.asarray(
                    self.store._key_mmap(int(sid))[loc[sel, 1]])
            index = LiveClusterIndex.from_state(state, digests)
        for entry in sorted(self.store.shards, key=lambda e: int(e["id"])):
            sid = int(entry["id"])
            keys = np.asarray(self.store._key_mmap(sid))
            for lo in range(0, keys.shape[0], _RECOVER_CHUNK):
                d = keys[lo:lo + _RECOVER_CHUNK]
                hit, _ = index.lookup_digests(d)
                fresh = np.flatnonzero(~hit)
                if fresh.size == 0:
                    continue
                sigs = np.asarray(self.store._sig_mmap(sid)[lo + fresh])
                keys_b = host_band_keys(sigs, self.params.n_bands)
                locator = np.stack(
                    [np.full(fresh.size, sid, np.int32),
                     (lo + fresh).astype(np.int32)], axis=1)
                index = index.absorb(
                    keys_b, sigs,
                    lambda u, _ix=index: self._gather(_ix, u),
                    self.params.n_hashes, self.params.threshold,
                    new_locator=locator, new_digests=d[fresh])
        # The publication point: one swap; a concurrent query keeps the
        # snapshot it already took.
        self._index = index
        self._generation_adopted = int(self.store.generation)
        obs_metrics.gauge("serve_replica_generation").set(
            self.store.generation)

    def refresh(self) -> bool:
        """Adopt a newer streamed generation (the only way a replica's
        state advances); True when the served view changed."""
        changed = self.store.refresh()
        if changed or int(self.store.generation) != self._generation_adopted:
            self._rebuild()
            return True
        return False

    # -- queries (any thread) -------------------------------------------------

    def _gather(self, index: LiveClusterIndex,
                uniq: np.ndarray) -> np.ndarray | None:
        loc = index.locator[uniq]
        try:
            return self.store.load_signatures(loc[:, 0], loc[:, 1])
        except (OSError, ValueError) as e:
            log.warning("replica: gather degraded (%s); candidates read "
                        "as misses", e)
            return None

    def query(self, vectors: np.ndarray) -> dict:
        """``ServeDaemon.query``'s contract over the last adopted
        generation, on the host."""
        t0 = deadline_clock()
        vectors = np.ascontiguousarray(vectors, np.uint32)
        index = self._index
        n = int(vectors.shape[0])
        hit, row = index.lookup_digests(row_digests(vectors))
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
                sigs, keys, lambda u: self._gather(index, u),
                self.params.n_hashes, self.params.threshold)
        self.lat_query.add(deadline_clock() - t0)
        return {"labels": out, "known": hit,
                "generation": index.generation}

    def topk(self, vectors: np.ndarray, k: int = 10,
             mode: str = "candidates") -> dict:
        """``ServeDaemon.topk``'s contract over the adopted snapshot and
        the streamed store: ``mode="scan"`` on ``device``."""
        t0 = deadline_clock()
        vectors = np.ascontiguousarray(vectors, np.uint32)
        index = self._index
        res = _topk_answer(self, index, self.store,
                           lambda u: self._gather(index, u),
                           vectors, k, mode)
        self.lat_topk.add(deadline_clock() - t0)
        return res

    # -- the write-plane verbs refuse -----------------------------------------

    def ingest(self, items, timeout=None, request_id=None) -> dict:
        raise RuntimeError(
            "this host is a read replica (read_only=True); ingest "
            "belongs to the range's single writer")

    def quiesce(self, timeout=None) -> dict:
        raise RuntimeError("read replica: no write-plane state to commit")

    def status(self) -> dict:
        index = self._index
        return {"ok": True, "read_only": True,
                "rows": int(index.n_rows),
                "generation": int(index.generation),
                "store_generation": int(self.store.generation),
                "store_rows": int(self.store.n_rows),
                "generation_adopted": int(self._generation_adopted),
                **self.lat_query.summary(),
                **self.lat_topk.summary(),
                "latency_by_verb": {
                    "query": self.lat_query.snapshot(),
                    "topk": self.lat_topk.snapshot(),
                }}


class ReplicationPuller:
    """Periodic pull and adoption on a daemon thread: keeps a replica's
    staleness bounded by ``interval_s``."""

    def __init__(self, src: str, replica: ServeReplica,
                 interval_s: float = 1.0) -> None:
        self.src = src
        self.replica = replica
        self.interval_s = float(interval_s)
        self.pulls = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def pull_once(self) -> bool:
        stream_shards(self.src, self.replica.store.directory)
        changed = self.replica.refresh()
        self.pulls += 1
        return changed

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.pull_once()
            except OSError as e:
                log.warning("replica pull failed (%s); retrying next "
                            "interval", e)
            self._stop.wait(self.interval_s)

    def start(self) -> "ReplicationPuller":
        if self._thread is None:
            t = threading.Thread(target=self._run, daemon=True,
                                 name="tse1m-serve-replica-pull")
            self._thread = t
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
            self._thread = None


__all__ = ["ReplicationPuller", "ServeReplica", "replica_staleness",
           "stream_shards"]
