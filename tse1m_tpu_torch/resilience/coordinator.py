"""Epoch leases and file heartbeats of the sharded serving plane: the part
of ``tse1m_tpu/resilience/coordinator.py`` a range writer and the router
run (``:81-101``, ``:195-383``, ``:576-688``).

- **Heartbeats.** :class:`HeartbeatWriter` beats a monotonically
  increasing ``seq`` into ``hb_NNN.json`` under a shared directory from a
  daemon thread (atomic tmp+rename, so a reader never sees a torn beat).
  A beat carries no timestamp: wall clocks of two hosts do not compare.
  :class:`PeerMonitor` declares a peer lost when its ``seq`` has not
  advanced within ``timeout_s`` of the local ``deadline_clock``.  Loss
  latches per epoch; a peer re-admits in a later epoch only under a run
  nonce never seen before (the replay guard: a stale file or a regressed
  seq never counts as an advance).
- **Epoch leases.** One ``lease_NNNN.json`` per digest range under the
  sharded serve root, ``{range, epoch, owner, nonce}``: a monotonic epoch
  and the holding run's nonce, no timestamp, fencing by epoch comparison.
  A shard writer proves its tenure (:meth:`RangeLeaseGuard.verify`)
  before every append and state commit; a writer whose range was claimed
  at a later epoch raises :class:`LeaseSupersededError` there with zero
  rows written.

The files are the JAX package's, byte for byte, so either package fences
the other's writer and reads its heartbeats.  The mesh's world is
``parallel/multihost.py``'s; what waits is the pod path: the pod
supervisor, the nonce exchange, the membership ledger and the host-loss
teardown (ROADMAP.md Queue 1, "Multi-GPU").
"""

from __future__ import annotations

import json
import logging
import os
import threading

from ..utils.atomic import atomic_write
from .watchdog import deadline_clock

log = logging.getLogger("tse1m_tpu_torch.resilience.coordinator")

_HB_PREFIX = "hb_"


def heartbeat_interval_s() -> float:
    return float(os.environ.get("TSE1M_HEARTBEAT_INTERVAL_S", 0.5))


def heartbeat_timeout_s() -> float:
    return float(os.environ.get("TSE1M_HEARTBEAT_TIMEOUT_S", 10.0))


class LeaseSupersededError(RuntimeError):
    """This writer's epoch lease on a digest range was superseded: a later
    epoch dealt the range to another writer.  The holder self-fences
    (no further appends) instead of double-writing."""

    def __init__(self, range_id: int, held: dict, current: dict | None):
        self.range_id = int(range_id)
        self.held = dict(held)
        self.current = dict(current) if current else None
        cur = (f"epoch {current.get('epoch')} owned by process "
               f"{current.get('owner')}" if current else "absent")
        super().__init__(
            f"lease on digest range {self.range_id} superseded: this "
            f"writer holds epoch {held.get('epoch')} as process "
            f"{held.get('owner')}, but the on-disk lease is {cur} — the "
            "range was re-dealt while this process was wedged; demoting "
            "to read-only (zero further appends) instead of double-"
            "writing")


# -- heartbeats ---------------------------------------------------------------

def heartbeat_path(directory: str, process_id: int) -> str:
    return os.path.join(directory, f"{_HB_PREFIX}{int(process_id):03d}.json")


class HeartbeatWriter:
    """Beat ``seq`` into this process's heartbeat file from a daemon
    thread.  Atomic writes only: a peer's read never races a beat."""

    def __init__(self, directory: str, process_id: int,
                 interval_s: float | None = None) -> None:
        self.directory = directory
        self.process_id = int(process_id)
        self.interval_s = (heartbeat_interval_s()
                           if interval_s is None else float(interval_s))
        self._lock = threading.Lock()
        self._seq = 0
        # A fresh run restarts seq at 1; the per-run nonce makes that an
        # advance over a stale file's higher seq.
        self._run_id = os.urandom(8).hex()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    @property
    def run_id(self) -> str:
        """This run's heartbeat nonce (fresh per HeartbeatWriter)."""
        return self._run_id

    def beat_once(self) -> int:
        from ..observability.tracing import pinned_trace

        with self._lock:
            self._seq += 1
            seq = self._seq
        with atomic_write(heartbeat_path(self.directory,
                                         self.process_id)) as f:
            # The pinned trace id rides every beat (readers ignore
            # unknown keys), as in the JAX package's files.
            json.dump({"process_id": self.process_id, "seq": seq,
                       "run": self._run_id,
                       "trace": pinned_trace()}, f)
        return seq

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.beat_once()
            except OSError as e:
                log.warning("heartbeat write failed (%s); peers may "
                            "declare this process lost", e)
            self._stop.wait(self.interval_s)

    def start(self) -> "HeartbeatWriter":
        if self._thread is None:
            self.beat_once()  # visible before any peer's grace expires
            t = threading.Thread(target=self._run, daemon=True,
                                 name=f"tse1m-heartbeat:{self.process_id}")
            with self._lock:
                self._thread = t
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()


class PeerMonitor:
    """Track peers' heartbeat seqs; declare a peer lost when its beat has
    not advanced within ``timeout_s`` of the local ``deadline_clock``.

    ``peers`` overrides the dense ``0..n_processes-1`` set, as for a
    router (not itself a writer) watching the shard daemons' range ids.
    Loss latches per epoch; :meth:`advance_epoch` opens the next one."""

    def __init__(self, directory: str, n_processes: int, process_id: int,
                 timeout_s: float | None = None,
                 peers: list | None = None) -> None:
        self.directory = directory
        self.process_id = int(process_id)
        self.peers = (sorted(int(p) for p in peers
                             if int(p) != self.process_id)
                      if peers is not None
                      else [p for p in range(int(n_processes))
                            if p != self.process_id])
        self.timeout_s = (heartbeat_timeout_s()
                          if timeout_s is None else float(timeout_s))
        now = deadline_clock()
        self._lock = threading.Lock()
        # peer -> (last (run, seq) seen, deadline_clock() at last advance);
        # an absent file gets the full grace window from the start.
        self._seen = {p: ((None, -1), now) for p in self.peers}
        # Every nonce ever seen per peer: a beat under a seen nonce that is
        # not the current one is a rollback, never an advance.
        self._nonces: dict[int, set] = {p: set() for p in self.peers}
        self.epoch = 0
        self._lost: set[int] = set()
        self._lost_history: set[int] = set()

    def _read_beat(self, peer: int):
        """(run nonce, seq) of the peer's last beat, or None."""
        try:
            with open(heartbeat_path(self.directory, peer),
                      encoding="utf-8") as f:
                d = json.load(f)
            return (d.get("run"), int(d["seq"]))
        except (OSError, ValueError, KeyError):
            return None

    def _advanced(self, peer: int, beat) -> bool:
        if beat is None:
            return False
        run, seq = beat
        last_run, last_seq = self._seen[peer][0]
        if run == last_run:
            return seq > last_seq
        return run not in self._nonces[peer]

    def poll(self) -> list:
        """Refresh every peer's state; returns the epoch's lost peers."""
        now = deadline_clock()
        with self._lock:
            for peer in self.peers:
                if peer in self._lost:
                    continue
                beat = self._read_beat(peer)
                (_, last_seq), last_t = self._seen[peer]
                if self._advanced(peer, beat):
                    self._seen[peer] = (beat, now)
                    if beat[0] is not None:
                        self._nonces[peer].add(beat[0])
                elif now - last_t > self.timeout_s:
                    self._lost.add(peer)
                    log.warning(
                        "peer %d declared lost in epoch %d (no heartbeat "
                        "advance in %.1fs, last seq %d)", peer, self.epoch,
                        self.timeout_s, last_seq)
                    from ..observability import record_degradation

                    record_degradation(
                        "host_lost", site="coordinator",
                        detail={"process": int(peer),
                                "epoch": int(self.epoch),
                                "timeout_s": self.timeout_s,
                                "last_seq": int(last_seq)})
            return sorted(self._lost)

    def advance_epoch(self, epoch: int | None = None) -> int:
        """Open the next epoch: the loss latches clear and every peer gets
        a fresh grace window; the nonce memory persists."""
        with self._lock:
            self.epoch = int(epoch) if epoch is not None else self.epoch + 1
            self._lost_history |= self._lost
            self._lost.clear()
            now = deadline_clock()
            for p in self.peers:
                self._seen[p] = (self._seen[p][0], now)
            return self.epoch

    def ever_lost(self) -> list:
        """Peers declared lost in any epoch."""
        with self._lock:
            return sorted(self._lost_history | self._lost)


# -- epoch leases -------------------------------------------------------------

_LEASE_FMT = "lease_{:04d}.json"


def lease_path(root: str, range_id: int) -> str:
    return os.path.join(root, _LEASE_FMT.format(int(range_id)))


def read_lease(root: str, range_id: int) -> dict | None:
    """The on-disk lease of a range, or None (absent or torn: the next
    acquire rewrites it)."""
    try:
        with open(lease_path(root, range_id), encoding="utf-8") as f:
            d = json.load(f)
        return {"range": int(d["range"]), "epoch": int(d["epoch"]),
                "owner": int(d["owner"]), "nonce": str(d.get("nonce", ""))}
    except (OSError, ValueError, KeyError, TypeError):
        return None


def write_lease(root: str, range_id: int, epoch: int, owner: int,
                nonce: str) -> dict:
    """The one lease mutation: atomic tmp+rename."""
    rec = {"range": int(range_id), "epoch": int(epoch),
           "owner": int(owner), "nonce": str(nonce)}
    with atomic_write(lease_path(root, range_id)) as f:
        json.dump(rec, f)
    return rec


def acquire_lease(root: str, range_id: int, epoch: int, owner: int,
                  nonce: str) -> dict:
    """Take (or re-take) the range's lease at ``epoch``; raises
    :class:`LeaseSupersededError` when the on-disk lease holds a later
    epoch, or the same epoch under another owner."""
    held = {"epoch": int(epoch), "owner": int(owner), "nonce": str(nonce)}
    cur = read_lease(root, range_id)
    if cur is not None:
        if cur["epoch"] > int(epoch):
            raise LeaseSupersededError(range_id, held, cur)
        if cur["epoch"] == int(epoch) and cur["owner"] != int(owner):
            raise LeaseSupersededError(range_id, held, cur)
    return write_lease(root, range_id, epoch, owner, nonce)


def verify_lease(root: str, range_id: int, epoch: int, owner: int,
                 nonce: str) -> None:
    """Prove this writer still holds the range's lease; anything else (a
    later epoch, another owner or nonce, a missing or torn lease) raises
    :class:`LeaseSupersededError`."""
    held = {"epoch": int(epoch), "owner": int(owner), "nonce": str(nonce)}
    cur = read_lease(root, range_id)
    if (cur is None or cur["epoch"] != int(epoch)
            or cur["owner"] != int(owner)
            or cur["nonce"] != str(nonce)):
        raise LeaseSupersededError(range_id, held, cur)


class RangeLeaseGuard:
    """One shard writer's proof of tenure over one digest range.

    :meth:`claim` advances the epoch past the on-disk lease (the
    replacement writer's seat; the bump fences the previous holder),
    :meth:`acquire` takes a given epoch.  ``verify`` is the check the
    shard ``ServeDaemon`` makes before every append and state commit."""

    def __init__(self, root: str, range_id: int, epoch: int, owner: int,
                 nonce: str) -> None:
        self.root = root
        self.range_id = int(range_id)
        self.epoch = int(epoch)
        self.owner = int(owner)
        self.nonce = str(nonce)

    @classmethod
    def claim(cls, root: str, range_id: int, owner: int,
              nonce: str | None = None) -> "RangeLeaseGuard":
        nonce = nonce if nonce is not None else os.urandom(8).hex()
        cur = read_lease(root, range_id)
        epoch = (int(cur["epoch"]) + 1) if cur is not None else 1
        acquire_lease(root, range_id, epoch, owner, nonce)
        return cls(root, range_id, epoch, owner, nonce)

    @classmethod
    def acquire(cls, root: str, range_id: int, epoch: int, owner: int,
                nonce: str) -> "RangeLeaseGuard":
        acquire_lease(root, range_id, epoch, owner, nonce)
        return cls(root, range_id, epoch, owner, nonce)

    def verify(self) -> None:
        verify_lease(self.root, self.range_id, self.epoch, self.owner,
                     self.nonce)


__all__ = ["HeartbeatWriter", "LeaseSupersededError", "PeerMonitor",
           "RangeLeaseGuard", "acquire_lease", "heartbeat_interval_s",
           "heartbeat_path", "heartbeat_timeout_s", "lease_path",
           "read_lease", "verify_lease", "write_lease"]
