"""Pod supervision, epoch leases and file heartbeats: a port of
``tse1m_tpu/resilience/coordinator.py``, run by the sharded serving plane
and by the pod path (``cluster_sessions_pod``).

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

- **Membership.** :class:`MembershipLedger` keeps ``membership.json``
  under the pod directory: a monotonic epoch, the member set and the
  range -> owner deal.  Epochs advance on loss and on re-admission; the
  re-deal is elastic (only orphaned ranges and the minimal rebalance
  move).
- **Supervision.** :class:`PodSupervisor` is this process's heartbeat
  writer and peer monitor; :meth:`PodSupervisor.guarded` turns a phase
  that waits on a dead peer into :class:`HostLostError` within one
  heartbeat timeout.  The run nonce (:func:`negotiate_run_nonce`) names
  the run's exchange directory (:func:`exchange_dir`) and is its trace
  id.  Every wait across processes polls :meth:`PeerMonitor.check`.

The pod plane starts no ``torch.distributed`` world, so a survivor has
no collective to hang in and no teardown barrier to wait at.  The
``hostloss`` and ``zombie`` fault kinds (``faults.py``) silence this
process's heartbeats through :func:`suspend_heartbeats`, so peers declare
it lost through the production monitor.

The files are the JAX package's, byte for byte, so either package fences
the other's writer, reads its heartbeats and continues its ledger.
"""

from __future__ import annotations

import glob
import json
import logging
import os
import shutil
import threading
import time
from typing import Callable

from ..utils.atomic import atomic_write
from .watchdog import deadline_clock

log = logging.getLogger("tse1m_tpu_torch.resilience.coordinator")

# graftspec binding: the epoch-lease protocol this module implements
# is modeled by tse1m_tpu_torch/spec/lease.py; the lint conformance pass
# holds the two together.
SPEC_MODELS = ("lease",)

_HB_PREFIX = "hb_"
_XCH_PREFIX = "xch_"


def heartbeat_interval_s() -> float:
    return float(os.environ.get("TSE1M_HEARTBEAT_INTERVAL_S", 0.5))


def heartbeat_timeout_s() -> float:
    return float(os.environ.get("TSE1M_HEARTBEAT_TIMEOUT_S", 10.0))


class HostLostError(RuntimeError):
    """Peer process(es) declared lost (no heartbeat within the timeout)."""

    def __init__(self, lost: list, site: str = ""):
        self.lost = sorted(int(p) for p in lost)
        self.site = site
        super().__init__(
            f"{site or 'pod'}: host(s) {self.lost} declared lost — no "
            "heartbeat within the timeout; their digest ranges reassign "
            "to survivors and their rows recompute")


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


# The hostloss and zombie fault kinds set this: the process stays alive
# but stops beating, so peers declare it lost through the production
# monitor.
_suspended = threading.Event()

# Set when any monitor of this process declares a peer lost.
_loss_seen = threading.Event()


def saw_host_loss() -> bool:
    return _loss_seen.is_set()


def hard_exit_if_host_lost(code: int) -> int:
    """``os._exit(code)`` when this run declared a peer lost inside a
    ``torch.distributed`` world of more than one rank (a collective's
    teardown waits for the dead rank); otherwise return ``code``.  The pod
    plane starts no world, so there it always returns.  Durable state is
    written with atomic renames before callers get here."""
    import torch.distributed as dist

    if (_loss_seen.is_set() and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        log.warning("pod: host loss was declared this run — exiting "
                    "without torch.distributed teardown (code %d)", code)
        import sys

        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(code)
    return code


def suspend_heartbeats() -> None:
    _suspended.set()


def resume_heartbeats() -> None:
    _suspended.clear()


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
            if not _suspended.is_set():
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
                    _loss_seen.set()
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

    def check(self, site: str = "") -> None:
        """Raise :class:`HostLostError` when any peer is lost."""
        lost = self.poll()
        if lost:
            raise HostLostError(lost, site=site)


class PodSupervisor:
    """One a process: its heartbeat writer and the peer monitor, and
    :meth:`guarded`, which turns a phase hung on a dead peer into
    :class:`HostLostError`."""

    _POLL_S = 0.25

    def __init__(self, directory: str, n_processes: int, process_id: int,
                 interval_s: float | None = None,
                 timeout_s: float | None = None) -> None:
        self.directory = directory
        self.n_processes = int(n_processes)
        self.process_id = int(process_id)
        self.writer = HeartbeatWriter(directory, process_id,
                                      interval_s=interval_s)
        self.monitor = PeerMonitor(directory, n_processes, process_id,
                                   timeout_s=timeout_s)

    def start(self) -> "PodSupervisor":
        self.writer.start()
        return self

    def stop(self) -> None:
        self.writer.stop()

    def survivors(self) -> list:
        lost = set(self.monitor.poll())
        return [p for p in range(self.n_processes) if p not in lost]

    def guarded(self, fn: Callable, site: str = "pod.collective"):
        """Run ``fn`` on a daemon thread while the monitor polls: a lost
        peer raises :class:`HostLostError` here and the hung attempt is
        abandoned (its result discarded).  A ``fn`` that fails while a
        peer looks dead re-raises as :class:`HostLostError` once the
        monitor confirms within one timeout.  :class:`LeaseSupersededError`
        and :class:`HostLostError` relay verbatim: a fenced writer must
        not be sent down the failover path to re-execute."""
        box: dict = {}

        def worker() -> None:
            try:
                box["result"] = fn()
            except BaseException as e:  # graftlint: disable=broad-except -- relayed verbatim below
                box["error"] = e

        t = threading.Thread(target=worker, daemon=True,
                             name=f"tse1m-pod:{site}")
        t.start()
        while True:
            t.join(self._POLL_S)
            if not t.is_alive():
                break
            self.monitor.check(site=site)
        if "error" in box:
            err = box["error"]
            if isinstance(err, (LeaseSupersededError, HostLostError)):
                raise err
            deadline = deadline_clock() + self.monitor.timeout_s
            while deadline_clock() < deadline:
                if self.monitor.poll():
                    break
                time.sleep(self._POLL_S)
            lost = self.monitor.poll()
            if lost:
                raise HostLostError(lost, site=site) from err
            raise err
        return box.get("result")


# -- the run nonce and the exchange directory ---------------------------------
#
# The pod directory outlives runs, so a run's exchange files live under a
# per-run directory named by a nonce the leader publishes, stamped with its
# heartbeat run id.  A peer accepts the nonce only under a leader heartbeat
# it has seen advance: a previous run leaves a nonce file and a leader
# heartbeat that agree with each other, and a peer that starts before this
# run's leader has beaten would otherwise adopt that dead run's nonce and
# wait in another exchange directory than the leader's.

_RUN_NONCE = "run_nonce.json"


def negotiate_run_nonce(supervisor: "PodSupervisor | None" = None,
                        pod_dir: str | None = None) -> str:
    """One hex nonce shared by every process of this run: process 0 mints
    and publishes it, peers poll for it under a leader heartbeat they have
    seen advance (checking the monitor, so a leader that dies first raises
    :class:`HostLostError`).  A single process mints its own.  Every
    process pins it as the run's trace id."""
    nonce = _negotiate_run_nonce(supervisor, pod_dir)
    from ..observability.tracing import adopt_trace

    adopt_trace(nonce)
    return nonce


def _negotiate_run_nonce(supervisor: "PodSupervisor | None",
                         pod_dir: str | None) -> str:
    if supervisor is None or supervisor.n_processes == 1:
        return os.urandom(8).hex()
    pod_dir = pod_dir or supervisor.directory
    path = os.path.join(pod_dir, _RUN_NONCE)
    if supervisor.process_id == 0:
        nonce = os.urandom(8).hex()
        with atomic_write(path) as f:
            json.dump({"nonce": nonce,
                       "leader_run": supervisor.writer.run_id}, f)
        return nonce
    deadline = deadline_clock() + supervisor.monitor.timeout_s * 2
    first = None  # the leader's beat when this peer started to wait
    while True:
        beat = None
        try:
            with open(heartbeat_path(pod_dir, 0), encoding="utf-8") as f:
                d = json.load(f)
            beat = (d.get("run"), int(d["seq"]))
        except (OSError, ValueError, KeyError, TypeError):
            pass
        if first is None:
            first = beat or (None, -1)
        rec = None
        try:
            with open(path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, ValueError):
            pass
        if (rec and beat is not None and beat != first
                and beat[0] is not None
                and rec.get("leader_run") == beat[0]
                and rec.get("nonce")):
            return str(rec["nonce"])
        supervisor.monitor.check(site="pod.nonce")
        if deadline_clock() > deadline:
            raise TimeoutError(
                "pod: no run nonce from process 0 within "
                f"{supervisor.monitor.timeout_s * 2:.0f}s (it is beating "
                "but has not announced a run)")
        time.sleep(0.1)


def exchange_dir(pod_dir: str, nonce: str,
                 sweep_stale: bool = False) -> str:
    """This run's exchange directory under the pod directory; process 0
    passes ``sweep_stale=True`` to remove earlier runs' (runs against one
    store are sequential, so a surviving directory is garbage)."""
    if sweep_stale:
        for old in glob.glob(os.path.join(pod_dir, _XCH_PREFIX + "*")):
            if os.path.basename(old) != _XCH_PREFIX + nonce:
                shutil.rmtree(old, ignore_errors=True)
    path = os.path.join(pod_dir, _XCH_PREFIX + nonce)
    os.makedirs(path, exist_ok=True)
    return path


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


# -- the membership ledger ----------------------------------------------------

_MEMBERSHIP = "membership.json"


class MembershipLedger:
    """``membership.json`` under the pod directory: a monotonic epoch, the
    member set and the digest-range -> owner deal.

    Epochs advance on loss and on re-admission.  The re-deal is elastic: a
    range keeps its owner while that owner is a member under the balanced
    target, and only orphaned and overflow ranges move, so labels and warm
    state stay put for every unmoved range.  One process writes each
    advance (the leader at bootstrap, the failover survivor mid-run);
    peers adopt it through :meth:`wait_for`."""

    def __init__(self, pod_dir: str, n_ranges: int) -> None:
        self.pod_dir = pod_dir
        self.n_ranges = int(n_ranges)
        self.path = os.path.join(pod_dir, _MEMBERSHIP)
        os.makedirs(pod_dir, exist_ok=True)

    def load(self) -> dict | None:
        """The current record, or None (absent or torn)."""
        try:
            with open(self.path, encoding="utf-8") as f:
                d = json.load(f)
            return {"epoch": int(d["epoch"]), "nonce": str(d.get("nonce", "")),
                    "members": sorted(int(m) for m in d["members"]),
                    "owners": {int(k): int(v)
                               for k, v in d["owners"].items()},
                    "moved": sorted(int(r) for r in d.get("moved", [])),
                    "prev_members": sorted(
                        int(m) for m in d.get("prev_members", []))}
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def _write(self, rec: dict) -> None:
        with atomic_write(self.path) as f:
            json.dump(rec, f)

    @staticmethod
    def _deal(prior_owners: dict | None, members: list,
              n_ranges: int) -> tuple[dict, list]:
        """(owners, moved ranges): every range stays with its prior owner
        while that owner is a member under the target ceil(n_ranges /
        members); the rest go to the least-loaded member (ties to the
        lowest id).  Deterministic: every process computes the same."""
        members = sorted(int(m) for m in members)
        target = -(-int(n_ranges) // len(members))
        counts = {m: 0 for m in members}
        owners: dict = {}
        pool = []
        for r in range(int(n_ranges)):
            o = (prior_owners or {}).get(r)
            if o in counts and counts[o] < target:
                owners[r] = o
                counts[o] += 1
            else:
                pool.append(r)
        moved = []
        for r in pool:
            m = min(members, key=lambda p: (counts[p], p))
            owners[r] = m
            counts[m] += 1
            if (prior_owners or {}).get(r) != m:
                moved.append(r)
        return owners, moved

    def bootstrap(self, members: list, nonce: str) -> dict:
        """Open this run's membership: the prior epoch and deal when the
        member set is unchanged, else the next epoch (a grown set is a
        re-admission)."""
        prior = self.load()
        members = sorted(int(m) for m in members)
        if prior is not None and prior["members"] == members:
            rec = {**prior, "nonce": str(nonce), "moved": []}
            self._write(rec)
            return rec
        if prior is None:
            reason = "bootstrap"
        elif set(members) - set(prior["members"]):
            reason = "host_readmitted"
        else:
            reason = "membership_change"
        return self._advance(prior, members, nonce, reason)

    def advance(self, members: list, nonce: str, reason: str) -> dict:
        """Force the next epoch (the failover survivor's seat)."""
        return self._advance(self.load(), sorted(int(m) for m in members),
                             nonce, reason)

    def _advance(self, prior: dict | None, members: list, nonce: str,
                 reason: str) -> dict:
        epoch = int(prior["epoch"]) + 1 if prior is not None else 0
        owners, moved = self._deal(
            prior.get("owners") if prior is not None else None,
            members, self.n_ranges)
        if prior is None:
            moved = []  # a fresh deal reassigns nothing
        rec = {"epoch": epoch, "nonce": str(nonce), "members": members,
               "owners": owners, "moved": sorted(moved),
               "prev_members": (prior or {}).get("members", [])}
        self._write(rec)
        if prior is not None:
            from ..observability import record_degradation

            record_degradation(
                "epoch_advance", site="coordinator.membership",
                detail={"epoch": epoch, "reason": reason,
                        "members": members, "moved": sorted(moved)})
            for p in sorted(set(members) - set(prior["members"])):
                record_degradation(
                    "host_readmitted", site="coordinator.membership",
                    detail={"process": int(p), "epoch": epoch})
            log.warning("pod membership epoch %d (%s): members %s, "
                        "moved ranges %s", epoch, reason, members,
                        sorted(moved))
        return rec

    def wait_for(self, nonce: str, monitor: "PeerMonitor | None" = None,
                 timeout_s: float | None = None) -> dict:
        """Adopt the record the leader wrote for this run (matched by
        nonce), polling the monitor so a leader death raises
        :class:`HostLostError` instead of hanging."""
        budget = (timeout_s if timeout_s is not None
                  else (monitor.timeout_s * 2 if monitor is not None
                        else heartbeat_timeout_s() * 2))
        deadline = deadline_clock() + budget
        while True:
            rec = self.load()
            if rec is not None and rec["nonce"] == str(nonce):
                return rec
            if monitor is not None:
                monitor.check(site="pod.membership")
            if deadline_clock() > deadline:
                raise TimeoutError(
                    f"pod: no membership record for nonce {nonce} within "
                    f"{budget:.0f}s (the leader is beating but has not "
                    "published the epoch deal)")
            time.sleep(0.1)


__all__ = ["HeartbeatWriter", "HostLostError", "LeaseSupersededError",
           "MembershipLedger", "PeerMonitor", "PodSupervisor",
           "RangeLeaseGuard", "acquire_lease", "exchange_dir",
           "hard_exit_if_host_lost", "heartbeat_interval_s",
           "heartbeat_path", "heartbeat_timeout_s", "lease_path",
           "negotiate_run_nonce", "read_lease", "resume_heartbeats",
           "saw_host_loss", "suspend_heartbeats", "verify_lease",
           "write_lease"]
