"""Persistent content-addressed MinHash signature store (the warm path's
cache): a copy of ``tse1m_tpu/cluster/store.py``, host numpy only.

A session's MinHash signature depends only on its raw id set and the hash
policy, so it is computed once and reused by every later run.
``cluster/pipeline.py`` probes this store and ships only the rows it
misses; ``cluster/incremental.py`` merges labels through the stored band
tables; ``cluster/kernels/score.py:bulk_topk_store`` scans every stored
row.  The on-disk layout is the JAX package's byte for byte, so a store
written by either package is read, merged into and appended to by the
other:

- ``store_manifest.json``: the policy key ``(n_hashes, seed, quant_bits,
  scheme)``, the CRC algorithm, the probe and layout generations and the
  committed shard list (and the serve journal when it is not empty).  A
  store opened under another policy refuses; a manifest with no
  ``scheme`` key loads as ``kminhash`` and a writable open adds the key.
- ``sig_NNNNN.npy`` / ``key_NNNNN.npy``: append-only shards of ``[M,
  n_hashes] uint32`` signatures (mmap-loaded) and ``[M, 2] uint64``
  content digests (``row_digests``), each CRC-framed in the manifest.
- ``state.json`` + ``state_NNNNN.npz``: the last run's LSH state (labels,
  per-band bucket tables, per-row shard locator, prefix fingerprint),
  what lets an accreted run merge labels; the json is the commit point.
- ``index_<fp>.keys.npy`` / ``index_<fp>.loc.npy``: the sorted probe
  index, materialized and mmap'd past ``TSE1M_SIG_STORE_IDX_ROWS`` rows.

Every write is tmp + ``os.replace``; a shard that fails its frame is moved
to ``quarantine/`` and its rows probe as misses and recompute; orphans are
swept at open; ``TSE1M_SIG_STORE_COMPACT_SHARDS`` shards fold into one at
open (the state's locator remapped exactly); ``TSE1M_SIG_STORE_MAX_MB``
evicts whole shards, least recently probed first; fresh shards get a
per-shard delta index until ``TSE1M_SIG_STORE_DELTA_SHARDS`` of them pile
up.  Digests are uint64 arithmetic and stay in numpy: torch has no
uint64 multiply.

The shard, compaction and state writes retry transient ``OSError``
(``utils/retry.py``) under the fault plane's ``store.sig.save``,
``store.compact.save`` and ``store.state.save`` seats.  A quarantined
shard or state and an evicted shard each record a degradation event
(``shard_quarantine``, ``state_quarantine``, ``shard_evicted``), as in the
JAX package; a shard quarantined while opening is also kept in
``quarantined_at_open``.  ``scrub`` walks the frames and reports the
``store_scrub_*`` keys; ``verify_signatures`` recomputes a seeded sample
of stored signatures from raw rows on the host, which catches corruption
that happened before a frame was written.  The trace plane's seats
(``trace_point``, ``shared_access``) sit where the JAX package's do, with
its site strings: append, evict, compact, refresh, and each swap of the
probe-index snapshot ``_snap``; the schedule explorer's ``store`` and
``store-evict`` scenarios drive them (``trace/explore.py``).  The mesh runs storeless
(``parallel/``); the pod path (``cluster_sessions_pod``) runs over
``ShardedSignatureStore``: one ``SignatureStore`` a digest range under a
shared root, each range written by its one owner under an epoch lease and
read by every process.  ``is_sharded_root`` tells such a root apart.
"""

from __future__ import annotations

import glob
import hashlib
import json
import logging
import os

import numpy as np

from ..observability import record_degradation
from ..observability.tracing import span
from ..resilience.faults import fault_point
from ..trace.hooks import shared_access, trace_point
from ..utils.atomic import atomic_write
from ..utils.retry import io_retry_policy, retry_call

log = logging.getLogger("tse1m_tpu_torch.store")

_MANIFEST = "store_manifest.json"
_STATE = "state.json"
_QUARANTINE_DIR = "quarantine"
# Serving idempotency journal bound: retries arrive within one client
# retry window, so a small LRU of recent request ids suffices — the
# oldest entries age out with each append's manifest commit.
_JOURNAL_MAX = 128

# The policy tuple: any of these changing invalidates every stored
# signature (different hash family / universe), so it is THE manifest key.
# ``scheme`` (cluster/schemes.py) joined the tuple after stores already
# existed in the wild: a manifest WITHOUT the key is a kminhash store by
# definition (the only family that existed when it was written), so
# normalization defaults absent -> "kminhash" on load and every newly
# written manifest carries the key explicitly.
POLICY_KEYS = ("n_hashes", "seed", "quant_bits", "scheme")


def normalize_policy(policy: dict) -> dict:
    """Canonical policy dict: ints for the numeric keys, the scheme
    string validated against the registry, absent scheme -> kminhash
    (pre-scheme stores must OPEN, not refuse — the migration contract)."""
    from .schemes import get_scheme

    out = {k: int(policy[k]) for k in POLICY_KEYS
           if k != "scheme" and k in policy}
    out["scheme"] = get_scheme(str(policy.get("scheme", "kminhash")))
    return out

# Past this many index rows the probe index is materialized + mmap'd
# instead of held in RAM (the bounded-memory story past ~10M rows).
_IDX_MMAP_ROWS_DEFAULT = 4_000_000
# Auto-compaction threshold: at open, this many committed shards fold
# into one (continuous fuzzing appends a small shard per day; without
# compaction a year is ~365 shards and every probe walks all of them).
_COMPACT_SHARDS_DEFAULT = 64


# -- CRC framing -------------------------------------------------------------
#
# CRC32C (Castagnoli) when the hardware-accelerated wheel is available;
# zlib's CRC-32 otherwise (ubiquitous, C-speed, equal burst-detection
# power — only the polynomial differs).  The algo that framed a store is
# recorded in its manifest, so verification never mixes polynomials; a
# store opened under the other algo is transparently re-framed.

try:  # pragma: no cover - depends on the environment's wheels
    from crc32c import crc32c as _crc_update

    _CRC_ALGO = "crc32c"
except ImportError:  # pragma: no cover
    from zlib import crc32 as _crc_update

    _CRC_ALGO = "crc32"


def file_crc(path: str, chunk_bytes: int = 1 << 20) -> int:
    """Frame checksum of a file's exact bytes, streamed (bounded RSS —
    verification must not page a multi-GB shard into memory)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                return int(crc)
            crc = _crc_update(block, crc)


# -- content digests ---------------------------------------------------------
#
# 128-bit per-row content hash, fully vectorised: two independent
# multilinear hashes over the row's uint32 ids (mod 2^64, random odd
# per-column coefficients from a FIXED seed — digests must be stable
# across processes and machines), finalised with a splitmix64 mix.
# Pairwise collision probability is ~2^-66; a collision would silently
# reuse another row's signature, so 64 bits alone would be too thin for
# a store that lives for thousands of runs.

_DIGEST_SEED = 0x74736531  # "tse1"
_coef_cache: dict[int, np.ndarray] = {}


def _digest_coeffs(set_size: int) -> np.ndarray:
    c = _coef_cache.get(set_size)
    if c is None:
        rng = np.random.default_rng(_DIGEST_SEED)
        c = (rng.integers(1, 1 << 63, size=(2, set_size), dtype=np.uint64)
             * np.uint64(2) + np.uint64(1))
        _coef_cache[set_size] = c
    return c


def _mix64(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


def row_digests(items: np.ndarray) -> np.ndarray:
    """[N, S] uint32 rows -> [N, 2] uint64 content digests.

    Hashes the RAW (pre-quantization) ids: the store policy carries the
    quantization width, so the same raw row under the same policy always
    maps to the same cached signature.
    """
    items = np.ascontiguousarray(items, dtype=np.uint32)
    if items.ndim != 2:
        raise ValueError(f"expected [N, S] items, got shape {items.shape}")
    n, s = items.shape
    coef = _digest_coeffs(s)
    out = np.empty((n, 2), np.uint64)
    step = 1 << 17  # bound the [step, S] uint64 temporary to ~64 MB
    for lo in range(0, n, step):
        v = items[lo:lo + step].astype(np.uint64)
        for lane in range(2):
            acc = (v * coef[lane][None, :]).sum(axis=1, dtype=np.uint64)
            acc ^= np.uint64(s)  # rows of different widths never collide
            out[lo:lo + step, lane] = _mix64(acc)
    return out


_DIG_DT = np.dtype([("a", "<u8"), ("b", "<u8")])


class _ProbeIndex:
    """One immutable generation of the sorted probe index: mode
    ('ram'|'mmap'), struct-view keys, raw [N, 2] keys, and the (shard,
    row) locator columns.  Published as a single attribute so concurrent
    readers snapshot it with one reference read."""

    __slots__ = ("mode", "keys", "keys2d", "shard", "row")

    def __init__(self, mode, keys, keys2d, shard, row):
        self.mode = mode
        self.keys = keys
        self.keys2d = keys2d
        self.shard = shard
        self.row = row


class _IndexSnapshot:
    """The store's whole probe view, base index plus the LSM delta runs,
    as one immutable object behind one reference
    (``SignatureStore._snap``): every layout change builds a fresh
    snapshot and swaps the reference, so a probe racing a ``refresh()``
    never reads a consolidated base with the deltas it replaced, or the
    old base without them."""

    __slots__ = ("base", "deltas")

    def __init__(self, base: "_ProbeIndex", deltas: tuple = ()) -> None:
        self.base = base
        self.deltas = tuple(deltas)

    @property
    def n_rows(self) -> int:
        return int(self.base.keys.shape[0]) + sum(
            int(d.keys.shape[0]) for d in self.deltas)


def _as_struct(digests: np.ndarray) -> np.ndarray:
    """[N, 2] uint64 -> [N] structured view (lexicographically sortable
    and searchsorted-able as one 128-bit key)."""
    d = np.ascontiguousarray(digests, dtype="<u8")
    return d.view(_DIG_DT).reshape(-1)


def digests_fingerprint(digests: np.ndarray) -> str:
    """Order-sensitive fingerprint of a digest sequence — the state's
    accretion-prefix check (`LshState.prefix_digest`)."""
    return hashlib.blake2b(
        np.ascontiguousarray(digests, dtype="<u8").tobytes(),
        digest_size=16).hexdigest()


class SignatureStore:
    """Content-addressed (digest -> MinHash signature) store + the last
    run's LSH state, under one directory.  Single-writer; readers see
    only manifest-committed shards.

    ``read_only=True`` opens the store as a pure reader (the pod path's
    non-owned digest ranges): probes and gathers work, but nothing on
    disk is touched — no manifest rewrites, no orphan sweep, no
    quarantine moves, no auto-compaction — so a reader can never race
    the range's single writer.  A shard that fails its frame still reads
    as absent (in-memory drop + degradation event); the owner quarantines
    it for real on its next open."""

    # The probe view is only ever rebound whole (one `_IndexSnapshot` per
    # layout change), never mutated in place.

    def __init__(self, directory: str, policy: dict,
                 max_bytes: int | None = None,
                 read_only: bool = False) -> None:
        self.directory = directory
        self.read_only = bool(read_only)
        os.makedirs(directory, exist_ok=True)
        self.policy = normalize_policy(policy)
        if max_bytes is None:
            mb = os.environ.get("TSE1M_SIG_STORE_MAX_MB")
            max_bytes = int(float(mb) * 2**20) if mb else None
        self.max_bytes = max_bytes
        self._manifest_path = os.path.join(directory, _MANIFEST)
        self._state_path = os.path.join(directory, _STATE)
        self._mmaps: dict[int, np.ndarray] = {}
        self._key_mmaps: dict[int, np.ndarray] = {}
        # Shards quarantined while opening THIS instance (scrub reports).
        self.quarantined_at_open: list[dict] = []
        # Serving-plane idempotency journal: request id -> the original
        # ack fields, committed with the SAME manifest write as the
        # shard append it describes — a retried ingest whose first
        # attempt already committed replays its ack instead of
        # re-absorbing (durable-once semantics across a writer restart).
        self.serve_journal: dict[str, dict] = {}
        prior = self._load_json(self._manifest_path)
        # Pre-scheme manifest: normalization defaults it to kminhash; a
        # writable open heals the manifest once so every committed
        # manifest carries the key explicitly from here on.
        heal_scheme = (prior is not None and not self.read_only
                       and "scheme" not in prior.get("policy", {}))
        if prior is not None:
            prior_policy = normalize_policy(prior.get("policy", {}))
            if prior_policy != self.policy:
                diff = {k: (prior_policy.get(k), self.policy.get(k))
                        for k in set(prior_policy) | set(self.policy)
                        if prior_policy.get(k) != self.policy.get(k)}
                raise ValueError(
                    f"signature store at {directory} was built under a "
                    "different policy — its cached signatures are wrong "
                    "for this run, every one of them; use a fresh "
                    "directory or delete it. mismatched (have, want): "
                    f"{diff}")
            self.shards = [dict(s) for s in prior.get("shards", [])]
            self._probe_gen = int(prior.get("probe_gen", 0))
            self.generation = int(prior.get("generation", 0))
            self.serve_journal = {
                str(k): dict(v)
                for k, v in prior.get("serve_journal", {}).items()}
            if prior.get("crc_algo", _CRC_ALGO) != _CRC_ALGO:
                if self.read_only:
                    # Cannot re-frame another host's shards; skip frame
                    # verification (legacy-entry semantics) rather than
                    # quarantine every shard under the wrong polynomial.
                    for entry in self.shards:
                        entry.pop("sig_crc", None)
                        entry.pop("key_crc", None)
                else:
                    self._reframe_all()
        else:
            self.shards = []
            self._probe_gen = 0
            self.generation = 0
        self._committed_fp = self._index_fingerprint()
        if prior is None or heal_scheme:
            self._write_manifest()
        self._validate_shards()
        if not self.read_only:
            self._sweep_orphans()
            if len(self.shards) >= self._compact_threshold():
                self.compact()
        self._build_index()

    @classmethod
    def open_existing(cls, directory: str,
                      max_bytes: int | None = None) -> "SignatureStore":
        """Open a store using the policy recorded in ITS OWN manifest —
        the scrub/compaction entry point, which must not require the
        caller to know the hash policy."""
        path = os.path.join(directory, _MANIFEST)
        try:
            with open(path, encoding="utf-8") as f:
                policy = json.load(f)["policy"]
        except (OSError, ValueError, KeyError) as e:
            raise FileNotFoundError(
                f"{directory} has no readable signature-store manifest "
                f"({e})") from e
        return cls(directory, policy, max_bytes=max_bytes)

    def _require_writable(self, op: str) -> None:
        if self.read_only:
            raise RuntimeError(
                f"signature store at {self.directory} is open read-only "
                f"(a non-owned pod digest range); {op}() belongs to the "
                "range's single writer")

    @staticmethod
    def _compact_threshold() -> int:
        return int(os.environ.get("TSE1M_SIG_STORE_COMPACT_SHARDS",
                                  _COMPACT_SHARDS_DEFAULT))

    @staticmethod
    def _idx_mmap_rows() -> int:
        return int(os.environ.get("TSE1M_SIG_STORE_IDX_ROWS",
                                  _IDX_MMAP_ROWS_DEFAULT))

    # -- shard files --------------------------------------------------------

    def _sig_path(self, sid: int) -> str:
        return os.path.join(self.directory, f"sig_{sid:05d}.npy")

    def _key_path(self, sid: int) -> str:
        return os.path.join(self.directory, f"key_{sid:05d}.npy")

    def _load_json(self, path: str) -> dict | None:
        if not os.path.exists(path):
            return None
        try:
            with open(path, encoding="utf-8") as f:
                return json.load(f)
        except (OSError, ValueError) as e:
            log.warning("unreadable %s (%s); treating as absent", path, e)
            return None

    def _write_manifest(self) -> None:
        if self.read_only:
            return  # readers never publish — the range owner's job
        # The store GENERATION advances exactly when the committed shard
        # layout changes (append / evict / compact / quarantine) — never
        # for LRU probe stamps — so a concurrent reader can answer "did
        # anything I mmap'd move?" with one integer compare (`refresh`).
        fp = self._index_fingerprint()
        if fp != self._committed_fp:
            self.generation += 1
            self._committed_fp = fp
        payload = {"policy": self.policy, "crc_algo": _CRC_ALGO,
                   "probe_gen": self._probe_gen,
                   "generation": self.generation,
                   "shards": self.shards}
        if self.serve_journal:
            # Only when non-empty, so batch-plane manifests stay
            # byte-identical to the pre-journal format.
            payload["serve_journal"] = self.serve_journal
        with atomic_write(self._manifest_path) as f:
            json.dump(payload, f)

    def _reframe_all(self) -> None:
        """Recompute every frame under the current CRC algo (a store
        moved between machines with/without the crc32c wheel)."""
        for entry in self.shards:
            sid = int(entry["id"])
            for key, path in (("sig_crc", self._sig_path(sid)),
                              ("key_crc", self._key_path(sid))):
                try:
                    entry[key] = file_crc(path)
                except OSError:
                    entry.pop(key, None)
        self._write_manifest()

    def _shard_ok(self, entry: dict) -> tuple[bool, str]:
        """(ok, reason).  A shard is good when both files exist, pass
        their CRC frames (a flipped byte ANYWHERE fails here), and
        mmap-load with the shapes the manifest promises.  Anything else
        must read as 'absent' so its rows recompute — never crash a warm
        run or feed it a silently-corrupt signature."""
        sid, rows = int(entry["id"]), int(entry["rows"])
        for crc_key, path in (("sig_crc", self._sig_path(sid)),
                              ("key_crc", self._key_path(sid))):
            want = entry.get(crc_key)
            if want is None:
                continue  # legacy unframed entry; `scrub --repair` frames it
            try:
                got = file_crc(path)
            except OSError as e:
                return False, f"unreadable ({e})"
            if int(got) != int(want):
                return False, (f"CRC frame mismatch on {os.path.basename(path)} "
                               f"(stored {want}, computed {got})")
        try:
            keys = np.load(self._key_path(sid), mmap_mode="r")
            sig = np.load(self._sig_path(sid), mmap_mode="r")
        except Exception as e:  # a torn shard reads as absent, whatever the failure
            return False, f"unloadable ({e})"
        if not (keys.shape == (rows, 2) and keys.dtype == np.uint64
                and sig.shape == (rows, self.policy["n_hashes"])
                and sig.dtype == np.uint32):
            return False, "shape/dtype mismatch vs manifest"
        return True, ""

    def _quarantine_file(self, path: str) -> str | None:
        """Move a corrupt artifact into quarantine/ (never delete — the
        operator may want the evidence); returns the new path."""
        if self.read_only or not os.path.exists(path):
            return None
        qdir = os.path.join(self.directory, _QUARANTINE_DIR)
        os.makedirs(qdir, exist_ok=True)
        base = os.path.basename(path)
        dest = os.path.join(qdir, base)
        k = 0
        while os.path.exists(dest):
            k += 1
            dest = os.path.join(qdir, f"{base}.{k}")
        os.replace(path, dest)
        return dest

    def _quarantine_shard(self, entry: dict, reason: str) -> None:
        sid = int(entry["id"])
        log.warning("store shard %d quarantined: %s — its %d row(s) will "
                    "probe as misses and recompute", sid, reason,
                    int(entry["rows"]))
        self._quarantine_file(self._sig_path(sid))
        self._quarantine_file(self._key_path(sid))
        self._mmaps.pop(sid, None)
        self._key_mmaps.pop(sid, None)
        event = record_degradation(
            "shard_quarantine", site="store",
            detail={"shard": sid, "rows": int(entry["rows"]),
                    "reason": reason[:200]})
        self.quarantined_at_open.append(event["detail"])

    def _validate_shards(self) -> None:
        good = []
        for entry in self.shards:
            ok, reason = self._shard_ok(entry)
            if ok:
                good.append(entry)
            else:
                self._quarantine_shard(entry, reason)
        if len(good) != len(self.shards):
            self.shards = good
            self._write_manifest()

    def _sweep_orphans(self) -> None:
        """Remove shard/temp/index files the manifest does not own —
        leftovers of a crash between file write and manifest commit
        (append OR compaction).  Runs at open, so a SIGKILL mid-
        compaction can never strand temp shards across runs."""
        owned = {self._sig_path(int(s["id"])) for s in self.shards}
        owned |= {self._key_path(int(s["id"])) for s in self.shards}
        owned |= set(self._index_paths())
        for pat in ("sig_*.npy", "key_*.npy", "*.tmp.npy", "*.tmp.npz",
                    "state_*.npz", "index_*.npy"):
            for p in glob.glob(os.path.join(self.directory, pat)):
                if p in owned or p == self._current_state_file():
                    continue
                if ".tmp." in p or pat in ("sig_*.npy", "key_*.npy",
                                           "state_*.npz", "index_*.npy"):
                    with _suppress_oserror():
                        os.remove(p)

    def _current_state_file(self) -> str | None:
        st = self._load_json(self._state_path)
        if st and st.get("file"):
            return os.path.join(self.directory, st["file"])
        return None

    # -- probe index --------------------------------------------------------

    def _index_fingerprint(self, shards: list | None = None) -> str:
        layout = [(int(s["id"]), int(s["rows"]))
                  for s in (self.shards if shards is None else shards)]
        return hashlib.blake2b(json.dumps(layout).encode(),
                               digest_size=6).hexdigest()

    def _index_paths(self) -> tuple[str, str]:
        fp = self._index_fingerprint()
        return (os.path.join(self.directory, f"index_{fp}.keys.npy"),
                os.path.join(self.directory, f"index_{fp}.loc.npy"))

    def _gather_index_arrays(self):
        keys, shard_of, row_of = [], [], []
        for s in self.shards:
            sid, rows = int(s["id"]), int(s["rows"])
            keys.append(np.asarray(np.load(self._key_path(sid),
                                           mmap_mode="r")))
            shard_of.append(np.full(rows, sid, np.int32))
            row_of.append(np.arange(rows, dtype=np.int32))
        keys2d = np.concatenate(keys)
        order = np.argsort(_as_struct(keys2d), kind="stable")
        loc = np.stack([np.concatenate(shard_of)[order],
                        np.concatenate(row_of)[order]], axis=1)
        return keys2d[order], loc

    def _delta_index_for(self, sid: int, keys2d: np.ndarray) -> "_ProbeIndex":
        """Small sorted index over ONE newly committed shard — the LSM
        delta layer.  A full `_build_index` re-sorts every key in the
        store (O(n log n), GIL-held); a serving daemon appending a batch
        per second cannot afford that per append, so fresh shards get a
        per-shard delta probed after the base index, and the base is
        re-consolidated only when deltas pile up or the shard layout
        shrinks (evict/compact/quarantine)."""
        order = np.argsort(_as_struct(keys2d), kind="stable").astype(np.int32)
        sorted2d = np.ascontiguousarray(keys2d[order])
        return _ProbeIndex("ram", _as_struct(sorted2d), sorted2d,
                           np.full(order.shape[0], sid, np.int32), order)

    @staticmethod
    def _delta_max() -> int:
        return int(os.environ.get("TSE1M_SIG_STORE_DELTA_SHARDS", 48))

    def _push_delta(self, sid: int, keys2d: np.ndarray) -> None:
        snap = self._snap
        if len(snap.deltas) >= self._delta_max():
            self._build_index()
            return
        trace_point("store.index.delta")
        # One swap: readers see the old snapshot or (base, deltas+run),
        # never a half-extended view.
        shared_access(self, "_snap", write=True, atomic=True)
        self._snap = _IndexSnapshot(
            snap.base, snap.deltas + (self._delta_index_for(sid, keys2d),))

    def _build_index(self) -> None:
        """(Re)build the sorted probe index and publish it as ONE
        snapshot object (`self._snap`: base + delta runs together) —
        `bulk_probe` reads the snapshot reference once, so a concurrent
        `refresh()` swapping in a newer generation can never hand a
        probe keys from one generation and locators from another, and a
        consolidation can never expose a cleared delta list against the
        pre-consolidation base.  Consolidates: the delta layer empties."""
        total = sum(int(s["rows"]) for s in self.shards)
        if total == 0:
            base = _ProbeIndex("ram", np.empty(0, _DIG_DT),
                               np.empty((0, 2), np.uint64),
                               np.empty(0, np.int32),
                               np.empty(0, np.int32))
        elif total < self._idx_mmap_rows():
            keys2d, loc = self._gather_index_arrays()
            base = _ProbeIndex("ram", _as_struct(keys2d), keys2d,
                               np.ascontiguousarray(loc[:, 0]),
                               np.ascontiguousarray(loc[:, 1]))
        else:
            # Bounded-memory mode: materialize the sorted index once per
            # shard-list generation, then PROBE VIA MMAP — steady-state
            # RSS is O(touched pages), not O(total keys).  Hits are
            # re-verified against the CRC-framed key shards below
            # (`_verify_hits`), so a rotted index byte downgrades to a
            # miss, never a wrong gather.
            keys_path, loc_path = self._index_paths()
            if not (os.path.exists(keys_path)
                    and os.path.exists(loc_path)):
                keys2d, loc = self._gather_index_arrays()
                for path, arr in ((keys_path, keys2d), (loc_path, loc)):
                    tmp = path + ".tmp.npy"
                    np.save(tmp, arr)
                    os.replace(tmp, path)
                del keys2d, loc
            keys2d_mm = np.load(keys_path, mmap_mode="r")
            loc_mm = np.load(loc_path, mmap_mode="r")
            base = _ProbeIndex("mmap",
                               keys2d_mm.view(_DIG_DT).reshape(-1),
                               keys2d_mm, loc_mm[:, 0], loc_mm[:, 1])
        trace_point("store.index.publish")
        shared_access(self, "_snap", write=True, atomic=True)
        self._snap = _IndexSnapshot(base)

    @property
    def n_rows(self) -> int:
        return self._snap.n_rows

    @property
    def _idx(self) -> "_ProbeIndex":
        """Base index of the current snapshot (tests/diagnostics)."""
        return self._snap.base

    @property
    def _idx_delta(self) -> list:
        """Delta runs of the current snapshot (tests/diagnostics)."""
        return list(self._snap.deltas)

    @property
    def _idx_mode(self) -> str:
        return self._snap.base.mode

    def refresh(self) -> bool:
        """Adopt shard-list changes committed by this directory's single
        writer since this handle last looked — the concurrent-reader
        half of the serving plane's reader/writer discipline.  Cheap
        when nothing changed: one manifest read and an integer
        generation compare.  When the generation moved, the committed
        shard list is re-read, shards this handle already trusted keep
        their frames (files are immutable once committed), NEW shards
        are frame-verified before use, and the probe index is rebuilt
        and swapped in as one atomic snapshot — a probe running in
        another thread keeps its old consistent view.  Returns True when
        the view changed."""
        for attempt in range(3):
            try:
                return self._refresh_once()
            except OSError as e:
                # A cross-process writer evicted/compacted between our
                # manifest read and the shard loads: re-read the
                # manifest — it now reflects the removal — rather than
                # surfacing a missing committed file to the reader.
                if not self.read_only or attempt == 2:
                    raise
                log.warning("refresh: shard vanished mid-adoption (%s); "
                            "re-reading the manifest", e)
        return False  # the loop always returns or raises

    def _refresh_once(self) -> bool:
        trace_point("store.refresh")
        meta = self._load_json(self._manifest_path)
        if meta is None:
            return False
        new_shards = [dict(s) for s in meta.get("shards", [])]
        gen = int(meta.get("generation", 0))
        if (gen == self.generation
                and self._index_fingerprint(new_shards)
                == self._index_fingerprint()):
            return False
        prior_policy = normalize_policy(meta.get("policy", self.policy))
        if prior_policy != self.policy:
            raise ValueError(
                f"signature store at {self.directory} changed policy "
                f"under this reader (have {prior_policy}, want "
                f"{self.policy})")
        known = self.shard_ids()
        good = []
        added = []
        for entry in new_shards:
            if int(entry["id"]) in known:
                good.append(entry)
                continue
            ok, reason = self._shard_ok(entry)
            if ok:
                good.append(entry)
                added.append(int(entry["id"]))
            else:
                # A reader never quarantines (that is the writer's job at
                # its next open); the bad shard just reads as absent.
                log.warning("refresh: new shard %s failed verification "
                            "(%s); treating as absent", entry.get("id"),
                            reason)
        removed = known - {int(e["id"]) for e in good}
        self.shards = good
        self.generation = gen
        self._committed_fp = self._index_fingerprint()
        live = self.shard_ids()
        for cache in (self._mmaps, self._key_mmaps):
            for sid in [s for s in cache if s not in live]:
                cache.pop(sid, None)
        if removed:
            self._build_index()  # evict/compact under us: consolidate
        else:
            # Append-only delta adoption: per-shard sorted indexes, no
            # O(total) re-sort — the serving reader refreshes once per
            # ingest generation and must stay cheap at millions of rows.
            # ALL adopted runs are built first and published in ONE
            # snapshot swap: pushing per shard exposed intermediate
            # views (e.g. the newest shard without its predecessor
            # after an eviction skip) that never existed as a committed
            # manifest generation.
            snap = self._snap
            runs = tuple(
                self._delta_index_for(
                    sid, np.asarray(np.load(self._key_path(sid))))
                for sid in added)
            if len(snap.deltas) + len(runs) > self._delta_max():
                self._build_index()
            else:
                trace_point("store.index.delta")
                shared_access(self, "_snap", write=True, atomic=True)
                self._snap = _IndexSnapshot(snap.base,
                                            snap.deltas + runs)
        return True

    @property
    def sig_bytes(self) -> int:
        h = self.policy["n_hashes"]
        return sum(int(s["rows"]) * h * 4 for s in self.shards)

    def shard_ids(self) -> set:
        return {int(s["id"]) for s in self.shards}

    def _key_mmap(self, sid: int) -> np.ndarray:
        mm = self._key_mmaps.get(sid)
        if mm is None:
            mm = np.load(self._key_path(sid), mmap_mode="r")
            self._key_mmaps[sid] = mm
        return mm

    def _verify_hits(self, digests: np.ndarray, hit: np.ndarray,
                     shard: np.ndarray, row: np.ndarray) -> None:
        """Mmap-index hits re-checked against the authoritative (CRC-
        framed) key shards: a corrupt index locator must downgrade to a
        miss-and-recompute, never gather another row's signature."""
        idx = np.flatnonzero(hit)
        if idx.size == 0:
            return
        d = np.ascontiguousarray(digests, dtype="<u8")
        for sid in np.unique(shard[idx]):
            sel = idx[shard[idx] == sid]
            actual = np.asarray(self._key_mmap(int(sid))[row[sel]])
            bad = sel[~np.all(actual == d[sel], axis=1)]
            if bad.size:
                log.warning("store index: %d locator(s) failed key "
                            "verification; treating as misses", bad.size)
                hit[bad] = False
                shard[bad] = -1
                row[bad] = -1

    def _touch_probed(self, shard: np.ndarray, hit: np.ndarray) -> None:
        """Stamp the shards this probe actually hit with a fresh probe
        generation (the LRU recency signal; persisted with the next
        manifest write).  Read-only handles skip it: their stamps could
        never reach the manifest, and a probe would write the shard
        entries under a racing ``refresh()``."""
        if self.read_only or not hit.any():
            return
        self._probe_gen += 1
        hot = set(int(s) for s in np.unique(shard[hit]))
        for entry in self.shards:
            if int(entry["id"]) in hot:
                entry["probe_gen"] = self._probe_gen

    def bulk_probe(self, digests: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """[N, 2] digests -> (hit [N] bool, shard [N] int32, row [N] int32).
        shard/row are -1 for misses."""
        n = digests.shape[0]
        shard = np.full(n, -1, np.int32)
        row = np.full(n, -1, np.int32)
        hit = np.zeros(n, bool)
        # ONE snapshot reference read; append/refresh/consolidation swap
        # `_snap` whole, so base and deltas can never be torn apart.
        shared_access(self, "_snap", write=False, atomic=True)
        snap = self._snap
        idx = snap.base
        deltas = snap.deltas
        if n == 0 or (idx.keys.shape[0] == 0 and not deltas):
            return hit, shard, row
        d2 = np.ascontiguousarray(digests, dtype="<u8")
        q = _as_struct(digests)
        if idx.keys.shape[0]:
            pos = np.searchsorted(idx.keys, q)
            inb = pos < idx.keys.shape[0]
            hit[inb] = np.all(
                np.asarray(idx.keys2d[pos[inb]]) == d2[inb], axis=1)
            shard[hit] = idx.shard[pos[hit]]
            row[hit] = idx.row[pos[hit]]
            if idx.mode == "mmap":
                self._verify_hits(digests, hit, shard, row)
        # LSM delta layer: shards appended since the last consolidation,
        # each with its own small sorted index (no overlap with the base
        # — consolidation empties the delta list).
        for dl in deltas:
            miss = np.flatnonzero(~hit)
            if miss.size == 0:
                break
            pos = np.searchsorted(dl.keys, q[miss])
            inb = pos < dl.keys.shape[0]
            sub = np.zeros(miss.size, bool)
            sub[inb] = np.all(dl.keys2d[pos[inb]] == d2[miss][inb], axis=1)
            sel = miss[sub]
            if sel.size:
                shard[sel] = dl.shard[pos[sub]]
                row[sel] = dl.row[pos[sub]]
                hit[sel] = True
        self._touch_probed(shard, hit)
        return hit, shard, row

    def _sig_mmap(self, sid: int) -> np.ndarray:
        mm = self._mmaps.get(sid)
        if mm is None:
            mm = np.load(self._sig_path(sid), mmap_mode="r")
            self._mmaps[sid] = mm
        return mm

    def load_signatures(self, shard: np.ndarray,
                        row: np.ndarray) -> np.ndarray:
        """Gather [K, n_hashes] uint32 signatures by (shard, row) pairs.
        Rows are gathered per shard in sorted order so the mmap reads
        pages sequentially."""
        k = int(shard.shape[0])
        out = np.empty((k, self.policy["n_hashes"]), np.uint32)
        for sid in np.unique(shard):
            sel = np.flatnonzero(shard == sid)
            rows = row[sel]
            order = np.argsort(rows, kind="stable")
            out[sel[order]] = self._sig_mmap(int(sid))[rows[order]]
        return out

    def load_digests(self, shard: np.ndarray, row: np.ndarray) -> np.ndarray:
        """Gather [K, 2] uint64 digests by (shard, row) pairs — the key
        files are the authoritative row identity, so the serve ``topk``
        verb answers in digests, not store rows.  Same per-shard sorted
        gather as `load_signatures` so the mmap reads pages
        sequentially."""
        k = int(shard.shape[0])
        out = np.empty((k, 2), np.uint64)
        for sid in np.unique(shard):
            sel = np.flatnonzero(shard == sid)
            rows = row[sel]
            order = np.argsort(rows, kind="stable")
            out[sel[order]] = self._key_mmap(int(sid))[rows[order]]
        return out

    # -- append -------------------------------------------------------------

    def journal_record(self, request_id: str, entry: dict) -> None:
        """Stage one serving ack under ``request_id`` so the NEXT
        manifest write (normally the append commit the ack describes)
        makes it durable atomically with the rows themselves.  Bounded:
        the oldest entries age out past ``_JOURNAL_MAX``."""
        self._require_writable("journal_record")
        self.serve_journal[str(request_id)] = dict(entry)
        while len(self.serve_journal) > _JOURNAL_MAX:
            self.serve_journal.pop(next(iter(self.serve_journal)))

    def append(self, digests: np.ndarray, sigs: np.ndarray) -> int:
        """Append (digest, signature) rows not already stored; returns the
        number of rows actually written.  Duplicate digests within the
        batch keep their first occurrence.  The shard write is atomic,
        CRC-framed, and retried (a torn write rewrites the temp files
        from scratch)."""
        self._require_writable("append")
        trace_point("store.append")
        if digests.shape[0] == 0:
            return 0
        hit, _, _ = self.bulk_probe(digests)
        fresh = np.flatnonzero(~hit)
        if fresh.size == 0:
            return 0
        d = np.ascontiguousarray(digests[fresh], dtype=np.uint64)
        s = np.ascontiguousarray(sigs[fresh], dtype=np.uint32)
        _, first = np.unique(_as_struct(d), return_index=True)
        first.sort()
        d, s = d[first], s[first]
        with span("store.append", rows=int(d.shape[0])):
            sid = 1 + max((int(e["id"]) for e in self.shards), default=-1)
            sig_path, key_path = self._sig_path(sid), self._key_path(sid)
            sig_tmp, key_tmp = sig_path + ".tmp.npy", key_path + ".tmp.npy"
            crcs = {}

            def write_shard() -> None:
                np.save(sig_tmp, s)
                np.save(key_tmp, d)
                # Frame BEFORE the rename: the checksum covers the bytes
                # the commit publishes, and a torn write re-frames.
                crcs["sig"] = file_crc(sig_tmp)
                crcs["key"] = file_crc(key_tmp)
                fault_point("store.sig.save", path=sig_tmp)
                os.replace(sig_tmp, sig_path)
                os.replace(key_tmp, key_path)

            retry_call(write_shard, policy=io_retry_policy(),
                       site="store.sig.save")
            self.shards.append({"id": sid, "rows": int(d.shape[0]),
                                "sig_crc": crcs["sig"],
                                "key_crc": crcs["key"],
                                "probe_gen": self._probe_gen})
            self._write_manifest()
            n_before = len(self.shards)
            self._evict(keep_sid=sid)
            if len(self.shards) != n_before:
                self._build_index()  # layout shrank: consolidate
            else:
                self._push_delta(sid, d)
            return int(d.shape[0])

    def _evict(self, keep_sid: int) -> None:
        """LRU whole-shard eviction down to ``max_bytes`` (never the
        shard just written): the shard with the OLDEST probe generation
        goes first — a shard no warm run has gathered from in ages is
        the cheapest recompute.  Safe by construction: evicted rows
        probe as misses and recompute; a stale LSH-state locator is
        detected at load (`load_state`)."""
        if not self.max_bytes:
            return
        while self.sig_bytes > self.max_bytes and len(self.shards) > 1:
            candidates = [e for e in self.shards
                          if int(e["id"]) != keep_sid]
            if not candidates:
                break
            victim = min(candidates,
                         key=lambda e: (int(e.get("probe_gen", 0)),
                                        int(e["id"])))
            trace_point("store.evict")
            self.shards.remove(victim)
            self._write_manifest()
            self._mmaps.pop(int(victim["id"]), None)
            self._key_mmaps.pop(int(victim["id"]), None)
            log.info("store eviction (LRU): dropped shard %d (%d rows, "
                     "probe_gen %d)", victim["id"], victim["rows"],
                     victim.get("probe_gen", 0))
            record_degradation("shard_evicted", site="store",
                               detail={"shard": int(victim["id"]),
                                       "rows": int(victim["rows"])})
            for p in (self._sig_path(int(victim["id"])),
                      self._key_path(int(victim["id"]))):
                with _suppress_oserror():
                    os.remove(p)

    # -- compaction ---------------------------------------------------------

    def compact(self, min_shards: int = 2) -> int:
        """Fold every committed shard into ONE large shard (many small
        daily appends -> one sequential-gather file).  Exact: the LSH
        state's per-row locator is remapped through the concatenation
        offsets, so a warm merge right after compaction behaves exactly
        as before it.  Returns the number of shards folded (0 = nothing
        to do).  Crash-safe: the new shard commits via the manifest like
        any append; a SIGKILL mid-write leaves temps the next open
        sweeps and the old shards untouched."""
        self._require_writable("compact")
        trace_point("store.compact")
        if len(self.shards) < max(2, min_shards):
            return 0
        old = list(self.shards)
        keys = np.concatenate([np.load(self._key_path(int(e["id"])))
                               for e in old])
        sigs = np.concatenate([np.load(self._sig_path(int(e["id"])))
                               for e in old])
        offsets = {}
        base = 0
        for e in old:
            offsets[int(e["id"])] = base
            base += int(e["rows"])
        sid = 1 + max(int(e["id"]) for e in old)
        sig_path, key_path = self._sig_path(sid), self._key_path(sid)
        sig_tmp, key_tmp = sig_path + ".tmp.npy", key_path + ".tmp.npy"
        crcs = {}

        def write_compacted() -> None:
            np.save(sig_tmp, sigs)
            np.save(key_tmp, keys)
            crcs["sig"] = file_crc(sig_tmp)
            crcs["key"] = file_crc(key_tmp)
            fault_point("store.compact.save", path=sig_tmp)
            os.replace(sig_tmp, sig_path)
            os.replace(key_tmp, key_path)

        retry_call(write_compacted, policy=io_retry_policy(),
                   site="store.compact.save")
        self.shards = [{"id": sid, "rows": int(keys.shape[0]),
                        "sig_crc": crcs["sig"], "key_crc": crcs["key"],
                        "probe_gen": max(int(e.get("probe_gen", 0))
                                         for e in old)}]
        self._write_manifest()  # the commit point: old shards now orphans
        self._remap_state(offsets, sid)
        self._mmaps.clear()
        self._key_mmaps.clear()
        for e in old:
            for p in (self._sig_path(int(e["id"])),
                      self._key_path(int(e["id"]))):
                with _suppress_oserror():
                    os.remove(p)
        self._sweep_orphans()
        self._build_index()
        log.info("store compaction: %d shards -> 1 (%d rows)", len(old),
                 int(keys.shape[0]))
        return len(old)

    def _remap_state(self, offsets: dict, new_sid: int) -> None:
        """Rewrite the LSH state's (shard, row) locator through the
        compaction offsets.  A state that cannot be remapped (torn,
        references an already-evicted shard) is dropped — the next run
        falls back to the union path, labels unchanged."""
        meta = self._load_json(self._state_path)
        if meta is None:
            return
        path = os.path.join(self.directory, str(meta.get("file")))
        try:
            with np.load(path) as z:
                payload = {k: z[k].copy() for k in z.files}
        except Exception as e:  # a torn state drops to the union run, whatever the failure
            log.warning("LSH state unreadable during compaction (%s); "
                        "dropping it", e)
            with _suppress_oserror():
                os.remove(self._state_path)
            return
        locator = payload.get("locator")
        if locator is None or (locator.size and not all(
                int(s) in offsets for s in np.unique(locator[:, 0]))):
            log.warning("LSH state references shard(s) outside this "
                        "compaction; dropping it")
            with _suppress_oserror():
                os.remove(self._state_path)
            return
        if locator.size:
            off = np.array([offsets[int(s)] for s in locator[:, 0]],
                           np.int64)
            payload["locator"] = np.stack(
                [np.full(locator.shape[0], new_sid, np.int32),
                 (locator[:, 1].astype(np.int64) + off).astype(np.int32)],
                axis=1)
        gen = int(meta.get("gen", 0)) + 1
        fname = f"state_{gen:05d}.npz"
        new_path = os.path.join(self.directory, fname)
        tmp = new_path + ".tmp.npz"

        def write_state() -> None:
            np.savez(tmp, **payload)
            fault_point("store.state.save", path=tmp)
            os.replace(tmp, new_path)

        retry_call(write_state, policy=io_retry_policy(),
                   site="store.state.save")
        meta.update(file=fname, gen=gen, crc=file_crc(new_path))
        with atomic_write(self._state_path) as f:
            json.dump(meta, f)
        old = path
        if old != new_path:
            with _suppress_oserror():
                os.remove(old)

    # -- scrub --------------------------------------------------------------

    def scrub(self, repair: bool = False, compact: bool = False) -> dict:
        """Walk the store and report frame health (the ``store_scrub_*``
        keys).  ``repair`` frames legacy (pre-CRC) shards and sweeps
        orphans; ``compact`` also folds the shards.  Corruption found here
        or at open is quarantined; scrub makes it visible and countable."""
        corrupt = list(self.quarantined_at_open)
        missing_crc = 0
        for entry in list(self.shards):
            ok, reason = self._shard_ok(entry)
            if not ok:
                self._quarantine_shard(entry, reason)
                self.shards.remove(entry)
                corrupt.append({"shard": int(entry["id"]),
                                "reason": reason})
                self._write_manifest()
                continue
            if entry.get("sig_crc") is None or entry.get("key_crc") is None:
                missing_crc += 1
                if repair:
                    sid = int(entry["id"])
                    entry["sig_crc"] = file_crc(self._sig_path(sid))
                    entry["key_crc"] = file_crc(self._key_path(sid))
                    self._write_manifest()
                    missing_crc -= 1
        state_ok = self._state_frame_ok()
        compacted = self.compact() if compact else 0
        if repair or compacted:
            self._sweep_orphans()
            self._build_index()
        qdir = os.path.join(self.directory, _QUARANTINE_DIR)
        quarantined = (len(os.listdir(qdir)) if os.path.isdir(qdir) else 0)
        return {
            "store_scrub_shards": len(self.shards),
            "store_scrub_rows": self.n_rows,
            "store_scrub_mb": round(self.sig_bytes / 2**20, 3),
            "store_scrub_corrupt": len(corrupt),
            "store_scrub_quarantined": quarantined,
            "store_scrub_missing_crc": missing_crc,
            "store_scrub_state_ok": bool(state_ok),
            "store_scrub_compacted": compacted,
            "store_scrub_repaired": bool(repair),
        }

    def verify_signatures(self, items: np.ndarray, sample: int = 256,
                          seed: int = 0) -> dict:
        """Recompute a seeded sample of the stored signatures of ``items``
        on the host (``scheme_host_signatures`` under the store's own
        policy, the rows quantized to its width) and compare.  The CRC
        frame only proves the bytes did not change since framing; this
        catches what was wrong before.  A shard holding a mismatching row
        is quarantined, so its rows recompute.  Returns the
        ``store_scrub_verify_*`` keys."""
        from .encode import quantize_ids
        from .schemes import make_params, scheme_host_signatures

        items = np.ascontiguousarray(items, dtype=np.uint32)
        digests = row_digests(items)
        hit, shard, row = self.bulk_probe(digests)
        idx = np.flatnonzero(hit)
        if idx.size > sample > 0:
            rng = np.random.default_rng(seed)
            idx = np.sort(rng.choice(idx, size=sample, replace=False))
        report = {"store_scrub_verify_sampled": int(idx.size),
                  "store_scrub_verify_mismatch": 0,
                  "store_scrub_verify_quarantined": 0,
                  "store_scrub_verify_ok": True}
        if idx.size == 0:
            return report
        stored = self.load_signatures(shard[idx], row[idx])
        rows = items[idx]
        qb = self.policy["quant_bits"]
        if qb:
            rows = quantize_ids(rows, qb)
        hp = make_params(self.policy["scheme"], self.policy["n_hashes"],
                         self.policy["seed"])
        want = scheme_host_signatures(rows, hp)
        bad = ~np.all(stored == want, axis=1)
        if not bad.any():
            return report
        bad_sids = {int(s) for s in np.unique(shard[idx][bad])}
        for entry in list(self.shards):
            if int(entry["id"]) in bad_sids:
                self._quarantine_shard(
                    entry, "sampled signature recompute mismatch "
                           "(pre-framing corruption)")
                self.shards.remove(entry)
        self._write_manifest()
        self._build_index()
        report.update(store_scrub_verify_mismatch=int(bad.sum()),
                      store_scrub_verify_quarantined=len(bad_sids),
                      store_scrub_verify_ok=False)
        return report

    def _state_frame_ok(self) -> bool:
        meta = self._load_json(self._state_path)
        if meta is None:
            return True  # no state is a valid (cold) store
        path = os.path.join(self.directory, str(meta.get("file")))
        if not os.path.exists(path):
            return False
        want = meta.get("crc")
        if want is None:
            return True  # legacy unframed state
        try:
            return int(file_crc(path)) == int(want)
        except OSError:
            return False

    # -- LSH run state ------------------------------------------------------

    def save_state(self, labels: np.ndarray, locator: np.ndarray,
                   tables: tuple[list, list], digests: np.ndarray,
                   n_bands: int, threshold: float) -> bool:
        """Commit the completed run's LSH state (atomically: npz first,
        then the json pointer carrying the npz's CRC frame).  Returns
        False — state intentionally not saved — when any row's signature
        is not locatable in the store (eviction raced the run); a warm
        merge must never gather from a shard that is gone."""
        self._require_writable("save_state")
        if locator.size and int(locator.min()) < 0:
            log.warning("not saving LSH state: %d row(s) have no stored "
                        "signature (store eviction?)",
                        int((locator[:, 0] < 0).sum()))
            return False
        prior = self._load_json(self._state_path) or {}
        gen = int(prior.get("gen", 0)) + 1
        fname = f"state_{gen:05d}.npz"
        path = os.path.join(self.directory, fname)
        tmp = path + ".tmp.npz"
        band_keys, band_reps = tables
        payload = {"labels": np.ascontiguousarray(labels, np.int32),
                   "locator": np.ascontiguousarray(locator, np.int32)}
        for b, (k, r) in enumerate(zip(band_keys, band_reps)):
            payload[f"bk_{b:03d}"] = np.ascontiguousarray(k, np.uint32)
            payload[f"br_{b:03d}"] = np.ascontiguousarray(r, np.int32)

        def write_state() -> None:
            np.savez(tmp, **payload)
            fault_point("store.state.save", path=tmp)
            os.replace(tmp, path)

        retry_call(write_state, policy=io_retry_policy(),
                   site="store.state.save")
        with atomic_write(self._state_path) as f:
            json.dump({"file": fname, "gen": gen,
                       "crc": file_crc(path),
                       "n_rows": int(labels.shape[0]),
                       "n_bands": int(n_bands),
                       "threshold": float(threshold),
                       "prefix_digest": digests_fingerprint(digests)}, f)
        # The probe generations stamped during this run ride along with
        # the state commit (the manifest is the LRU ledger).
        self._write_manifest()
        old = prior.get("file")
        if old and old != fname:
            with _suppress_oserror():
                os.remove(os.path.join(self.directory, old))
        return True

    def load_state(self, n_bands: int, threshold: float):
        """The last run's LSH state, or None when absent, torn, CRC-
        corrupt, built under different banding/threshold, or referencing
        evicted shards.  Unlike a sig-policy mismatch this does not
        refuse the run — the signatures are still valid; only the
        label-merge shortcut is.  A corrupt state npz is quarantined so
        the union fallback recomputes from verified signatures."""
        from .incremental import LshState

        meta = self._load_json(self._state_path)
        if meta is None:
            return None
        if (int(meta.get("n_bands", -1)) != int(n_bands)
                or float(meta.get("threshold", -1.0)) != float(threshold)):
            log.warning("LSH state at %s was built under different "
                        "banding/threshold; rebuilding", self.directory)
            return None
        path = os.path.join(self.directory, str(meta.get("file")))
        want_crc = meta.get("crc")
        if want_crc is not None and os.path.exists(path):
            try:
                got = file_crc(path)
            except OSError:
                got = None
            if got is None or int(got) != int(want_crc):
                log.warning("LSH state CRC frame mismatch; quarantining "
                            "and rebuilding via the union path")
                self._quarantine_file(path)
                with _suppress_oserror():
                    os.remove(self._state_path)
                record_degradation("state_quarantine", site="store",
                                   detail={"file": os.path.basename(path)})
                return None
        try:
            with np.load(path) as z:
                labels = z["labels"]
                locator = z["locator"]
                band_keys = [z[f"bk_{b:03d}"] for b in range(n_bands)]
                band_reps = [z[f"br_{b:03d}"] for b in range(n_bands)]
        except Exception as e:  # a torn state reads as absent, whatever the failure
            log.warning("LSH state unreadable (%s); rebuilding", e)
            return None
        if labels.shape[0] != int(meta["n_rows"]):
            return None
        if locator.size and not (set(np.unique(locator[:, 0]).tolist())
                                 <= self.shard_ids()):
            log.warning("LSH state references evicted shard(s); rebuilding")
            return None
        return LshState(n_rows=int(meta["n_rows"]),
                        labels=labels, locator=locator,
                        band_keys_sorted=band_keys, band_reps=band_reps,
                        prefix_digest=str(meta["prefix_digest"]))


class _suppress_oserror:
    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        return et is not None and issubclass(et, OSError)


# -- pod-scale sharding ------------------------------------------------------
#
# The 128-bit content digest space splits into ``n_ranges`` contiguous
# ranges by the top 32 bits of lane a, and each range is a complete
# SignatureStore under ``range_NNNN/`` of the shared root.  A range has one
# writer, its owner, which appends its novel rows; every process may open
# every range read-only, so the pod probe is complete without moving
# signatures between processes.  Ownership is the membership ledger's deal
# when one is given (``resilience/coordinator.MembershipLedger``), else the
# modulo deal ``r % n_processes``.

_TOPOLOGY = "pod_topology.json"


def is_sharded_root(root: str) -> bool:
    """True when ``root`` is a pod-sharded store (either package's)."""
    return os.path.exists(os.path.join(root, _TOPOLOGY))


def digest_range_ids(digests: np.ndarray, n_ranges: int) -> np.ndarray:
    """[N, 2] uint64 digests -> [N] int32 owning range: a contiguous split
    of the top 32 bits of lane a, the same on every process and machine
    (the pod store's and the sharded serving plane's deal)."""
    hi = np.ascontiguousarray(digests, dtype="<u8")[:, 0] >> np.uint64(32)
    return ((hi * np.uint64(n_ranges)) >> np.uint64(32)).astype(np.int32)


class ShardedSignatureStore:
    """The pod path's store: digest-range sharded under one shared root.

    ``root`` holds ``pod_topology.json`` (the range count and policy,
    written once at creation) and one ``range_NNNN/`` SignatureStore a
    range.  With a ``membership`` record (``MembershipLedger``) ownership
    is its deal and the store is lease-fenced: at open it acquires the
    current epoch's lease of every owned range, and every :meth:`append`
    verifies tenure first; a writer whose lease was superseded demotes to
    read-only and raises ``LeaseSupersededError`` (a ``lease_superseded``
    degradation event) with zero rows written.  Without one ownership is
    the modulo deal ``{r : r % n_processes == process_id}``.  Other ranges
    open read-only on first touch.  ``reassigned_ranges`` lists the owned
    ranges that changed writer at this epoch, each a
    ``shard_range_reassigned`` event."""

    def __init__(self, root: str, policy: dict, n_processes: int = 1,
                 process_id: int = 0, n_ranges: int | None = None,
                 max_bytes: int | None = None,
                 membership: dict | None = None) -> None:
        if os.path.exists(os.path.join(root, _MANIFEST)):
            raise ValueError(
                f"signature store at {root} is a single-host store "
                "(store_manifest.json present); a pod run needs a sharded "
                "root — point --sig-store at a fresh directory")
        self.root = root
        self.policy = normalize_policy(policy)
        self.process_id = int(process_id)
        self.n_processes = max(1, int(n_processes))
        self.max_bytes = max_bytes
        os.makedirs(root, exist_ok=True)
        topo_path = os.path.join(root, _TOPOLOGY)
        topo = None
        if os.path.exists(topo_path):
            try:
                with open(topo_path, encoding="utf-8") as f:
                    topo = json.load(f)
            except (OSError, ValueError) as e:
                log.warning("unreadable %s (%s); rewriting", topo_path, e)
        if topo is None:
            topo = {"n_ranges": int(n_ranges or self.n_processes),
                    "policy": self.policy}
            try:
                with atomic_write(topo_path) as f:
                    json.dump(topo, f)
            except OSError:
                # Every process races to commit the same topology at first
                # open; the loser's rename can fail, and the winner's file
                # is the commit.
                with open(topo_path, encoding="utf-8") as f:
                    topo = json.load(f)
        if normalize_policy(topo.get("policy") or {}) != self.policy:
            raise ValueError(
                f"sharded signature store at {root} was built under a "
                f"different policy (have {topo.get('policy')}, want "
                f"{self.policy}); use a fresh directory or delete it")
        self.n_ranges = int(topo["n_ranges"])
        self.epoch: int | None = None
        self.lease_nonce: str | None = None
        self.fenced = False
        if membership is not None:
            # A process opening after its ranges were re-dealt fences here,
            # before it can write a byte.
            from ..resilience.coordinator import acquire_lease

            self.epoch = int(membership["epoch"])
            self.lease_nonce = str(membership.get("nonce", ""))
            owners = {int(k): int(v)
                      for k, v in membership["owners"].items()}
            self.owned = [r for r in range(self.n_ranges)
                          if owners.get(r) == self.process_id]
            moved = {int(r) for r in membership.get("moved", [])}
            self.reassigned_ranges = [r for r in self.owned if r in moved]
            for r in self.reassigned_ranges:
                record_degradation(
                    "shard_range_reassigned", site="store.pod",
                    detail={"range": int(r), "epoch": self.epoch,
                            "to_process": self.process_id})
            for r in self.owned:
                acquire_lease(root, r, self.epoch, self.process_id,
                              self.lease_nonce)
        else:
            # Modulo deal (scrub and direct opens): a range whose creation
            # owner (owner == range id) is no longer a live process id was
            # inherited from a lost process.
            self.owned = [r for r in range(self.n_ranges)
                          if r % self.n_processes == self.process_id]
            self.reassigned_ranges = [r for r in self.owned
                                      if r >= self.n_processes
                                      and r < self.n_ranges]
            for r in self.reassigned_ranges:
                record_degradation(
                    "shard_range_reassigned", site="store.pod",
                    detail={"range": int(r), "from_process": int(r),
                            "to_process": self.process_id})
        self._stores: dict[int, SignatureStore] = {}

    is_sharded_root = staticmethod(is_sharded_root)

    @staticmethod
    def root_n_ranges(root: str, default: int = 1) -> int:
        """The range count of an existing root's topology, or ``default``
        for a root not created yet (the ledger deals the ranges the store
        will split)."""
        try:
            with open(os.path.join(root, _TOPOLOGY),
                      encoding="utf-8") as f:
                return int(json.load(f)["n_ranges"])
        except (OSError, ValueError, KeyError, TypeError):
            return int(default)

    def _range_dir(self, r: int) -> str:
        return os.path.join(self.root, f"range_{r:04d}")

    def range_store(self, r: int) -> SignatureStore:
        store = self._stores.get(r)
        if store is None:
            store = SignatureStore(self._range_dir(r), self.policy,
                                   max_bytes=self.max_bytes,
                                   read_only=r not in self.owned)
            self._stores[r] = store
        return store

    def owned_mask(self, digests: np.ndarray) -> np.ndarray:
        """Rows whose digest range this process writes."""
        rid = digest_range_ids(digests, self.n_ranges)
        return np.isin(rid, np.asarray(self.owned, dtype=np.int32))

    def probe(self, digests: np.ndarray
              ) -> tuple[np.ndarray, np.ndarray]:
        """[N, 2] digests -> (hit [N] bool, loc [N, 3] int32 (range,
        shard, row), -1 rows for misses), over every range."""
        n = digests.shape[0]
        hit = np.zeros(n, bool)
        loc = np.full((n, 3), -1, np.int32)
        if n == 0:
            return hit, loc
        rid = digest_range_ids(digests, self.n_ranges)
        for r in np.unique(rid):
            sel = np.flatnonzero(rid == r)
            h, sh, rw = self.range_store(int(r)).bulk_probe(digests[sel])
            hit[sel] = h
            loc[sel, 0] = int(r)
            loc[sel, 1] = sh
            loc[sel, 2] = rw
        loc[~hit] = -1
        return hit, loc

    def load_signatures(self, loc: np.ndarray) -> np.ndarray:
        """Gather [K, n_hashes] signatures by (range, shard, row) triples,
        every one a probe hit."""
        k = int(loc.shape[0])
        out = np.empty((k, self.policy["n_hashes"]), np.uint32)
        for r in np.unique(loc[:, 0]):
            sel = np.flatnonzero(loc[:, 0] == r)
            out[sel] = self.range_store(int(r)).load_signatures(
                loc[sel, 1], loc[sel, 2])
        return out

    def demote_to_read_only(self) -> None:
        """Self-fence: every open range store flips read-only and the
        owned set empties; the process may still probe and gather."""
        self.fenced = True
        self.owned = []
        for store in self._stores.values():
            store.read_only = True

    def _check_lease(self, r: int) -> None:
        """Prove tenure on range ``r`` just before appending; a
        superseded or unprovable lease demotes the store and raises."""
        from ..resilience.coordinator import (LeaseSupersededError,
                                              read_lease, verify_lease)

        if self.fenced:
            raise LeaseSupersededError(
                r, {"epoch": self.epoch, "owner": self.process_id,
                    "nonce": self.lease_nonce}, read_lease(self.root, r))
        if self.epoch is not None:
            try:
                verify_lease(self.root, r, self.epoch, self.process_id,
                             self.lease_nonce)
            except LeaseSupersededError as e:
                self.demote_to_read_only()
                record_degradation(
                    "lease_superseded", site="store.pod",
                    detail={"range": int(r), "held_epoch": int(self.epoch),
                            "process": self.process_id,
                            "current": e.current})
                log.warning("pod: %s", e)
                raise
            return
        # An unleased open of a lease-fenced root: a lease on disk means an
        # epoch governs the range, and a writer that cannot prove tenure
        # must fence.
        cur = read_lease(self.root, r)
        if cur is not None:
            self.demote_to_read_only()
            record_degradation(
                "lease_superseded", site="store.pod",
                detail={"range": int(r), "held_epoch": None,
                        "process": self.process_id, "current": cur})
            raise LeaseSupersededError(
                r, {"epoch": None, "owner": self.process_id,
                    "nonce": None}, cur)

    def append(self, digests: np.ndarray, sigs: np.ndarray) -> int:
        """Append novel rows into their owned range stores (rows of other
        ranges are skipped: their owners append them from the exchanged
        tails), each range's lease verified first."""
        if digests.shape[0] == 0:
            return 0
        rid = digest_range_ids(digests, self.n_ranges)
        written = 0
        for r in self.owned:
            sel = np.flatnonzero(rid == r)
            if sel.size:
                self._check_lease(r)
                written += self.range_store(r).append(digests[sel],
                                                      sigs[sel])
        return written

    @property
    def n_rows(self) -> int:
        return sum(self.range_store(r).n_rows
                   for r in range(self.n_ranges))

    def refresh(self) -> bool:
        """Adopt peers' committed appends in every opened range; True
        when any range changed."""
        changed = False
        for store in list(self._stores.values()):
            changed |= store.refresh()
        return changed

    def scrub(self, repair: bool = False, compact: bool = False) -> dict:
        """Scrub every range and sum the reports (repair and compact only
        the owned ranges: a reader never rewrites another's range)."""
        out: dict = {"store_scrub_ranges": self.n_ranges,
                     "store_scrub_owned_ranges": len(self.owned)}
        state_ok = True
        for r in range(self.n_ranges):
            mine = r in self.owned
            rep = self.range_store(r).scrub(repair=repair and mine,
                                            compact=compact and mine)
            for k, v in rep.items():
                if isinstance(v, bool):
                    continue
                out[k] = out.get(k, 0) + v if isinstance(v, (int, float)) \
                    else v
            state_ok = state_ok and rep.get("store_scrub_state_ok", True)
        out["store_scrub_state_ok"] = state_ok
        out["store_scrub_repaired"] = bool(repair)
        out["store_scrub_mb"] = round(out.get("store_scrub_mb", 0), 3)
        return out

    def verify_signatures(self, items: np.ndarray, sample: int = 256,
                          seed: int = 0) -> dict:
        """The sampled recompute (``SignatureStore.verify_signatures``)
        over every range, ``sample // n_ranges`` rows a range."""
        digests = row_digests(np.ascontiguousarray(items, np.uint32))
        rid = digest_range_ids(digests, self.n_ranges)
        out = {"store_scrub_verify_sampled": 0,
               "store_scrub_verify_mismatch": 0,
               "store_scrub_verify_quarantined": 0,
               "store_scrub_verify_ok": True}
        per = max(1, sample // self.n_ranges)
        for r in range(self.n_ranges):
            sel = np.flatnonzero(rid == r)
            if not sel.size:
                continue
            rep = self.range_store(int(r)).verify_signatures(
                items[sel], sample=per, seed=seed + r)
            for k in ("store_scrub_verify_sampled",
                      "store_scrub_verify_mismatch",
                      "store_scrub_verify_quarantined"):
                out[k] += rep[k]
            out["store_scrub_verify_ok"] &= rep["store_scrub_verify_ok"]
        return out


__all__ = ["POLICY_KEYS", "ShardedSignatureStore", "SignatureStore",
           "digest_range_ids", "digests_fingerprint", "file_crc",
           "is_sharded_root", "row_digests"]
