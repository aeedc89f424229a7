"""Schedule exploration over the serve and store planes' concurrency: a
port of ``tse1m_tpu/trace/explore.py``, over the port's own objects.

Each *scenario* builds the objects fresh in a temporary directory and
hands the scheduler a set of named thread bodies that run the real
critical sections, with no mocks and no test-only branches.  The sizes,
seeds, invariants and environment are the JAX package's:

- ``serve``: the daemon's ingest-absorb-swap path (``_ingest_batch``)
  racing membership queries and a read-only store handle doing
  ``refresh()`` and probes.  Every query answers from one published
  snapshot (its labels for acknowledged rows equal the cold host
  clustering of that generation's row prefix, element for element), the
  generations each thread sees never decrease, and a reader's probe
  coverage is always a whole committed generation.
- ``store``: ``SignatureStore.append`` (the delta threshold forced low, so
  appends consolidate) racing a read-only handle's ``refresh()`` and
  ``bulk_probe`` from two more threads.  A probe sees a committed
  generation, never a torn index, and the gathered signatures are the
  appended ones.
- ``store-evict``: the same under a byte cap, so appends evict shards;
  probe coverage equals a committed (possibly evicted) shard view.
- ``router``: ``ShardRouter`` over two shard daemons, a writer ingesting
  through the router, a second writer replaying one batch under the same
  request id, and a querier broadcasting.  The port's read verbs fan out
  in parallel: under the scheduler the querier's per-shard forwards run
  on child threads it steps (``q.0``, ``q.1``), so their interleavings
  with the writers are explored too.  The replayed slice is never
  absorbed twice, the two acks of one request id carry the same labels,
  exact duplicates share their original's label, shard generations
  never regress and a routed label, once seen, never changes.
- ``replica``: an evicting source writer racing ``stream_shards`` and a
  replica's ``refresh()``.  The replica's probe coverage is always a
  committed source view and its adopted generation never decreases.

:func:`explore` drives N seeded PCT schedules plus a bounded exhaustive
enumeration of decision prefixes; every failure raises
:class:`~.sched.ScheduleError` whose message carries the replay string
(``v1:fix:...``), and :func:`replay` re-runs one.

``device`` places the daemons' and the replica's device work (the card
unless the caller asks for the CPU).  The daemons sign novel rows on the
host (``signer="host"``, as the JAX package's scenarios do) unless the
caller passes ``signer="device"``; then the MinHash kernels run from the
scheduled threads.
"""

from __future__ import annotations

import os
import shutil
import tempfile

from ..device import resolve_device
from .hooks import Tracer, clear_tracer, install_tracer
from .lockset import LocksetChecker
from .sched import DeterministicScheduler, Schedule, ScheduleError

_POLICY = {"n_hashes": 16, "seed": 0, "quant_bits": 0}
_BATCH = 4
_N_ROWS = 12


def _serve_scenario(tmp: str, device, signer: str):
    import numpy as np

    from ..cluster.host import host_cluster
    from ..cluster.pipeline import ClusterParams
    from ..cluster.store import SignatureStore, row_digests
    from ..data.synth import synth_session_sets
    from ..serve.daemon import ServeDaemon

    params = ClusterParams(n_hashes=_POLICY["n_hashes"], n_bands=4,
                           seed=_POLICY["seed"])
    items = synth_session_sets(_N_ROWS, set_size=16, seed=5,
                               dup_fraction=0.0)[0]
    digests = row_digests(items)
    expected = {0: np.empty(0, np.int32)}
    for k in range(_BATCH, _N_ROWS + 1, _BATCH):
        expected[k] = host_cluster(items[:k], n_hashes=params.n_hashes,
                                   n_bands=params.n_bands,
                                   seed=params.seed)
    daemon = ServeDaemon(os.path.join(tmp, "store"), params=params,
                         device=device, signer=signer)
    reader = SignatureStore(os.path.join(tmp, "store"),
                            daemon.store.policy, read_only=True)
    query_obs: list = []
    probe_obs: list = []

    def writer() -> None:
        for lo in range(0, _N_ROWS, _BATCH):
            daemon._ingest_batch(items[lo:lo + _BATCH])
            idx = daemon._index
            k = idx.n_rows
            if not np.array_equal(idx.labels, expected[k]):
                raise AssertionError(
                    f"absorb broke label parity at generation "
                    f"{idx.generation}: {idx.labels.tolist()} != "
                    f"{expected[k].tolist()}")

    def querier() -> None:
        for _ in range(4):
            resp = daemon.query(items)
            query_obs.append((int(resp["generation"]),
                              np.asarray(resp["known"]).copy(),
                              np.asarray(resp["labels"]).copy()))

    def refresher() -> None:
        for _ in range(3):
            reader.refresh()
            hit, _, _ = reader.bulk_probe(digests)
            probe_obs.append(np.asarray(hit).copy())

    def validate() -> None:
        last_gen = -1
        for gen, known, labels in query_obs:
            if gen < last_gen:
                raise AssertionError(
                    f"query generations regressed: {gen} after {last_gen}")
            last_gen = gen
            k = gen * _BATCH
            if not (known[:k].all() and not known[k:].any()):
                raise AssertionError(
                    f"membership at generation {gen} is not the row "
                    f"prefix of that snapshot: {known.tolist()}")
            if not np.array_equal(labels[:k], expected[k]):
                raise AssertionError(
                    f"query labels at generation {gen} do not match the "
                    f"cold clustering of its {k}-row prefix: "
                    f"{labels[:k].tolist()} != {expected[k].tolist()}")
        for hit in probe_obs:
            k = int(hit.sum())
            if k % _BATCH or not hit[:k].all():
                raise AssertionError(
                    "reader probe saw a torn store view: hits "
                    f"{np.flatnonzero(hit).tolist()} are not a whole "
                    "committed generation")

    bodies = {"w": writer, "q": querier, "r": refresher}
    return bodies, validate


def _store_scenario(tmp: str, evict: bool, reader_cls=None):
    import numpy as np

    from ..cluster.store import SignatureStore

    if reader_cls is None:
        reader_cls = SignatureStore
    rng = np.random.default_rng(11)
    n_batches, rows = 5, 3
    digests = rng.integers(1, 2**63, size=(n_batches * rows, 2),
                           dtype=np.uint64)
    sigs = rng.integers(0, 2**32, size=(n_batches * rows,
                                        _POLICY["n_hashes"]),
                        dtype=np.uint64).astype(np.uint32)
    max_bytes = (2 * rows * _POLICY["n_hashes"] * 4 + 1) if evict else None
    writer_store = SignatureStore(os.path.join(tmp, "store"), _POLICY,
                                  max_bytes=max_bytes)
    reader = reader_cls(os.path.join(tmp, "store"), _POLICY,
                        read_only=True)
    probe_obs: list = []
    batch_of = np.repeat(np.arange(n_batches), rows)
    # Every manifest state the writer commits, in order: the append
    # commit (shard added, eviction pending) and each one-victim eviction
    # step write the manifest, and a reader may adopt any of them.
    # Victims go lowest shard id first (the append's probe misses, so
    # probe_gen never advances here).
    committed: list = [frozenset()]
    shard_sets: list = [set()]
    live: set = set()
    for b in range(n_batches):
        live = live | {b}
        shard_sets.append(set(live))
        while evict and len(live) > 2:
            live = live - {min(live)}
            shard_sets.append(set(live))
    for s in shard_sets:
        committed.append(frozenset(
            i for i in range(n_batches * rows) if int(batch_of[i]) in s))

    def writer() -> None:
        for b in range(n_batches):
            blk = slice(b * rows, (b + 1) * rows)
            writer_store.append(digests[blk], sigs[blk])

    def refresher() -> None:
        for _ in range(4):
            reader.refresh()
            live = {int(e["id"]) for e in reader.shards}
            hit, _, _ = reader.bulk_probe(digests)
            view = frozenset(int(i) for i in np.flatnonzero(hit))
            want = frozenset(i for i in range(n_batches * rows)
                             if int(batch_of[i]) in live)
            if view != want:
                raise AssertionError(
                    f"refresh adopted shards {sorted(live)} but probe "
                    f"coverage is {sorted(view)} (want {sorted(want)}) "
                    "— torn probe index")

    def prober() -> None:
        for _ in range(6):
            hit, shard, row = reader.bulk_probe(digests)
            view = frozenset(int(i) for i in np.flatnonzero(hit))
            probe_obs.append(view)
            if not evict and hit.any():
                got = reader.load_signatures(shard[hit], row[hit])
                if not np.array_equal(got, sigs[hit]):
                    raise AssertionError(
                        "probe locators gathered wrong signatures "
                        "(torn index published mid-consolidation)")

    def validate() -> None:
        valid = set(committed)
        for view in probe_obs:
            if view not in valid:
                raise AssertionError(
                    "probe saw a store view that was never committed "
                    f"(torn index): rows {sorted(view)}; committed "
                    f"views: {[sorted(v) for v in valid]}")

    bodies = {"w": writer, "rp": prober, "rr": refresher}
    return bodies, validate


def router_corpus():
    """The ``router`` scenario's 12 rows: a corpus that populates both
    digest ranges and carries exact duplicates (only exact duplicates
    co-shard): unique rows rejection-sampled until each range owns five,
    then copies of rows 0 and 1."""
    import numpy as np

    from ..cluster.store import digest_range_ids, row_digests

    rng = np.random.default_rng(7)
    picked: list = []
    want = {0: 5, 1: 5}
    while want[0] or want[1]:
        row = rng.integers(0, 2**32, size=(1, 16),
                           dtype=np.int64).astype(np.uint32)
        rid = int(digest_range_ids(row_digests(row), 2)[0])
        if want[rid]:
            want[rid] -= 1
            picked.append(row[0])
    return np.stack(picked + [picked[0], picked[1]])  # 12 rows, 10 unique


def _router_scenario(tmp: str, device, signer: str, router_cls=None):
    import numpy as np

    from ..cluster.pipeline import ClusterParams
    from ..serve.daemon import ServeDaemon
    from ..serve.router import ShardRouter
    from ..serve.server import decode_vectors
    from . import sync as tsync

    if router_cls is None:
        router_cls = ShardRouter
    params = ClusterParams(n_hashes=_POLICY["n_hashes"], n_bands=4,
                           seed=_POLICY["seed"])
    items = router_corpus()
    daemons = {sid: ServeDaemon(os.path.join(tmp, f"range_{sid:04d}"),
                                params=params, device=device, signer=signer)
               for sid in (0, 1)}

    def direct(daemon, ing_lock):
        # One ingest-loop thread serializes a shard's absorbs behind its
        # TCP queue; the named lock models exactly that, while queries
        # stay lock-free (snapshot reads).
        def call(msg: dict, timeout_s=None) -> dict:
            if msg.get("op") == "ingest":
                rid = msg.get("request_id")
                with ing_lock:
                    return daemon._ingest_batch(
                        decode_vectors(msg),
                        request_id=str(rid) if rid else None)
            res = daemon.query(decode_vectors(msg))
            return {"ok": True,
                    "labels": res["labels"].astype(int).tolist(),
                    "known": res["known"].astype(bool).tolist(),
                    "generation": int(res["generation"])}
        return call

    router = router_cls({
        sid: direct(d, tsync.Lock(f"shard{sid}.ingest"))
        for sid, d in daemons.items()})
    acks: list = []
    fix0_acks: list = []
    query_obs: list = []

    def writer() -> None:
        r = router.ingest(items[0:4], request_id="fix0")
        fix0_acks.append(r)
        acks.append(r)
        acks.append(router.ingest(items[4:8]))
        acks.append(router.ingest(items[8:12]))

    def replayer() -> None:
        # Same content, same request id: whichever of the two "fix0"
        # submissions runs second must replay the per-shard journal acks,
        # not absorb a second copy.
        r = router.ingest(items[0:4], request_id="fix0")
        fix0_acks.append(r)

    def querier() -> None:
        for _ in range(3):
            resp = router.query(items)
            query_obs.append((np.asarray(resp["labels"]).copy(),
                              np.asarray(resp["known"]).copy(),
                              dict(resp["shard_generations"])))

    def validate() -> None:
        try:
            _validate()
        finally:
            router.close()

    def _validate() -> None:
        for a in acks + fix0_acks:
            if int(a["acked"]) != 4 or len(a["labels"]) != 4:
                raise AssertionError(f"short ack: {a}")
        l0, l1 = fix0_acks[0]["labels"], fix0_acks[1]["labels"]
        if l0 != l1:
            raise AssertionError(
                "the two acks for request id fix0 disagree: "
                f"{l0} != {l1} (replay answered from a different view)")
        total = sum(d._index.n_rows for d in daemons.values())
        if total != 12:
            raise AssertionError(
                f"double-absorb: shards hold {total} index rows for 12 "
                "submitted rows (the replayed slice re-absorbed)")
        prev_known = prev_labels = None
        last_gens: dict = {}
        for labels, known, gens in query_obs:
            for sid, g in gens.items():
                if g < last_gens.get(sid, 0):
                    raise AssertionError(
                        f"shard {sid} generation regressed: {g} after "
                        f"{last_gens.get(sid)}")
                last_gens[sid] = g
            for j, orig in ((10, 0), (11, 1)):
                if known[j] != known[orig] or labels[j] != labels[orig]:
                    raise AssertionError(
                        f"exact duplicate {j} of row {orig} diverged: "
                        f"known {known[j]}/{known[orig]}, labels "
                        f"{labels[j]}/{labels[orig]}")
            if prev_known is not None:
                for i in range(12):
                    if prev_known[i] and not known[i]:
                        raise AssertionError(
                            f"membership regressed for row {i}")
                    if prev_labels[i] >= 0 and labels[i] != prev_labels[i]:
                        raise AssertionError(
                            f"routed label for row {i} changed: "
                            f"{prev_labels[i]} -> {labels[i]}")
            prev_known, prev_labels = known, labels
        final = router.query(items)
        fl = np.asarray(final["labels"])
        if not np.asarray(final["known"]).all():
            raise AssertionError("post-run rows missing from membership")
        if (fl < 0).any() or len(set(fl[:10].tolist())) != 10:
            raise AssertionError(
                f"post-run global labels malformed: {fl.tolist()}")
        if fl[10] != fl[0] or fl[11] != fl[1]:
            raise AssertionError(
                f"post-run duplicate labels diverged: {fl.tolist()}")

    bodies = {"w": writer, "rp": replayer, "q": querier}
    return bodies, validate


def _replica_scenario(tmp: str, device):
    import numpy as np

    from ..cluster.pipeline import ClusterParams
    from ..cluster.store import SignatureStore
    from ..serve.replicate import ServeReplica, stream_shards

    params = ClusterParams(n_hashes=_POLICY["n_hashes"], n_bands=4,
                           seed=_POLICY["seed"])
    rng = np.random.default_rng(11)
    n_batches, rows = 4, 3
    digests = rng.integers(1, 2**63, size=(n_batches * rows, 2),
                           dtype=np.uint64)
    sigs = rng.integers(0, 2**32, size=(n_batches * rows,
                                        _POLICY["n_hashes"]),
                        dtype=np.uint64).astype(np.uint32)
    max_bytes = 2 * rows * _POLICY["n_hashes"] * 4 + 1  # keep 2 live shards
    src = os.path.join(tmp, "src")
    dst = os.path.join(tmp, "replica")
    writer_store = SignatureStore(src, _POLICY, max_bytes=max_bytes)
    # Bootstrap: one committed batch and one pull before the explored
    # window, so the replica adopts the writer's policy from a streamed
    # manifest.
    writer_store.append(digests[:rows], sigs[:rows])
    stream_shards(src, dst)
    replica = ServeReplica(dst, params=params, device=device)
    batch_of = np.repeat(np.arange(n_batches), rows)
    # Every source manifest state, in commit order (append and each
    # one-victim eviction step): the streamer may copy, and the replica
    # adopt, any of them.
    committed: list = []
    shard_sets: list = []
    live: set = set()
    for b in range(n_batches):
        live = live | {b}
        shard_sets.append(set(live))
        while len(live) > 2:
            live = live - {min(live)}
            shard_sets.append(set(live))
    for s in shard_sets:
        committed.append(frozenset(
            i for i in range(n_batches * rows) if int(batch_of[i]) in s))
    probe_obs: list = []
    gen_obs: list = []

    def writer() -> None:
        for b in range(1, n_batches):
            blk = slice(b * rows, (b + 1) * rows)
            writer_store.append(digests[blk], sigs[blk])

    def streamer() -> None:
        for _ in range(3):
            try:
                stream_shards(src, dst)
            except OSError:
                # Every bounded retry raced the writer's eviction: this
                # pull gives up, as the puller does, and the replica stays
                # on its last adopted generation, which the invariant
                # allows.
                pass

    def refresher() -> None:
        for _ in range(4):
            replica.refresh()
            gen_obs.append(int(replica._generation_adopted))
            hit, _, _ = replica.store.bulk_probe(digests)
            probe_obs.append(frozenset(
                int(i) for i in np.flatnonzero(hit)))

    def validate() -> None:
        valid = set(committed)
        for view in probe_obs:
            if view not in valid:
                raise AssertionError(
                    "replica adopted a store view the writer never "
                    f"committed (torn stream): rows {sorted(view)}; "
                    f"committed views: {[sorted(v) for v in valid]}")
        last = -1
        for g in gen_obs:
            if g < last:
                raise AssertionError(
                    f"replica adopted generation regressed: {g} after "
                    f"{last}")
            last = g

    bodies = {"w": writer, "s": streamer, "rr": refresher}
    return bodies, validate


SCENARIOS = {
    "serve": lambda tmp, dev, signer: _serve_scenario(tmp, dev, signer),
    "store": lambda tmp, dev, signer: _store_scenario(tmp, evict=False),
    "store-evict": lambda tmp, dev, signer: _store_scenario(tmp, evict=True),
    "router": lambda tmp, dev, signer: _router_scenario(tmp, dev, signer),
    "replica": lambda tmp, dev, signer: _replica_scenario(tmp, dev),
}

# The environment of a scenario run: a tiny LSM delta threshold makes
# appends and refreshes consolidate inside the explored window, and a low
# consolidation bound on the live index exercises its delta-run path.
_SCENARIO_ENV = {"TSE1M_SIG_STORE_DELTA_SHARDS": "2",
                 "TSE1M_LIVE_DELTA_RUNS": "2"}


class RunOutcome:
    """One schedule's realized trace (for dedup and exhaustive
    branching), with the seats it passed."""

    __slots__ = ("decisions", "alternatives", "schedule_str", "races",
                 "sites")

    def __init__(self, decisions, alternatives, schedule_str, races,
                 sites=()):
        self.decisions = tuple(decisions)
        self.alternatives = tuple(alternatives)
        self.schedule_str = schedule_str
        self.races = races
        self.sites = tuple(sites)


def run_scenario(scenario: str, schedule: Schedule,
                 timeout_s: float = 60.0, build=None,
                 device="cuda", signer: str = "host") -> RunOutcome:
    """Run one scenario under one schedule; raises ScheduleError (with the
    replay string) on any invariant violation, deadlock, hang or detected
    race.  ``build(tmp)`` overrides the scenario factory (the planted-bug
    tests inject broken subclasses through it)."""
    dev = resolve_device(device)
    if build is None:
        if scenario not in SCENARIOS:
            raise ValueError(f"unknown scenario {scenario!r}; have "
                             f"{sorted(SCENARIOS)}")
        factory = SCENARIOS[scenario]

        def build(tmp):
            return factory(tmp, dev, signer)
    tmp = tempfile.mkdtemp(prefix=f"graftrace_{scenario.replace('-', '_')}_")
    saved = {k: os.environ.get(k) for k in _SCENARIO_ENV}
    os.environ.update(_SCENARIO_ENV)
    sched = DeterministicScheduler(schedule, timeout_s=timeout_s)
    lockset = LocksetChecker()
    try:
        bodies, validate = build(tmp)
        install_tracer(Tracer(lockset=lockset, scheduler=sched))
        try:
            sched.run(bodies)
        finally:
            clear_tracer()
        try:
            validate()
        except AssertionError as e:
            raise ScheduleError(str(e),
                                sched.realized().to_string()) from e
        if lockset.races:
            raise ScheduleError(
                "lockset race(s) under this schedule:\n" + "\n".join(
                    r.describe() for r in lockset.races),
                sched.realized().to_string())
        return RunOutcome(sched.decisions, sched.alternatives,
                          schedule.to_string(), len(lockset.races),
                          sched.sites)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


def explore(scenario: str, n_seeded: int = 200, exhaustive_bound: int = 4,
            base_seed: int = 0, pct_depth: int = 3, build=None,
            device="cuda", signer: str = "host") -> dict:
    """N seeded PCT schedules plus bounded exhaustive prefix enumeration;
    returns summary stats, raises on the first failing schedule (the
    message carries the replay string)."""
    traces: set = set()
    runs = 0
    for i in range(n_seeded):
        out = run_scenario(scenario, Schedule.pct(base_seed + i,
                                                  depth=pct_depth),
                           build=build, device=device, signer=signer)
        traces.add(out.decisions)
        runs += 1
    # Bounded exhaustive: branch every alternative at the first
    # ``exhaustive_bound`` decision points, depth first over realized
    # traces (stateless model checking over the yield-point graph).
    frontier: list[tuple] = [()]
    seen_prefix: set = set()
    while frontier:
        prefix = frontier.pop()
        if prefix in seen_prefix:
            continue
        seen_prefix.add(prefix)
        out = run_scenario(scenario, Schedule.fixed(prefix), build=build,
                           device=device, signer=signer)
        runs += 1
        traces.add(out.decisions)
        for i in range(len(prefix),
                       min(len(out.decisions), exhaustive_bound)):
            for alt in out.alternatives[i]:
                if alt != out.decisions[i]:
                    frontier.append(out.decisions[:i] + (alt,))
    return {"trace_schedules_explored": runs,
            "trace_distinct_traces": len(traces),
            "trace_races_found": 0}


def replay(schedule_str: str, scenario: str = "serve", device="cuda",
           signer: str = "host") -> RunOutcome:
    """Re-run one committed or reported schedule string exactly."""
    return run_scenario(scenario, Schedule.from_string(schedule_str),
                        device=device, signer=signer)


__all__ = ["RunOutcome", "SCENARIOS", "explore", "replay", "router_corpus",
           "run_scenario"]
