"""The port's trace plane (``tse1m_tpu_torch/trace/``) on the CPU: every
test of ``tests/test_trace.py`` run against the port, and the two
packages' explorers held to each other.

- Schedule strings, determinism and replay, the planted unlocked write,
  the old-shape ``StageRecorder`` regression on the port's
  ``cluster/observability.py``, the latency and SLO layer clean under
  ``traced()``, the admission transition under schedules, and deadlock
  detection, as in the JAX package's tests.
- ``explore("serve", n_seeded=205, exhaustive_bound=4)`` on the port: at
  least 200 schedules and 8 distinct traces, each with label parity
  against the cold host clustering and monotone snapshot generations.
- ``store`` and ``store-evict``; the planted torn index publication, a
  subclass of the port's ``SignatureStore._delta_index_for``, caught with
  a ``v1:fix:`` string that replays the failure while the real store
  passes under it; the committed adversarial strings.
- Cross-package: for ``store``, ``store-evict`` and ``serve``, the
  committed string and 20 seeded PCT schedules realize the same decisions
  and pass the same seats, site for site, in both packages.

Tolerance: exact (labels, decisions, sites).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading

import numpy as np
import pytest

from tse1m_tpu.trace import explore as jexplore
from tse1m_tpu.trace import hooks as jhooks
from tse1m_tpu.trace import lockset as jlockset
from tse1m_tpu.trace import sched as jsched
from tse1m_tpu_torch.cluster.observability import StageRecorder
from tse1m_tpu_torch.cluster.store import SignatureStore, _IndexSnapshot
from tse1m_tpu_torch.observability import pop_degradation_events
from tse1m_tpu_torch.trace import (RaceError, Schedule, ScheduleError,
                                   shared_access, trace_point, traced)
from tse1m_tpu_torch.trace import sync as tsync
from tse1m_tpu_torch.trace.explore import (_store_scenario, explore, replay,
                                           run_scenario)

DEV = "cpu"

# The JAX package's committed interleavings (tests/test_trace.py).
ADVERSARIAL_SCHEDULES = {
    "serve": "v1:fix:q,r,w,q,w,r,q,w,r,q,w,q,r,w,r,q",
    "store": "v1:fix:rp,rr,w,rp,w,rr,rp,w,rr,rp,w,rr,rp,w,rp",
}


# -- schedule strings -------------------------------------------------------

def test_schedule_string_roundtrip():
    s = Schedule.pct(123, depth=5)
    assert Schedule.from_string(s.to_string()).to_string() == \
        "v1:pct:123:5"
    f = Schedule.fixed(["w", "q", "w"])
    assert Schedule.from_string(f.to_string()).choices == ("w", "q", "w")
    with pytest.raises(ValueError):
        Schedule.from_string("v2:what")
    with pytest.raises(ValueError):
        Schedule("rr")


def test_scheduler_is_deterministic_and_replayable():
    """Same schedule -> identical realized decisions; the realized fixed
    schedule replays the exact interleaving."""
    def build(tmp):
        log: list = []

        def body(name):
            def run():
                for i in range(3):
                    trace_point(f"{name}.{i}")
                    log.append(name)
            return run

        return ({"a": body("a"), "b": body("b"), "c": body("c")},
                lambda: None)

    outs = [run_scenario("serve", Schedule.pct(7), build=build, device=DEV)
            for _ in range(2)]
    assert outs[0].decisions == outs[1].decisions
    assert len(outs[0].decisions) > 0
    fixed = run_scenario("serve", Schedule.fixed(outs[0].decisions),
                         build=build, device=DEV)
    assert fixed.decisions == outs[0].decisions


def test_entry_points_default_to_the_card():
    """Without a card, the explorer's entry points raise before running
    anything; nothing falls back to the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario("store", Schedule.pct(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        explore("store", n_seeded=1, exhaustive_bound=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        replay(ADVERSARIAL_SCHEDULES["store"], "store")


# -- lockset: planted races are caught, fixed code is clean -----------------

class _UnlockedCounter:
    """Planted bug: an instrumented shared write with no lock."""

    def __init__(self) -> None:
        self.n = 0

    def bump(self) -> None:
        shared_access(self, "n", write=True)
        self.n += 1


def _on_thread(fn) -> None:
    t = threading.Thread(target=fn)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()


def test_lockset_catches_planted_unlocked_write():
    with traced(raise_on_race=False) as tr:
        c = _UnlockedCounter()
        _on_thread(c.bump)
        _on_thread(c.bump)
    races = tr.lockset.races
    assert len(races) == 1
    r = races[0]
    assert r.name == "_UnlockedCounter.n"
    assert "NO locks" in str(r.current)
    assert r.previous is not None  # both access sites reported
    assert "test_torch_trace.py" in r.current.site
    with pytest.raises(RaceError):
        with traced():
            c2 = _UnlockedCounter()
            _on_thread(c2.bump)
            _on_thread(c2.bump)


class _OldStageRecorder(StageRecorder):
    """The old ``as_dict`` shape: iterates the live dicts without the lock
    while a producer thread adds."""

    def as_dict(self) -> dict:
        shared_access(self, "stages", write=False)  # no lock held
        out: dict = {}
        for name in sorted(self.wall):
            out[f"stage_{name}_s"] = round(self.wall[name], 4)
        return out


def _stage_recorder_regression(rec: StageRecorder) -> list:
    """Producer-thread adds interleaved with reader-thread dict reads."""
    with traced(raise_on_race=False) as tr:
        _on_thread(lambda: rec.add("h2d", 0.1, 1024))
        rec.as_dict()
        _on_thread(lambda: rec.add("encode", 0.2, 512))
        rec.as_dict()
    return tr.lockset.races


def test_stage_recorder_unlocked_read_regression():
    old = _stage_recorder_regression(_OldStageRecorder())
    assert old and old[0].name == "_OldStageRecorder.stages"
    # the port's recorder under the exact same interleaving: no race
    assert _stage_recorder_regression(StageRecorder()) == []


def test_latency_and_slo_layer_lockset_clean():
    """LatencyRecorder bucket updates and the SLO counters are
    lock-consistent under traced()."""
    from tse1m_tpu_torch.observability.latency import LatencyRecorder
    from tse1m_tpu_torch.serve.slo import (AdmissionController, SloPolicy,
                                           SloTracker)

    with traced() as tr:
        lat = LatencyRecorder("audit")
        pol = SloPolicy(max_backlog_batches=2, query_p99_target_ms=0.001)
        adm = AdmissionController(pol)
        trk = SloTracker(pol)

        def hammer(seed: int):
            def run():
                for i in range(50):
                    lat.add(0.001 * ((seed + i) % 7))
                    lat.snapshot()
                    adm.try_admit((seed + i) % 4)
                    adm.stats()
                    trk.observe_query(0.5)
                    trk.stats()
                lat.buckets()
            return run

        threads = [threading.Thread(target=hammer(s)) for s in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    assert tr.lockset.races == []
    pop_degradation_events()  # drop the backpressure and SLO events made


def test_admission_transition_atomic_under_schedules():
    """Under every small-bound interleaving of reject/admit/reject the
    backpressure transition fires once a serialized admit->reject
    boundary (1 or 2 events), never zero, and the layer stays
    lockset-clean."""
    from tse1m_tpu_torch.serve.slo import AdmissionController, SloPolicy

    def build(tmp):
        pop_degradation_events()
        adm = AdmissionController(SloPolicy(max_backlog_batches=4))
        results: dict = {}

        def reject(name):
            def run():
                results[name] = adm.try_admit(9)[0]
            return run

        def admit():
            results["a"] = adm.try_admit(0)[0]

        def validate():
            events = [e for e in pop_degradation_events()
                      if e["kind"] == "serve_backpressure"]
            assert results["r1"] is False and results["r2"] is False
            assert results["a"] is True
            assert 1 <= len(events) <= 2, events
            assert adm.stats()["ingest_backlog_max"] == 9

        return ({"r1": reject("r1"), "a": admit, "r2": reject("r2")},
                validate)

    stats = explore("serve", n_seeded=20, exhaustive_bound=6, build=build,
                    device=DEV)
    assert stats["trace_races_found"] == 0


# -- the explorer over the port's serve and store planes ---------------------

def test_explore_serve_200_seeded_schedules_parity_and_monotonicity():
    """At least 200 seeded schedules over the ingest-absorb-swap / query /
    refresh interleaving, each with element-for-element label parity
    against the cold host clustering of every published generation and
    non-decreasing snapshot generations."""
    stats = explore("serve", n_seeded=205, exhaustive_bound=4, device=DEV)
    assert stats["trace_schedules_explored"] >= 200
    assert stats["trace_races_found"] == 0
    assert stats["trace_distinct_traces"] >= 8


def test_store_refresh_racing_consolidation_and_eviction():
    """refresh() racing _push_delta consolidation (the delta threshold
    forced to 2) and LRU eviction: probes always see a whole committed
    generation."""
    stats = explore("store", n_seeded=40, exhaustive_bound=4, device=DEV)
    assert stats["trace_races_found"] == 0
    evict = explore("store-evict", n_seeded=30, exhaustive_bound=3,
                    device=DEV)
    assert evict["trace_races_found"] == 0


class _TornRefreshStore(SignatureStore):
    """A refresh() adoption with one snapshot swap per added shard
    (publishing each delta run as it is built), so a concurrent probe can
    see the newest shard without its predecessors: a store view no
    manifest generation committed.  The port's refresh publishes every
    run in one swap."""

    def _delta_index_for(self, sid, keys2d):
        run = super()._delta_index_for(sid, keys2d)
        snap = self._snap
        self._snap = _IndexSnapshot(snap.base, snap.deltas + (run,))
        trace_point("store.index.torn-adopt")  # the torn window
        return run


def test_planted_torn_index_publication_is_caught_and_replays():
    build = lambda tmp: _store_scenario(tmp, evict=True,  # noqa: E731
                                        reader_cls=_TornRefreshStore)
    with pytest.raises(ScheduleError) as ei:
        # The window is one yield wide, so a seed catches it with a
        # probability of a few percent; the explorer finds one in 200.
        explore("store-evict", n_seeded=200, exhaustive_bound=4,
                build=build, device=DEV)
    msg = str(ei.value)
    # Either detection is the planted bug: a probe seeing a store view no
    # manifest committed, or the adoption window failing on a shard the
    # writer evicted mid-refresh.
    assert "torn index" in msg or "No such file" in msg
    assert "replay: v1:fix:" in msg
    replay_str = ei.value.schedule_str
    assert replay_str.startswith("v1:fix:")
    with pytest.raises(ScheduleError):
        run_scenario("store-evict", Schedule.from_string(replay_str),
                     build=build, device=DEV)
    # and the port's real store under the same schedule is torn-free
    run_scenario("store-evict", Schedule.from_string(replay_str),
                 device=DEV)


def test_committed_adversarial_schedules_stay_green():
    for scenario, s in ADVERSARIAL_SCHEDULES.items():
        out = replay(s, scenario, device=DEV)
        assert out.races == 0


def test_schedule_failure_carries_replay_string():
    def build(tmp):
        def boom():
            trace_point("boom")
            raise ValueError("planted failure")

        return ({"a": boom, "b": lambda: None}, lambda: None)

    with pytest.raises(ScheduleError) as ei:
        run_scenario("serve", Schedule.pct(3), build=build, device=DEV)
    assert "planted failure" in str(ei.value)
    assert "replay: v1:fix:" in str(ei.value)


def test_traced_does_not_nest():
    with traced():
        with pytest.raises(RuntimeError):
            with traced():
                pass


def test_deadlock_detection_reports_schedule():
    """Two scheduled threads taking two named locks in opposite orders
    deadlock under some interleaving; the scheduler reports it with the
    replay string instead of hanging."""
    def build(tmp):
        l1, l2 = tsync.Lock("l1"), tsync.Lock("l2")

        def ab():
            with l1:
                trace_point("ab.mid")
                with l2:
                    pass

        def ba():
            with l2:
                trace_point("ba.mid")
                with l1:
                    pass

        return ({"ab": ab, "ba": ba}, lambda: None)

    with pytest.raises(ScheduleError) as ei:
        # the bounded exhaustive enumeration finds the inversion
        explore("serve", n_seeded=0, exhaustive_bound=6, build=build,
                device=DEV)
    assert "deadlock" in str(ei.value)
    assert ei.value.schedule_str.startswith("v1:fix:")


# -- the two packages' explorers, decision for decision ----------------------

def _jax_run(scenario: str, schedule_str: str) -> tuple:
    """One JAX-package scenario run as its ``run_scenario`` runs it, with
    the scheduler's realized decisions and the seats it passed."""
    sched = jsched.DeterministicScheduler(
        jsched.Schedule.from_string(schedule_str))
    tmp = tempfile.mkdtemp(prefix="jax_trace_")
    saved = {k: os.environ.get(k) for k in jexplore._SCENARIO_ENV}
    os.environ.update(jexplore._SCENARIO_ENV)
    try:
        bodies, validate = jexplore.SCENARIOS[scenario](tmp)
        jhooks.install_tracer(jhooks.Tracer(
            lockset=jlockset.LocksetChecker(), scheduler=sched))
        try:
            sched.run(bodies)
        finally:
            jhooks.clear_tracer()
        validate()
        return tuple(sched.decisions), tuple(sched.sites)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


_CROSS = [(scenario, s) for scenario in ("store", "store-evict", "serve")
          for s in ([ADVERSARIAL_SCHEDULES["serve" if scenario == "serve"
                                           else "store"]]
                    + [f"v1:pct:{i}:3" for i in range(20)])]


@pytest.mark.parametrize("scenario,schedule_str", _CROSS)
def test_same_decisions_and_sites_as_jax(scenario, schedule_str):
    """One schedule string realizes the same decision sequence and passes
    the same seats, in the same order, in both packages."""
    want_decisions, want_sites = _jax_run(scenario, schedule_str)
    out = run_scenario(scenario, Schedule.from_string(schedule_str),
                       device=DEV)
    assert out.decisions == want_decisions
    assert out.sites == want_sites
    assert len(out.decisions) > 0


def test_serve_labels_equal_jax_under_one_schedule():
    """The serve scenario's daemon ends with the JAX daemon's labels."""
    import tse1m_tpu.serve.daemon as jdaemon
    from tse1m_tpu.cluster import ClusterParams as JParams
    from tse1m_tpu_torch.cluster.pipeline import ClusterParams
    from tse1m_tpu_torch.data.synth import synth_session_sets
    from tse1m_tpu_torch.serve.daemon import ServeDaemon

    items = synth_session_sets(12, set_size=16, seed=5,
                               dup_fraction=0.0)[0]
    with tempfile.TemporaryDirectory() as tmp:
        jd = jdaemon.ServeDaemon(
            os.path.join(tmp, "j"), signer="host",
            params=JParams(n_hashes=16, n_bands=4, seed=0,
                           use_pallas="never"))
        td = ServeDaemon(os.path.join(tmp, "t"), device=DEV, signer="host",
                         params=ClusterParams(n_hashes=16, n_bands=4,
                                              seed=0))
        for lo in range(0, 12, 4):
            a = jd._ingest_batch(items[lo:lo + 4])
            b = td._ingest_batch(items[lo:lo + 4])
            assert a["labels"] == b["labels"]
        np.testing.assert_array_equal(jd._index.labels, td._index.labels)
