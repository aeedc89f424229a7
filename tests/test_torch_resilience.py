"""The supervision pieces of the port against the JAX package's, on the
CPU: the calibrated chunk step (``_stream_plan`` clamped to the surviving
chunk size, the repair of a fault in earlier versions of the port), the
stage watchdog, the failure classifiers, the calibration writer, the fault
plane's firing sequences, the step runner's degradation events, and the
``cluster`` command's degradation keys and manifest step.  Comparisons
are exact."""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from tse1m_tpu import observability as jobs
from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.resilience import faults as jfaults
from tse1m_tpu.resilience import watchdog as jwd
from tse1m_tpu.utils import calibration as jcal
from tse1m_tpu_torch import observability as tobs
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.resilience import faults as tfaults
from tse1m_tpu_torch.resilience import watchdog as twd
from tse1m_tpu_torch.utils import calibration as tcal
from tse1m_tpu_torch.utils.runner import StepRunner

PLAIN_WIRE = dict(encoding="pack24", entropy="off", prefilter="off")


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("TSE1M_ROUTER_CAL", str(tmp_path / "cal.json"))
    for mod in (jfaults, tfaults):
        mod.clear_plan()
    jobs.pop_degradation_events()
    tobs.pop_degradation_events()
    saved = tflight._flight_dir
    yield
    tflight._flight_dir = saved
    for mod in (jfaults, tfaults):
        mod.clear_plan()


# -- the calibrated chunk step ----------------------------------------------

@pytest.mark.parametrize("n", [20_000, 3_000])
def test_calibrated_chunk_step_as_jax(tmp_path, n):
    """Under a calibration whose surviving chunk is 4,096 rows of 64 ids,
    both packages plan the same step, ship the same chunks and bytes and
    give the same labels: at 20,000 rows the clamp bites (4,096, not
    5,120), at 3,000 it does not."""
    cal = str(tmp_path / "cal.json")
    jcal.update_calibration(cal, wire={"chunk_bytes": 4096 * 64 * 4})
    items = np.random.default_rng(5).integers(0, 1 << 20, size=(n, 64),
                                              dtype=np.uint32)
    tp = tpipe.ClusterParams(n_hashes=32, n_bands=4, h2d_chunks=4,
                             **PLAIN_WIRE)
    jp = jpipe.ClusterParams(n_hashes=32, n_bands=4, h2d_chunks=4,
                             use_pallas="never", **PLAIN_WIRE)
    step = tpipe._stream_plan(items, tp)
    assert step == jpipe._stream_plan(items, jp)
    assert step == (4096 if n == 20_000 else 1024)
    got = tpipe.cluster_sessions(items, tp, device="cpu")
    want = jpipe.cluster_sessions(items, jp)
    np.testing.assert_array_equal(got, want)
    for key in ("chunk_bits", "wire_bytes", "wire_quant_bits"):
        assert tpipe.last_run_info[key] == jpipe.last_run_info[key], key
    assert len(tpipe.last_run_info["chunk_bits"]) == -(-n // step)


# -- the stage watchdog -------------------------------------------------------

def test_watchdog_budgets_adapt_as_jax(monkeypatch):
    """Budgets before and after each observation, seed rates, the floor
    and byte-less stages equal JAX's."""
    pairs = [(twd.StageWatchdog(min_budget_s=1.0, factor=2.0),
              jwd.StageWatchdog(min_budget_s=1.0, factor=2.0)),
             (twd.StageWatchdog(min_budget_s=0.5, factor=3.0,
                                seed_rates={"h2d": 10e6}),
              jwd.StageWatchdog(min_budget_s=0.5, factor=3.0,
                                seed_rates={"h2d": 10e6}))]
    observations = [("h2d", 1.0, 10 * 2**20), ("h2d", 0.5, 40 * 2**20),
                    ("h2d", 0.0, 5), ("compute", 2.0, 0),
                    ("h2d", 3.0, 2**20)]
    for t, j in pairs:
        for stage, secs, nbytes in observations:
            for probe in (0, 1, 10**6, 100 * 2**20, 10**10):
                assert t.budget_for(stage, probe) == j.budget_for(stage,
                                                                  probe)
            t.observe(stage, secs, nbytes)
            j.observe(stage, secs, nbytes)
    monkeypatch.setenv("TSE1M_WATCHDOG_MIN_BUDGET_S", "7")
    monkeypatch.setenv("TSE1M_WATCHDOG_FACTOR", "3")
    monkeypatch.setenv("TSE1M_WATCHDOG_MAX_STALLS", "4")
    t, j = twd.StageWatchdog(), jwd.StageWatchdog()
    assert (t.min_budget_s, t.factor, t.max_stalls) == (
        j.min_budget_s, j.factor, j.max_stalls) == (7.0, 3.0, 4)


def test_watchdog_kill_switch_as_jax(monkeypatch):
    monkeypatch.setenv("TSE1M_WATCHDOG", "0")
    for mod in (twd, jwd):
        wd = mod.StageWatchdog(min_budget_s=0.05, max_stalls=0)
        assert wd.guarded_call("h2d", lambda: "ok") == "ok"
        assert wd.budget_for("h2d", 10**12) == 0.0
    assert tobs.pop_degradation_events() == []
    assert tpipe._compute_budget_s() == jpipe._compute_budget_s() == 0.0


def test_bounded_stalls_then_raise_as_jax(tmp_path):
    """max_stalls + 1 cancelled attempts, each a stall_retry event, then
    the StallError and a flight dump of the breach; a stall that clears
    retries to the result."""
    tflight.set_flight_dir(str(tmp_path / "flight"))
    events = {}
    for name, mod, obs in (("t", twd, tobs), ("j", jwd, jobs)):
        wd = mod.StageWatchdog(min_budget_s=0.1, max_stalls=1)
        with pytest.raises(mod.StallError):
            wd.guarded_call("h2d", lambda: time.sleep(1.0), nbytes=64,
                            site="unit")
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) == 1:
                time.sleep(1.0)
            return "ok"

        assert wd.guarded_call("h2d", flaky, site="unit") == "ok"
        events[name] = [(e["kind"], e["site"], e["detail"])
                        for e in obs.pop_degradation_events()]
    assert events["t"] == events["j"]
    assert [e[0] for e in events["t"]] == ["stall_retry"] * 3
    dumps = os.listdir(tmp_path / "flight")
    assert len(dumps) == 1
    with open(tmp_path / "flight" / dumps[0]) as f:
        assert json.load(f)["reason"] == "deadline_breach"


# -- the classifiers ----------------------------------------------------------

def test_classifiers():
    """JAX's markers classify alike in both packages; torch's own
    out-of-memory is a resource exhaustion; a sticky CUDA error (by type,
    or by the CUDA runtime's text) is neither retried nor an OOM."""
    shared = [RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating"),
              RuntimeError("unrelated"), ConnectionError("any"),
              RuntimeError("INTERNAL: stream closed: device lost"),
              ValueError("bad shape"), RuntimeError("rpc failed: socket")]
    for e in shared:
        assert twd.is_resource_exhausted(e) == jwd.is_resource_exhausted(e)
        assert twd.is_device_loss(e) == jwd.is_device_loss(e)
        assert not twd.is_sticky_cuda_error(e)
    assert twd.is_device_loss(twd.StallError("site", 1.0))
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert twd.is_resource_exhausted(oom) and not twd.is_device_loss(oom)
    assert not twd.is_sticky_cuda_error(oom)
    sticky = [torch.AcceleratorError("CUDA error: an illegal memory access "
                                     "was encountered"),
              RuntimeError("CUDA error: device-side assert triggered"),
              RuntimeError("minhash_u32 launch: unspecified launch failure"),
              RuntimeError("rans launch: an illegal memory access was "
                           "encountered"),
              RuntimeError("uncorrectable ECC error encountered")]
    for e in sticky:
        assert twd.is_sticky_cuda_error(e), e
        assert not twd.is_resource_exhausted(e)
    err = twd.terminal_device_error(sticky[0], "/ck")
    assert isinstance(err, twd.StickyDeviceError)
    assert "checkpoint_dir='/ck'" in str(err) and "AcceleratorError" in \
        str(err)
    assert "checkpoint_dir" in str(twd.terminal_device_error(sticky[1]))


# -- the calibration writer ---------------------------------------------------

def _masked(path):
    with open(path) as f:
        saved = json.load(f)
    stamps = {sec: {k: e["ts"] for k, e in saved[sec].items()}
              for sec in ("cost_per_row", "wire")}
    for sec in ("cost_per_row", "wire"):
        for e in saved[sec].values():
            e.pop("ts")
    return saved, stamps


def test_update_calibration_writes_jax_files(tmp_path):
    """The same updates give the same file, timestamps masked; a kept
    entry keeps its stamp; None deletes; each package reads the other's
    file."""
    t, j = str(tmp_path / "t.json"), str(tmp_path / "j.json")
    updates = [dict(wire={"h2d_MBps": 11.0}),
               dict(cost_per_row={"rq1:pandas": 2e-8}),
               dict(wire={"chunk_bytes": 4096, "quant_bits": 10}),
               dict(wire={"quant_bits": None})]
    for u in updates:
        tcal.update_calibration(t, **u)
        jcal.update_calibration(j, **u)
        time.sleep(0.01)
    (ts, tstamps), (js, _) = _masked(t), _masked(j)
    assert ts == js
    assert ts["wire"] == {"h2d_MBps": {"value": 11.0},
                          "chunk_bytes": {"value": 4096}}
    assert tstamps["wire"]["h2d_MBps"] < tstamps["wire"]["chunk_bytes"]
    assert tcal.load_calibration(j) == jcal.load_calibration(j)
    assert jcal.load_calibration(t) == tcal.load_calibration(t)
    tcal.update_calibration(None, wire={"x": 1})  # no path: no-op
    assert tcal.load_calibration(str(tmp_path / "absent.json")) == {
        "cost_per_row": {}, "wire": {}}


# -- the fault plane ----------------------------------------------------------

PLAN = {"seed": 7, "rules": [
    {"site": "pipeline.h2d", "kind": "raise", "after_calls": 1, "times": 2,
     "message": "RESOURCE_EXHAUSTED: x"},
    {"site": "pipeline.*", "kind": "delay", "delay_s": 0.001, "times": 3,
     "probability": 0.5},
    {"site": "store.sig.save", "kind": "connection_drop", "times": -1,
     "probability": 0.4},
    {"site": "checkpoint.cluster.save", "kind": "torn_write",
     "truncate_fraction": 0.25, "times": 2},
    {"site": "store.state.save", "kind": "stall", "stall_s": 0.001},
    {"site": "store.compact.save", "kind": "kill"},
]}
SEATS = (["pipeline.h2d", "pipeline.compute"] * 4
         + ["store.sig.save"] * 6 + ["checkpoint.cluster.save"] * 3
         + ["store.state.save"] * 2 + ["store.compact.save", "other"])


def _fire_all(mod, plan, tmp_path, tag):
    """Each seat in turn under the plan: what each call did."""
    seen = []
    with plan.active():
        for i, site in enumerate(SEATS):
            path = str(tmp_path / f"{tag}_{i}.bin")
            with open(path, "wb") as f:
                f.write(bytes(range(200)))
            try:
                mod.fault_point(site, path=path)
                seen.append((site, "pass", os.path.getsize(path)))
            except (mod.InjectedFault, SystemExit) as e:
                seen.append((site, type(e).__name__, os.path.getsize(path),
                             str(e)))
    return seen, list(plan.fired)


def test_fault_plans_fire_as_jax(tmp_path, monkeypatch):
    """The same plan dict, seed and seat sequence fire the same rules in
    both packages, with the same effects, over every kind but the pod
    coordinator's (kill: the signal is caught here)."""
    killed = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: killed.append(sig))
    tflight.set_flight_dir(None)
    monkeypatch.delenv("TSE1M_FLIGHT_DIR", raising=False)
    tplan = tfaults.FaultPlan.from_dict(PLAN)
    jplan = jfaults.FaultPlan.from_dict(PLAN)
    assert tplan.to_dict() == jplan.to_dict()
    assert tplan.to_dict()["seed"] == 7 and len(tplan.rules) == 6
    got = _fire_all(tfaults, tplan, tmp_path, "t")
    want = _fire_all(jfaults, jplan, tmp_path, "j")
    assert got == want
    kinds = {k for _, k in got[1]}
    assert kinds == {"raise", "delay", "connection_drop", "torn_write",
                     "stall", "kill"}
    assert len(killed) == 2
    # One plan file drives either package.
    path = str(tmp_path / "plan.json")
    tplan.save(path)
    assert jfaults.FaultPlan.from_json(path).to_dict() == tplan.to_dict()
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultRule(site="x", kind="melt")


def test_fault_plan_from_the_environment(tmp_path, monkeypatch):
    path = str(tmp_path / "plan.json")
    jfaults.FaultPlan.from_dict(PLAN).save(path)
    monkeypatch.setenv("TSE1M_FAULT_PLAN", path)
    monkeypatch.setattr(tfaults, "_plan", None)
    monkeypatch.setattr(tfaults, "_env_loaded", False)
    plan = tfaults.active_plan()
    assert plan is not None and plan.to_dict()["seed"] == 7
    assert tfaults.active_plan() is plan
    monkeypatch.setenv("TSE1M_FAULT_PLAN", str(tmp_path / "absent.json"))
    monkeypatch.setattr(tfaults, "_env_loaded", False)
    with pytest.raises(RuntimeError, match="could not be loaded"):
        tfaults.active_plan()


@pytest.mark.parametrize("kind", ["hostloss", "zombie"])
def test_pod_kinds_fire_as_jax(tmp_path, kind):
    """The pod kinds, in both packages: the seat passes through after
    ``stall_s``, or for a zombie as soon as ``wake_path`` exists; a
    hostloss leaves this process's heartbeats suspended, a zombie resumes
    them.  The fired log is JAX's."""
    from tse1m_tpu.resilience import coordinator as jco
    from tse1m_tpu_torch.resilience import coordinator as tco

    wake = tmp_path / "wake"
    rule = {"site": "pod.*", "kind": kind, "stall_s": 0.3,
            "wake_path": str(wake) if kind == "zombie" else None}
    fired, suspended = [], []
    for faults, co in ((tfaults, tco), (jfaults, jco)):
        plan = faults.FaultPlan.from_dict({"seed": 3, "rules": [rule]})
        with plan.active():
            t0 = time.monotonic()
            faults.fault_point("pod.seat")
            slept = time.monotonic() - t0
            faults.fault_point("pod.seat")  # times=1: passes at once
        suspended.append(co._suspended.is_set())
        co.resume_heartbeats()
        assert 0.25 <= slept < 2.0
        fired.append(plan.fired)
    assert fired[0] == fired[1] == [("pod.seat", kind)]
    assert suspended == [kind == "hostloss"] * 2
    if kind == "zombie":
        wake.touch()
        plan = tfaults.FaultPlan.from_dict({"rules": [
            dict(rule, stall_s=30.0)]})
        with plan.active():
            t0 = time.monotonic()
            tfaults.fault_point("pod.seat")
            assert time.monotonic() - t0 < 1.0
        assert not tco._suspended.is_set()


def test_fault_plan_counts_exactly_across_threads():
    """The producer thread fires seats too: the counters take a lock."""
    plan = tfaults.FaultPlan([tfaults.FaultRule(site="s", kind="delay",
                                                delay_s=0.0, times=500)])
    with plan.active():
        threads = [threading.Thread(target=lambda: [
            tfaults.fault_point("s") for _ in range(200)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    assert not any(th.is_alive() for th in threads)
    assert plan.rules[0]._seen == 1600 and len(plan.fired) == 500


# -- the step runner and the cluster command ---------------------------------

def test_step_runner_embeds_degradation_events(tmp_path):
    path = str(tmp_path / "m.json")
    runner = StepRunner(path)

    def degraded_step():
        tobs.record_degradation("chunk_halving", site="test",
                                detail={"to_rows": 64})

    runner.run("work", degraded_step)
    runner.run("clean", lambda: None)
    with open(path) as f:
        manifest = json.load(f)
    work, clean = manifest["steps"]
    assert [e["kind"] for e in work["degradations"]] == ["chunk_halving"]
    assert clean["degradations"] is None  # isolation between steps
    assert manifest["degradation_counts"] == {"chunk_halving": 1}


def test_cluster_command_reports_degradations(tmp_path, monkeypatch,
                                              capsys):
    """``cluster`` prints chunk_halvings and degradation_events (0 on a
    clean run, as JAX's command) and records its step; under an injected
    out-of-memory the halving shows in the report and the manifest, with
    the labels of the clean run."""
    monkeypatch.setenv("TSE1M_RESULT_DIR", str(tmp_path / "results"))
    argv = ["cluster", "--n", "2048", "--device", "cpu", "--ari-sample",
            "0", "--wire-quant-bits", "-1"]
    assert cli_main(argv) == 0
    clean = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert clean["chunk_halvings"] == 0 and clean["degradation_events"] == 0
    plan = tfaults.FaultPlan.from_dict({"rules": [{
        "site": "pipeline.h2d", "kind": "raise",
        "message": "RESOURCE_EXHAUSTED: injected"}]})
    with plan.active():
        assert cli_main(argv + ["--checkpoint-dir",
                                str(tmp_path / "ck")]) == 0
    hurt = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert hurt["chunk_halvings"] == 1 and hurt["degradation_events"] == 1
    assert hurt["n_clusters"] == clean["n_clusters"]
    assert hurt["ari_vs_planted"] == clean["ari_vs_planted"]
    with open(tmp_path / "results" / "run_manifest.json") as f:
        manifest = json.load(f)
    step, = manifest["steps"]
    assert step["name"] == "cluster" and step["status"] == "ok"
    assert step["result"]["chunk_halvings"] == 1
    assert [e["kind"] for e in step["degradations"]] == ["chunk_halving"]
    assert manifest["degradation_counts"] == {"chunk_halving": 1}
    assert os.listdir(tmp_path / "ck") == []


def test_cluster_command_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("TSE1M_RESULT_DIR", str(tmp_path / "results"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["cluster", "--n", "64", "--checkpoint-dir",
                  str(tmp_path / "ck")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpipe.cluster_sessions_resumable(
            np.zeros((8, 4), np.uint32), tpipe.ClusterParams(),
            checkpoint_dir=str(tmp_path / "ck"))
    assert not os.path.exists(tmp_path / "results")
    assert not os.path.exists(tmp_path / "ck")
