"""The port's degradation ladder (``tse1m_tpu_torch/cluster/ladder.py``)
against the JAX package's, on the CPU, under the same fault plans: the
out-of-memory rungs (quant drop, then chunk halving), the clamp and its
restore on heal, store runs that never drop the width, out of rungs,
stalls, device loss, the resumable path, and the serving daemon's ingest.
JAX runs with ``use_pallas="never"``, as its own tests do; each package
builds its own ``FaultPlan`` from one dict and writes its own calibration
file.  Comparisons are exact: labels, ``last_run_info``'s ladder keys, the
ordered events (kind, site, detail) and the calibration entries without
their timestamps.  One difference is by design: the port never fails over
to the CPU (no ``device_failover`` event)."""

import ast
import json
import os

import numpy as np
import pytest
import torch

from tse1m_tpu import observability as jobs
from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.resilience import faults as jfaults
from tse1m_tpu.serve import ServeDaemon as JDaemon
from tse1m_tpu_torch import observability as tobs
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.observability import flat_metrics
from tse1m_tpu_torch.resilience import faults as tfaults
from tse1m_tpu_torch.resilience import watchdog as twd
from tse1m_tpu_torch.serve import ServeDaemon

LADDER_KEYS = ("chunk_halvings", "quant_drops", "wire_quant_bits",
               "chunk_bits", "wire_bytes", "encoding")
OOM = "RESOURCE_EXHAUSTED: injected allocation failure"


@pytest.fixture(autouse=True)
def _clean(monkeypatch, tmp_path):
    monkeypatch.setenv("TSE1M_ROUTER_CAL", str(tmp_path / "unused.json"))
    jfaults.clear_plan()
    tfaults.clear_plan()
    jobs.pop_degradation_events()
    tobs.pop_degradation_events()
    yield
    jfaults.clear_plan()
    tfaults.clear_plan()


def _params(pkg, **kw):
    base = dict(n_hashes=32, n_bands=4)
    base.update(kw)
    if pkg == "j":
        return jpipe.ClusterParams(use_pallas="never", **base)
    return tpipe.ClusterParams(**base)


def _events(pkg):
    return [(e["kind"], e["site"], e["detail"])
            for e in (jobs if pkg == "j" else tobs).pop_degradation_events()]


def _cal(path):
    """The calibration file's entries without their timestamps."""
    if not os.path.exists(path):
        return None
    with open(path) as f:
        saved = json.load(f)
    return {sec: {k: e["value"] for k, e in (saved.get(sec) or {}).items()}
            for sec in ("cost_per_row", "wire")}


def _run(pkg, items, plan, monkeypatch, tmp_path, cal=None, **kw):
    """One package's run under its own copy of ``plan`` and calibration
    file; returns (labels or the exception, ladder keys, events, the
    calibration entries)."""
    path = str(tmp_path / f"cal_{pkg}.json")
    if cal is not None:
        with open(path, "w") as f:
            json.dump(cal, f)
    monkeypatch.setenv("TSE1M_ROUTER_CAL", path)
    mod = jfaults if pkg == "j" else tfaults
    fp = mod.FaultPlan.from_dict(plan) if plan else None
    run = kw.pop("run", None) or (
        lambda p: (jpipe.cluster_sessions(items, p) if pkg == "j" else
                   tpipe.cluster_sessions(items, p, device="cpu")))
    if fp is not None:
        mod.install_plan(fp)
    try:
        out = run(_params(pkg, **kw))
    except Exception as e:  # the failure is the result to compare
        out = e
    finally:
        mod.clear_plan()
    info = (jpipe if pkg == "j" else tpipe).last_run_info
    return (out, {k: info.get(k) for k in LADDER_KEYS}, _events(pkg),
            _cal(path), fp)


def _both(items, plan, monkeypatch, tmp_path, **kw):
    return (_run("j", items, plan, monkeypatch, tmp_path, **kw),
            _run("t", items, plan, monkeypatch, tmp_path, **kw))


def _oom_plan(**kw):
    return {"rules": [dict(site="pipeline.h2d", kind="raise", message=OOM,
                           **kw)]}


def _assert_same(j, t):
    assert np.array_equal(t[0], j[0])
    assert t[1] == j[1]
    assert t[2] == j[2]
    assert t[3] == j[3]


def test_oom_halves_the_chunk_as_jax(monkeypatch, tmp_path):
    items = synth_session_sets(2048, set_size=16, seed=3)[0]
    want = tpipe.cluster_sessions(items, _params("t", h2d_chunks=4,
                                                 wire_quant_bits=-1),
                                  device="cpu")
    j, t = _both(items, _oom_plan(after_calls=1), monkeypatch, tmp_path,
                 h2d_chunks=4, wire_quant_bits=-1)
    _assert_same(j, t)
    np.testing.assert_array_equal(t[0], want)
    assert t[1]["chunk_halvings"] == 1
    assert [e[0] for e in t[2]] == ["chunk_halving"]
    assert t[3]["wire"] == {"chunk_bytes": 256 * 16 * 4}
    assert t[4].fired == [("pipeline.h2d", "raise")]
    # The next run of either package starts at the surviving size.
    p_t, p_j = (_params(k, h2d_chunks=4, wire_quant_bits=-1) for k in "tj")
    assert tpipe._stream_plan(items, p_t) == jpipe._stream_plan(
        items, p_j) == 256


def test_torch_out_of_memory_climbs_as_the_marker(monkeypatch, tmp_path):
    """torch's own OutOfMemoryError, raised by the staged copy of the
    second chunk, climbs the same rung as the injected marker."""
    items = synth_session_sets(2048, set_size=16, seed=3)[0]
    marker = _run("t", items, _oom_plan(after_calls=1), monkeypatch,
                  tmp_path, h2d_chunks=4, wire_quant_bits=-1)
    real_put, calls = tpipe._put, []

    def put(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                              "allocate 2.00 GiB")
        return real_put(*a, **kw)

    monkeypatch.setattr(tpipe, "_put", put)
    os.remove(tmp_path / "cal_t.json")
    real = _run("t", items, None, monkeypatch, tmp_path, h2d_chunks=4,
                wire_quant_bits=-1)
    np.testing.assert_array_equal(real[0], marker[0])
    assert real[1] == marker[1] and real[3] == marker[3]
    strip = [(k, s, {x: v for x, v in d.items() if x != "error"})
             for k, s, d in marker[2]]
    assert [(k, s, {x: v for x, v in d.items() if x != "error"})
            for k, s, d in real[2]] == strip
    assert real[2][0][2]["error"].startswith("OutOfMemoryError: CUDA out")


def test_oom_drops_quant_bits_before_halving_as_jax(monkeypatch, tmp_path):
    items = synth_session_sets(400, set_size=16, seed=13)[0]
    j, t = _both(items, _oom_plan(), monkeypatch, tmp_path)
    _assert_same(j, t)
    assert [e[0] for e in t[2]] == ["quant_drop"]
    assert t[1]["quant_drops"] == 1 and t[1]["wire_quant_bits"] == 10
    assert t[3]["wire"] == {"quant_bits": 10}
    # One universe: the labels of an explicit 10-bit run.
    ref = tpipe.cluster_sessions(items, _params("t", wire_quant_bits=10),
                                 device="cpu")
    np.testing.assert_array_equal(t[0], ref)


def test_clamped_run_restores_on_heal_as_jax(monkeypatch, tmp_path):
    items = synth_session_sets(300, set_size=16, seed=7)[0]
    floor = {"schema_version": 2, "cost_per_row": {},
             "wire": {"quant_bits": {"value": 10, "ts": 4e9}}}
    j, t = _both(items, None, monkeypatch, tmp_path, cal=floor)
    _assert_same(j, t)
    assert t[1]["wire_quant_bits"] == 10
    assert [e[0] for e in t[2]] == ["quant_restore"]
    assert t[3]["wire"] == {}
    # Healed: the next run ships full fidelity.
    tpipe.cluster_sessions(items, _params("t"), device="cpu")
    assert tpipe.last_run_info["wire_quant_bits"] == 0


def test_store_runs_never_drop_quant_bits_as_jax(monkeypatch, tmp_path):
    items = synth_session_sets(400, set_size=16, seed=3)[0]
    j = _run("j", items, _oom_plan(), monkeypatch, tmp_path,
             sig_store=str(tmp_path / "sj"))
    t = _run("t", items, _oom_plan(), monkeypatch, tmp_path,
             sig_store=str(tmp_path / "st"))
    _assert_same(j, t)
    assert [e[0] for e in t[2]] == ["chunk_halving"]
    assert t[1]["wire_quant_bits"] == 0 and t[1]["quant_drops"] is None


def test_oom_at_the_smallest_chunk_surfaces_as_jax(monkeypatch, tmp_path):
    items = synth_session_sets(64, set_size=16, seed=3)[0]
    j, t = _both(items, _oom_plan(times=99), monkeypatch, tmp_path)
    assert isinstance(j[0], jfaults.InjectedFault)
    assert isinstance(t[0], tfaults.InjectedFault)
    assert str(t[0]) == str(j[0])
    assert t[2] == j[2] and t[3] == j[3]
    assert [e[0] for e in t[2]] == ["quant_drop", "quant_drop",
                                    "chunk_halving", "chunk_halving"]


def test_stall_is_cancelled_and_retried_as_jax(monkeypatch, tmp_path):
    items = synth_session_sets(1024, set_size=16, seed=5)[0]
    want = tpipe.cluster_sessions(items, _params("t", h2d_chunks=2),
                                  device="cpu")
    monkeypatch.setenv("TSE1M_WATCHDOG_MIN_BUDGET_S", "0.3")
    plan = {"rules": [dict(site="pipeline.h2d", kind="stall", stall_s=1.5)]}
    j, t = _both(items, plan, monkeypatch, tmp_path, h2d_chunks=2)
    _assert_same(j, t)
    np.testing.assert_array_equal(t[0], want)
    assert [e[0] for e in t[2]] == ["stall_retry"]


def test_compute_stall_retries_on_the_card_it_ran_on(monkeypatch, tmp_path):
    """A stalled compute wait past TSE1M_WATCHDOG_COMPUTE_BUDGET_S is a
    device retry of that chunk in both packages."""
    items = synth_session_sets(1024, set_size=16, seed=5)[0]
    want = tpipe.cluster_sessions(items, _params("t", h2d_chunks=2),
                                  device="cpu")
    monkeypatch.setenv("TSE1M_WATCHDOG_COMPUTE_BUDGET_S", "0.3")
    plan = {"rules": [dict(site="pipeline.compute", kind="stall",
                           stall_s=1.0, times=2)]}
    calls = []
    real = tpipe._chunk_minhash
    monkeypatch.setattr(tpipe, "_chunk_minhash",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    j, t = _both(items, plan, monkeypatch, tmp_path, h2d_chunks=2)
    assert [e[0] for e in j[2]] == ["device_retry", "device_retry",
                                    "device_failover"]
    assert t[2] == j[2][:2]
    np.testing.assert_array_equal(t[0], want)
    np.testing.assert_array_equal(j[0], want)
    assert len(calls) == 2 + 2  # two chunks, the first rerun twice


@pytest.mark.parametrize("times", [2, 6])
def test_device_loss_retries_on_the_card_no_failover(monkeypatch, tmp_path,
                                                     times):
    """Note B: JAX fails over to the CPU at its second device failure; the
    port retries on the same card, records no device_failover, and gives
    the same labels.  At the sixth failure both packages raise: JAX's
    budget counts the failures across its failover too."""
    items = synth_session_sets(1024, set_size=16, seed=7)[0]
    want = tpipe.cluster_sessions(items, _params("t", h2d_chunks=2),
                                  device="cpu")
    plan = {"rules": [dict(site="pipeline.h2d", kind="raise", times=times,
                           message="injected: device lost")]}
    j, t = _both(items, plan, monkeypatch, tmp_path, h2d_chunks=2)
    jkinds = [e[0] for e in j[2]]
    assert jkinds.count("device_failover") == 1
    assert [e for e in j[2] if e[0] != "device_failover"] == t[2]
    assert [e[0] for e in t[2]] == ["device_retry"] * min(times, 6)
    if times == 2:
        np.testing.assert_array_equal(t[0], want)
        np.testing.assert_array_equal(j[0], want)
    else:
        assert isinstance(t[0], tfaults.InjectedFault)
        assert isinstance(j[0], jfaults.InjectedFault)


@pytest.mark.parametrize("error", [
    torch.AcceleratorError("CUDA error: an illegal memory access was "
                           "encountered"),
    RuntimeError("minhash_u32 launch: unspecified launch failure"),
])
def test_sticky_cuda_error_raises_at_once(monkeypatch, tmp_path, error):
    """A sticky CUDA error is terminal: no rung, no retry, the compute
    launched once; the message says how to carry on, naming the checkpoint
    directory when there is one."""
    items = synth_session_sets(1024, set_size=16, seed=7)[0]
    calls = []

    def broken(*a, **k):
        calls.append(1)
        raise error

    monkeypatch.setattr(tpipe, "_chunk_minhash", broken)
    with pytest.raises(twd.StickyDeviceError, match="unusable") as got:
        tpipe.cluster_sessions(items, _params("t", h2d_chunks=2),
                               device="cpu")
    assert got.value.__cause__ is error and len(calls) == 1
    assert tobs.pop_degradation_events() == []
    ck = str(tmp_path / "ck")
    with pytest.raises(twd.StickyDeviceError, match="checkpoint_dir=") as got:
        tpipe.cluster_sessions_resumable(items, _params("t", h2d_chunks=2),
                                         checkpoint_dir=ck, device="cpu")
    assert ck in str(got.value) and len(calls) == 2


def test_resumable_oom_keeps_the_layout_as_jax(monkeypatch, tmp_path):
    """An out-of-memory under the checkpointed path halves inside the
    chunk: the manifest keeps its step and its four chunks, the labels are
    the undisturbed run's, and the manifest meta equals JAX's."""
    items = synth_session_sets(2048, set_size=16, seed=11)[0]
    want = tpipe.cluster_sessions(items, _params("t", h2d_chunks=4),
                                  device="cpu")
    metas = {}

    def run(pkg):
        d = str(tmp_path / f"ck_{pkg}")

        def go(p):
            if pkg == "j":
                return jpipe.cluster_sessions_resumable(
                    items, p, checkpoint_dir=d, cleanup=False)
            return tpipe.cluster_sessions_resumable(
                items, p, checkpoint_dir=d, cleanup=False, device="cpu")

        out = _run(pkg, items, _oom_plan(after_calls=1), monkeypatch,
                   tmp_path, run=go, h2d_chunks=4)
        with open(os.path.join(d, "manifest.json")) as f:
            metas[pkg] = json.load(f)
        return out

    j, t = run("j"), run("t")
    _assert_same(j, t)
    np.testing.assert_array_equal(t[0], want)
    assert [e[0] for e in t[2]] == ["chunk_halving"]
    assert t[2][0][1] == "pipeline.resumable"
    assert t[3]["wire"] == {"chunk_bytes": 256 * 16 * 4}
    meta = {k: v for k, v in metas["t"].items() if k != "chunk_crcs"}
    assert meta == {k: v for k, v in metas["j"].items() if k != "chunk_crcs"}
    assert meta["step"] == 512 and meta["chunks_done"] == [0, 1, 2, 3]


def _daemon_pair(tmp_path):
    tp = tpipe.ClusterParams(n_hashes=32, n_bands=4)
    jp = jpipe.ClusterParams(n_hashes=32, n_bands=4, use_pallas="never")
    return (ServeDaemon(str(tmp_path / "t"), params=tp, device="cpu"),
            JDaemon(str(tmp_path / "j"), params=jp))


def test_daemon_ingest_survives_oom_as_jax(monkeypatch, tmp_path):
    """An out-of-memory at a batch's ingest halves the novel rows' chunk:
    the batch still acks, the stored signatures equal an undisturbed
    daemon's and the JAX daemon's under the same plan, the port's
    degradations_total{kind="chunk_halving"} counts it, and the ingest
    never touches last_run_info."""
    items = synth_session_sets(96, set_size=16, seed=21)[0]
    tpipe.last_run_info.clear()
    tpipe.last_run_info["sentinel"] = 1
    before = tobs.counter("degradations_total", kind="chunk_halving").value
    ref = ServeDaemon(str(tmp_path / "ref"), params=tpipe.ClusterParams(
        n_hashes=32, n_bands=4), device="cpu").start()
    try:
        ref_ack = ref.ingest(items, timeout=300)
    finally:
        ref.stop()
    t, j = _daemon_pair(tmp_path)
    tplan = tfaults.FaultPlan.from_dict(_oom_plan())
    jplan = jfaults.FaultPlan.from_dict(_oom_plan())
    t.start()
    j.start()
    try:
        with tplan.active():
            tack = t.ingest(items, timeout=300)
        with jplan.active():
            jack = j.ingest(items, timeout=300)
    finally:
        t.stop()
        j.stop()
    assert tack["ok"] and tack["acked"] == 96
    assert {k: tack[k] for k in ("acked", "novel", "labels")} == {
        k: jack[k] for k in ("acked", "novel", "labels")} == {
        k: ref_ack[k] for k in ("acked", "novel", "labels")}
    assert tplan.fired == jplan.fired == [("pipeline.h2d", "raise")]
    for name in ("sig_00000.npy", "key_00000.npy"):
        got = np.load(tmp_path / "t" / name)
        np.testing.assert_array_equal(got, np.load(tmp_path / "ref" / name))
        np.testing.assert_array_equal(got, np.load(tmp_path / "j" / name))
    kinds = [e[0] for e in _events("t")]
    assert "chunk_halving" in kinds
    assert kinds == [e[0] for e in _events("j")]
    assert tobs.counter("degradations_total",
                        kind="chunk_halving").value == before + 1
    assert flat_metrics()["metrics_degradations_total"] >= 1
    assert tpipe.last_run_info == {"sentinel": 1}


def test_ladder_never_moves_work_to_the_cpu():
    """The ladder's handlers retry on the device they were given or
    raise: ladder.py holds no "cpu" device string, names no plain kernel
    and records no failover."""
    path = os.path.join(os.path.dirname(tpipe.__file__), "ladder.py")
    tree = ast.parse(open(path, encoding="utf-8").read())
    strings = {n.value for n in ast.walk(tree)
               if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    names = {n.attr if isinstance(n, ast.Attribute) else n.id
             for n in ast.walk(tree) if isinstance(n, (ast.Attribute,
                                                       ast.Name))}
    assert "cpu" not in strings and "device_failover" not in strings
    assert not [n for n in names if "plain" in n or "fallback" in n]
