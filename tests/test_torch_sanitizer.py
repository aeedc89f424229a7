"""tse1m_tpu_torch's runtime sanitizer (``lint/runtime.py``) against the
JAX package's (``tse1m_tpu/lint/runtime.py``): the compile counter sees
the port's builds (a native g++ build, a dynamo graph) and nothing when
warm, ``sanitized(0)`` raises on a build, the sync guard counts host waits
by their innermost port frame and puts the sync debug mode back, and the
warm cluster hot loops (``cluster_sessions`` under three wire encodings,
``cluster_sessions_resumable``) build nothing and give JAX's labels under
JAX's ``sanitized(0)``.  Mirrors ``tests/test_lint_runtime.py``.
Tolerance: exact."""

import threading
import warnings

import numpy as np
import pytest
import torch

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.cluster import cluster_sessions as jcluster
from tse1m_tpu.cluster import cluster_sessions_resumable as jresumable
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.lint import runtime as jruntime
from tse1m_tpu_torch import native
from tse1m_tpu_torch.cluster.pipeline import ClusterParams as TParams
from tse1m_tpu_torch.cluster.pipeline import cluster_sessions as tcluster
from tse1m_tpu_torch.cluster.pipeline import \
    cluster_sessions_resumable as tresumable
from tse1m_tpu_torch.lint import runtime as truntime
from tse1m_tpu_torch.observability import metrics as tmetrics
from tse1m_tpu_torch.observability import profiling as tprof

SYNC = "called a synchronizing CUDA operation (Triggered internally at x)"


def _fresh_native(tmp_path, monkeypatch):
    """The native layer as a first process sees it: no library built."""
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "native"))
    monkeypatch.setattr(native, "_modules", {})


def test_compile_counter_counts_a_native_build_then_none_warm(
        tmp_path, monkeypatch):
    _fresh_native(tmp_path, monkeypatch)
    tmetrics.reset_metrics()
    assert tprof.install_compile_listener() is True
    with truntime.CompileCounter() as cold:
        assert native.loaded("encode")
    assert cold.count == 1
    with truntime.CompileCounter() as warm:
        assert native.loaded("encode")
        assert native.group_delta(np.zeros((4, 8), np.uint32), 16,
                                  3) is not None
    assert warm.count == 0
    hist = tmetrics.histogram("jit_compile_seconds",
                              event="_tse1m_torch_encode")
    assert hist.snapshot()["count"] == 1
    tmetrics.reset_metrics()


def test_compile_counter_sees_a_dynamo_graph():
    f = torch.compile(lambda v: v * 3 + 1, backend="eager")
    with truntime.CompileCounter() as cold:
        f(torch.arange(7))
    assert cold.count >= 1
    with truntime.CompileCounter() as warm:
        f(torch.arange(7))
    assert warm.count == 0


def test_sanitized_enforces_compile_budget(tmp_path, monkeypatch):
    _fresh_native(tmp_path, monkeypatch)
    with pytest.raises(truntime.SanitizerViolation, match="compile budget"):
        with truntime.sanitized(compile_budget=0):
            native.loaded("encode")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "again"))
    monkeypatch.setattr(native, "_modules", {})
    with truntime.sanitized() as report:
        native.loaded("encode")
    got = report.as_dict()
    assert got["sanitizer_compile_count"] == 1
    assert got["sanitizer_compile_budget"] is None
    assert got["sanitizer_transfer_guard"] is False
    assert issubclass(truntime.SanitizerViolation, AssertionError)


def test_self_check_on_the_cpu_reports_the_guard_difference():
    """JAX's self-check proves its transfer guard; the port's guard counts
    host waits on a card, so on the CPU it reports the guard off and no
    sync site, with JAX's keys and the sync sites besides."""
    got = truntime.self_check("cpu")
    want = jruntime.self_check()
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"sanitizer_sync_sites"}
    assert got["sanitizer_available"] is want["sanitizer_available"] is True
    assert got["sanitizer_compile_count"] == want[
        "sanitizer_compile_count"] == 0
    assert got["sanitizer_compile_budget"] == 0
    assert want["sanitizer_transfer_guard"] is True
    assert got["sanitizer_transfer_guard"] is False
    assert got["sanitizer_sync_sites"] == {}


def test_self_check_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        truntime.self_check()


def test_sync_guard_counts_waits_by_site_and_restores_the_mode(monkeypatch):
    """The guard on a card, with torch's sync-debug switch stubbed: every
    synchronizing-call warning from any thread counts under its innermost
    ``tse1m_tpu_torch/`` frame (else its own frame), nothing else is
    swallowed, and the previous mode comes back."""
    modes = [0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: modes[-1])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: modes.append(m))
    port_frame = compile("warnings.warn(SYNC)",
                         "/r/tse1m_tpu_torch/cluster/fake.py", "exec")
    with warnings.catch_warnings(record=True) as shown:
        warnings.simplefilter("always")
        with truntime.sanitized(compile_budget=0) as report:
            assert modes[-1] == "warn"
            warnings.warn(SYNC)
            exec(port_frame, {"warnings": warnings, "SYNC": SYNC})
            exec(port_frame, {"warnings": warnings, "SYNC": SYNC})
            th = threading.Thread(target=lambda: exec(
                port_frame, {"warnings": warnings, "SYNC": SYNC}),
                daemon=True)
            th.start()
            th.join(5.0)
            warnings.warn("an unrelated warning")
    assert not th.is_alive()
    assert modes == [0, "warn", 0]
    got = report.as_dict()
    assert got["sanitizer_transfer_guard"] is True
    assert got["sanitizer_compile_count"] == 0
    sites = got["sanitizer_sync_sites"]
    assert sites.pop("cluster/fake.py:1") == 3
    (own,) = sites
    assert own.startswith("test_torch_sanitizer.py:") and sites[own] == 1
    assert [str(w.message) for w in shown] == ["an unrelated warning"]


@pytest.mark.parametrize("encoding", ["auto", "delta", "pack24"])
def test_cluster_hot_loop_builds_nothing_warm(encoding):
    """A warm ``cluster_sessions`` on the CPU builds nothing, for every
    wire encoding, and its labels equal JAX's warm labels under JAX's
    ``sanitized(0)``."""
    items, _ = synth_session_sets(3000, seed=3)
    tparams = TParams(encoding=encoding, h2d_chunks=2)
    warm = tcluster(items, tparams, device="cpu")
    with truntime.sanitized(compile_budget=0) as report:
        labels = tcluster(items, tparams, device="cpu")
    np.testing.assert_array_equal(labels, warm)
    assert report.compile_count == 0
    assert report.transfer_guard_active is False
    jparams = JParams(encoding=encoding, h2d_chunks=2)
    jcluster(items, jparams)
    with jruntime.sanitized(compile_budget=0) as jreport:
        want = jcluster(items, jparams)
    assert jreport.compile_count == 0
    np.testing.assert_array_equal(labels, want)


def test_cluster_resumable_builds_nothing_warm(tmp_path):
    """The checkpointed path (shard saves and loads) builds nothing warm
    either, and gives JAX's labels."""
    items, _ = synth_session_sets(2500, seed=5)
    tparams = TParams(encoding="pack24", h2d_chunks=2)
    warm = tresumable(items, tparams, checkpoint_dir=str(tmp_path / "a"),
                      device="cpu")
    with truntime.sanitized(compile_budget=0) as report:
        labels = tresumable(items, tparams,
                            checkpoint_dir=str(tmp_path / "b"),
                            device="cpu")
    np.testing.assert_array_equal(labels, warm)
    assert report.compile_count == 0
    jparams = JParams(encoding="pack24", h2d_chunks=2)
    jresumable(items, jparams, checkpoint_dir=str(tmp_path / "c"))
    with jruntime.sanitized(compile_budget=0):
        want = jresumable(items, jparams,
                          checkpoint_dir=str(tmp_path / "d"))
    np.testing.assert_array_equal(labels, want)
