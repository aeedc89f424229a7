"""A resumable run that was halved by an out-of-memory, then killed, then
resumed: the port adopts the step its checkpoint was cut at, where the
JAX package re-plans under the persisted chunk size and refuses its own
checkpoint.  The one place where the port departs from the reference on
purpose.  On the CPU, JAX with ``use_pallas="never"``; labels exact."""

import numpy as np
import pytest

from tse1m_tpu.cluster import checkpoint as jck
from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu.resilience import faults as jfaults
from tse1m_tpu_torch.cluster import checkpoint as tck
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.resilience import faults as tfaults

OOM_AT_SECOND_COPY = {"rules": [{
    "site": "pipeline.h2d", "kind": "raise", "after_calls": 1, "times": 1,
    "message": "RESOURCE_EXHAUSTED: injected allocation failure"}]}


class Killed(RuntimeError):
    pass


@pytest.fixture(autouse=True)
def _clean():
    jfaults.clear_plan()
    tfaults.clear_plan()
    yield
    jfaults.clear_plan()
    tfaults.clear_plan()


def _killed_at_fourth_save(monkeypatch, mod):
    real = mod.ClusterCheckpoint.save_chunk
    saved = []

    def save(self, index, sig, keys):
        if len(saved) == 3:
            raise Killed(index)
        real(self, index, sig, keys)
        saved.append(index)

    monkeypatch.setattr(mod.ClusterCheckpoint, "save_chunk", save)


def _halve_then_kill(pkg, items, params, ckpt_dir, monkeypatch):
    """The first run: an out-of-memory at the second copy halves a chunk
    (and persists the surviving size), then the run dies at its fourth
    shard save with the manifest's step at 512."""
    faults, ck = (jfaults, jck) if pkg == "j" else (tfaults, tck)
    with monkeypatch.context() as m:
        _killed_at_fourth_save(m, ck)
        faults.install_plan(faults.FaultPlan.from_dict(OOM_AT_SECOND_COPY))
        try:
            with pytest.raises(Killed):
                if pkg == "j":
                    jpipe.cluster_sessions_resumable(
                        items, params, checkpoint_dir=ckpt_dir)
                else:
                    tpipe.cluster_sessions_resumable(
                        items, params, checkpoint_dir=ckpt_dir, device="cpu")
        finally:
            faults.clear_plan()


def test_halved_then_killed_run_resumes(tmp_path, monkeypatch):
    monkeypatch.setenv("TSE1M_ROUTER_CAL", str(tmp_path / "cal.json"))
    items = synth_session_sets(2048, set_size=16, seed=11)[0]
    kw = dict(n_hashes=32, n_bands=4, h2d_chunks=4)
    jp = jpipe.ClusterParams(use_pallas="never", **kw)
    tp = tpipe.ClusterParams(**kw)
    want = jpipe.cluster_sessions_resumable(
        items, jp, checkpoint_dir=str(tmp_path / "clean"))

    jdir = str(tmp_path / "ck_j")
    _halve_then_kill("j", items, jp, jdir, monkeypatch)
    with pytest.raises(ValueError,
                       match=r"mismatched \(have, want\): "
                             r"\{'step': \(512, 256\)\}"):
        jpipe.cluster_sessions_resumable(items, jp, checkpoint_dir=jdir)

    monkeypatch.setenv("TSE1M_ROUTER_CAL", str(tmp_path / "cal_t.json"))
    tdir = str(tmp_path / "ck_t")
    _halve_then_kill("t", items, tp, tdir, monkeypatch)
    assert tpipe._stream_plan(items, tp) == 256  # the persisted clamp
    got = tpipe.cluster_sessions_resumable(items, tp, checkpoint_dir=tdir,
                                           device="cpu")
    np.testing.assert_array_equal(got, want)
