"""The port's pod path (``cluster_sessions_pod``, ``cluster --sig-store``
across processes) against the JAX package's and the cold run, on the CPU.

- In process: one process, ``solo``, and 3 processes over 1,001 rows (not
  a multiple of 3), the exchanges driven from threads with explicit
  ``n_processes``/``process_id``, under kminhash and cminhash: labels
  equal JAX's ``cluster_sessions_pod`` and the cold storeless run element
  for element; ``last_run_info``'s ``pod_*`` and ``cache_*`` keys JAX's;
  each package running warm on a root the other populated.
- Real 2-process pods through ``python -m tse1m_tpu_torch cluster
  --device cpu`` at JAX's N=800 and 0.2 s / 5 s heartbeats (the
  counterpart of tests/test_pod_chaos.py): clean then warm, a worker
  SIGKILLed, the leader SIGKILLed, a zombie writer woken after its range
  was re-dealt.  Each ends with labels equal to the uninterrupted run's
  and one merged manifest.

Tolerance: exact (labels, JSON keys).
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.observability import \
    pop_degradation_events as j_pop_events
from tse1m_tpu.observability import tracing as jtracing
from tse1m_tpu.resilience import coordinator as jco
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.observability import \
    pop_degradation_events as t_pop_events
from tse1m_tpu_torch.parallel import multihost as tmh
from tse1m_tpu_torch.observability import tracing as ttracing
from tse1m_tpu_torch.resilience import coordinator as tco

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_THREE = 1001
SCHEMES = ["kminhash", "cminhash"]
# JAX's tests/pod_harness.py:29-34: a loss declared in seconds, with slack
# for a busy machine.
POD_ENV = {"TSE1M_HEARTBEAT_INTERVAL_S": "0.2",
           "TSE1M_HEARTBEAT_TIMEOUT_S": "5",
           "TSE1M_WATCHDOG": "0"}
N_CLI, SEED_CLI = 800, 13
TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _unpinned(monkeypatch):
    """Both packages start with no pinned trace id, as a fresh process
    does: an id an earlier test in this process pinned rides one
    package's beats and exchange payloads.  What a test pins is undone
    after it."""
    monkeypatch.setattr(jtracing, "_pinned", None)
    monkeypatch.setattr(ttracing, "_pinned", None)


def _tparams(root, scheme="kminhash") -> tpipe.ClusterParams:
    return tpipe.ClusterParams(n_hashes=32, n_bands=4, scheme=scheme,
                               sig_store=None if root is None else str(root))


def _jparams(root, scheme="kminhash") -> jpipe.ClusterParams:
    return jpipe.ClusterParams(n_hashes=32, n_bands=4, scheme=scheme,
                               use_pallas="never",
                               sig_store=None if root is None else str(root))


@pytest.fixture(scope="module")
def rows():
    return synth_session_sets(N_THREE, set_size=16, seed=3)[0]


@pytest.fixture(scope="module")
def cold(rows):
    return {s: tpipe.cluster_sessions(rows, _tparams(None, s), device="cpu")
            for s in SCHEMES}


def _info(pipe) -> dict:
    return {k: v for k, v in pipe.last_run_info.items()
            if k.startswith(("pod_", "cache_"))
            or k in ("encoding", "wire_quant_bits")}


def _three(pkg: str, rows, root, scheme: str) -> list:
    """Three processes of one package as threads over one root: a ledger
    bootstrapped for the three, one exchange directory."""
    co, pipe = (tco, tpipe) if pkg == "torch" else (jco, jpipe)
    params = (_tparams if pkg == "torch" else _jparams)(root, scheme)
    mem = co.MembershipLedger(os.path.join(str(root), "pod"), 3).bootstrap(
        [0, 1, 2], "abcd")
    xch = co.exchange_dir(os.path.join(str(root), "pod"), "abcd")
    kw = {"device": "cpu"} if pkg == "torch" else {}
    out: dict = {}

    def run(pid: int) -> None:
        lo, hi = tmh.pod_row_range(N_THREE, 3, pid)
        out[pid] = pipe.cluster_sessions_pod(
            rows[lo:hi], N_THREE, params, exchange_dir=xch, membership=mem,
            n_processes=3, process_id=pid, **kw)

    threads = [threading.Thread(target=run, args=(p,)) for p in range(3)]
    [t.start() for t in threads]
    [t.join() for t in threads]
    return [out.get(p) for p in range(3)]


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("mode", ["one", "solo"])
def test_pod_labels_and_run_info_equal_jax(tmp_path, rows, cold, mode,
                                           scheme):
    """A one-process pod and a solo run: labels JAX's and the cold run's,
    ``last_run_info``'s pod and cache keys JAX's, cold then warm."""
    solo = mode == "solo"
    for run in ("cold", "warm"):
        got = tpipe.cluster_sessions_pod(rows, N_THREE, _tparams(
            tmp_path / "t", scheme), device="cpu", solo=solo)
        tinfo = _info(tpipe)
        want = jpipe.cluster_sessions_pod(rows, N_THREE, _jparams(
            tmp_path / "j", scheme), solo=solo)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, cold[scheme])
        assert tinfo == _info(jpipe)
        assert tinfo["cache_hit_rate"] == (0.0 if run == "cold" else 1.0)
        assert tinfo["encoding"] == "pod-store"
        assert tinfo["cache_mode"] == "pod"
    assert sorted(k for k in tinfo if k.startswith("pod_")) == [
        "pod_appended_rows", "pod_epoch", "pod_members", "pod_n_ranges",
        "pod_owned_ranges", "pod_processes", "pod_reassigned_ranges"]
    t_pop_events(), j_pop_events()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_three_processes_equal_jax_and_cold(tmp_path, rows, cold, scheme):
    """3 processes over 1,001 rows: every process's labels are JAX's
    three processes' and the cold run's; the root is then warm for a
    single process of either package."""
    got = _three("torch", rows, tmp_path / "t", scheme)
    want = _three("jax", rows, tmp_path / "j", scheme)
    for t, j in zip(got, want):
        np.testing.assert_array_equal(t, cold[scheme])
        np.testing.assert_array_equal(j, cold[scheme])
    again = tpipe.cluster_sessions_pod(rows, N_THREE, _tparams(
        tmp_path / "t", scheme), device="cpu")
    np.testing.assert_array_equal(again, cold[scheme])
    info = _info(tpipe)
    assert info["cache_hit_rate"] == 1.0
    # A single process inherits the three ranges at the next epoch.
    assert info["pod_epoch"] == 1 and info["pod_owned_ranges"] == [0, 1, 2]
    assert info["pod_reassigned_ranges"] == [1, 2]
    t_pop_events(), j_pop_events()


@pytest.mark.parametrize("first", ["torch", "jax"])
def test_each_package_runs_warm_on_the_others_root(tmp_path, rows, cold,
                                                   first):
    """One package populates a root through its pod path; the other runs
    warm on it, every row a hit, the labels the cold run's; the ledger's
    epoch carries on."""
    root = tmp_path / "root"
    if first == "torch":
        tpipe.cluster_sessions_pod(rows, N_THREE, _tparams(root),
                                   device="cpu")
        got = jpipe.cluster_sessions_pod(rows, N_THREE, _jparams(root))
        info = _info(jpipe)
    else:
        jpipe.cluster_sessions_pod(rows, N_THREE, _jparams(root))
        got = tpipe.cluster_sessions_pod(rows, N_THREE, _tparams(root),
                                         device="cpu")
        info = _info(tpipe)
    np.testing.assert_array_equal(got, cold["kminhash"])
    assert info["cache_hit_rate"] == 1.0 and info["pod_appended_rows"] == 0
    assert info["pod_epoch"] == 0
    # cluster_sessions on a pod root routes to the pod path too.
    np.testing.assert_array_equal(tpipe.cluster_sessions(
        rows, _tparams(root), device="cpu"), cold["kminhash"])
    assert tpipe.last_run_info["cache_mode"] == "pod"
    t_pop_events(), j_pop_events()


# -- real 2-process pods through the command line ------------------------------


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("TSE1M_")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", TSE1M_ROUTER_CAL="", **POD_ENV, **extra)
    return env


# ``python -m tse1m_tpu_torch cluster`` with its labels kept, as JAX's
# tests/chaos_drivers.py pod keeps them: the command runs unchanged, its
# labels saved as .npy (argv[1]) when they come back.
_KEEP_LABELS = """
import sys
import numpy as np
import tse1m_tpu_torch.__main__ as cli
real = cli._cluster_labels
def keep(*args, **kwargs):
    labels = real(*args, **kwargs)
    np.save(sys.argv[1], labels)
    return labels
cli._cluster_labels = keep
sys.exit(cli.main(sys.argv[2:]))
"""


def _cluster_cmd(store: str, labels: str) -> list:
    return [sys.executable, "-c", _KEEP_LABELS, labels, "cluster", "--n",
            str(N_CLI), "--seed", str(SEED_CLI), "--sig-store", store,
            "--device", "cpu", "--ari-sample", "0"]


def _pod(tmp, store: str, result_dir: str, plans: dict | None = None,
         on_poll=None, leader_late_s: float = 0.0) -> dict:
    """Two ``cluster`` processes under TSE1M_NUM_PROCESSES=2 (process 1
    first, process 0 ``leader_late_s`` later); returns per process {rc,
    out, err, labels, report}."""
    procs = {}
    for pid in (1, 0):
        if pid == 0:
            time.sleep(leader_late_s)
        extra = {"TSE1M_NUM_PROCESSES": "2", "TSE1M_PROCESS_ID": str(pid),
                 "TSE1M_RESULT_DIR": result_dir}
        if plans and pid in plans:
            path = os.path.join(str(tmp), f"plan_p{pid}.json")
            with open(path, "w") as f:
                json.dump(plans[pid], f)
            extra["TSE1M_FAULT_PLAN"] = path
        procs[pid] = subprocess.Popen(
            _cluster_cmd(store, os.path.join(str(tmp), f"labels_p{pid}.npy")),
            cwd=REPO, env=_env(**extra), stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    procs = [procs[0], procs[1]]
    out = {}
    pipes = {pid: p.communicate for pid, p in enumerate(procs)}
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while any(p.poll() is None for p in procs):
            if on_poll is not None:
                on_poll(procs)
            if time.monotonic() > deadline:
                raise AssertionError("pod processes still running")
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, p in enumerate(procs):
        so, se = pipes[pid](timeout=60)
        lab = os.path.join(str(tmp), f"labels_p{pid}.npy")
        report = (json.loads(so.strip().splitlines()[-1])
                  if p.returncode == 0 else None)
        out[pid] = {"rc": p.returncode, "out": so, "err": se,
                    "labels": np.load(lab) if os.path.exists(lab) else None,
                    "report": report}
    return out


def _single(tmp, store: str) -> dict:
    """One ``cluster`` process on the pod root (no TSE1M_NUM_PROCESSES):
    the resumed-after-loss shape."""
    lab = os.path.join(str(tmp), "labels_single.npy")
    proc = subprocess.run(_cluster_cmd(store, lab), cwd=REPO,
                          env=_env(TSE1M_RESULT_DIR=os.path.join(
                              str(tmp), "single")),
                          capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return {"labels": np.load(lab),
            "report": json.loads(proc.stdout.strip().splitlines()[-1])}


@pytest.fixture(scope="module")
def cli_cold():
    """The uninterrupted run: ``cluster``'s rows under its params, storeless
    on one process, equal to JAX's."""
    items = synth_session_sets(N_CLI, seed=SEED_CLI)[0]
    labels = tpipe.cluster_sessions(items, tpipe.ClusterParams(
        seed=SEED_CLI), device="cpu")
    np.testing.assert_array_equal(labels, jpipe.cluster_sessions(
        items, jpipe.ClusterParams(seed=SEED_CLI, use_pallas="never")))
    return labels


def _manifest(result_dir: str) -> dict:
    with open(os.path.join(result_dir, "run_manifest.json")) as f:
        return json.load(f)


def test_cli_pod_clean_then_warm(tmp_path, cli_cold):
    """A clean pod, then a warm one whose leader starts last: the worker
    finds the first run's nonce file and leader heartbeat, which agree,
    and must wait for this run's leader instead of adopting them."""
    store, tmp = str(tmp_path / "store"), tmp_path
    for run, hit, late in (("r1", 0.0, 0.0), ("r2", 1.0, 3.0)):
        res = _pod(tmp, store, str(tmp_path / run), leader_late_s=late)
        for pid in (0, 1):
            assert res[pid]["rc"] == 0, res[pid]["err"][-3000:]
            np.testing.assert_array_equal(res[pid]["labels"], cli_cold)
            rep = res[pid]["report"]
            assert rep["cache_hit_rate"] == hit
            assert rep["encoding"] == "pod-store"
            assert (rep["pod_processes"], rep["pod_process_id"],
                    rep["pod_epoch"]) == (2, pid, 0)
            assert "pod_survivor" not in rep
        assert sorted(res[0]["report"]["pod_owned_ranges"]
                      + res[1]["report"]["pod_owned_ranges"]) == [0, 1]
        m = _manifest(str(tmp_path / run))
        assert m["ok"] is True and m["pod"]["merged_from"] == [0, 1]
        assert m["pod"]["missing"] == [] and m["pod"]["epoch"] == 0
        assert {s["process"] for s in m["steps"]} == {0, 1}
    assert sorted(os.listdir(os.path.join(store, "pod"))) == [
        "hb_000.json", "hb_001.json", "membership.json", "run_nonce.json",
        f"xch_{json.load(open(os.path.join(store, 'pod', 'run_nonce.json')))['nonce']}"]


def _expect_failover(res: dict, live: int, dead: int, result_dir: str,
                     cli_cold) -> dict:
    assert res[live]["rc"] == 0, res[live]["err"][-4000:]
    np.testing.assert_array_equal(res[live]["labels"], cli_cold)
    rep = res[live]["report"]
    assert rep["pod_survivor"] == live and rep["pod_lost"] == [dead]
    assert rep["pod_epoch"] == 1 and dead in rep["pod_reassigned_ranges"]
    assert rep["pod_promoted_leader"] is (dead == 0)
    m = _manifest(result_dir)
    kinds = ["host_lost", "pod_failover", "shard_range_reassigned",
             "epoch_advance"] + (["leader_promoted"] if dead == 0 else [])
    for kind in kinds:
        assert m["degradation_counts"].get(kind, 0) >= 1, (kind, m)
    assert m["pod"]["merged_from"] == [0, 1] and m["pod"]["epoch"] == 1
    return m


KILL = {"rules": [{"site": "pipeline.h2d", "kind": "kill"}]}


@pytest.mark.parametrize("dead", [1, 0])
def test_cli_pod_sigkill_fails_over(tmp_path, cli_cold, dead):
    """SIGKILL a worker (dead=1) or the leader (dead=0) at its first H2D
    copy: the survivor declares the loss, advances the epoch (promoting
    itself when the leader died), re-executes alone with the cold labels
    and merges one manifest, in which the dead process's fragment shows
    the step it was in.  A later single process on the root is all hits
    with the same labels."""
    store, rdir = str(tmp_path / "store"), str(tmp_path / "r")
    res = _pod(tmp_path, store, rdir, plans={dead: KILL})
    assert res[dead]["rc"] == -signal.SIGKILL, res[dead]["err"][-3000:]
    m = _expect_failover(res, 1 - dead, dead, rdir, cli_cold)
    steps = {s["process"]: s["status"] for s in m["steps"]}
    assert steps == {dead: "running", 1 - dead: "ok"}
    again = _single(tmp_path, store)
    np.testing.assert_array_equal(again["labels"], cli_cold)
    assert again["report"]["cache_hit_rate"] == 1.0
    # Process 0 alone: the survivor's membership when it was process 0;
    # a re-admission at the next epoch when the survivor was process 1.
    assert again["report"]["pod_epoch"] == (2 if dead == 0 else 1)


def _root_files(store: str) -> dict:
    out = {}
    for base, dirs, names in os.walk(store):
        dirs[:] = [d for d in dirs if d != "pod"]
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, store)] = f.read()
    return out


def test_cli_pod_zombie_fences_with_zero_appends(tmp_path, cli_cold):
    """Wedge worker 1 at its first H2D copy (heartbeats suspended); once
    process 0 has failed over and exited, wake it: it meets its superseded
    lease at its first append, exits 1 with LeaseSupersededError and no
    labels, and the root's files are as the survivor left them."""
    store, rdir = str(tmp_path / "store"), str(tmp_path / "r")
    wake = str(tmp_path / "wake")
    plan = {"rules": [{"site": "pipeline.h2d", "kind": "zombie",
                       "stall_s": 120.0, "wake_path": wake}]}
    membership = os.path.join(store, "pod", "membership.json")
    seen: dict = {}

    def wake_zombie(procs) -> None:
        if "root" in seen or procs[0].poll() is None:
            return
        with open(membership) as f:
            assert json.load(f)["epoch"] == 1
        seen["root"] = _root_files(store)
        open(wake, "w").close()

    res = _pod(tmp_path, store, rdir, plans={1: plan}, on_poll=wake_zombie)
    _expect_failover(res, 0, 1, rdir, cli_cold)
    assert res[1]["rc"] == 1 and res[1]["labels"] is None
    assert "LeaseSupersededError" in res[1]["err"]
    with open(os.path.join(rdir, "run_manifest.p001.json")) as f:
        frag = json.load(f)
    assert frag["degradation_counts"].get("lease_superseded", 0) >= 1
    assert frag["steps"][0]["status"] == "failed"
    assert "LeaseSupersededError" in frag["steps"][0]["error"]
    assert _root_files(store) == seen["root"]
    again = _single(tmp_path, store)
    np.testing.assert_array_equal(again["labels"], cli_cold)
    assert again["report"]["cache_hit_rate"] == 1.0
