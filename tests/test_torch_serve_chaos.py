"""The sharded SIGKILL round of ``tests/serve_harness.py:214`` rebuilt on
tse1m_tpu_torch, its children on the CPU (``--device cpu``).

Two ``python -m tse1m_tpu_torch serve --root R --range i`` children own
the two digest ranges; shard 0 runs under a fault plan that SIGKILLs it
at ``serve.ingest.commit`` on its third commit.  A watcher respawns it,
and the respawn claims the range's next lease epoch.  The router (in
process, or a ``serve-router`` child driven by ``ServeClient``) retries
the in-flight slice under the same request id against the replacement.
The round must lose no acked row (``lost_acked == 0``), absorb none
twice (the shards' rows equal the uninterrupted oracle's), ack all six
batches, and answer labels equal to the oracle's element for element.
The oracle is the same batches through the same router over in-process
daemons.  Every child has its own timeout, so a hang fails this test and
not the suite."""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from tse1m_tpu_torch.cluster.pipeline import ClusterParams
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.observability import flight as tflight
from tse1m_tpu_torch.resilience.coordinator import read_lease
from tse1m_tpu_torch.serve import (LocalTransport, ServeClient, ServeDaemon,
                                   ShardRouter, TcpTransport)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT_S = 120.0
N, BATCH, KILL_BATCH, SHARDS = 600, 100, 2, 2


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TSE1M_LIVE_DELTA_RUNS", raising=False)
    monkeypatch.delenv("TSE1M_FAULT_PLAN", raising=False)
    saved = tflight._flight_dir
    yield
    tflight._flight_dir = saved


def _env(plan_path=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("TSE1M_")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    if plan_path:
        env["TSE1M_FAULT_PLAN"] = plan_path
    return env


def _wait_port(proc, port_file, what):
    deadline = time.monotonic() + CHILD_TIMEOUT_S
    while time.monotonic() < deadline:
        if os.path.exists(port_file):
            with open(port_file, encoding="utf-8") as f:
                txt = f.read().strip()
            if txt:
                return int(txt)
        if proc.poll() is not None:
            _, err = proc.communicate(timeout=10)
            raise AssertionError(f"{what} died before binding "
                                 f"(rc={proc.returncode})\n{err[-3000:]}")
        time.sleep(0.05)
    proc.kill()
    raise AssertionError(f"{what} never wrote its port file")


def spawn_shard(root, sid, plan_path=None):
    port_file = os.path.join(root, f"serve_{sid:04d}.port")
    if os.path.exists(port_file):  # never race a stale port
        os.remove(port_file)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tse1m_tpu_torch", "serve", "--root", root,
         "--range", str(sid), "--device", "cpu"],
        env=_env(plan_path), cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    return proc, _wait_port(proc, port_file, f"shard {sid}")


def spawn_router(root, port_file):
    proc = subprocess.Popen(
        [sys.executable, "-m", "tse1m_tpu_torch", "serve-router", "--root",
         root, "--shards", str(SHARDS), "--port-file", port_file],
        env=_env(), cwd=REPO, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    return proc, _wait_port(proc, port_file, "serve-router")


def _stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=CHILD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def oracle_round(items, root):
    params = ClusterParams()
    daemons = {sid: ServeDaemon(os.path.join(root, f"range_{sid:04d}"),
                                params=params, state_commit_every=1,
                                device="cpu").start()
               for sid in range(SHARDS)}
    try:
        router = ShardRouter({s: LocalTransport(d)
                              for s, d in daemons.items()})
        for i, lo in enumerate(range(0, len(items), BATCH)):
            assert router.ingest(items[lo:lo + BATCH], timeout=300,
                                 request_id=f"b{i:04d}")["ok"]
        router.quiesce(timeout=300)
        final = router.query(items)
        rows = sum(int(d._index.n_rows) for d in daemons.values())
        router.close()
    finally:
        for d in daemons.values():
            d.stop(commit=False)
    assert final["known"].all()
    return final["labels"], rows


def sharded_kill_round(tmp, router_child):
    items = synth_session_sets(N, set_size=64, seed=13)[0]
    oracle_labels, oracle_rows = oracle_round(items,
                                              os.path.join(tmp, "oracle"))
    root = os.path.join(tmp, "root")
    os.makedirs(root)
    plan_path = os.path.join(tmp, "plan.json")
    with open(plan_path, "w", encoding="utf-8") as f:
        json.dump({"rules": [{"site": "serve.ingest.commit", "kind": "kill",
                              "after_calls": KILL_BATCH}]}, f)
    procs = []
    victim, _ = spawn_shard(root, 0, plan_path)
    procs.append(victim)
    procs.append(spawn_shard(root, 1)[0])
    respawned = {}

    def watch_and_respawn():
        try:
            victim.wait(timeout=CHILD_TIMEOUT_S)
            respawned["proc"], _ = spawn_shard(root, 0)
        except Exception as e:  # noqa: BLE001 - reported by the main thread
            respawned["error"] = e

    watcher = threading.Thread(target=watch_and_respawn, daemon=True)
    watcher.start()
    router = client = None
    acks = []
    try:
        if router_child:
            rproc, rport = spawn_router(root, os.path.join(tmp, "router"))
            procs.append(rproc)
            client = ServeClient(port=rport)
            ingest = lambda v, rid: client.ingest(  # noqa: E731
                v, timeout_s=CHILD_TIMEOUT_S, request_id=rid)
            query = lambda v: client.query(  # noqa: E731
                v, timeout_s=CHILD_TIMEOUT_S)
        else:
            router = ShardRouter(
                {sid: TcpTransport(port_file=os.path.join(
                    root, f"serve_{sid:04d}.port")) for sid in range(SHARDS)})
            ingest = lambda v, rid: router.ingest(  # noqa: E731
                v, timeout=CHILD_TIMEOUT_S, request_id=rid)
            query = router.query
        for i, lo in enumerate(range(0, N, BATCH)):
            r = ingest(items[lo:lo + BATCH], f"b{i:04d}")
            assert r["ok"], r
            acks.append(r)
        watcher.join(timeout=CHILD_TIMEOUT_S)
        assert not watcher.is_alive() and "error" not in respawned, respawned
        procs.append(respawned["proc"])
        assert victim.returncode == -signal.SIGKILL, victim.returncode
        # The kill seat's flight dump names it.
        flights = sorted(glob.glob(os.path.join(root, "range_0000",
                                                "flight_*.json")))
        assert flights, "the kill seat left no flight dump"
        with open(flights[-1], encoding="utf-8") as f:
            flight = json.load(f)
        assert (flight["reason"], flight["site"]) == \
            ("fault.kill", "serve.ingest.commit")
        # The replacement claimed the next epoch.
        assert read_lease(root, 0)["epoch"] == 2
        assert read_lease(root, 1)["epoch"] == 1
        final = query(items)
        lost = int((~np.asarray(final["known"])).sum())
        if router_child:
            client.quiesce(timeout_s=CHILD_TIMEOUT_S)
            status = client.status()
        else:
            router.quiesce(timeout=CHILD_TIMEOUT_S)
            status = router.status()
        rows = sum(int(s["rows"]) for s in status["shard_status"].values())
        return {"lost_acked": lost, "rows": rows, "oracle_rows": oracle_rows,
                "acked_batches": len(acks),
                "labels_equal": bool(np.array_equal(final["labels"],
                                                    oracle_labels)),
                "status_ok": bool(status["ok"]),
                "router_rows": int(status["router_rows"])}
    finally:
        if client is not None:
            client.close()
        if router is not None:
            router.close()
        for proc in procs + [respawned.get("proc")]:
            if proc is not None:
                _stop(proc)
        watcher.join(timeout=5)


@pytest.mark.parametrize("router_child", [False, True],
                         ids=["router_in_process", "router_child"])
def test_sharded_sigkill_round(tmp_path, router_child):
    got = sharded_kill_round(str(tmp_path), router_child)
    assert got["lost_acked"] == 0
    assert got["rows"] == got["oracle_rows"] == N
    assert got["acked_batches"] == N // BATCH
    assert got["labels_equal"]
    assert got["status_ok"] and got["router_rows"] == N
