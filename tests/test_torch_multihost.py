"""The port's commands under a world on the CPU, and its manifest merge.

- ``python -m tse1m_tpu_torch cluster`` as 2 processes under the
  ``TSE1M_*`` variables (``--device cpu``, a ``file://`` rendezvous):
  each rank reports the single-process run's clusters and ARI, writes a
  manifest fragment, and process 0 merges them into one
  ``run_manifest.json`` (the port's form of
  tests/test_multihost_multiprocess.py:107).
- ``all`` as 2 ranks over the golden study: rank 0's files equal a
  single-rank run's byte for byte (and the goldens), rank 0 prints the
  single run's transcript, and rank 1 writes and prints nothing.
- ``merge_run_manifests`` equals the JAX package's on the fragments of
  tests/test_pod_supervision.py:192-240 and tests/test_telemetry.py:234.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from tse1m_tpu.observability import merge as jmerge
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster.pipeline import ClusterParams
from tse1m_tpu_torch.observability import merge as tmerge
from tse1m_tpu_torch.data.synth import SynthSpec, generate_study

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GEN = os.path.join(REPO, "tests", "goldens", "generate_goldens.py")
_spec = importlib.util.spec_from_file_location("generate_goldens", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)
TIMEOUT_S = 300
N_CLUSTER = 3000


def _env(**extra) -> dict:
    env = {k: v for k, v in os.environ.items() if not k.startswith("TSE1M_")}
    env.update(PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1", **extra)
    return env


def _world_env(init: str, world: int, rank: int, **extra) -> dict:
    return _env(TSE1M_COORDINATOR=init, TSE1M_NUM_PROCESSES=str(world),
                TSE1M_PROCESS_ID=str(rank), **extra)


def _run_all(procs: list) -> list:
    """(returncode, stdout, stderr) of each process, every one waited
    for."""
    out = []
    for p in procs:
        try:
            so, se = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        out.append((p.returncode, so, se))
    return out


def _popen(args: list, env: dict, cwd) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "tse1m_tpu_torch", *args],
                            cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def cluster_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cluster_world")
    args = ["cluster", "--n", str(N_CLUSTER), "--device", "cpu"]
    init = f"file://{d}/rendezvous"
    procs = [_popen(args, _world_env(init, 2, r,
                                     TSE1M_RESULT_DIR=str(d / "world")), d)
             for r in range(2)]
    procs.append(_popen(args, _env(TSE1M_RESULT_DIR=str(d / "single")), d))
    return d, _run_all(procs)


def _report(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])


def test_cluster_world_reports_the_single_process_run(cluster_runs):
    d, runs = cluster_runs
    for rc, _, se in runs:
        assert rc == 0, se[-3000:]
    single = _report(runs[2][1])
    assert single["encoding"] != "mesh-presharded"
    for rank in (0, 1):
        got = _report(runs[rank][1])
        for key in ("n_sessions", "n_clusters", "ari_vs_planted",
                    "ari_vs_host_sample", "ari_sample_n", "set_width"):
            assert got[key] == single[key], key
        assert got["encoding"] == "mesh-presharded"
        assert got["processes"] == 2
        assert got["chunk_halvings"] == 0
        # The mesh run's label propagation: at least one step, at most
        # the cap.
        assert 1 <= got["propagate_steps"] <= ClusterParams().n_iters
    assert "propagate_steps" not in single


def test_cluster_world_merges_one_manifest(cluster_runs):
    d, runs = cluster_runs
    world = d / "world"
    single = _report(runs[2][1])
    for rank in (0, 1):
        assert (world / f"run_manifest.p{rank:03d}.json").exists()
    merged = json.loads((world / "run_manifest.json").read_text())
    assert merged["ok"] is True
    assert merged["pod"]["n_processes"] == 2
    assert merged["pod"]["merged_from"] == [0, 1]
    assert merged["pod"]["missing"] == []
    assert [s["process"] for s in merged["steps"]] == [0, 1]
    for step in merged["steps"]:
        assert step["name"] == "cluster" and step["status"] == "ok"
        assert step["result"]["n_clusters"] == single["n_clusters"]
        assert step["result"]["ari_vs_planted"] == single["ari_vs_planted"]
    # The merge is the JAX package's over the same fragments.
    assert merged == jmerge.merge_run_manifests(
        str(world), 2, out_path=str(d / "jax_merged.json"))


def test_sig_store_under_a_world_is_the_pod_path(tmp_path, monkeypatch,
                                                capsys):
    """``cluster --sig-store`` under TSE1M_NUM_PROCESSES=2 is the pod path:
    no torch.distributed world starts (not even with a coordinator set);
    with no peer ever beating, process 0 declares it lost, fails over
    alone, and reports the single-process run's clusters and ARI."""
    import torch.distributed as dist

    from tse1m_tpu_torch.observability import pop_degradation_events

    for k, v in {"TSE1M_NUM_PROCESSES": "2", "TSE1M_PROCESS_ID": "0",
                 "TSE1M_COORDINATOR": "127.0.0.1:1",
                 "TSE1M_HEARTBEAT_INTERVAL_S": "0.05",
                 "TSE1M_HEARTBEAT_TIMEOUT_S": "0.5", "TSE1M_WATCHDOG": "0",
                 "TSE1M_ROUTER_CAL": "",
                 "TSE1M_RESULT_DIR": str(tmp_path / "out")}.items():
        monkeypatch.setenv(k, v)
    assert cli_main(["cluster", "--n", "300", "--device", "cpu",
                     "--ari-sample", "0", "--sig-store",
                     str(tmp_path / "store")]) == 0
    assert not dist.is_initialized()
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rep["pod_survivor"], rep["pod_lost"], rep["pod_epoch"]) == (
        0, [1], 1)
    assert rep["encoding"] == "pod-store" and rep["pod_processes"] == 1
    for k in ("TSE1M_NUM_PROCESSES", "TSE1M_PROCESS_ID",
              "TSE1M_COORDINATOR"):
        monkeypatch.delenv(k)
    assert cli_main(["cluster", "--n", "300", "--device", "cpu",
                     "--ari-sample", "0"]) == 0
    single = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rep["n_clusters"], rep["ari_vs_planted"]) == (
        single["n_clusters"], single["ari_vs_planted"])
    merged = json.load(open(tmp_path / "out" / "run_manifest.p000.json"))
    assert merged["epoch"] == 1
    pop_degradation_events()


@pytest.fixture(scope="module")
def all_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("all_world")
    study = generate_study(SynthSpec(**gen.SPEC))
    db, csv = str(d / "study.sqlite"), str(d / "corpus.csv")
    study.to_db(db)
    study.write_corpus_csv(csv)

    def args(out: str) -> list:
        return ["all", "--db", db, "--result-dir", out, "--test-mode",
                "--corpus-csv", csv, "--device", "cpu"]

    # Figures carry no creation time under SOURCE_DATE_EPOCH.
    init = f"file://{d}/rendezvous"
    procs = [_popen(args(str(d / "world")),
                    _world_env(init, 2, r, SOURCE_DATE_EPOCH="0"), d)
             for r in range(2)]
    procs.append(_popen(args(str(d / "single")),
                        _env(SOURCE_DATE_EPOCH="0"), d))
    return d, _run_all(procs)


def _files(root) -> dict:
    out = {}
    for base, _, names in os.walk(root):
        for n in names:
            p = os.path.join(base, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_all_world_rank0_writes_the_single_run_files(all_runs):
    d, runs = all_runs
    for rc, _, se in runs:
        assert rc == 0, se[-3000:]
    world, single = _files(d / "world"), _files(d / "single")
    assert sorted(world) == sorted(single)
    data = [rel for rel in single if not rel.endswith(".json")]
    assert set(gen.FILES) <= set(data)
    for rel in data:
        assert world[rel] == single[rel], rel
    for rel in gen.FILES:
        with open(os.path.join(gen.GOLDEN_DIR, rel), "rb") as f:
            assert world[rel] == f.read(), rel
    manifest = json.loads(world["run_manifest.json"])
    assert manifest["ok"] is True
    assert {s["status"] for s in manifest["steps"]} == {"ok"}
    # Rank 0 prints the transcript a single rank prints; rank 1 nothing.
    assert runs[0][1] == runs[2][1]
    assert runs[1][1] == ""


def _fragment(ok: bool, counts: dict, steps: list) -> dict:
    return {"ok": ok, "degradation_counts": counts, "steps": steps,
            "summary": {"ok": len(steps)}, "started_at": "t",
            "wall_seconds": 1.5}


def _telemetry_fragment(pid: int, hits: int, depth: float) -> dict:
    return {
        "ok": True, "summary": {"ok": 1}, "steps": [],
        "degradation_counts": {}, "trace_id": "cafe" * 4,
        "metrics": {
            "counters": [{"name": "hits", "labels": {}, "value": hits}],
            "gauges": [{"name": "depth", "labels": {}, "value": depth}],
            "histograms": [{"name": "lat_s", "labels": {}, "count": 2,
                            "sum": 0.5, "p50_ms": 1.0,
                            "p99_ms": float(pid + 1), "max_ms": 9.0,
                            "buckets": []}],
        },
    }


FRAGMENT_SETS = {
    "summed": {0: _fragment(True, {"chunk_halving": 1},
                            [{"step": "cluster", "status": "ok"}]),
               1: _fragment(True, {"chunk_halving": 2, "host_lost": 1},
                            [{"step": "cluster", "status": "ok"}])},
    "missing": {0: _fragment(True, {}, [{"step": "cluster",
                                         "status": "ok"}])},
    "failed": {0: _fragment(True, {}, []), 1: _fragment(False, {}, [])},
    "telemetry": {0: _telemetry_fragment(0, 2, 3.0),
                  1: _telemetry_fragment(1, 5, 1.0)},
    "epochs": {0: dict(_fragment(True, {}, [{"step": "a"}]), epoch=2),
               1: dict(_fragment(True, {"x": 1}, [{"step": "b"}]),
                       epoch=3, started_at="s")},
}


@pytest.mark.parametrize("case", sorted(FRAGMENT_SETS))
def test_merge_equals_jax(tmp_path, case):
    dirs = {}
    for pkg in ("torch", "jax"):
        d = tmp_path / pkg
        d.mkdir()
        for pid, frag in FRAGMENT_SETS[case].items():
            with open(tmp_path / pkg / f"run_manifest.p{pid:03d}.json",
                      "w") as f:
                json.dump(frag, f)
        dirs[pkg] = str(d)
    got = tmerge.merge_run_manifests(dirs["torch"], 2)
    want = jmerge.merge_run_manifests(dirs["jax"], 2)
    assert got == want
    with open(os.path.join(dirs["torch"], "run_manifest.json"), "rb") as f:
        got_bytes = f.read()
    with open(os.path.join(dirs["jax"], "run_manifest.json"), "rb") as f:
        assert got_bytes == f.read()
    assert tmerge.fragment_manifest_path(dirs["torch"], 7) == \
        os.path.join(dirs["torch"], "run_manifest.p007.json")
    n = len(FRAGMENT_SETS[case])
    assert tmerge.sweep_stale_fragments(dirs["torch"]) == n
    assert tmerge.sweep_stale_fragments(dirs["torch"]) == 0
