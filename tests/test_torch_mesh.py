"""The port's mesh on the CPU: ``cluster_sessions(mesh=)`` over gloo worlds
of 3 and 4 ranks against the JAX package's ``cluster_sessions`` on a mesh
of as many forced CPU devices, and against the single-device run.

Each world is spawned once for the file (one process a rank, rendezvous
through ``file://`` under a temporary directory); its workers run the
code string ``WORKER``, which imports only ``tse1m_tpu_torch``, run every
case and write their labels as ``.npy`` and their run info, mesh stats and
refusals as JSON.  Every rank's labels must equal JAX's mesh labels and
the port's single-device labels element for element (tolerance: exact),
under kminhash and cminhash, with band padding (32 hashes in 4 bands over
3 ranks), row padding (1,003 rows), the 24-bit pack against the raw feed,
ids of 2^24 and more, a pre-sharded feed and an explicit quantization.
The refusals come in JAX's order and words; ``detection_hist_sharded``
equals its bincount oracle.  These mirror tests/test_cluster.py:129-165
and tests/test_multihost.py:41-159."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from tse1m_tpu.cluster import ClusterParams as JParams
from tse1m_tpu.cluster import cluster_sessions as jcluster
from tse1m_tpu.cluster import pipeline as jpipeline
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.parallel import make_mesh, multihost

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (3, 4)
WORLD_TIMEOUT_S = 240

# name -> (rows, set size, seed, ids transform, ClusterParams fields).
CASES = {
    "kminhash": (2000, 32, 3, None, {}),
    "cminhash": (2000, 32, 3, None, {"scheme": "cminhash"}),
    "band_padding": (2000, 32, 3, None, {"n_hashes": 32, "n_bands": 4}),
    "row_padding": (1003, 16, 11, None, {}),
    "raw_feed": (2000, 32, 3, "raw", {}),
    "high_ids": (2000, 32, 3, "high", {}),
    "high_ids_cminhash": (2000, 32, 3, "high", {"scheme": "cminhash"}),
    "quant10": (2000, 32, 3, None, {"wire_quant_bits": 10}),
}
HIST_MAX_ITER = 30

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
from tse1m_tpu_torch.cluster import pipeline as P
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.parallel import detection_hist_sharded, make_mesh
from tse1m_tpu_torch.parallel import multihost

a = json.loads(sys.argv[1])
os.environ["TSE1M_NUM_PROCESSES"] = str(a["world"])
os.environ["TSE1M_PROCESS_ID"] = str(a["rank"])
assert multihost.initialize_from_env(device="cpu", init_method=a["init"])
mesh = make_mesh()
rank, out = a["rank"], a["out"]
report = {"info": {}, "stats": {}, "errors": {}}


def items_of(n, s, seed, how):
    items = synth_session_sets(n, s, seed=seed)[0]
    if how == "high":
        items = (items.astype(np.uint64) + (1 << 28)).astype(np.uint32)
    return items


for name, (n, s, seed, how, fields) in a["cases"].items():
    items = items_of(n, s, seed, how)
    P._PACK_LIMIT = 0 if how == "raw" else 1 << 24
    mesh.reset_stats()
    labels = P.cluster_sessions(items, P.ClusterParams(**fields), mesh=mesh,
                                device="cpu")
    np.save(os.path.join(out, f"{name}.r{rank}.npy"), labels)
    report["info"][name] = {k: v for k, v in P.last_run_info.items()
                            if k != "stages"}
    report["info"][name]["stage_keys"] = sorted(P.last_run_info["stages"])
    report["stats"][name] = json.loads(json.dumps(mesh.stats))
P._PACK_LIMIT = 1 << 24

# The pre-sharded feed: each rank puts only its own logical rows.
items = items_of(1003, 16, 11, None)
lo, hi = multihost.local_row_range(multihost.padded_row_count(1003, mesh))
rows, n_pad = multihost.put_process_local_padded(items[lo:min(hi, 1003)],
                                                 1003, mesh)
labels = P.cluster_sessions(rows, P.ClusterParams(), mesh=mesh,
                            device="cpu")[:1003]
np.save(os.path.join(out, f"presharded.r{rank}.npy"), labels)
report["info"]["presharded"] = {"encoding": P.last_run_info["encoding"],
                                "n_pad": n_pad, "range": [lo, hi]}

it = np.random.default_rng(5).integers(0, a["hist_max_iter"] + 10,
                                        size=1001)
hist = detection_hist_sharded(it, a["hist_max_iter"], mesh)
np.save(os.path.join(out, f"hist.r{rank}.npy"), hist.numpy())


def refusal(key, fn):
    try:
        fn()
    except Exception as e:  # the refusal is what is recorded
        report["errors"][key] = [type(e).__name__, str(e)]
    else:
        report["errors"][key] = None


small = items_of(12, 4, 0, None)
refusal("prefilter_on", lambda: P.cluster_sessions(
    small, P.ClusterParams(prefilter="on"), mesh=mesh, device="cpu"))
refusal("sig_store", lambda: P.cluster_sessions(
    small, P.ClusterParams(sig_store=out), mesh=mesh, device="cpu"))
refusal("prefilter_on_and_bad_encoding", lambda: P.cluster_sessions(
    small, P.ClusterParams(prefilter="on", encoding="zstd"), mesh=mesh,
    device="cpu"))
refusal("prefilter_on_and_sig_store", lambda: P.cluster_sessions(
    small, P.ClusterParams(prefilter="on", sig_store=out), mesh=mesh,
    device="cpu"))
refusal("unpadded_presharded", lambda: P.cluster_sessions(
    multihost.ShardedRows(torch.zeros((5, 4), dtype=torch.int32),
                          a["world"] * 5 + 1),
    P.ClusterParams(), mesh=mesh, device="cpu"))
refusal("not_a_mesh", lambda: P.cluster_sessions(
    small, P.ClusterParams(), mesh=object(), device="cpu"))
refusal("more_ranks", lambda: make_mesh(a["world"] + 1))
refusal("fewer_ranks", lambda: make_mesh(a["world"] - 1))
with open(os.path.join(out, f"report.r{rank}.json"), "w") as f:
    json.dump(report, f)
multihost.shutdown()
'''


def spawn_world(world: int, args: dict, tmp) -> list:
    """Run ``WORKER`` as each rank of a world; return the rank processes'
    outputs after every rank exited 0."""
    init = f"file://{tmp}/rendezvous"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER,
         json.dumps(dict(args, rank=r, world=world, init=init, out=str(tmp)))],
        cwd=str(tmp), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    outs = []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=WORLD_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, text))
    assert all(rc == 0 for rc, _ in outs), [t[-3000:] for _, t in outs]
    return outs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"mesh{world}")
        spawn_world(world, {"cases": CASES, "hist_max_iter": HIST_MAX_ITER},
                    tmp)
        out[world] = tmp
    return out


def _items(case: str) -> np.ndarray:
    n, s, seed, how, _ = CASES[case]
    items = synth_session_sets(n, s, seed=seed)[0]
    if how == "high":
        items = (items.astype(np.uint64) + (1 << 28)).astype(np.uint32)
    return items


def _jmesh(world: int):
    return jax.sharding.Mesh(np.array(jax.devices()[:world]), ("data",))


def _labels(tmp, case: str, world: int) -> list:
    return [np.load(os.path.join(tmp, f"{case}.r{r}.npy"))
            for r in range(world)]


def _report(tmp, rank: int) -> dict:
    with open(os.path.join(tmp, f"report.r{rank}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_mesh_labels_equal_jax_mesh_and_single_device(worlds, monkeypatch,
                                                      world, case):
    items = _items(case)
    fields = CASES[case][4]
    if CASES[case][3] == "raw":
        monkeypatch.setattr(jpipeline, "_PACK_LIMIT", 0)
    want = jcluster(items, JParams(use_pallas="never", **fields),
                    mesh=_jmesh(world))
    single = tpipe.cluster_sessions(items, tpipe.ClusterParams(**fields),
                                    device="cpu")
    np.testing.assert_array_equal(single, want)
    for labels in _labels(worlds[world], case, world):
        assert labels.dtype == np.int32 and labels.shape == want.shape
        np.testing.assert_array_equal(labels, want)
    # The run info JAX records for a mesh run.
    j_info = dict(jpipeline.last_run_info)
    for r in range(world):
        info = _report(worlds[world], r)["info"][case]
        for key in ("encoding", "wire_mb", "wire_quant_bits",
                    "chunk_halvings"):
            assert info.get(key) == j_info.get(key), (key, info, j_info)
        # The port adds one counter JAX does not record: the steps its
        # label propagation ran, two pmin each.
        assert set(info) - {"stage_keys", "propagate_steps"} \
            == set(j_info) - {"stages"}
        assert info["stage_keys"] == sorted(j_info["stages"])
        steps = info["propagate_steps"]
        assert 1 <= steps <= JParams().n_iters
        assert _report(worlds[world], r)["stats"][case]["pmin"]["calls"] \
            == 2 * steps


@pytest.mark.parametrize("world", WORLDS)
def test_pack24_and_raw_feed_agree(worlds, world):
    tmp = worlds[world]
    packed = _labels(tmp, "kminhash", world)
    raw = _labels(tmp, "raw_feed", world)
    for p, r in zip(packed, raw):
        np.testing.assert_array_equal(p, r)
    info = _report(tmp, 0)["info"]
    assert info["kminhash"]["encoding"] == "mesh-pack24"
    assert info["raw_feed"]["encoding"] == "mesh-raw"
    assert info["high_ids"]["encoding"] == "mesh-raw"
    # The pack ships three bytes an id where the raw feed ships four.
    assert info["kminhash"]["wire_mb"] < info["raw_feed"]["wire_mb"]


@pytest.mark.parametrize("world", WORLDS)
def test_presharded_feed_equals_host_feed(worlds, world):
    tmp = worlds[world]
    items = _items("row_padding")
    want = tpipe.cluster_sessions(items, tpipe.ClusterParams(), device="cpu")
    n_pad = -(-1003 // world) * world
    per = n_pad // world
    for r, labels in enumerate(_labels(tmp, "presharded", world)):
        np.testing.assert_array_equal(labels, want)
        info = _report(tmp, r)["info"]["presharded"]
        assert info["encoding"] == "mesh-presharded"
        assert info["n_pad"] == n_pad
        assert info["range"] == [r * per, (r + 1) * per]


@pytest.mark.parametrize("world", WORLDS)
def test_collectives_and_band_padding(worlds, world):
    """One key exchange and one signature gather a run; two pmins an
    iteration of the propagation; the padded band count's bytes."""
    tmp = worlds[world]
    for case, (n, s, _, _, fields) in CASES.items():
        n_bands = fields.get("n_bands", 16)
        n_hashes = fields.get("n_hashes", 128)
        padded_bands = -(-n_bands // world) * world
        nl = -(-n // world)
        for r in range(world):
            st = _report(tmp, r)["stats"][case]
            assert st["all_to_all"]["calls"] == 1
            assert st["all_to_all"]["bytes"] == nl * padded_bands * 4
            assert st["all_gather"]["calls"] == 1
            assert st["all_gather"]["bytes"] == nl * world * n_hashes * 4
            assert st["pmin"]["calls"] % 2 == 0 and st["pmin"]["calls"] >= 2
            assert st["pmin"]["bytes"] == st["pmin"]["calls"] * nl * world * 8
            assert set(st) == {"all_to_all", "all_gather", "pmin"}


@pytest.mark.parametrize("world", WORLDS)
def test_detection_hist_sharded_matches_oracle(worlds, world):
    it = np.random.default_rng(5).integers(0, HIST_MAX_ITER + 10, size=1001)
    in_range = (it >= 1) & (it <= HIST_MAX_ITER)
    want = np.bincount(np.where(in_range, it, 0),
                       minlength=HIST_MAX_ITER + 1)[1:]
    for r in range(world):
        got = np.load(os.path.join(worlds[world], f"hist.r{r}.npy"))
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def _jax_refusal(fn):
    with pytest.raises(Exception) as e:
        fn()
    return [type(e.value).__name__, str(e.value)]


@pytest.mark.parametrize("world", WORLDS)
def test_refusals_in_jax_order_and_words(worlds, world, tmp_path):
    mesh = _jmesh(world)
    small = synth_session_sets(12, 4, seed=0)[0]
    store = str(tmp_path)
    want = {
        "prefilter_on": _jax_refusal(lambda: jcluster(
            small, JParams(prefilter="on"), mesh=mesh)),
        "sig_store": _jax_refusal(lambda: jcluster(
            small, JParams(sig_store=store), mesh=mesh)),
        "prefilter_on_and_bad_encoding": _jax_refusal(lambda: jcluster(
            small, JParams(prefilter="on", encoding="zstd"), mesh=mesh)),
        "prefilter_on_and_sig_store": _jax_refusal(lambda: jcluster(
            small, JParams(prefilter="on", sig_store=store), mesh=mesh)),
        "unpadded_presharded": _jax_refusal(lambda: jcluster(
            jax.device_put(np.zeros((world * 5 + 1, 4), np.uint32)),
            JParams(), mesh=mesh)),
    }
    for r in range(world):
        got = _report(worlds[world], r)["errors"]
        for key in ("prefilter_on", "prefilter_on_and_bad_encoding",
                    "prefilter_on_and_sig_store", "unpadded_presharded",
                    "sig_store"):
            assert got[key] == want[key], key
        assert "cluster_sessions_pod" in got["sig_store"][1]
        assert got["not_a_mesh"][0] == "TypeError"
        assert got["more_ranks"] == [
            "ValueError", f"requested {world + 1} devices, have {world}"]
        # JAX gives a mesh of the first n devices; here every rank of the
        # world runs the same code, so a mesh spans the whole world.
        assert got["fewer_ranks"][0] == "ValueError"
        assert "spans the whole world" in got["fewer_ranks"][1]


def test_no_world_no_mesh(monkeypatch):
    for var in ("TSE1M_COORDINATOR", "TSE1M_NUM_PROCESSES",
                "TSE1M_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize_from_env(device="cpu") is False
    with pytest.raises(ValueError, match="no torch.distributed world"):
        make_mesh()
    assert multihost.local_row_range(101) == (0, 101)
    assert multihost.padded_row_count(101) == 101
    assert multihost.pod_process_env() == (1, 0)
    multihost.all_processes_ready("noop")
    monkeypatch.setenv("TSE1M_COORDINATOR", "127.0.0.1:1")
    monkeypatch.setenv("TSE1M_NUM_PROCESSES", "2")
    with pytest.raises(RuntimeError, match="TSE1M_PROCESS_ID"):
        multihost.initialize_from_env(device="cpu")
