"""The port's profiler regions (``observability.tracing.region``) on the
two measured paths, on the CPU.

A gloo world of one rank, started in this process through a ``file://``
rendezvous under a temporary directory, runs ``cluster_sessions(mesh=)``
under a CPU ``torch.profiler``; a signature store of three shards runs
``bulk_topk_store``.  Each exported Chrome trace must hold the regions
that the benchmark's region metrics read (``benchmark/metrics/``), nested
as the code opens them: one ``tse1m.lsh.step`` a step of
``last_run_info["propagate_steps"]``, two ``tse1m.mesh.pmin`` a step, one
``tse1m.scan.chunk`` a chunk.  Labels and top-k answers are equal bit for
bit with and without the profiler.  Without a profiler ``region`` is the
shared no-op; a ``tracing.span`` is also the region of its name, and its
ring record keeps its keys."""

import json
from collections import Counter

import numpy as np
import pytest
import torch

from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.cluster import store as tstore
from tse1m_tpu_torch.cluster.kernels import score as ksc
from tse1m_tpu_torch.data import synth_session_sets
from tse1m_tpu_torch.observability import tracing
from tse1m_tpu_torch.parallel import make_mesh, multihost

H = 16
POLICY = {"n_hashes": H, "seed": 0, "quant_bits": 0}
SHARDS = (300, 515, 77)
CHUNK_ROWS = 128
RING_KEYS = {"trace", "span", "parent", "name", "start_s", "dur_s", "ok",
             "tags", "pid"}
# The mesh path's regions: each name -> the region it lies inside (None:
# directly under the call).
MESH_REGIONS = {
    "tse1m.consts": None, "tse1m.minhash": None, "tse1m.lsh": None,
    "tse1m.mesh.all_to_all": "tse1m.lsh",
    "tse1m.mesh.all_gather": "tse1m.lsh",
    "tse1m.lsh.elect": "tse1m.lsh", "tse1m.lsh.jaccard": "tse1m.lsh",
    "tse1m.lsh.propagate": "tse1m.lsh",
    "tse1m.lsh.step": "tse1m.lsh.propagate",
    "tse1m.mesh.pmin": "tse1m.lsh.step",
    "tse1m.lsh.converge": "tse1m.lsh.step",
    "tse1m.sync": None, "tse1m.fetch": None,
}


def _traced(fn, path):
    """(fn's result, [(name, start, end)] of the trace's user
    annotations) with ``fn`` run under a CPU profiler."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return out, [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                 for e in events if e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _ours(regions, prefix="tse1m."):
    return [r for r in regions if r[0].startswith(prefix)]


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    rendezvous = tmp_path_factory.mktemp("world") / "rendezvous"
    multihost.init_world(1, 0, f"file://{rendezvous}", "cpu")
    try:
        yield make_mesh()
    finally:
        multihost.shutdown()


@pytest.fixture(scope="module")
def mesh_run(mesh, tmp_path_factory):
    """A mesh clustering call untraced, then traced: (items, labels
    untraced, labels traced, the traced call's run info, its regions)."""
    items = synth_session_sets(2000, 32, seed=3)[0]

    def call():
        return tpipe.cluster_sessions(items, tpipe.ClusterParams(),
                                      mesh=mesh, device="cpu")

    plain = call()
    traced, regions = _traced(
        call, tmp_path_factory.mktemp("trace") / "mesh.json")
    return items, plain, traced, dict(tpipe.last_run_info), regions


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A store of three shards and its signatures in scan order."""
    path = tmp_path_factory.mktemp("store") / "s"
    rng = np.random.default_rng(0)
    st = tstore.SignatureStore(str(path), POLICY)
    sigs = []
    for i, n in enumerate(SHARDS):
        ids = rng.integers(0, 1 << 32, size=(n, 4), dtype=np.uint64)
        sig = rng.integers(0, 3, size=(n, H), dtype=np.uint64)
        st.append(tstore.row_digests(ids.astype(np.uint32) + np.uint32(i)),
                  sig.astype(np.uint32))
        sigs.append(sig.astype(np.uint32))
    return tstore.SignatureStore(str(path), POLICY), np.concatenate(sigs)


def test_mesh_call_exports_every_region_nested(mesh_run):
    _, _, _, _, regions = mesh_run
    ours = _ours(regions)
    names = Counter(r[0] for r in ours)
    assert set(names) == set(MESH_REGIONS), names
    for name in ("tse1m.consts", "tse1m.minhash", "tse1m.lsh",
                 "tse1m.mesh.all_to_all", "tse1m.mesh.all_gather",
                 "tse1m.lsh.elect", "tse1m.lsh.jaccard",
                 "tse1m.lsh.propagate", "tse1m.sync", "tse1m.fetch"):
        assert names[name] == 1, (name, names)
    for r in ours:
        parent = MESH_REGIONS[r[0]]
        if parent is None:
            assert not any(_inside(r, o) for o in ours if o is not r), r
        else:
            assert any(o[0] == parent and _inside(r, o) for o in ours), r
    # The call's stages come in the order the call runs them.
    top = sorted((r for r in ours if MESH_REGIONS[r[0]] is None),
                 key=lambda r: r[1])
    assert [r[0] for r in top] == ["tse1m.consts", "tse1m.minhash",
                                   "tse1m.lsh", "tse1m.sync", "tse1m.fetch"]
    assert all(a[2] <= b[1] for a, b in zip(top, top[1:]))


def test_step_regions_count_the_propagation_steps(mesh_run):
    _, _, _, info, regions = mesh_run
    names = Counter(r[0] for r in regions)
    steps = info["propagate_steps"]
    assert isinstance(steps, int) and 1 <= steps <= tpipe.ClusterParams(
        ).n_iters
    assert names["tse1m.lsh.step"] == steps
    assert names["tse1m.lsh.converge"] == steps
    assert names["tse1m.mesh.pmin"] == 2 * steps


def test_mesh_labels_equal_with_and_without_the_profiler(mesh_run):
    items, plain, traced, _, _ = mesh_run
    single = tpipe.cluster_sessions(items, tpipe.ClusterParams(),
                                    device="cpu")
    assert traced.dtype == plain.dtype == np.int32
    np.testing.assert_array_equal(traced, plain)
    np.testing.assert_array_equal(plain, single)


def test_mesh_stats_unchanged_by_the_regions(mesh, mesh_run):
    items = mesh_run[0]
    mesh.reset_stats()
    tpipe.cluster_sessions(items, tpipe.ClusterParams(), mesh=mesh,
                           device="cpu")
    steps = tpipe.last_run_info["propagate_steps"]
    assert set(mesh.stats) == {"pmin", "all_gather", "all_to_all"}
    assert mesh.stats["pmin"]["calls"] == 2 * steps
    for s in mesh.stats.values():
        assert set(s) == {"calls", "bytes", "seconds"}
        assert s["seconds"] >= 0.0


@pytest.mark.parametrize("overlap", [True, False])
def test_scan_exports_prepare_chunks_finalize(store, tmp_path, overlap):
    st, scan = store
    queries = scan[[5, 400, 850]]

    def call():
        return ksc.bulk_topk_store(st, queries, 3, device="cpu",
                                   block_n=CHUNK_ROWS, chunk_rows=CHUNK_ROWS,
                                   overlap=overlap)

    plain = call()
    traced, regions = _traced(call, tmp_path / "scan.json")
    chunks = sum(-(-n // CHUNK_ROWS) for n in SHARDS)
    names = Counter(r[0] for r in _ours(regions))
    assert names["tse1m.scan.prepare"] == 1
    assert names["tse1m.scan.finalize"] == 1
    assert names["tse1m.scan.chunk"] == chunks
    # The producer's start and the waits are the main thread's: one
    # start, one wait a chunk, beside the chunks.
    assert names["tse1m.scan.stage_setup"] == (1 if overlap else 0)
    assert names["tse1m.scan.wait"] == (chunks if overlap else 0)
    assert set(names) <= {"tse1m.scan.prepare", "tse1m.scan.finalize",
                          "tse1m.scan.chunk", "tse1m.scan.wait",
                          "tse1m.scan.stage_setup"}, names
    ours = _ours(regions, "tse1m.scan.")
    prep = next(r for r in ours if r[0] == "tse1m.scan.prepare")
    fin = next(r for r in ours if r[0] == "tse1m.scan.finalize")
    for r in ours:
        if r[0] in ("tse1m.scan.chunk", "tse1m.scan.wait",
                    "tse1m.scan.stage_setup"):
            assert prep[2] <= r[1] and r[2] <= fin[1], r
            assert not any(_inside(r, o) for o in ours
                           if o[0] == "tse1m.scan.chunk" and o is not r)
    for got, want, host in zip(traced, plain,
                               ksc.score_topk_host(queries, scan, 3)):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, host)


def test_region_without_a_profiler_is_the_shared_noop():
    assert not torch.autograd.profiler._is_profiler_enabled
    first = tracing.region("tse1m.a")
    assert first is tracing._NO_REGION
    assert tracing.region("tse1m.b") is first
    with first as entered:
        assert entered is None


def test_region_under_a_profiler_is_a_record_function(tmp_path):
    def call():
        r = tracing.region("tse1m.probe")
        assert isinstance(r, torch.autograd.profiler.record_function)
        with r:
            torch.ones(4).sum()

    _, regions = _traced(call, tmp_path / "probe.json")
    assert [r[0] for r in regions] == ["tse1m.probe"]


def test_span_is_a_region_and_keeps_its_ring_record(tmp_path):
    tracing.clear_spans()
    with tracing.span("probe.untraced", k=1):
        pass

    def call():
        with tracing.span("probe.traced", k=2):
            with tracing.span("probe.inner"):
                torch.ones(4).sum()

    _, regions = _traced(call, tmp_path / "span.json")
    named = {r[0]: r for r in regions}
    assert set(named) == {"probe.traced", "probe.inner"}
    assert _inside(named["probe.inner"], named["probe.traced"])
    records = tracing.recent_spans()
    assert [r["name"] for r in records] == ["probe.untraced", "probe.inner",
                                            "probe.traced"]
    for r in records:
        assert set(r) == RING_KEYS
        assert r["ok"] is True
    assert records[0]["tags"] == {"k": 1} and records[2]["tags"] == {"k": 2}
    assert records[1]["parent"] == records[2]["span"]
    tracing.clear_spans()


def test_no_record_function_outside_region():
    """Every profiler region of the port goes through ``region``."""
    import pathlib

    root = pathlib.Path(tpipe.__file__).resolve().parents[1]
    hits = [str(p.relative_to(root)) for p in sorted(root.rglob("*.py"))
            if "record_function" in p.read_text()]
    assert hits == ["observability/tracing.py"], hits
