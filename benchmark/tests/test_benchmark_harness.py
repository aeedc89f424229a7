"""The harness: the manifest against its files and the limits a
benchmark manifest keeps to, the result line, the trace's arithmetic, the
copied bounds, and what the benchmark may import."""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

from benchmark.harness import cells, peaks, runner
from benchmark.harness.trace import TraceView, gaps_us, short_name, union_us

BENCH = cells.BENCH_DIR
ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = ["command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"]
# Keys that name a width, which a configuration may never reduce.
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$|"
                   r"_rank$|head|expansion|per_tok|n_hashes|n_bands|"
                   r"set_size)")
MAX_CELLS = 24


@pytest.fixture(scope="module")
def man():
    return cells.manifest()


def _stems(sub: str, ext: str) -> set:
    return {f[:-len(ext)] for f in os.listdir(os.path.join(BENCH, sub))
            if f.endswith(ext)}


def _text(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_manifest_names_exactly_its_files(man):
    assert {c["name"] for c in man["configs"]} == _stems("configs", ".json")
    assert {w["name"] for w in man["workloads"]} == _stems("workloads",
                                                           ".json")
    assert {m["name"] for m in man["per_layer"]} == _stems("metrics", ".py")
    drivers = {cells.workload(w["name"])["driver"] for w in man["workloads"]}
    assert drivers == _stems("drivers", ".py")
    for c in man["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert cells.config(c["name"])["name"] == c["name"]
    for w in man["workloads"]:
        wl = cells.workload(w["name"])
        assert (wl["config"], wl["traffic"]) == (w["config"], w["traffic"])
        assert set(wl["limits"]) and all(
            isinstance(v, (int, float)) for v in wl["limits"].values())
    for m in man["per_layer"]:
        assert callable(cells.metric(m["name"]).read)


def test_manifest_keys_and_limits(man):
    assert list(man) == TOP_KEYS
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert man["paths"] == ["benchmark"]
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells, 14 runs a cell, fits in 43,200 s.
    assert ((2 + 14 * MAX_CELLS) * (rs + 60) + MAX_CELLS * 2 * 90 + 1200
            <= 43200)
    assert len(json.dumps(man)) <= 64 * 1024
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"])
        assert len(c["reduced"]) <= 16
        assert not any(WIDTH.search(k) for k in c["reduced"])
        cfg = cells.config(c["name"])
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert 1 <= len(man["workloads"]) <= MAX_CELLS
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"])
        assert w["config"] in {c["name"] for c in man["configs"]}
    names = [m["name"] for m in man["end_to_end"] + man["per_layer"]]
    assert len(set(names)) == len(names)
    assert "setup_s" in {m["name"] for m in man["end_to_end"]}
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _text(m["layer"])
        assert m["moves"] in {e["name"] for e in man["end_to_end"]}
    for w in man["workloads"]:
        e2e = {m["name"] for m in cells.end_to_end_of(man, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = cells.per_layer_of(man, w["name"])
        assert layer and all(m["moves"] in e2e for m in layer)


def test_names_and_units_use_the_allowed_characters(man):
    names = ([c["name"] for c in man["configs"]]
             + [w["name"] for w in man["workloads"]]
             + [w["config"] for w in man["workloads"]]
             + [w["traffic"] for w in man["workloads"]]
             + [k for c in man["configs"] for k in c["reduced"]]
             + [m["name"] for m in man["end_to_end"] + man["per_layer"]])
    assert all(NAME.match(n) for n in names), names
    units = [m["unit"] for m in man["end_to_end"] + man["per_layer"]]
    assert all(UNIT.match(u) for u in units), units
    assert all(m["better"] in ("lower", "higher")
               for m in man["end_to_end"] + man["per_layer"])
    assert all(_text(w) and not w.startswith("/") and ".." not in w
               for w in man["command"])
    for dirpath, _, files in os.walk(BENCH):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert "__pycache__" in rel or PATH.match(rel), rel


def test_layers_are_those_of_perf_md(man):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in man["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_copied_bounds_reproduce_the_kernel_table():
    ms, by = peaks.minhash_bound(250_368, 64, 128, 16)
    assert (round(ms, 4), by) == (0.1244, "operations")
    ms, by = peaks.topk_bound(64, 1_000_000, 128)
    assert (round(ms, 4), by) == (0.4891, "operations")


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def _sources(sub: str = ""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        found = _imports(path) & set(runner.FORBIDDEN_MODULES)
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in _sources("reference"):
        assert "tse1m_tpu_torch" not in _imports(path), path


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    assert runner.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "tse1m_tpu_torch_fake", object())
    assert runner.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "tse1m_tpu.fake", object())
    assert runner.forbidden_loaded() == ["tse1m_tpu"]


def test_percentile_is_nearest_rank():
    vals = list(range(1, 201))
    assert runner.percentile(vals, 95) == 190
    assert runner.percentile([3.0], 95) == 3.0


def _events():
    """A synthetic trace: a window of 1,000 us, two calls, kernels,
    copies and host ops."""
    def x(name, cat, ts, dur, **args):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
                "args": args}
    return [
        x("bench.window", "user_annotation", 0, 1000),
        x("bench.call", "user_annotation", 0, 500),
        x("bench.call", "user_annotation", 500, 500),
        x("aten::sort", "cpu_op", 400, 200),
        x("void minhash_keys_kernel<false>(unsigned int const*)", "kernel",
          100, 200),
        x("void at::native::radixSort(int)", "kernel", 250, 100),
        x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 600, 50,
          bytes=4000),
        x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy", 700, 100,
          bytes=8000),
        x("outside", "kernel", 2000, 10),
    ]


def test_trace_view_arithmetic():
    assert short_name("void ns::(anonymous namespace)::k<1>(int)") == "k"
    assert union_us([(0, 10), (5, 20), (30, 40)]) == 30
    assert gaps_us([(10, 20), (15, 30)], 0, 50) == [(0, 10), (30, 50)]
    view = TraceView(_events(), {"rows": 1000, "set_size": 64,
                                 "n_hashes": 128, "n_bands": 16,
                                 "scheme": "kminhash", "queries": 8,
                                 "store_rows": 100})
    assert view.calls == 2 and len(view.device) == 4
    assert view.window_s == pytest.approx(1e-3)
    assert view.busy_s == pytest.approx(400e-6)
    bd = view.breakdown()
    assert bd["device_ops"][0][0] == "minhash_keys_kernel"
    assert bd["device_ops"][0][1] == pytest.approx(200e-6)
    gaps = dict(bd["idle_gaps"])
    assert gaps == pytest.approx({"bench.call": 350e-6, "aten::sort": 250e-6})
    sig = cells.metric("signature_roofline_pct").read(view)
    bound = peaks.minhash_bound(1000, 64, 128, 16)[0]
    assert sig == pytest.approx(100 * bound * 2 / 0.2)
    assert cells.metric("lsh_device_ms").read(view) == pytest.approx(0.1)
    assert cells.metric("launches_per_call.cluster").read(view) == 2
    assert cells.metric("device_idle_pct.cluster").read(view) == \
        pytest.approx(60.0)
    assert cells.metric("scan_h2d_ms").read(view) == pytest.approx(0.05)
    assert cells.metric("topk_roofline_pct").read(view) is None


SMALL = {"cluster.kminhash.resident": {"config": {"n_sessions": 2000}},
         "scan.cminhash.q32k": {"config": {"n_sessions": 2000},
                                "params": {"queries": 128,
                                           "sample_per_pass": 8}}}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_result_line_keys(cell, trace):
    res = runner.run_cell(cell, 2**31 + 7, 0.3, trace, device="cpu",
                          overrides=SMALL[cell])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    # The compared numbers, each beside its limit, come last, under a key
    # of their own, as the benchmark's contract asks.
    assert list(res) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ({"busy_s", "window_s"} <= set(dev)) == trace
    man = cells.manifest()
    if not trace:
        want = {m["name"] for m in cells.end_to_end_of(man, cell)}
        assert set(res["metrics"]) == want
    else:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    wl = cells.workload(cell)
    assert set(res["checks"]) == set(wl["limits"])
    json.dumps(res)


@pytest.mark.parametrize("seed", [5, 2**33 + 1])
def test_relabel_corpus_has_the_same_sizes_on_every_seed(seed):
    import numpy as np

    from benchmark.harness.synth import corpus

    scan = cells.driver("bulk_scan")
    wl = cells.workload("scan.cminhash.q32k")
    cfg = dict(cells.config(wl["config"]), n_sessions=2000)
    items = corpus(cfg, seed, 0)
    q = scan.relabel_corpus(items, cfg, wl["params"], seed)
    assert np.array_equal(q, scan.relabel_corpus(items, cfg, wl["params"],
                                                 seed))
    assert q.shape == items.shape and q.dtype == np.uint32
    # A fresh session holds almost no stored id; a copy keeps about
    # 1 - mutate_prob of its source's.
    stored = np.isin(q, items).mean(axis=1)
    fresh = stored < 0.5
    assert fresh.sum() == round(wl["params"]["novel_share"] * len(q))
    assert abs(stored[~fresh].mean() - (1 - wl["params"]["mutate_prob"])) \
        < 0.01


def test_run_without_a_card_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "scan.cminhash.q32k", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert "{" not in p.stdout


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", str(2**31 + 11), "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
