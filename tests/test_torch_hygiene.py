"""Rules of the tse1m_tpu_torch port that hold by construction: it imports
nothing of JAX, the JAX package, pandas, PyYAML or requests, matplotlib
only inside the RQ drivers' figure functions and selenium only inside the
issue client's methods (never when a module is imported: the card's
machine has none of them), its entry points run on the card unless asked for the
CPU and raise without one, and no kernel launch sits behind a handler that
could fall back to a plain version."""

import ast
import os

import numpy as np
import pytest
import torch

import tse1m_tpu_torch
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.cluster.kernels import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tse1m_tpu_torch")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(node):
    if isinstance(node, ast.Import):
        yield from (alias.name for alias in node.names)
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
        yield node.module


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        yield from _imports(node)


def _module_level_imports(path):
    """Imports that run when the module is imported: everything outside a
    function body."""
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    stack = list(tree.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        yield from _imports(node)
        stack.extend(ast.iter_child_nodes(node))


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tse1m_tpu", "pandas", "yaml",
                   "requests")


def _selenium(name: str) -> bool:
    return name.split(".")[0] == "selenium"


def _plotting(name: str) -> bool:
    return name.split(".")[0] in ("matplotlib", "matplotlib_venn")


def test_port_imports_nothing_of_jax():
    sources = _port_sources()
    assert len(sources) > 10
    bad = [(os.path.relpath(p, REPO), m) for p in sources
           for m in _imported_modules(p) if _forbidden(m)]
    assert bad == []
    # The rule tells the JAX package from the port by exact name.
    assert _forbidden("tse1m_tpu.cluster") and not _forbidden(
        "tse1m_tpu_torch.cluster")
    # The card machine has neither pandas nor matplotlib: pandas nowhere,
    # matplotlib only inside the RQ drivers' functions.
    assert _forbidden("pandas") and _plotting("matplotlib.pyplot")
    analysis = os.path.join(PKG, "analysis")
    at_import = [(os.path.relpath(p, REPO), m) for p in sources
                 for m in _module_level_imports(p) if _plotting(m)]
    assert at_import == []
    outside = [(os.path.relpath(p, REPO), m) for p in sources
               for m in _imported_modules(p)
               if _plotting(m) and not p.startswith(analysis)]
    assert outside == []
    drivers = {os.path.basename(p) for p in sources if p.startswith(analysis)
               and any(_plotting(m) for m in _imported_modules(p))}
    assert drivers == {"common.py", "rq3.py", "rq4a.py", "rq4b.py"}
    # PyYAML and requests nowhere; selenium only inside the issue
    # client's functions.
    assert _forbidden("yaml") and _forbidden("requests.adapters")
    selenium = [(os.path.relpath(p, REPO), m) for p in sources
                for m in _module_level_imports(p) if _selenium(m)]
    assert selenium == []
    users = {os.path.relpath(p, PKG) for p in sources
             if any(_selenium(m) for m in _imported_modules(p))}
    assert users == {os.path.join("collect", "issues_selenium.py")}
    # The new serving modules are among the sources checked.
    assert {os.path.join(PKG, "serve", f) for f in (
        "router.py", "replicate.py")} | {os.path.join(
            PKG, "resilience", "coordinator.py")} <= set(sources)
    # So are the device tooling's: the named locks and the sanitizer.
    assert {os.path.join(PKG, "trace", "sync.py"),
            os.path.join(PKG, "lint", "runtime.py")} <= set(sources)
    # And the correctness plane's: the specs, their checker, the lint.
    assert {os.path.join(PKG, "spec", f) for f in (
        "__init__.py", "dsl.py", "mc.py", "lease.py", "ingest_ack.py",
        "replica.py", "mutants.py", "verbs.py")} | {os.path.join(
            PKG, "lint", f) for f in (
            "__init__.py", "__main__.py", "engine.py", "graph.py",
            "interproc.py", "rules.py")} | {os.path.join(
            PKG, "resilience", "fault_matrix.py")} <= set(sources)
    # And the I/O plane's: the collectors and the round toolbelt.
    assert {os.path.join(PKG, "collect", f) for f in (
        "__init__.py", "transport.py", "checkpoint.py", "table.py",
        "yaml_subset.py", "projects.py", "gcs_metadata.py", "coverage.py",
        "buildlogs.py", "issues.py", "issues_selenium.py", "corpus.py",
        "normalize.py")} | {os.path.join(PKG, "bench.py"), os.path.join(
            PKG, "observability", "regress.py")} <= set(sources)


def test_correctness_plane_runs_without_jax_or_pandas(tmp_path):
    """The spec checker and the lint run in an interpreter where jax,
    pandas and the JAX package cannot be imported, as on the card's
    machine, and pull none of them in."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'pandas', 'tse1m_tpu'):\n"
        "    sys.modules[name] = None\n"
        "from tse1m_tpu_torch.spec import check_all, mutant_selftest\n"
        "from tse1m_tpu_torch.lint import lint_paths\n"
        "assert all(r.ok for r in check_all())\n"
        "assert all(r['caught'] for r in mutant_selftest().values())\n"
        f"found = lint_paths([{str(tmp_path / 'm.py')!r}],"
        f" root={str(tmp_path)!r})\n"
        "assert [f.rule for f in found] == ['wire-layer'], found\n"
        "loaded = [m for m in sys.modules if sys.modules[m] is not None\n"
        "          and m.split('.')[0] in ('jax', 'pandas', 'tse1m_tpu')]\n"
        "assert loaded == [], loaded\n"
        "print('ok')\n")
    (tmp_path / "m.py").write_text("def f(t):\n    return t.cuda()\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_no_handler_around_kernel_launches():
    """No try/except in the kernels package, the pipeline, the RQ backend
    or its segment ops, the band-sharded tail or the mesh: a failed build,
    launch or collective raises, nothing gives way to the plain version,
    the single-device path or the CPU."""
    paths = [os.path.join(PKG, "cluster", "pipeline.py"),
             os.path.join(PKG, "cluster", "sharded.py"),
             os.path.join(PKG, "backend", "torch_backend.py"),
             os.path.join(PKG, "ops", "segment.py")] + [
        os.path.join(PKG, "parallel", f)
        for f in ("__init__.py", "mesh.py", "multihost.py", "rq_mesh.py")] + [
        os.path.join(PKG, "cluster", "kernels", f)
        for f in ("__init__.py", "minhash.py", "cminhash.py", "rans.py",
                  "score.py", "_build.py")]
    for path in paths:
        tree = ast.parse(open(path, encoding="utf-8").read())
        handlers = [n.lineno for n in ast.walk(tree)
                    if isinstance(n, ast.ExceptHandler)]
        assert handlers == [], (path, handlers)


def test_resolve_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tse1m_tpu_torch.resolve_device(device)
    assert tse1m_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        tse1m_tpu_torch.resolve_device("meta")


def test_entry_point_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for scheme in ("kminhash", "cminhash", "weighted"):
        params = tpipe.ClusterParams(encoding="pack24", entropy="off",
                                     prefilter="off", scheme=scheme)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpipe.cluster_sessions(np.zeros((4, 4), np.uint32), params)


def test_build_is_lazy_and_targets_hopper():
    assert _build._ext is None  # importing the package built nothing
    assert "-gencode=arch=compute_90a,code=sm_90a" in _build.CUDA_FLAGS
    assert _build.BUILD_DIR == os.path.join(REPO, "build", "tse1m_tpu_torch")
    assert all(os.path.isfile(s) and s.startswith(PKG)
               for s in _build.SOURCES)
    # One build step for every kernel; PyTorch's headers in one file only.
    names = [os.path.basename(s) for s in _build.SOURCES]
    assert names == ["minhash.cu", "cminhash.cu", "rans.cu", "score.cu",
                     "binding.cpp"]
    for s in _build.SOURCES:
        text = open(s, encoding="utf-8").read()
        assert ("torch/extension.h" in text) == s.endswith("binding.cpp")


def test_uint32_helpers_round_trip():
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
    t = tse1m_tpu_torch.u32_tensor(vals)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(tse1m_tpu_torch.as_u32_numpy(t), vals)
    wide = tse1m_tpu_torch.widen(t)
    assert wide.tolist() == [int(v) for v in vals]
    assert torch.equal(tse1m_tpu_torch.narrow(wide), t)
