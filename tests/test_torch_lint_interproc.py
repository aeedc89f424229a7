"""The port's graftlint, its whole-program half (``lint/graph.py``,
``lint/interproc.py``), against the JAX package's: every mini-project
under ``tests/lint_fixtures/interproc/``, staged under each package's
layout, gives the same findings and witness chains modulo the package
prefix; ``--why`` prints each pass's chain; the digest cache hits,
invalidates and survives a corrupt file as a cold run; faults seeded into
copies of the port's own modules are flagged; and the port, linted whole,
is clean against its empty baseline, with every pass seeing the port's
specs, dispatch surfaces, fault seats and published snapshots.
"""

from __future__ import annotations

import glob
import json
import os
import shutil
import subprocess

import pytest

from tse1m_tpu.lint.engine import lint_project as jlint_project
from tse1m_tpu_torch.lint import engine as tengine
from tse1m_tpu_torch.lint import graph as tgraph
from tse1m_tpu_torch.lint import interproc as tinterproc
from tse1m_tpu_torch.lint.engine import (default_targets, lint_project,
                                         main, repo_root, run_repo_lint)
from tse1m_tpu_torch.lint.graph import build_graph, content_digest

FIXTURES = os.path.join(os.path.dirname(__file__), "lint_fixtures")
INTERPROC = os.path.join(FIXTURES, "interproc")
SUBDIRS = sorted(os.listdir(INTERPROC))
PASS_FIXTURES = [
    ("sql-interp", "taint_bad", "taint_good"),
    ("retry-bypass", "taint_bad", "taint_good"),
    ("lease-fence", "fence_bad", "fence_good"),
    ("lock-order", "locks_bad", "locks_good"),
    ("fault-seat-drift", "seats_bad", "seats_good"),
    ("snapshot-publish", "snapshot_bad", "snapshot_good"),
    ("atomic-swap", "swap_bad", "swap_good"),
    ("spec-conformance", "spec_bad", "spec_good"),
    ("verb-dispatch-drift", "verbs_bad", "verbs_good"),
]


def _stage(root, package: str, subdir: str) -> list:
    """The mini-project copied under ``root/<package>/<subdir>/``; its
    seat inventory takes the package's inventory name."""
    dst = os.path.join(str(root), package, subdir)
    os.makedirs(dst)
    for src in sorted(glob.glob(os.path.join(INTERPROC, subdir, "*.py"))):
        name = os.path.basename(src)
        if package == "tse1m_tpu_torch" and name == "ci_fault_matrix.py":
            name = tinterproc.MATRIX_BASENAME
        shutil.copy(src, os.path.join(dst, name))
    return sorted(glob.glob(os.path.join(dst, "*.py")))


def _normalized(findings, root) -> list:
    def norm(text: str) -> str:
        text = text.replace(str(root), "<root>")
        text = text.replace("tse1m_tpu_torch", "PKG")
        text = text.replace("tse1m_tpu", "PKG")
        text = text.replace("tests/ci_fault_matrix.py", "<inventory>")
        text = text.replace("PKG/resilience/fault_matrix.py", "<inventory>")
        return text.replace("ci_fault_matrix.py", "fault_matrix.py")

    return sorted((f.rule, norm(f.path), f.line, f.col, norm(f.message),
                   tuple(norm(w) for w in f.witness), f.suppressed)
                  for f in findings)


def _run_both(tmp_path, subdir: str):
    out = {}
    for package, fn in (("tse1m_tpu", jlint_project),
                        ("tse1m_tpu_torch", lint_project)):
        root = tmp_path / package.replace("tse1m_tpu", "pkg")
        paths = _stage(root, package, subdir)
        findings, _stats, _graph = fn(paths, paths, rules={},
                                      root=str(root), use_cache=False)
        out[package] = _normalized(findings, root)
    return out["tse1m_tpu_torch"], out["tse1m_tpu"]


@pytest.mark.parametrize("subdir", SUBDIRS)
def test_mini_project_findings_equal_jax(subdir, tmp_path):
    port, ref = _run_both(tmp_path, subdir)
    assert port == ref
    rules = {r for r, bad, _ in PASS_FIXTURES if bad == subdir}
    if rules:  # a bad twin: each of its passes fires, with a chain
        live = [f for f in port if not f[-1]]
        assert rules <= {f[0] for f in live}
        assert any(f[5] for f in live if f[0] in rules)


@pytest.mark.parametrize("rule,bad,good", PASS_FIXTURES)
def test_pass_bad_fires_good_silent(rule, bad, good, tmp_path):
    for subdir, fires in ((bad, True), (good, False)):
        paths = _stage(tmp_path / subdir, "tse1m_tpu_torch", subdir)
        findings, _, _ = lint_project(paths, paths, rules={},
                                      root=str(tmp_path / subdir),
                                      use_cache=False)
        hit = [f for f in findings if f.rule == rule and not f.suppressed]
        assert bool(hit) is fires, (rule, subdir)


def test_the_same_project_passes():
    from tse1m_tpu.lint.interproc import PROJECT_PASSES, PROJECT_RULES

    assert list(tinterproc.PROJECT_PASSES) == list(PROJECT_PASSES)
    assert tinterproc.PROJECT_RULES == PROJECT_RULES
    assert len(tinterproc.PROJECT_PASSES) == 8


# -- --why, through the command -------------------------------------------------

@pytest.mark.parametrize("rule,subdir,expect", [
    ("sql-interp", "taint_bad", "raw SQL execution"),
    ("retry-bypass", "taint_bad", "dbwrap"),
    ("lease-fence", "fence_bad", "LeaseSupersededError"),
    ("lock-order", "locks_bad", "_lock"),
    ("fault-seat-drift", "seats_bad", "fault_point"),
    ("snapshot-publish", "snapshot_bad", "item-writes"),
    ("atomic-swap", "swap_bad", "aliases"),
    ("spec-conformance", "spec_bad", "fault_point"),
    ("verb-dispatch-drift", "verbs_bad", "SERVER_VERBS"),
])
def test_why_works_for_every_pass(capsys, rule, subdir, expect):
    """Each seeded fixture's finding and its witness chain, printed by
    ``lint --why`` (the command anchors paths at the repo root)."""
    paths = sorted(glob.glob(os.path.join(INTERPROC, subdir, "*.py")))
    findings, _, _ = lint_project(paths, paths, rules={}, root=repo_root(),
                                  use_cache=False)
    found = [f for f in findings if f.rule == rule and f.witness]
    assert found
    outputs = []
    for target in found:
        capsys.readouterr()
        rc = main(paths + ["--no-cache", "--why",
                           f"{rule}:{target.path}:{target.line}"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert rule in out
        outputs.append(out)
    assert any(expect in out for out in outputs)


def test_why_unknown_location_and_graph(capsys):
    paths = sorted(glob.glob(os.path.join(INTERPROC, "taint_bad", "*.py")))
    assert main(paths + ["--no-cache", "--why", "lease-fence:nope.py:1"]) \
        == 2
    assert main(paths + ["--no-cache", "--why", "garbage"]) == 2
    capsys.readouterr()
    assert main(paths + ["--no-cache", "--graph"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["functions"] >= 3
    assert any("daily_report" in e and e.endswith("dbwrap.run_stmt")
               for e in report["edges"])


# -- the digest cache ----------------------------------------------------------

def test_the_cache_is_the_ports_own():
    from tse1m_tpu.lint.graph import CACHE_BASENAME as JAX_CACHE

    assert tgraph.CACHE_BASENAME == ".graftlint_torch_cache.json"
    assert tgraph.CACHE_BASENAME != JAX_CACHE
    with open(os.path.join(repo_root(), ".gitignore")) as f:
        assert tgraph.CACHE_BASENAME in f.read().split()


def test_digest_cache_hits_and_invalidation(tmp_path):
    paths = _stage(tmp_path, "tse1m_tpu_torch", "fence_bad")
    root = str(tmp_path)
    g1 = build_graph(paths, root=root, use_cache=True)
    assert g1.cache_hits == 0 and len(g1.extracted) == len(paths)
    g2 = build_graph(paths, root=root, use_cache=True)
    assert g2.cache_hits == g2.cache_files == len(paths)
    assert g2.extracted == []
    store = [p for p in paths if p.endswith("store.py")][0]
    with open(store, "a") as f:
        f.write("\n# touched\n")
    g3 = build_graph(paths, root=root, use_cache=True)
    assert [p.rsplit("/", 1)[-1] for p in g3.extracted] == ["store.py"]
    assert g3.cache_hits == len(paths) - 1


def test_warm_findings_equal_cold(tmp_path):
    paths = _stage(tmp_path, "tse1m_tpu_torch", "fence_bad")

    def run():
        findings, _, _ = lint_project(paths, paths, rules={},
                                      root=str(tmp_path), use_cache=True)
        return [(f.rule, f.path, f.line, f.message) for f in findings]

    cold = run()
    assert cold and run() == cold


@pytest.mark.parametrize("garbage", [
    b"{\"version\": 4, \"files\": {\"a\"",       # torn mid-write
    b"[1, 2, 3]",                                # not an object
    b"{\"version\": 4, \"files\": [1]}",         # files not a map
    b"{\"version\": 4, \"files\": {\"x.py\": 7}}",  # entry not a map
    b"\xff\xfe\x00",                             # not text
])
def test_a_corrupt_cache_only_makes_the_run_cold(tmp_path, garbage):
    paths = _stage(tmp_path, "tse1m_tpu_torch", "fence_bad")
    with open(tgraph.cache_path(str(tmp_path)), "wb") as f:
        f.write(garbage)
    cold = build_graph(paths, root=str(tmp_path), use_cache=True)
    assert cold.cache_hits == 0 and len(cold.facts) == len(paths)
    warm = build_graph(paths, root=str(tmp_path), use_cache=True)
    assert warm.cache_hits == len(paths)
    assert not glob.glob(str(tmp_path / "*.tmp"))


def test_reverse_dependency_closure_and_changed(tmp_path):
    paths = _stage(tmp_path, "tse1m_tpu_torch", "taint_good")
    g = build_graph(paths, root=str(tmp_path), use_cache=False)
    wrap = "tse1m_tpu_torch/taint_good/dbwrap.py"
    assert g.reverse_closure({wrap}) == {
        wrap, "tse1m_tpu_torch/taint_good/report.py"}

    def git(*a):
        subprocess.run(["git", *a], cwd=tmp_path, check=True,
                       capture_output=True)

    git("init", "-q")
    git("add", "-A")
    git("-c", "user.email=t@t", "-c", "user.name=t", "commit", "-qm", "x")
    with open(os.path.join(str(tmp_path), wrap), "a") as f:
        f.write("\n# edited\n")
    report, info = tengine.changed_closure(str(tmp_path), "HEAD", paths)
    assert info["changed"] == [wrap]
    assert info["closure"] == [wrap, "tse1m_tpu_torch/taint_good/report.py"]
    assert sorted(os.path.basename(p) for p in report) == ["dbwrap.py",
                                                            "report.py"]


def test_content_digest_stability():
    assert content_digest(b"x") == content_digest(b"x")
    assert content_digest(b"x") != content_digest(b"y")


# -- faults seeded into copies of the port's own modules ------------------------

def _port_copy(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(repo_root(), "tse1m_tpu_torch"),
                    root / "tse1m_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc",
                                                  "*.cc", "*.h"))
    return root


def _seed(root, rel: str, old: str, new: str) -> None:
    path = root / "tse1m_tpu_torch" / rel
    text = path.read_text()
    assert text.count(old) == 1, (rel, old)
    path.write_text(text.replace(old, new))


def _new_findings(root) -> list:
    targets = default_targets(str(root))
    findings, _, _ = lint_project(targets, targets, root=str(root),
                                  use_cache=False)
    return [f for f in findings if not f.suppressed]


SEEDED = {
    # the spec's seat renamed away in the code it names
    "spec-seat-renamed": (
        "resilience/coordinator.py", "def verify_lease(",
        "def verify_tenure(", "spec-conformance",
        "references `verify_lease` but no such function exists"),
    # a verb the server answers that no other surface, and no spec, has
    "verb-on-one-surface": (
        "serve/server.py", '        if op == "ping":',
        '        if op == "evict":\n            return {"ok": True}\n'
        '        if op == "ping":', "verb-dispatch-drift",
        "handles undeclared evict"),
    # the per-range append moved above its lease check
    "append-above-verify": (
        "cluster/store.py",
        "                self._check_lease(r)\n"
        "                written += self.range_store(r).append(digests[sel],\n"
        "                                                      sigs[sel])",
        "                written += self.range_store(r).append(digests[sel],\n"
        "                                                      sigs[sel])\n"
        "                self._check_lease(r)", "lease-fence",
        "not dominated by verify_lease"),
    # a new fault seat with no inventory entry
    "seat-without-inventory": (
        "cluster/checkpoint.py",
        '            fault_point("checkpoint.cluster.save", path=tmp)',
        '            fault_point("checkpoint.cluster.save", path=tmp)\n'
        '            fault_point("checkpoint.cluster.extra")',
        "fault-seat-drift", "`checkpoint.cluster.extra` has no "
        "PRODUCTION_SEATS entry"),
    # a handler that swallows injected faults again
    "handler-swallows-faults": (
        "serve/server.py",
        "        except Exception as e:  # a structured error answer\n"
        "            reraise_if_fault(e)\n",
        "        except Exception as e:  # a structured error answer\n",
        "broad-except", "can swallow resilience.InjectedFault"),
    # an in-place write to a published snapshot
    "published-snapshot-mutated": (
        "cluster/store.py",
        "        snap = self._snap\n"
        "        if len(snap.deltas) >= self._delta_max():",
        "        snap = self._snap\n        snap.deltas.append(None)\n"
        "        if len(snap.deltas) >= self._delta_max():",
        "atomic-swap", "on published reference"),
}


def test_the_port_copy_lints_clean(tmp_path):
    assert _new_findings(_port_copy(tmp_path)) == []


@pytest.mark.parametrize("fault", sorted(SEEDED))
def test_a_seeded_fault_is_flagged(fault, tmp_path):
    rel, old, new, rule, text = SEEDED[fault]
    root = _port_copy(tmp_path)
    _seed(root, rel, old, new)
    found = [f for f in _new_findings(root) if f.rule == rule]
    assert any(text in f.message for f in found), [
        (f.location(), f.message) for f in found]


# -- the port itself -------------------------------------------------------------

@pytest.fixture(scope="module")
def port_graph():
    root = repo_root()
    return build_graph(default_targets(root), root=root, use_cache=False)


def test_the_port_lints_clean_against_its_baseline():
    """The acceptance gate: the whole port, every rule and pass, exits 0
    with nothing baselined; every suppression carries a reason."""
    summary = run_repo_lint()
    assert summary["ok"] is True and summary["new_findings"] == 0
    assert summary["baselined"] == 0 and summary["stale_baseline_entries"] \
        == 0
    assert summary["suppressed"] == sum(
        summary["suppressed_by_rule"].values()) > 0
    for path in default_targets(repo_root()):
        src = tengine.load_source(path, os.path.relpath(path, repo_root()))
        for rec in src.suppress_reasons:
            assert rec["reason"], (path, rec)


def test_the_passes_see_the_ports_protocol_code(port_graph):
    g = port_graph
    assert set(tinterproc._spec_modules(g)) == {"ingest_ack", "lease",
                                                "replica"}
    surfaces = tinterproc._dispatch_verbs(g)
    for const in ("SERVER_VERBS", "ROUTER_VERBS", "CLIENT_VERBS",
                  "FORWARD_VERBS"):
        assert surfaces[const], f"no {const} dispatch surface resolved"
    sites, unresolved = tinterproc._production_sites(g)
    assert unresolved == []
    assert {"serve.ingest.commit", "serve.router.forward",
            "serve.replica.stream"} <= set(sites)
    protected = tinterproc._protected_classes(g)
    for cls in ("cluster.incremental.LiveClusterIndex",
                "cluster.store._IndexSnapshot", "cluster.store._ProbeIndex"):
        assert f"tse1m_tpu_torch.{cls}" in protected
    slots = tinterproc._publish_slots(g)
    assert "_snap" in slots["tse1m_tpu_torch.cluster.store.SignatureStore"]
    assert "_index" in slots["tse1m_tpu_torch.serve.daemon.ServeDaemon"]
    assert "_index" in slots[
        "tse1m_tpu_torch.serve.replicate.ServeReplica"]
    models = {p: f["constants"].get("SPEC_MODELS")
              for p, f in g.facts.items() if "SPEC_MODELS" in f["constants"]}
    assert models == {
        "tse1m_tpu_torch/resilience/coordinator.py": ["lease"],
        "tse1m_tpu_torch/serve/daemon.py": ["ingest_ack", "lease"],
        "tse1m_tpu_torch/serve/replicate.py": ["replica"],
        "tse1m_tpu_torch/serve/router.py": ["ingest_ack"]}
    for pass_fn in (tinterproc.snapshot_publish_pass,
                    tinterproc.atomic_swap_pass,
                    tinterproc.spec_conformance_pass,
                    tinterproc.verb_dispatch_drift_pass,
                    tinterproc.fault_seat_drift_pass,
                    tinterproc.lock_order_pass,
                    tinterproc.lease_fence_pass, tinterproc.taint_pass):
        assert pass_fn(g) == [], pass_fn.__name__


def test_the_seat_inventory_matches_the_port(port_graph):
    """The port's inventory: every seat a live one, every kind one the
    port's fault plane implements, every entry naming its coverage."""
    from tse1m_tpu_torch.resilience.fault_matrix import PRODUCTION_SEATS
    from tse1m_tpu_torch.resilience.faults import _KINDS

    sites, _ = tinterproc._production_sites(port_graph)
    assert set(PRODUCTION_SEATS) == set(sites)
    for seat, rec in PRODUCTION_SEATS.items():
        assert set(rec["kinds"]) <= set(_KINDS), seat
        assert rec["covered_by"], seat
    assert tinterproc.MATRIX_DEFAULT == os.path.join(
        "tse1m_tpu_torch", "resilience", "fault_matrix.py")


def test_the_lint_command_exits_0(capsys):
    from tse1m_tpu_torch.__main__ import main as port_main

    capsys.readouterr()
    assert port_main(["lint", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] is True and report["findings"] == []
    assert report["graph_files"] == len(default_targets(repo_root()))
