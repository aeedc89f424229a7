"""The port's graftlint (``tse1m_tpu_torch/lint/``), its per-file half,
against the JAX package's (``tse1m_tpu/lint/``): every fixture under
``tests/lint_fixtures/`` gives the same findings (rule, line, column) under
both packages' rules, each package reading it under its own paths (the
path-scoped rules see ``tse1m_tpu/...`` for JAX's rules and the port's
counterpart for the port's); the two rules whose subject is translated to
torch idiom (``wire-layer``, ``host-in-jit``) fire on torch fixture pairs;
and the engine's suppressions, baseline and command behave as JAX's.
"""

from __future__ import annotations

import glob
import json
import os
import shutil

import pytest

from tse1m_tpu.lint import engine as jengine
from tse1m_tpu.lint.rules import RULES as JRULES
from tse1m_tpu_torch.lint import engine as tengine
from tse1m_tpu_torch.lint import rules as trules
from tse1m_tpu_torch.lint.engine import (Baseline, LintError, lint_paths,
                                         main)
from tse1m_tpu_torch.lint.rules import RULES as TRULES

FIXTURES = os.path.join(os.path.dirname(__file__), "lint_fixtures")
FIXTURE_FILES = sorted(os.path.basename(p) for p in glob.glob(
    os.path.join(FIXTURES, "*.py")))

# The places a fixture is read as, as (JAX path, the port's counterpart):
# outside every plane, and in each plane some path-scoped rule reads —
# the wire layer, the replay planes, the watchdog plane and the serve
# prefix, the profiling plane, the router's and the replica's write
# planes, the DB layer, the scheme registry's kernel modules.
SPOOFS = [
    (None, None),
    ("tse1m_tpu/analysis/fixture.py", "tse1m_tpu_torch/analysis/fixture.py"),
    ("tse1m_tpu/cluster/pipeline.py", "tse1m_tpu_torch/cluster/pipeline.py"),
    ("tse1m_tpu/cluster/encode.py", "tse1m_tpu_torch/cluster/encode.py"),
    ("tse1m_tpu/cluster/entropy.py", "tse1m_tpu_torch/cluster/entropy.py"),
    ("tse1m_tpu/cluster/prefilter.py",
     "tse1m_tpu_torch/cluster/prefilter.py"),
    ("tse1m_tpu/cluster/store.py", "tse1m_tpu_torch/cluster/store.py"),
    ("tse1m_tpu/cluster/fixture.py", "tse1m_tpu_torch/cluster/fixture.py"),
    ("tse1m_tpu/cluster/schemes.py", "tse1m_tpu_torch/cluster/schemes.py"),
    ("tse1m_tpu/cluster/minhash.py", "tse1m_tpu_torch/cluster/minhash.py"),
    ("tse1m_tpu/cluster/host.py", "tse1m_tpu_torch/cluster/host.py"),
    ("tse1m_tpu/cluster/minhash_pallas.py",
     "tse1m_tpu_torch/cluster/kernels/minhash.py"),
    ("tse1m_tpu/resilience/fixture.py",
     "tse1m_tpu_torch/resilience/fixture.py"),
    ("tse1m_tpu/resilience/watchdog.py",
     "tse1m_tpu_torch/resilience/watchdog.py"),
    ("tse1m_tpu/resilience/coordinator.py",
     "tse1m_tpu_torch/resilience/coordinator.py"),
    ("tse1m_tpu/db/connection.py", "tse1m_tpu_torch/db/connection.py"),
    ("tse1m_tpu/db/pglib.py", "tse1m_tpu_torch/db/pglib.py"),
    ("tse1m_tpu/db/fixture.py", "tse1m_tpu_torch/db/fixture.py"),
    ("tse1m_tpu/observability/latency.py",
     "tse1m_tpu_torch/observability/latency.py"),
    ("tse1m_tpu/observability/profiling.py",
     "tse1m_tpu_torch/observability/profiling.py"),
    ("tse1m_tpu/serve/fixture.py", "tse1m_tpu_torch/serve/fixture.py"),
    ("tse1m_tpu/serve/daemon.py", "tse1m_tpu_torch/serve/daemon.py"),
    ("tse1m_tpu/serve/router.py", "tse1m_tpu_torch/serve/router.py"),
    ("tse1m_tpu/serve/replicate.py", "tse1m_tpu_torch/serve/replicate.py"),
]


def _findings(engine, rules, abspath, relpath) -> list:
    """(rule, line, col) of every finding the rules make in one file,
    suppressions honoured, as the JAX package's test reads them."""
    src = engine.load_source(abspath, relpath)
    out = []
    for name, fn in rules.items():
        for f in fn(src):
            disabled = src.line_disables.get(f.line, set())
            if not (name in src.file_disables or name in disabled):
                out.append((name, f.line, f.col))
    return sorted(out)


@pytest.mark.parametrize("fixture", FIXTURE_FILES)
def test_fixture_findings_equal_jax(fixture):
    path = os.path.join(FIXTURES, fixture)
    fired = set()
    for jpath, tpath in SPOOFS:
        want = _findings(jengine, JRULES, path, jpath or fixture)
        got = _findings(tengine, TRULES, path, tpath or fixture)
        assert got == want, (fixture, jpath)
        fired |= {r for r, _, _ in got}
    if fixture.startswith("bad_"):
        assert fired, f"{fixture} fires under no rule"


def test_the_same_rule_catalog():
    assert list(TRULES) == list(JRULES)
    assert len(TRULES) == 13


def test_every_rule_fires_on_its_bad_fixture():
    """The parity above is not vacuous: each rule fires somewhere."""
    fired = set()
    for fixture in FIXTURE_FILES:
        path = os.path.join(FIXTURES, fixture)
        for _, tpath in SPOOFS:
            fired |= {r for r, _, _ in _findings(
                tengine, TRULES, path, tpath or fixture)}
    assert fired == set(TRULES)


def test_score_module_is_a_wire_seat_in_both():
    """The scoring plane's kernel module is the one kernel module in the
    wire layer, in both packages."""
    bad = os.path.join(FIXTURES, "bad_wire_layer.py")
    rule = {"wire-layer": TRULES["wire-layer"]}
    jrule = {"wire-layer": JRULES["wire-layer"]}
    assert not _findings(tengine, rule, bad,
                         "tse1m_tpu_torch/cluster/kernels/score.py")
    assert not _findings(jengine, jrule, bad,
                         "tse1m_tpu/cluster/kernels/score.py")
    for other in ("rans", "minhash", "cminhash"):
        assert _findings(tengine, rule, bad,
                         f"tse1m_tpu_torch/cluster/kernels/{other}.py")


# -- the translated subjects, on torch fixture pairs --------------------------

BAD_WIRE = '''"""Host<->device copies in torch idiom outside the wire layer."""
import numpy as np
import torch


def stage(x, dev):
    return torch.from_numpy(x).to(dev)


def stage_kw(x, device):
    return torch.from_numpy(x).to(device=device, non_blocking=True)


def stage_literal(t):
    return t.to("cuda:0")


def stage_made(t):
    return t.to(torch.device("cuda"))


def stage_default(t, device=None):
    return t.to(device or "cpu")


def stage_self(self, t):
    return t.to(self.device)


def fetch(t):
    return t.cpu().numpy()


def legacy(t):
    return t.cuda()


def build(x, dev):
    return torch.as_tensor(np.asarray(x), device=dev)


def build_literal(x):
    return torch.tensor(x, device="cuda")
'''

GOOD_WIRE = '''"""No copy across the link: casts, allocations, host tensors."""
import numpy as np
import torch


def cast(t):
    return t.to(torch.int64)


def cast_kw(t):
    return t.to(dtype=torch.float32)


def like(t, other):
    return t.to(other.dtype)


def alloc(n, dev):
    return torch.empty(n, device=dev)


def host(x):
    return torch.as_tensor(np.asarray(x))


def host_tensor(x):
    return torch.tensor(x)
'''

BAD_TRACED = '''"""Host ops and traced-value control flow in bodies torch traces."""
import numpy as np
import torch


@torch.compile
def uses_numpy(x):
    return x + np.float32(1.0)


@torch.compile(dynamic=True)
def syncs(x):
    return float(x[0]) + x.sum().item()


@torch.jit.script
def branches(x):
    if x > 0:
        return x
    return -x


def _loop(x, n):
    while n > 0:
        n = n - 1
    return x


looped = torch.compile(_loop)
scripted = torch.jit.trace(_loop, (torch.ones(1), 2))
'''

GOOD_TRACED = '''"""Device-only bodies: no host op, no branch on a traced value."""
import torch


@torch.compile
def scale(x, *, factor=2):
    if factor > 1:
        return x * factor
    return x


@torch.jit.script
def select(x):
    return torch.where(x > 0, x, -x)


def plain(x):
    if x.sum().item() > 0:
        return float(x[0])
    return 0.0
'''


def _write(tmp_path, name, text) -> str:
    p = tmp_path / name
    p.write_text(text)
    return str(p)


def _rule(rule, path, relpath) -> list:
    return _findings(tengine, {rule: TRULES[rule]}, path, relpath)


def test_wire_layer_reads_torch_copies(tmp_path):
    bad = _write(tmp_path, "bad.py", BAD_WIRE)
    good = _write(tmp_path, "good.py", GOOD_WIRE)
    out_of_plane = "tse1m_tpu_torch/analysis/fixture.py"
    found = _rule("wire-layer", bad, out_of_plane)
    assert [line for _, line, _ in found] == [
        7, 11, 15, 19, 23, 27, 31, 35, 39, 43]
    assert not _rule("wire-layer", good, out_of_plane)
    # Inside the wire layer the same copies are the point.
    for seat in trules._WIRE_LAYER:
        assert not _rule("wire-layer", bad, seat)
    # JAX's rule reads only JAX's idiom: the torch copies pass it.
    assert not _findings(jengine, {"wire-layer": JRULES["wire-layer"]},
                         bad, "tse1m_tpu/analysis/fixture.py")
    msgs = [f.message for f in TRULES["wire-layer"](
        tengine.load_source(bad, out_of_plane))]
    assert any(".cpu()" in m for m in msgs)
    assert any("torch.as_tensor(..., device=)" in m for m in msgs)


def test_host_in_jit_reads_torch_traced_bodies(tmp_path):
    bad = _write(tmp_path, "bad.py", BAD_TRACED)
    good = _write(tmp_path, "good.py", GOOD_TRACED)
    src = tengine.load_source(bad, "bad.py")
    found = TRULES["host-in-jit"](src)
    msgs = " | ".join(f.message for f in found)
    assert "np.float32" in msgs
    assert "float()" in msgs and ".item()" in msgs
    assert "control flow" in msgs and "`branches`" in msgs
    assert "`_loop`" in msgs  # wrapped at module level
    assert not _rule("host-in-jit", good, "good.py")
    # JAX's rule knows no torch tracer.
    assert not _findings(jengine, {"host-in-jit": JRULES["host-in-jit"]},
                         bad, "bad.py")


def test_the_port_traces_nothing_today():
    """The port holds no torch.compile / torch.jit body: the rule fires on
    nothing in it (its subject is held by the fixture pair above)."""
    from tse1m_tpu_torch.lint.engine import default_targets, repo_root

    root = repo_root()
    for path in default_targets(root):
        rel = os.path.relpath(path, root)
        src = tengine.load_source(path, rel)
        assert not trules._collect_traced_functions(src), rel


# -- suppressions --------------------------------------------------------------

def test_suppression_same_line_and_reason(tmp_path):
    p = tmp_path / "s.py"
    p.write_text(
        "try:\n    x = 1\n"
        "except Exception:  # graftlint: disable=broad-except -- why not\n"
        "    pass\n")
    src = tengine.load_source(str(p), "s.py")
    assert src.line_disables == {3: {"broad-except"}}
    assert src.suppress_reasons[0]["reason"] == "why not"
    findings = lint_paths([str(p)], root=str(tmp_path))
    assert all(f.suppressed for f in findings if f.rule == "broad-except")


def test_suppression_standalone_comment_covers_next_line(tmp_path):
    p = tmp_path / "s.py"
    p.write_text(
        "import torch\n"
        "# graftlint: disable=wire-layer -- probe\n"
        "d = torch.ones(1).cuda()\n")
    src = tengine.load_source(str(p), "s.py")
    assert src.line_disables == {3: {"wire-layer"}}
    findings = lint_paths([str(p)], root=str(tmp_path))
    assert [f.suppressed for f in findings if f.rule == "wire-layer"] == [
        True]


def test_suppression_file_level(tmp_path):
    p = tmp_path / "s.py"
    p.write_text(
        "# graftlint: disable-file=broad-except -- fixture file\n"
        "try:\n    x = 1\nexcept Exception:\n    pass\n"
        "try:\n    y = 2\nexcept Exception:\n    pass\n")
    findings = lint_paths([str(p)], root=str(tmp_path))
    broad = [f for f in findings if f.rule == "broad-except"]
    assert len(broad) == 2 and all(f.suppressed for f in broad)


def test_suppression_covers_decorated_def_as_jax():
    path = os.path.join(FIXTURES, "suppress_decorated.py")
    port = tengine.load_source(path, "suppress_decorated.py")
    ref = jengine.load_source(path, "suppress_decorated.py")
    assert port.line_disables == ref.line_disables
    assert port.suppress_reasons == ref.suppress_reasons
    # the disable spreads over the decorator span and the def line
    assert len(port.line_disables) >= 3


# -- baseline --------------------------------------------------------------------

def test_baseline_roundtrip_and_regression(tmp_path):
    work = tmp_path / "repo"
    work.mkdir()
    target = work / "mod.py"
    shutil.copy(os.path.join(FIXTURES, "bad_broad_except.py"), target)
    bl_path = str(tmp_path / "baseline.json")
    findings = lint_paths([str(target)], root=str(work))
    assert [f for f in findings if not f.suppressed]
    Baseline.write(bl_path, findings)
    entries = json.load(open(bl_path))["findings"]
    assert entries and all(e["reason"] for e in entries)
    baseline = Baseline.load(bl_path)
    again = lint_paths([str(target)], root=str(work), baseline=baseline)
    assert all(f.baselined for f in again if not f.suppressed)
    target.write_text(target.read_text()
                      + "\n\ndef fresh(fn):\n    try:\n        fn()\n"
                        "    except Exception as boom:\n        return boom\n")
    fresh = [f for f in lint_paths([str(target)], root=str(work),
                                   baseline=Baseline.load(bl_path))
             if not f.suppressed and not f.baselined]
    assert len(fresh) == 1 and fresh[0].text.startswith(
        "except Exception as boom")
    target.write_text("x = 1\n")
    baseline = Baseline.load(bl_path)
    assert not lint_paths([str(target)], root=str(work), baseline=baseline)
    assert baseline.stale_entries()


def test_baseline_multiplicity(tmp_path):
    body = ("def f(a):\n    try:\n        a()\n    except Exception:\n"
            "        pass\n")
    target = tmp_path / "m.py"
    target.write_text(body + body.replace("def f", "def g"))
    bl_path = str(tmp_path / "b.json")
    Baseline.write(bl_path, lint_paths([str(target)], root=str(tmp_path)))
    target.write_text(target.read_text() + body.replace("def f", "def h"))
    out = lint_paths([str(target)], root=str(tmp_path),
                     baseline=Baseline.load(bl_path))
    assert len([f for f in out if not f.baselined]) == 1


def test_the_ports_baseline_is_empty():
    with open(tengine.BASELINE_DEFAULT) as f:
        assert json.load(f)["findings"] == []
    assert tengine.BASELINE_DEFAULT.endswith(
        os.path.join("tse1m_tpu_torch", "lint", "baseline.json"))


# -- the command -------------------------------------------------------------

def test_cli_exit_codes_and_json(tmp_path, capsys):
    bad = str(tmp_path / "bad.py")
    shutil.copy(os.path.join(FIXTURES, "bad_retry_bypass.py"), bad)
    assert main([bad, "--no-cache"]) == 1
    capsys.readouterr()
    assert main([bad, "--json", "--no-cache"]) == 1
    report = json.loads(capsys.readouterr().out)
    assert report["ok"] is False
    assert report["by_rule"]["retry-bypass"] >= 1
    assert report["findings"][0]["path"].endswith("bad.py")
    assert main([bad, "--rules", "no-such-rule"]) == 2
    assert main([bad, "--rules", "broad-except", "--no-cache"]) == 0


def test_lint_command_prints_suppressions_by_rule(tmp_path, capsys):
    from tse1m_tpu_torch.__main__ import main as port_main

    p = tmp_path / "s.py"
    p.write_text(
        "import torch\n"
        "x = torch.ones(1).cpu()  # graftlint: disable=wire-layer -- probe\n"
        "try:\n    pass\n"
        "except Exception:  # graftlint: disable=broad-except -- probe\n"
        "    pass\n")
    capsys.readouterr()
    assert port_main(["lint", str(p), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["suppressed_by_rule"] == {"broad-except": 1,
                                            "wire-layer": 1}
    assert port_main(["lint", str(p)]) == 0
    err = capsys.readouterr().err
    assert "suppressed by rule: broad-except 1, wire-layer 1" in err


def test_run_repo_lint_raises_with_summary(tmp_path):
    """A violation planted in a copy of the port fails the whole-package
    lint with its machine summary (the ``graftlint`` step's record)."""
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(tengine.repo_root(), "tse1m_tpu_torch"),
                    root / "tse1m_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc",
                                                  "*.cc", "*.h"))
    (root / "tse1m_tpu_torch" / "_planted.py").write_text(
        "import requests\n\n\ndef f(u):\n    return requests.get(u)\n")
    with pytest.raises(LintError) as ei:
        tengine.run_repo_lint(root=str(root))
    assert ei.value.step_result["new_findings"] == 1
    assert ei.value.step_result["by_rule"] == {"retry-bypass": 1}
    assert ei.value.step_result["suppressed"] > 0
