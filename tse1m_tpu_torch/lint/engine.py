"""The graftlint rule engine: the port's counterpart of
``tse1m_tpu/lint/engine.py``, retargeted at the port's own code.

Mechanics, in one place so every rule stays a pure AST visitor:

- **Targets** — by default every ``.py`` file under ``tse1m_tpu_torch/``.
  Tests and ``chip_smoke.py`` are deliberately out of scope: chaos
  drivers legitimately SIGKILL processes, monkeypatch clocks, and write
  files non-atomically.
- **Suppressions** — ``# graftlint: disable=rule-a,rule-b -- reason`` on
  the finding's line suppresses those rules for that line;
  ``# graftlint: disable-file=rule-a -- reason`` anywhere in the file
  suppresses the rule file-wide.  The ``-- reason`` tail is required by
  convention (the JAX package's LINTING.md) and surfaced in ``--json``
  output so a reasonless suppression is visible in review.
- **Baseline** — a committed JSON file of grandfathered findings.  A
  finding matches a baseline entry on (rule, path, normalized source
  line text) with multiplicity, so edits elsewhere in the file don't
  invalidate it, while touching the offending line itself does.
  ``--write-baseline`` regenerates the file (preserving reasons of
  entries that still match); new findings then fail the run until fixed,
  suppressed, or explicitly re-baselined.
- **Output** — human lines (``path:line:col: rule: message``) or
  ``--json`` for machines (the ``all`` command's run-manifest step).

Exit codes: 0 clean, 1 non-baselined findings, 2 usage/internal error.
"""

from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
import time
from dataclasses import asdict, dataclass, field

BASELINE_DEFAULT = os.path.join(os.path.dirname(__file__), "baseline.json")

_SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*(disable|disable-file)="
    r"(?P<rules>[\w,-]+)"
    r"(?:\s+--\s*(?P<reason>.*))?")


class LintError(RuntimeError):
    """Non-baselined findings (carries the machine summary for the
    run-manifest step)."""

    def __init__(self, message: str, step_result: dict | None = None):
        super().__init__(message)
        self.step_result = step_result


@dataclass
class Finding:
    rule: str
    path: str          # repo-relative, posix form
    line: int          # 1-based
    col: int           # 0-based
    message: str
    text: str = ""     # stripped source line (baseline matching key)
    baselined: bool = False
    suppressed: bool = False
    # Interprocedural findings carry the call chain that proves them
    # (``--why RULE:path:line`` prints it); per-file findings leave it
    # empty.  Not part of the baseline key.
    witness: list = field(default_factory=list)

    def key(self) -> tuple:
        return (self.rule, self.path, self.text)

    def location(self) -> str:
        return f"{self.path}:{self.line}:{self.col}"


@dataclass
class FileSource:
    """One parsed target file, shared by every rule."""

    path: str                    # repo-relative posix
    abspath: str
    text: str
    lines: list[str]
    tree: ast.AST
    # line -> set of rule names disabled on that line; "*" = all
    line_disables: dict[int, set] = field(default_factory=dict)
    file_disables: set = field(default_factory=set)
    # (scope, rules) -> reason strings, for the JSON report
    suppress_reasons: list = field(default_factory=list)


def load_source(abspath: str, relpath: str) -> FileSource:
    with open(abspath, encoding="utf-8") as f:
        text = f.read()
    lines = text.splitlines()
    tree = ast.parse(text, filename=relpath)
    src = FileSource(path=relpath, abspath=abspath, text=text, lines=lines,
                     tree=tree)
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = {r.strip() for r in m.group("rules").split(",") if r.strip()}
        reason = (m.group("reason") or "").strip()
        if m.group(1) == "disable-file":
            src.file_disables |= rules
        else:
            # A trailing comment suppresses its own line; a standalone
            # comment line suppresses the NEXT line (long statements).
            target = i + 1 if line.strip().startswith("#") else i
            src.line_disables.setdefault(target, set()).update(rules)
        src.suppress_reasons.append(
            {"line": i, "scope": m.group(1), "rules": sorted(rules),
             "reason": reason})
    # A standalone suppression directly above a DECORATED def targets
    # the first decorator line; findings may anchor anywhere in the
    # decorator stack (multi-line decorators) or on the `def` line
    # itself, so the disable set spreads across the whole span.
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node.decorator_list:
            first = min(d.lineno for d in node.decorator_list)
            covered = src.line_disables.get(first)
            if not covered:
                continue
            last = max([getattr(d, "end_lineno", d.lineno)
                        for d in node.decorator_list] + [node.lineno])
            for ln in range(first, last + 1):
                src.line_disables.setdefault(ln, set()).update(covered)
    return src


class Baseline:
    """The committed set of grandfathered findings.

    Entries carry a multiplicity ``count`` (identical offending lines in
    one file collapse into one entry) and a human ``reason``."""

    def __init__(self, entries: list[dict] | None = None):
        self.entries = entries or []
        self._budget: dict[tuple, int] = {}
        for e in self.entries:
            k = (e["rule"], e["path"], e["text"])
            self._budget[k] = self._budget.get(k, 0) + int(e.get("count", 1))
        self._used: dict[tuple, int] = {}

    @classmethod
    def load(cls, path: str) -> "Baseline":
        if not os.path.exists(path):
            return cls([])
        with open(path, encoding="utf-8") as f:
            return cls(json.load(f).get("findings", []))

    def absorb(self, finding: Finding) -> bool:
        """True (and consume one unit of budget) if the finding is
        grandfathered."""
        k = finding.key()
        used = self._used.get(k, 0)
        if used < self._budget.get(k, 0):
            self._used[k] = used + 1
            return True
        return False

    def stale_entries(self) -> list[dict]:
        """Entries whose budget was never (fully) consumed — the finding
        they grandfathered was fixed and they can be deleted."""
        out = []
        for e in self.entries:
            k = (e["rule"], e["path"], e["text"])
            if self._used.get(k, 0) < self._budget.get(k, 0):
                out.append(e)
                # report each key once even when count > 1
                self._used[k] = self._budget[k]
        return out

    @staticmethod
    def write(path: str, findings: list[Finding],
              old: "Baseline | None" = None,
              default_reason: str = "grandfathered pre-graftlint finding") \
            -> int:
        """Serialize ``findings`` (the non-suppressed ones) as the new
        baseline, keeping the reason of any entry that already existed."""
        reasons = {}
        if old is not None:
            for e in old.entries:
                reasons[(e["rule"], e["path"], e["text"])] = \
                    e.get("reason", default_reason)
        grouped: dict[tuple, dict] = {}
        for f in findings:
            if f.suppressed:
                continue
            k = f.key()
            if k in grouped:
                grouped[k]["count"] += 1
            else:
                grouped[k] = {"rule": f.rule, "path": f.path, "line": f.line,
                              "text": f.text, "count": 1,
                              "message": f.message,
                              "reason": reasons.get(k, default_reason)}
        payload = {"comment": "graftlint baseline — grandfathered findings. "
                              "Matching is (rule, path, line text) with "
                              "multiplicity; fix the line or re-run "
                              "--write-baseline to update.",
                   "findings": sorted(grouped.values(),
                                      key=lambda e: (e["path"], e["line"],
                                                     e["rule"]))}
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")
        os.replace(tmp, path)
        return len(grouped)


def repo_root() -> str:
    """The directory holding the ``tse1m_tpu_torch`` package (== the repo
    root in every supported layout)."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def default_targets(root: str | None = None) -> list[str]:
    root = root or repo_root()
    targets = []
    pkg = os.path.join(root, "tse1m_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                targets.append(os.path.join(dirpath, name))
    return targets


def lint_paths(paths: list[str], rules: dict | None = None,
               root: str | None = None,
               baseline: Baseline | None = None,
               sources: dict | None = None) -> list[Finding]:
    """Run ``rules`` over ``paths``; returns every finding with its
    ``suppressed``/``baselined`` flags resolved (callers filter).  A
    ``sources`` dict receives each parsed file (abspath -> FileSource),
    so a caller parses each file once."""
    from .rules import RULES

    rules = rules if rules is not None else RULES
    root = root or repo_root()
    findings: list[Finding] = []
    for abspath in paths:
        rel = os.path.relpath(os.path.abspath(abspath), root)
        rel = rel.replace(os.sep, "/")
        try:
            src = load_source(abspath, rel)
        except (OSError, SyntaxError) as e:
            findings.append(Finding(rule="parse-error", path=rel, line=1,
                                    col=0, message=f"could not lint: {e}"))
            continue
        if sources is not None:
            sources[os.path.abspath(abspath)] = src
        for name, rule_fn in rules.items():
            for f in rule_fn(src):
                f.rule = name
                if not f.text and 1 <= f.line <= len(src.lines):
                    f.text = src.lines[f.line - 1].strip()
                disabled = src.line_disables.get(f.line, set())
                if (name in src.file_disables or name in disabled
                        or "*" in disabled):
                    f.suppressed = True
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if baseline is not None:
        for f in findings:
            if not f.suppressed:
                f.baselined = baseline.absorb(f)
    return findings


def _resolve_flags(findings: list[Finding], sources: dict,
                   root: str) -> None:
    """Fill text + suppression flags for findings whose file wasn't in
    the per-file loop (interprocedural findings can anchor anywhere,
    including the fault-seat inventory)."""
    for f in findings:
        src = sources.get(f.path)
        if src is None:
            try:
                src = load_source(os.path.join(root, f.path), f.path)
            except (OSError, SyntaxError):
                continue
            sources[f.path] = src
        if not f.text and 1 <= f.line <= len(src.lines):
            f.text = src.lines[f.line - 1].strip()
        disabled = src.line_disables.get(f.line, set())
        if (f.rule in src.file_disables or f.rule in disabled
                or "*" in disabled):
            f.suppressed = True


def lint_project(report_paths: list[str], graph_paths: list[str],
                 rules: dict | None = None,
                 project_rules: set | None = None,
                 root: str | None = None,
                 baseline: "Baseline | None" = None,
                 use_cache: bool = True,
                 matrix_path: str | None = None):
    """The whole-program lint driver.

    Per-file rules run over ``report_paths``; the interprocedural
    passes (lint/interproc.py) run over the ProjectGraph built from
    ``graph_paths`` (a superset — unchanged files come from the digest
    cache).  Returns ``(findings, stats)`` where stats carries the
    graph/cache/wall numbers the run manifest records."""
    from .graph import build_graph
    from .interproc import MATRIX_BASENAME, run_project_passes

    t0 = time.perf_counter()
    root = root or repo_root()
    parsed: dict = {}
    findings = lint_paths(report_paths, rules=rules, root=root,
                          baseline=None, sources=parsed)
    sources: dict = {}
    prebuilt: dict = {}
    for abspath, src in parsed.items():
        sources[src.path] = src
        prebuilt[abspath] = (src.path, src.text, src.tree)
    graph = build_graph(graph_paths, root=root, sources=prebuilt,
                        use_cache=use_cache)
    if matrix_path is None:
        # Fixture runs carry their own seat inventory: a linted file
        # named like the inventory overrides the package's own.
        for abspath in report_paths:
            if os.path.basename(abspath) == MATRIX_BASENAME:
                matrix_path = os.path.abspath(abspath)
                break
    project = run_project_passes(graph, wanted_rules=project_rules,
                                 matrix_path=matrix_path)
    _resolve_flags(project, sources, root)
    findings += project
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if baseline is not None:
        for f in findings:
            if not f.suppressed:
                f.baselined = baseline.absorb(f)
    stats = {
        "wall_s": round(time.perf_counter() - t0, 3),
        "graph_files": len(graph.facts),
        "graph_functions": len(graph.functions),
        "graph_call_edges": sum(len(v) for v in graph.calls.values()),
        "cache_files": graph.cache_files,
        "cache_hits": graph.cache_hits,
        "cache_hit_rate": round(
            graph.cache_hits / graph.cache_files, 4)
        if graph.cache_files else 0.0,
    }
    return findings, stats, graph


def _git_changed(root: str, ref: str) -> set:
    """Repo-relative paths of files that differ from ``ref`` (committed
    diff + working tree + untracked)."""
    import subprocess

    out: set = set()
    for cmd in (["git", "diff", "--name-only", ref, "--"],
                ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            proc = subprocess.run(cmd, cwd=root, capture_output=True,
                                  text=True, timeout=30, check=True)
        except (OSError, subprocess.SubprocessError) as e:
            raise RuntimeError(
                f"--changed {ref}: {' '.join(cmd)} failed: {e}") from e
        out |= {ln.strip() for ln in proc.stdout.splitlines()
                if ln.strip().endswith(".py")}
    return out


def changed_closure(root: str, ref: str, targets: list[str]):
    """(report_paths, info) for ``--changed REF``: files whose content
    digest differs from the cache/ref plus their reverse-dependency
    closure from the import graph."""
    from .graph import build_graph

    changed = _git_changed(root, ref)
    rel_targets = {os.path.relpath(os.path.abspath(p), root)
                   .replace(os.sep, "/"): p for p in targets}
    graph = build_graph(targets, root=root, use_cache=True)
    seed = {rel for rel in changed if rel in rel_targets}
    closure = graph.reverse_closure(seed) & set(rel_targets)
    report = [rel_targets[rel] for rel in sorted(closure)]
    info = {"ref": ref, "changed": sorted(seed),
            "closure": sorted(closure)}
    return report, info


def summarize(findings: list[Finding],
              stale: list[dict] | None = None) -> dict:
    new = [f for f in findings if not f.suppressed and not f.baselined]
    by_rule: dict[str, int] = {}
    for f in new:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    # Every finding per rule (suppressed/baselined included): the run
    # manifest's evidence that a rule RAN, not just that it was clean.
    by_rule_total: dict[str, int] = {}
    suppressed_by_rule: dict[str, int] = {}
    for f in findings:
        by_rule_total[f.rule] = by_rule_total.get(f.rule, 0) + 1
        if f.suppressed:
            suppressed_by_rule[f.rule] = suppressed_by_rule.get(f.rule,
                                                                0) + 1
    return {
        "ok": not new,
        "new_findings": len(new),
        "baselined": sum(1 for f in findings if f.baselined),
        "suppressed": sum(1 for f in findings if f.suppressed),
        "by_rule": dict(sorted(by_rule.items())),
        "by_rule_total": dict(sorted(by_rule_total.items())),
        "suppressed_by_rule": dict(sorted(suppressed_by_rule.items())),
        "stale_baseline_entries": len(stale or []),
    }


def run_repo_lint(baseline_path: str = BASELINE_DEFAULT,
                  root: str | None = None) -> dict:
    """Programmatic whole-repo lint (the ``cli all`` manifest step):
    per-file rules plus the interprocedural passes, with the graph's
    wall time / cache hit rate / rule counts in the summary.

    Returns the JSON summary when clean; raises :class:`LintError`
    carrying the summary when there are non-baselined findings."""
    root = root or repo_root()
    baseline = Baseline.load(baseline_path)
    targets = default_targets(root)
    findings, stats, _ = lint_project(targets, targets,
                                      baseline=baseline, root=root)
    summary = summarize(findings, baseline.stale_entries())
    summary.update(stats)
    if not summary["ok"]:
        new = [f for f in findings if not f.suppressed and not f.baselined]
        detail = "; ".join(f"{f.location()} {f.rule}" for f in new[:5])
        raise LintError(
            f"graftlint: {len(new)} non-baselined finding(s): {detail}",
            step_result=summary)
    return summary


def _parse_why(spec: str):
    """'RULE:path:line' -> (rule, path, line) or None."""
    parts = spec.rsplit(":", 2)
    if len(parts) != 3 or not parts[2].isdigit():
        return None
    return parts[0], parts[1].replace(os.sep, "/"), int(parts[2])


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tse1m_tpu_torch.lint",
        description="graftlint over the port: enforce its device, DB and "
                    "resilience invariants (rule catalog: the JAX "
                    "package's LINTING.md)")
    ap.add_argument("paths", nargs="*",
                    help="files to lint (default: tse1m_tpu_torch/)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=BASELINE_DEFAULT,
                    help="baseline file (default: %(default)s)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding, ignoring the baseline")
    ap.add_argument("--write-baseline", action="store_true",
                    help="rewrite the baseline from the current findings "
                         "(keeps reasons of entries that still match)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated subset of rules to run")
    ap.add_argument("--changed", metavar="REF", default=None,
                    help="incremental mode: lint only files whose content "
                         "differs from REF plus their reverse-dependency "
                         "closure (interprocedural passes still see the "
                         "whole graph, via the digest cache)")
    ap.add_argument("--why", metavar="RULE:PATH:LINE", default=None,
                    help="explain one finding: print the interprocedural "
                         "witness chain that proves it")
    ap.add_argument("--graph", action="store_true",
                    help="print the project import/call-graph summary "
                         "(with per-file edges for explicit paths)")
    ap.add_argument("--no-cache", action="store_true",
                    help="ignore and do not write the digest cache")
    args = ap.parse_args(argv)

    from .interproc import PROJECT_RULES
    from .rules import RULES

    t0 = time.perf_counter()
    all_rules = set(RULES) | set(PROJECT_RULES)
    rules = RULES
    project_rules: set | None = None
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = wanted - all_rules
        if unknown:
            print(f"unknown rule(s): {', '.join(sorted(unknown))}; "
                  f"available: {', '.join(sorted(all_rules))}",
                  file=sys.stderr)
            return 2
        rules = {k: v for k, v in RULES.items() if k in wanted}
        project_rules = wanted & set(PROJECT_RULES)

    root = repo_root()
    targets = default_targets(root)
    changed_info = None
    if args.changed and args.paths:
        print("--changed and explicit paths are mutually exclusive",
              file=sys.stderr)
        return 2
    if args.changed:
        try:
            report_paths, changed_info = changed_closure(
                root, args.changed, targets)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            return 2
        graph_paths = targets
    elif args.paths:
        report_paths = [os.path.abspath(p) for p in args.paths]
        graph_paths = report_paths
    else:
        report_paths = graph_paths = targets
    old = Baseline.load(args.baseline)
    baseline = None if (args.no_baseline or args.write_baseline) else old
    findings, stats, graph = lint_project(
        report_paths, graph_paths, rules=rules,
        project_rules=project_rules, root=root, baseline=baseline,
        use_cache=not args.no_cache)

    if args.graph:
        report = {"files": stats["graph_files"],
                  "functions": stats["graph_functions"],
                  "call_edges": stats["graph_call_edges"],
                  "cache_hit_rate": stats["cache_hit_rate"]}
        if args.paths:
            rels = {os.path.relpath(os.path.abspath(p), root)
                    .replace(os.sep, "/") for p in args.paths}
            report["edges"] = [
                f"{q} -> {t}"
                for q, edges in sorted(graph.calls.items())
                if graph.fn_file.get(q) in rels
                for t, _ in edges]
        print(json.dumps(report, indent=2))
        return 0

    if args.why:
        spec = _parse_why(args.why)
        if spec is None:
            print("--why wants RULE:path:line", file=sys.stderr)
            return 2
        rule, path, line = spec
        hits = [f for f in findings
                if f.rule == rule and f.path == path and f.line == line]
        if not hits:
            print(f"no {rule} finding at {path}:{line} (run without "
                  "--why to list findings)", file=sys.stderr)
            return 2
        for f in hits:
            print(f"{f.location()}: {f.rule}: {f.message}")
            for step in (f.witness or ["(single-file finding — no "
                                       "interprocedural chain)"]):
                print(f"    {step}")
        return 0

    if args.write_baseline:
        n = Baseline.write(args.baseline, findings, old=old)
        print(f"graftlint: baseline rewritten with {n} entr"
              f"{'y' if n == 1 else 'ies'} -> {args.baseline}")
        return 0

    # Stale-entry detection only makes sense against the full target set:
    # an explicit-path or --changed run never visits most baselined files.
    full_run = not args.paths and not args.changed
    stale = (baseline.stale_entries()
             if baseline is not None and full_run else [])
    summary = summarize(findings, stale)
    summary.update(stats)
    summary["wall_s"] = round(time.perf_counter() - t0, 3)
    if changed_info is not None:
        summary["changed"] = changed_info
    new = [f for f in findings if not f.suppressed and not f.baselined]
    if args.json:
        report = dict(summary)
        report["findings"] = [asdict(f) for f in new]
        report["stale_baseline"] = stale
        print(json.dumps(report, indent=2))
    else:
        for f in new:
            print(f"{f.location()}: {f.rule}: {f.message}")
        for e in stale:
            print(f"note: stale baseline entry ({e['rule']} at {e['path']}: "
                  f"{e['text'][:60]!r}) — finding fixed, entry can be "
                  "removed", file=sys.stderr)
        scope = (f"{len(changed_info['closure'])} file(s) in the changed "
                 f"closure of {changed_info['ref']}, "
                 if changed_info is not None else "")
        print(f"graftlint: {summary['new_findings']} new, "
              f"{summary['baselined']} baselined, "
              f"{summary['suppressed']} suppressed"
              + (f", {len(stale)} stale baseline entries" if stale else "")
              + f" ({scope}wall {summary['wall_s']}s, cache hit rate "
              f"{summary['cache_hit_rate']})",
              file=sys.stderr)
        if summary["suppressed_by_rule"]:
            print("graftlint: suppressed by rule: " + ", ".join(
                f"{r} {n}" for r, n in summary["suppressed_by_rule"].items()),
                file=sys.stderr)
    return 1 if new else 0
