"""graftlint over the port: the static-analysis plane and the runtime
sanitizer, counterparts of the JAX package's ``tse1m_tpu/lint/`` with its
names, retargeted at ``tse1m_tpu_torch/``:

- :mod:`engine` — AST rule engine: per-rule suppression comments
  (``# graftlint: disable=RULE -- reason``), a committed baseline
  (``lint/baseline.json``) for grandfathered findings, machine-readable
  JSON output, and the whole-program driver (``--why`` witness chains,
  ``--changed`` incremental mode, ``--graph``).
- :mod:`rules` — the JAX package's 13 per-file rules; ``wire-layer`` and
  ``host-in-jit`` also read their subjects in torch idiom (explicit
  host<->device copies; bodies ``torch.compile``/``torch.jit`` trace).
- :mod:`graph` — the project import/call graph: per-file fact
  extraction, cross-module symbol resolution, digest-cached facts
  (``.graftlint_torch_cache.json`` at the repo root).
- :mod:`interproc` — the eight whole-program passes: taint, lease-fence,
  lock-order, fault-seat-drift (against ``resilience/fault_matrix.py``),
  snapshot-publish, atomic-swap, spec-conformance and
  verb-dispatch-drift.
- :mod:`runtime` — the runtime sanitizer: the build counter and the
  sync guard around a warm hot loop.

Run it: ``python -m tse1m_tpu_torch.lint`` (or ``python -m
tse1m_tpu_torch lint``).  Exit 0 means every finding is fixed, suppressed
with a reason, or baselined.
"""

from .engine import (BASELINE_DEFAULT, Baseline, Finding, LintError,
                     lint_paths, lint_project, load_source, main,
                     repo_root, run_repo_lint)
from .rules import RULES

__all__ = ["BASELINE_DEFAULT", "Baseline", "Finding", "LintError", "RULES",
           "lint_paths", "lint_project", "load_source", "main",
           "repo_root", "run_repo_lint"]
