"""The paper's research-question drivers over ``TorchBackend``.

``run_rqs`` runs drivers in the JAX package's order (``tse1m_tpu/cli.py:
170-201``), each step isolated by ``StepRunner`` and recorded in
``<result_dir>/run_manifest.json``; the ``all`` command and every single
RQ command of ``python -m tse1m_tpu_torch`` go through it.  Running all
six (``all``), it first records the correctness plane's two steps, as
the JAX package's ``all`` does (``tse1m_tpu/cli.py:181-190``):
``graftlint`` (the port's lint over ``tse1m_tpu_torch/`` and the runtime
sanitizer's self-check on the run's device) and ``graftspec`` (the three
protocol specs model-checked and the mutant self-test).  A failing step
fails the run; the RQs still run to completion.
"""

from __future__ import annotations

import logging
import os

import torch

from ..config import Config
from ..device import resolve_device
from ..utils.runner import StepRunner
from .rq1 import run_rq1
from .rq2_changepoints import run_rq2_changepoints
from .rq2_trends import run_rq2_trends
from .rq3 import run_rq3
from .rq4a import run_rq4a
from .rq4b import run_rq4b

log = logging.getLogger(__name__)

RQ_DRIVERS = {
    "rq1": run_rq1,
    "rq2a": run_rq2_changepoints,
    "rq2b": run_rq2_trends,
    "rq3": run_rq3,
    "rq4a": run_rq4a,
    "rq4b": run_rq4b,
}


def _lint_step(device: torch.device) -> dict:
    """The ``graftlint`` step: the port's whole-package lint plus the
    runtime sanitizer's self-check on ``device``, as the step's result
    (a failing lint's summary rides on its LintError)."""
    from ..lint import run_repo_lint
    from ..lint.runtime import self_check

    runtime = self_check(device)
    summary = run_repo_lint()  # raises LintError on non-baselined findings
    summary["runtime"] = runtime
    return summary


def _spec_step() -> dict:
    """The ``graftspec`` step: every protocol spec model-checked and the
    mutant self-test; a violated spec or an uncaught mutant fails it."""
    from ..spec import SpecError, check_all, mutant_selftest

    results = check_all()
    summary = {"specs": [r.summary() for r in results],
               "mutants": mutant_selftest()}
    bad = [r for r in results if not r.ok]
    if bad:
        raise SpecError("; ".join(
            f"{r.spec}: {r.violation.describe()}" for r in bad))
    return summary


def _run_recorded(runner: StepRunner, name: str, fn, *args) -> None:
    """``runner.run`` with the step's result recorded as the JAX package's
    runner records it: the dict the step returns, or the ``step_result``
    its exception carries."""
    box: dict = {}

    def step():
        try:
            box["result"] = fn(*args)
        except BaseException as e:
            box["result"] = getattr(e, "step_result", None)
            raise

    rec = runner.run(name, step)
    if isinstance(box.get("result"), dict):
        runner.record_result(rec, box["result"])


def run_rqs(cfg: Config, names=tuple(RQ_DRIVERS),
            device: str | torch.device = "cuda") -> StepRunner:
    """Run the named drivers in order on ``device``, each to completion
    whatever the others do; all six (``all``) come after the
    ``graftlint`` and ``graftspec`` steps.  The device is resolved first,
    so without a card this raises before any step reads or writes."""
    dev = resolve_device(device)
    manifest_path = os.path.join(cfg.result_dir, "run_manifest.json")
    runner = StepRunner(manifest_path)
    if tuple(names) == tuple(RQ_DRIVERS):
        _run_recorded(runner, "graftlint", _lint_step, dev)
        _run_recorded(runner, "graftspec", _spec_step)
    for name in names:
        log.info("=== %s (device=%s) ===", name, dev)
        runner.run(name, RQ_DRIVERS[name], cfg, device=dev)
    if runner.failed:
        log.error("run finished with failures: %s (manifest: %s)",
                  ", ".join(s.name for s in runner.failed), manifest_path)
    return runner


__all__ = ["RQ_DRIVERS", "run_rqs"]
