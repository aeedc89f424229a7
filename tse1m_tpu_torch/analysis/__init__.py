"""The paper's research-question drivers over ``TorchBackend``.

``run_rqs`` runs drivers in the JAX package's order (``tse1m_tpu/cli.py:
170-201``), each step isolated by ``StepRunner`` and recorded in
``<result_dir>/run_manifest.json``; the ``all`` command and every single
RQ command of ``python -m tse1m_tpu_torch`` go through it.
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


def run_rqs(cfg: Config, names=tuple(RQ_DRIVERS),
            device: str | torch.device = "cuda") -> StepRunner:
    """Run the named drivers in order on ``device``, each to completion
    whatever the others do.  The device is resolved first, so without a
    card this raises before any step reads or writes."""
    dev = resolve_device(device)
    manifest_path = os.path.join(cfg.result_dir, "run_manifest.json")
    runner = StepRunner(manifest_path)
    for name in names:
        log.info("=== %s (device=%s) ===", name, dev)
        runner.run(name, RQ_DRIVERS[name], cfg, device=dev)
    if runner.failed:
        log.error("run finished with failures: %s (manifest: %s)",
                  ", ".join(s.name for s in runner.failed), manifest_path)
    return runner


__all__ = ["RQ_DRIVERS", "run_rqs"]
