"""Run manifests: a trimmed copy of ``tse1m_tpu/utils/manifest.py``.

One JSON record of an analysis run (backend, device, phase timings,
artifact paths, row counts) saved beside its artifacts as
``<name>_manifest.json``.
"""

from __future__ import annotations

import json
import os
import platform
import time
from dataclasses import dataclass, field
from typing import Any

import torch

from .atomic import atomic_write


@dataclass
class RunManifest:
    name: str
    backend: str
    device: str
    extra: dict[str, Any] = field(default_factory=dict)
    artifacts: list[str] = field(default_factory=list)
    started_at: float = field(default_factory=time.time)

    def add_artifact(self, path: str) -> None:
        self.artifacts.append(path)

    def record(self, **kwargs: Any) -> None:
        self.extra.update(kwargs)

    def record_backend(self, backend) -> None:
        """Record how ``backend = auto`` resolved: a router's learned
        calibration (``backend/auto.py`` ``calibration()``), which shows
        the engine each RQ ran on and why, or the device engine it gave
        in a world of several ranks.  A no-op for a plain engine."""
        cal = getattr(backend, "calibration", None)
        if callable(cal):
            self.record(router_calibration=cal())
        note = getattr(backend, "auto_resolution", None)
        if note is not None:
            self.record(auto_resolution=dict(note))

    def save(self, out_dir: str,
             timings: dict[str, float] | None = None) -> str:
        dev = torch.device(self.device)
        payload = {
            "name": self.name,
            "backend": self.backend,
            "device": (torch.cuda.get_device_name(dev)
                       if dev.type == "cuda" else "cpu"),
            "started_at": self.started_at,
            "wall_seconds": time.time() - self.started_at,
            "host": platform.node(),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "timings": timings or {},
            "artifacts": self.artifacts,
            **self.extra,
        }
        path = os.path.join(out_dir, f"{self.name}_manifest.json")
        with atomic_write(path) as f:
            json.dump(payload, f, indent=2, default=str)
        return path


__all__ = ["RunManifest"]
