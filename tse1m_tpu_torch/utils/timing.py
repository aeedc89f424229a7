"""Phase timing: a trimmed copy of ``tse1m_tpu/utils/timing.py`` (host
wall clock per named phase; no profiler hook)."""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field


@dataclass
class PhaseTimer:
    phases: dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        yield
        self.phases[name] = (self.phases.get(name, 0.0)
                             + time.perf_counter() - start)

    def as_dict(self) -> dict[str, float]:
        return dict(self.phases)


__all__ = ["PhaseTimer"]
