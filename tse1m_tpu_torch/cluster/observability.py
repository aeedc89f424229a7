"""Per-stage pipeline telemetry (encode / h2d / compute / d2h).

``StageRecorder`` accumulates (wall seconds, payload bytes) per stage.  The
streaming pipeline records ``encode`` and ``h2d`` from its producer thread
while ``compute`` accrues on the main thread, so summed stage walls exceed
the elapsed wall exactly when the overlap works; ``as_dict`` reports that
surplus as ``h2d_overlap_fraction``.  Stage names and the flat
``stage_<name>_s`` / ``stage_<name>_mb`` keys follow the JAX package's
``tse1m_tpu.observability.StageRecorder``, and so does the lockset
detector's field name, ``stages``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

from ..trace import sync as tsync
from ..trace.hooks import shared_access


class StageRecorder:
    """Thread-safe (wall seconds, bytes) accumulator per pipeline stage."""

    def __init__(self) -> None:
        self._lock = tsync.Lock("StageRecorder")
        self.wall: dict[str, float] = defaultdict(float)
        self.nbytes: dict[str, int] = defaultdict(int)
        self.total_wall_s: float = 0.0

    def add(self, stage: str, seconds: float, nbytes: int = 0) -> None:
        with self._lock:
            shared_access(self, "stages", write=True)
            self.wall[stage] += seconds
            self.nbytes[stage] += nbytes

    @contextlib.contextmanager
    def stage(self, name: str, nbytes: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, nbytes)

    def set_total(self, seconds: float) -> None:
        with self._lock:
            shared_access(self, "stages", write=True)
            self.total_wall_s = seconds

    def as_dict(self) -> dict:
        """Flat form: stage_<name>_s / stage_<name>_mb keys, the total wall
        and the fraction of H2D seconds hidden behind other stages."""
        with self._lock:
            shared_access(self, "stages", write=False)
            walls, nbytes = dict(self.wall), dict(self.nbytes)
            total = self.total_wall_s
        out: dict = {}
        for name in sorted(walls):
            out[f"stage_{name}_s"] = round(walls[name], 4)
            if nbytes.get(name):
                out[f"stage_{name}_mb"] = round(nbytes[name] / 2**20, 2)
        if total:
            out["stage_total_wall_s"] = round(total, 4)
        h2d = walls.get("h2d", 0.0)
        hidden = sum(walls.values()) - total
        out["h2d_overlap_fraction"] = (
            round(min(1.0, max(0.0, hidden / h2d)), 4)
            if h2d > 0.0 and total > 0.0 else 0.0)
        return out
