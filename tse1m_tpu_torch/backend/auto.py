"""The per-RQ router behind ``backend = auto``: a port of
``tse1m_tpu/backend/auto.py``.

Each RQ call goes to the engine predicted to answer it sooner on this
machine: ``"device"``, ``TorchBackend`` on the card, or ``"host"``,
``TorchBackend`` on the CPU.  The rule is the JAX package's, constant for
constant, with ``jax`` read as ``device`` and ``pandas`` as ``host``:

- bootstrap priors steer only the first call of each RQ: the host at
  ``_PRIOR_HOST_COEF[rq]`` seconds a relevant row, the device at
  ``_RTT_MULTIPLE`` dispatch round trips;
- every completed call updates an EWMA (weight ``_EWMA_ALPHA``) of that
  (rq, engine)'s observed seconds a row, except the first device call of
  each RQ, which pays one-time set-up (the study's upload to the card);
- when one engine is measured and the other is not, the unmeasured one
  is tried once unless its prior loses by more than ``_EXPLORE_FACTOR``;
- ``rq_suite`` is routed whole, as ``suite``.

Both engines are held to each other by the RQ tests, so routing changes
speed, never results.  With ``cal_path`` set, the measured costs persist
through ``utils/calibration.py`` under the keys ``<rq>:device`` and
``<rq>:host``; the loader keeps only those, so one file can serve both
packages without either reading the other's costs.

There is no CPU failover: a device-loss error on the device engine
raises (the JAX package re-runs the call on pandas).  The fault plane's
``backend.device.call`` seat sits before each device call.
"""

from __future__ import annotations

import logging
import time

import torch

from ..device import resolve_device
from ..resilience.faults import fault_point
from .base import Backend

log = logging.getLogger("tse1m_tpu_torch.backend.auto")

# Bootstrap priors: host seconds a relevant row.  Only the first call of
# each RQ is routed by these; measurements replace them at once.
_PRIOR_HOST_COEF = {
    "rq1": 2e-8,
    "rq2cp": 2.5e-6,
    "rq2tr": 8e-7,
    "rq3": 1.1e-6,
    "rq4a": 2e-8,
    "rq4b": 3e-7,
    "suite": 4.5e-6,   # six host RQs over the shared tables
}
# The unmeasured device: one dispatch, one fetch and a margin, in round
# trips.  Replaced by the measured device wall after one call.
_RTT_MULTIPLE = 4.0
# EWMA weight of the newest observation: adapts within a couple of calls,
# and one noisy wall does not flap the routing.
_EWMA_ALPHA = 0.5
# An engine never measured here is tried once while its prior is within
# this factor of the measured incumbent; without it the router would
# starve the unmeasured engine for good.
_EXPLORE_FACTOR = 5.0

# The study tables that set each RQ's count of relevant rows.
_RQ_TABLES = {
    "rq1": ("fuzz",),
    "rq2cp": ("covb",),
    "rq2tr": ("cov",),
    "rq3": ("fuzz", "covb", "cov"),
    "rq4a": ("fuzz",),
    "rq4b": ("cov",),
    "suite": ("fuzz", "covb", "cov"),
}

_ENGINES = ("device", "host")


class AutoBackend(Backend):
    """Routes each RQ call to the engine measured to win on this machine.

    ``rtt_s`` is the measured dispatch round trip
    (``backend._dispatch_rtt_s``); both engines are built at first use.
    ``device`` is the device engine's card."""

    name = "auto"

    def __init__(self, rtt_s: float, cal_path: str | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._rtt_s = float(rtt_s)
        self._engines: dict = {}
        # (rq, engine) -> EWMA of observed seconds a relevant row.  The
        # device's fixed round trip folds into its cost a row at the
        # observed scale: right while call sizes are stable, as they are
        # within one analysis run.
        self._cost: dict = {}
        self._dev_compiled: set = set()  # RQs whose device set-up is paid
        self.last_engine: str | None = None  # the engine of the last call
        self._cal_path = cal_path or None
        self._load_calibration()

    def _load_calibration(self) -> None:
        if not self._cal_path:
            return
        from ..utils.calibration import load_calibration

        saved = load_calibration(self._cal_path)["cost_per_row"]
        for key, cost in saved.items():
            rq, _, eng = key.partition(":")
            if rq in _PRIOR_HOST_COEF and eng in _ENGINES:
                self._cost[(rq, eng)] = float(cost)
        if self._cost:
            log.info("router calibration reloaded from %s (%d entries)",
                     self._cal_path, len(self._cost))

    def _save_calibration(self) -> None:
        if not self._cal_path:
            return
        from ..utils.calibration import update_calibration

        update_calibration(
            self._cal_path,
            cost_per_row=self.calibration()["cost_per_row"])

    def _engine(self, name: str) -> Backend:
        be = self._engines.get(name)
        if be is None:
            from .torch_backend import TorchBackend

            be = (TorchBackend(self.device) if name == "device"
                  else TorchBackend("cpu", mesh=None))
            self._engines[name] = be
        return be

    def _predict(self, rq: str, engine: str, rows: int) -> float:
        c = self._cost.get((rq, engine))
        if c is not None:
            return max(rows, 1) * c
        if engine == "host":
            return max(rows, 1) * _PRIOR_HOST_COEF[rq]
        return _RTT_MULTIPLE * self._rtt_s

    def _pick(self, rq: str, rows: int) -> tuple:
        pd = self._predict(rq, "device", rows)
        ph = self._predict(rq, "host", rows)
        md = (rq, "device") in self._cost
        mh = (rq, "host") in self._cost
        if md != mh:
            # One engine measured, the other on its prior: try the
            # unmeasured one once unless its prior loses by more than
            # _EXPLORE_FACTOR.  Regret is one mispredicted call per (rq,
            # engine); the measurement fixes the routing from then on.
            name, prior, incumbent = (("device", pd, ph) if not md
                                      else ("host", ph, pd))
            if prior <= _EXPLORE_FACTOR * incumbent:
                return name, self._engine(name)
        if pd < ph:
            return "device", self._engine("device")
        return "host", self._engine("host")

    def _observe(self, rq: str, engine: str, rows: int,
                 wall_s: float) -> None:
        key = (rq, engine)
        c = wall_s / max(rows, 1)
        prev = self._cost.get(key)
        self._cost[key] = (c if prev is None
                           else _EWMA_ALPHA * c + (1 - _EWMA_ALPHA) * prev)
        self._save_calibration()

    def _run(self, rq: str, arrays, method: str, *args, **kw):
        rows = self._rows(arrays, *_RQ_TABLES[rq])
        engine, be = self._pick(rq, rows)
        self.last_engine = engine
        t0 = time.perf_counter()
        if engine == "device":
            fault_point("backend.device.call")
        out = getattr(be, method)(arrays, *args, **kw)
        wall = time.perf_counter() - t0
        if engine == "device" and rq not in self._dev_compiled:
            # The first device call of an RQ pays one-time set-up;
            # recording it would bias the routing against the device.
            self._dev_compiled.add(rq)
        else:
            self._observe(rq, engine, rows, wall)
        return out

    def calibration(self) -> dict:
        """Learned routing state, for the run manifest."""
        return {
            "dispatch_rtt_s": self._rtt_s,
            "cost_per_row": {f"{rq}:{eng}": cost
                             for (rq, eng), cost in sorted(self._cost.items())},
        }

    @staticmethod
    def _rows(arrays, *tables) -> int:
        return int(sum(len(getattr(arrays, t)) for t in tables))

    def rq1_detection(self, arrays, limit_date_ns, min_projects):
        return self._run("rq1", arrays, "rq1_detection", limit_date_ns,
                         min_projects)

    def rq2_change_points(self, arrays, limit_date_ns):
        return self._run("rq2cp", arrays, "rq2_change_points", limit_date_ns)

    def rq2_trends(self, arrays, limit_date_ns):
        return self._run("rq2tr", arrays, "rq2_trends", limit_date_ns)

    def rq3_coverage_at_detection(self, arrays, limit_date_ns):
        return self._run("rq3", arrays, "rq3_coverage_at_detection",
                         limit_date_ns)

    def rq4a_detection_trend(self, arrays, limit_date_ns, g1_idx, g2_idx,
                             min_projects):
        return self._run("rq4a", arrays, "rq4a_detection_trend",
                         limit_date_ns, g1_idx, g2_idx, min_projects)

    def rq4b_group_trends(self, arrays, limit_date_ns, g1_idx, g2_idx,
                          percentiles=(25, 50, 75)):
        return self._run("rq4b", arrays, "rq4b_group_trends", limit_date_ns,
                         g1_idx, g2_idx, percentiles)

    def rq_suite(self, arrays, limit_date_ns, min_projects, g1_idx, g2_idx,
                 percentiles=(25, 50, 75)):
        """Whole-suite routing: the device's suite against the host's, by
        the same measured-cost rule."""
        return self._run("suite", arrays, "rq_suite", limit_date_ns,
                         min_projects, g1_idx, g2_idx, percentiles)


__all__ = ["AutoBackend"]
