"""The RQ backend: ``TorchBackend``, the ``auto`` router and the six result
types, with the dispatcher :func:`get_backend`.

``get_backend(cfg, device)`` reads ``cfg.backend`` (``program/envFile.ini``
``[FRAMEWORK] backend``, or ``TSE1M_BACKEND``) as the JAX package's
dispatcher does, with the port's engines:

- ``auto`` in a ``torch.distributed`` world of more than one rank ->
  ``TorchBackend(device)``: routing each rank's calls on its own would
  split the collectives between ranks that chose differently.  It is
  logged, and the run manifest records it (``auto_resolution``);
- ``auto`` on a card, in a world of one rank -> ``AutoBackend``
  (``backend/auto.py``): each RQ call goes to the card or the CPU by
  measured cost, seeded by the probed dispatch round trip;
- anything else -> ``TorchBackend(device)``: ``auto`` with
  ``device="cpu"`` (JAX's ``auto`` is pandas off the TPU), and ``pandas``
  or ``jax_tpu``, which keep the port on the device it was given.

The round-trip probe runs once a process.  A probe that fails on the
card raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import logging
import os
import time

import torch

from ..device import resolve_device
from ..parallel import multihost
from .auto import AutoBackend
from .base import (Backend, RQ1Result, RQ2ChangePointsResult, RQ2TrendsResult,
                   RQ3Result, RQ4aTrendResult, RQ4bTrendsResult)
from .torch_backend import TorchBackend

log = logging.getLogger("tse1m_tpu_torch.backend")


def _dispatch_rtt_s(device: torch.device) -> float:
    """Median of 3 round trips of a tiny op and its 4-byte fetch, after
    one warm call: the cost of one dispatch and its result on the host."""
    v = torch.zeros(8, dtype=torch.int32, device=device)
    int((v + 1)[0].item())  # warm
    samples = []
    for _ in range(3):
        t0 = time.perf_counter()
        int((v + 1)[0].item())
        samples.append(time.perf_counter() - t0)
    return sorted(samples)[1]


_auto_rtt_s: float | None = None


def _probed_rtt_s(device: torch.device) -> float:
    """The process's dispatch round trip, probed once."""
    global _auto_rtt_s
    if _auto_rtt_s is None:
        _auto_rtt_s = _dispatch_rtt_s(device)
        log.info("backend=auto: dispatch round trip %.3f ms on %s "
                 "(per-RQ routing active)", _auto_rtt_s * 1e3, device)
    return _auto_rtt_s


def get_backend(cfg, device: str | torch.device = "cuda") -> Backend:
    """The RQ engine ``cfg.backend`` names, on ``device`` (see the module
    docstring)."""
    dev = resolve_device(device)
    if cfg.backend == "auto":
        world = multihost._world()[0]
        if world > 1:
            log.info("backend=auto in a world of %d ranks: every RQ on %s "
                     "(per-rank routing would split the collectives)",
                     world, dev)
            be = TorchBackend(dev)
            # utils/manifest.py:record_backend writes this down.
            be.auto_resolution = {"backend": "auto", "engine": "device",
                                  "world_size": world}
            return be
        if dev.type == "cuda":
            cal = os.environ.get("TSE1M_ROUTER_CAL",
                                 getattr(cfg, "router_cal_path", None) or "")
            return AutoBackend(_probed_rtt_s(dev), cal_path=cal or None,
                               device=dev)
    return TorchBackend(dev)


__all__ = ["AutoBackend", "Backend", "RQ1Result", "RQ2ChangePointsResult",
           "RQ2TrendsResult", "RQ3Result", "RQ4aTrendResult",
           "RQ4bTrendsResult", "TorchBackend", "get_backend"]
