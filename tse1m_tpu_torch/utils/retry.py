"""Bounded retries of local I/O: a trimmed copy of
``tse1m_tpu/resilience/retry.py`` and ``io_retry_policy``.

The signature store writes each shard under ``retry_call(...,
policy=io_retry_policy())``: a transient ``OSError`` (a flaky mount, a
full disk freed a moment later) rewrites the shard's temp files from
scratch instead of failing the run.  Backoff is exponential with full
jitter, optionally capped by a deadline over all attempts.  The JAX
package's span per attempt and its retry counter belong to its tracing
and metrics planes, which are not ported.
"""

from __future__ import annotations

import logging
import os
import random
import time
from dataclasses import dataclass
from typing import Callable

log = logging.getLogger("tse1m_tpu_torch.retry")


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff and budget of :func:`retry_call`."""

    max_attempts: int = 4
    base_delay: float = 0.25          # first backoff step, seconds
    max_delay: float = 30.0           # per-sleep cap
    deadline: float | None = None     # wall-clock budget over all attempts
    jitter: bool = True               # full jitter: sleep ~ U(0, step)
    retry_on: tuple = (Exception,)    # exception allowlist (isinstance)

    def step(self, attempt: int) -> float:
        """Backoff before jitter for the 0-based attempt number."""
        return min(self.max_delay, self.base_delay * (2 ** attempt))


class RetryError(RuntimeError):
    """All attempts failed (or the deadline passed).  ``__cause__`` is the
    last exception; ``attempts`` is how many were made."""

    def __init__(self, message: str, attempts: int):
        super().__init__(message)
        self.attempts = attempts


def io_retry_policy(**overrides) -> RetryPolicy:
    """The JAX package's policy for local-I/O seats, read from the same
    environment: ``TSE1M_RETRY_ATTEMPTS`` (4), ``TSE1M_RETRY_BASE_DELAY``
    (0.05 s), ``TSE1M_RETRY_MAX_DELAY`` (2 s), ``TSE1M_RETRY_DEADLINE``."""
    kw = dict(
        max_attempts=int(os.environ.get("TSE1M_RETRY_ATTEMPTS", 4)),
        base_delay=float(os.environ.get("TSE1M_RETRY_BASE_DELAY", 0.05)),
        max_delay=float(os.environ.get("TSE1M_RETRY_MAX_DELAY", 2.0)),
    )
    if "TSE1M_RETRY_DEADLINE" in os.environ:
        kw["deadline"] = float(os.environ["TSE1M_RETRY_DEADLINE"])
    kw.update(overrides)
    return RetryPolicy(**kw)


def retry_call(fn: Callable, *args, policy: RetryPolicy | None = None,
               site: str = "", **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``: only
    exceptions in ``policy.retry_on`` are retried, anything else
    propagates at once; past the attempts or the deadline it raises
    :class:`RetryError` from the last exception."""
    policy = policy or RetryPolicy()
    start = time.monotonic()
    label = site or getattr(fn, "__name__", "call")
    last: BaseException | None = None
    attempts = 0
    for attempt in range(policy.max_attempts):
        attempts = attempt + 1
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            last = e
        delay = policy.step(attempt)
        if policy.jitter:
            delay = random.uniform(0, delay)
        if policy.deadline is not None:
            remaining = policy.deadline - (time.monotonic() - start)
            if remaining <= 0 or attempt + 1 >= policy.max_attempts:
                break
            delay = min(delay, remaining)
        elif attempt + 1 >= policy.max_attempts:
            break
        log.warning("%s: attempt %d/%d failed (%s: %s); retrying in %.2fs",
                    label, attempts, policy.max_attempts,
                    type(last).__name__, last, delay)
        if delay > 0:
            time.sleep(delay)
    raise RetryError(f"{label}: giving up after {attempts} attempts: "
                     f"{type(last).__name__}: {last}", attempts) from last


__all__ = ["RetryError", "RetryPolicy", "io_retry_policy", "retry_call"]
