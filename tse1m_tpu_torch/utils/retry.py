"""The shared retry engine: a copy of ``tse1m_tpu/resilience/retry.py``
and its ``io_retry_policy``.

One loop for every I/O seat: bounded attempts, exponential backoff with
full jitter, a deadline over all attempts, an exception allowlist
(``policy.retry_on``, narrowed further by ``should_retry``), a recovery
hook between attempts (``on_retry``: the study database reconnects there
after a dropped connection) and server ``Retry-After`` hints (an
exception's ``retry_after`` raises the next sleep, capped by what is left
of the deadline).  The signature store and the cluster checkpoints write
their shards under ``io_retry_policy()``; the HTTP transport
(``collect/transport.py``) and the study database (``db/connection.py``)
retry through the same loop.

As in the JAX package, each attempt is its own span (``attempt.<site>``,
tagged with the error type when it fails and ``fault: injected`` when the
fault plane raised it), every retry adds one to the ``retries_total``
counter of its site, and ``sleep``, ``rng`` and ``clock`` are injectable,
so a test replays the engine's sleeps exactly.
"""

from __future__ import annotations

import logging
import os
import random
import time
from dataclasses import dataclass, field
from typing import Callable

from ..resilience.faults import InjectedFault
from ..resilience.watchdog import deadline_clock

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


@dataclass
class RetryStats:
    """What the engine did: attempts made and each sleep, in order."""

    attempts: int = 0
    sleeps: list = field(default_factory=list)


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


def retry_call(
    fn: Callable,
    *args,
    policy: RetryPolicy | None = None,
    site: str = "",
    should_retry: Callable[[BaseException], bool] | None = None,
    on_retry: Callable[[BaseException, int], None] | None = None,
    sleep: Callable[[float], None] = time.sleep,
    rng: random.Random | None = None,
    clock: Callable[[], float] = deadline_clock,
    stats: RetryStats | None = None,
    **kwargs,
):
    """Call ``fn(*args, **kwargs)``, retrying per ``policy``.

    Only exceptions in ``policy.retry_on`` for which ``should_retry(exc)``
    holds (when given) are retried; anything else propagates at once.
    ``on_retry(exc, attempt)`` runs before each new attempt.  An
    exception's ``retry_after`` (seconds) raises the next sleep to at
    least that, still capped by the remaining deadline.  Past the attempts
    or the deadline it raises :class:`RetryError` from the last exception.
    """
    # Function-level imports: the telemetry plane sits above this module
    # in the import graph.
    from ..observability import metrics as obs_metrics
    from ..observability import tracing

    policy = policy or RetryPolicy()
    rng = rng or random
    start = clock()
    label = site or getattr(fn, "__name__", "call")
    last: BaseException | None = None
    attempts = 0
    for attempt in range(policy.max_attempts):
        attempts = attempt + 1
        if stats is not None:
            stats.attempts = attempts
        try:
            with tracing.span(f"attempt.{label}", attempt=attempts) as sp:
                try:
                    return fn(*args, **kwargs)
                except BaseException as e:
                    sp.set_tag("error", type(e).__name__)
                    if isinstance(e, InjectedFault):
                        sp.set_tag("fault", "injected")
                    raise
        except policy.retry_on as e:
            if should_retry is not None and not should_retry(e):
                raise
            last = e
        delay = policy.step(attempt)
        if policy.jitter:
            delay = rng.uniform(0, delay)
        hint = getattr(last, "retry_after", None)
        if hint is not None:
            delay = max(delay, float(hint))
        if policy.deadline is not None:
            remaining = policy.deadline - (clock() - start)
            if remaining <= 0 or attempt + 1 >= policy.max_attempts:
                break
            # Sleeping past the deadline cannot help: spend what is left.
            delay = min(delay, remaining)
        elif attempt + 1 >= policy.max_attempts:
            break
        log.warning("%s: attempt %d/%d failed (%s: %s); retrying in %.2fs",
                    label, attempts, policy.max_attempts,
                    type(last).__name__, last, delay)
        obs_metrics.counter("retries_total", site=label).inc()
        if on_retry is not None:
            on_retry(last, attempt)
        if stats is not None:
            stats.sleeps.append(delay)
        if delay > 0:
            sleep(delay)
    raise RetryError(f"{label}: giving up after {attempts} attempts: "
                     f"{type(last).__name__}: {last}", attempts) from last


__all__ = ["RetryError", "RetryPolicy", "RetryStats", "io_retry_policy",
           "retry_call"]
