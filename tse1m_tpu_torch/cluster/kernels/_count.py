"""Launch counts of the kernel wrappers, kept exact across threads.

Each wrapper keeps its count in ``<wrapper>.launches``.  ``launches += 1``
is a read, an add and a store, which two threads can interleave and so
lose a count; the serving daemon's ingest thread and its request threads
launch kernels at the same time.  So every bump, reset and read takes one
lock.
"""

from __future__ import annotations

import threading

_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; a wrapper calls it where it
    launches its kernel, and nowhere else."""
    with _lock:
        wrapper.launches += 1


def reset_counts(wrappers) -> None:
    with _lock:
        for wrapper in wrappers:
            wrapper.launches = 0


def read_counts(wrappers) -> dict:
    with _lock:
        return {wrapper.__name__: wrapper.launches for wrapper in wrappers}
