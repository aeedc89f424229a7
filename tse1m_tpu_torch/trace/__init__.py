"""Named locks with the profiler's lock-wait seat (``sync``); the JAX
package's schedule explorer and its hooks are not ported."""

from .sync import Lock, RLock, set_lock_wait_recorder

__all__ = ["Lock", "RLock", "set_lock_wait_recorder"]
