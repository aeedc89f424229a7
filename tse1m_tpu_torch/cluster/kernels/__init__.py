"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper counts its kernel launches in ``<wrapper>.launches``;
``reset_launch_counts`` and ``launch_counts`` read and clear them all.
"""

from .cminhash import cminhash_binmin
from .minhash import minhash_and_keys, minhash_and_keys_packed
from .rans import rans_decode
from .score import topk_chunk

_WRAPPERS = (minhash_and_keys, cminhash_binmin, minhash_and_keys_packed,
             rans_decode, topk_chunk)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    for wrapper in _WRAPPERS:
        wrapper.launches = 0


def launch_counts() -> dict:
    return {wrapper.__name__: wrapper.launches for wrapper in _WRAPPERS}


__all__ = ["cminhash_binmin", "launch_counts", "minhash_and_keys",
           "minhash_and_keys_packed", "rans_decode", "reset_launch_counts",
           "topk_chunk"]
