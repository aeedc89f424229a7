"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (under
one lock: ``_count.py``); ``reset_launch_counts`` and ``launch_counts``
clear and read them all.
"""

from ._count import read_counts, reset_counts
from .cminhash import cminhash_binmin
from .minhash import minhash_and_keys, minhash_and_keys_packed
from .rans import rans_decode
from .score import topk_chunk

_WRAPPERS = (minhash_and_keys, cminhash_binmin, minhash_and_keys_packed,
             rans_decode, topk_chunk)


def reset_launch_counts() -> None:
    """Set every kernel's launch count to 0."""
    reset_counts(_WRAPPERS)


def launch_counts() -> dict:
    return read_counts(_WRAPPERS)


__all__ = ["cminhash_binmin", "launch_counts", "minhash_and_keys",
           "minhash_and_keys_packed", "rans_decode", "reset_launch_counts",
           "topk_chunk"]
