"""Signature-scheme registry: the dispatch point for signature kernels.

The JAX package offers three schemes (``kminhash``, ``cminhash``,
``weighted``).  This package ports ``kminhash``, the K-permutation
multiply-add family, with the same constant stream, so one parameter set
gives the same signatures in both.  The one-permutation schemes are named
here and refused until they are ported (ROADMAP.md Queue 1 item 5).

Hash constants are the only parameters of this system: they play the part
that weights play in a model.  ``params_from_numpy`` carries the JAX
package's ``HashParams.arrays`` (numpy uint32) into this package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..device import u32_tensor
from .kernels.minhash import minhash_and_keys, minhash_and_keys_packed
from .minhash import make_hash_params

SCHEMES = ("kminhash", "cminhash", "weighted")


@dataclass(frozen=True)
class HashParams:
    """One scheme's hash constants: ``arrays`` = (a, b), [H] int32 tensors
    carrying uint32 bits, derived from (scheme, n_hashes, seed)."""

    scheme: str
    n_hashes: int
    arrays: tuple

    def to(self, device: str | torch.device) -> "HashParams":
        """The same params with the arrays on ``device`` (once per run)."""
        return HashParams(self.scheme, self.n_hashes,
                          tuple(t.to(device) for t in self.arrays))


def get_scheme(name: str) -> str:
    if name not in SCHEMES:
        raise ValueError(
            f"unknown signature scheme {name!r}; valid schemes: "
            f"{', '.join(SCHEMES)}")
    if name != "kminhash":
        raise NotImplementedError(
            f"signature scheme {name!r} is not ported yet (ROADMAP.md "
            "Queue 1 item 5: the one-permutation schemes)")
    return name


def params_from_numpy(scheme: str, n_hashes: int, arrays) -> HashParams:
    """HashParams from numpy uint32 constants, e.g. the JAX package's
    ``HashParams.arrays``."""
    get_scheme(scheme)
    return HashParams(scheme, n_hashes, tuple(u32_tensor(x) for x in arrays))


def make_params(scheme: str, n_hashes: int, seed: int = 0) -> HashParams:
    """Resolve a scheme's hash constants on the CPU (``.to`` moves them)."""
    return params_from_numpy(scheme, n_hashes,
                             make_hash_params(n_hashes, seed))


def scheme_sig_and_keys(items: torch.Tensor, hp: HashParams, n_bands: int):
    """[N, S] int32 ids -> ([N, H] signatures, [N, B] band keys)."""
    return minhash_and_keys(items, *hp.arrays, n_bands)


def scheme_sig_and_keys_packed(payload: torch.Tensor, shape: tuple, k: int,
                               offset: int, hp: HashParams, n_bands: int):
    """``scheme_sig_and_keys`` over a byte-packed wire chunk."""
    return minhash_and_keys_packed(payload, shape, k, offset, *hp.arrays,
                                   n_bands)


__all__ = ["HashParams", "SCHEMES", "get_scheme",
           "make_params", "params_from_numpy", "scheme_sig_and_keys",
           "scheme_sig_and_keys_packed"]
