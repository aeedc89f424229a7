"""Device selection and the package's uint32 convention.

Every id, hash constant, signature and band key is a uint32 in the JAX
package.  PyTorch's ``uint32`` lacks ``add``, ``minimum``, ``amin``, ``<<``,
``%`` and ``scatter_reduce``, so this package carries each such value as an
``int32`` tensor holding the same 32 bits: 4 bytes a value on the card, as
in JAX.  The CUDA kernels read and write those bits as ``uint32_t``.  The
plain PyTorch versions widen them to ``int64`` in ``[0, 2^32)`` (``widen``),
compute with every intermediate kept below ``2^63``, mask to 32 bits, and
narrow back (``narrow``).
"""

from __future__ import annotations

import numpy as np
import torch

U32_MASK = 0xFFFFFFFF


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  ``None`` means the card.  Raises when a CUDA device is
    asked for and none is present; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but no CUDA device is available; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev


def u32_tensor(a, device: str | torch.device | None = None) -> torch.Tensor:
    """numpy uint32 values -> an int32 tensor carrying the same bits."""
    arr = np.ascontiguousarray(np.asarray(a, dtype=np.uint32))
    # graftlint: disable=wire-layer -- the port's uint32 host-to-device helper (torch has no uint32 kernels, so the bits ride as int32); JAX's jnp.asarray stages uint32 implicitly, unseen by the rule
    return torch.from_numpy(arr.view(np.int32).copy()).to(device or "cpu")


def as_u32_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor of uint32 bit patterns -> numpy uint32 (on the host)."""
    # graftlint: disable=wire-layer -- the port's uint32 device-to-host helper (the inverse view); JAX's np.asarray fetches implicitly, unseen by the rule
    return t.detach().cpu().numpy().view(np.uint32)


def widen(t: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or uint8 bytes) -> int64 values in [0, 2^32)."""
    return t.to(torch.int64) & U32_MASK


def narrow(t: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensors carrying the same bits."""
    return ((t ^ 0x80000000) - 0x80000000).to(torch.int32)


__all__ = ["U32_MASK", "as_u32_numpy", "narrow", "resolve_device",
           "u32_tensor", "widen"]
