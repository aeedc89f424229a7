"""tse1m_tpu_torch: the PyTorch/CUDA port of tse1m_tpu, for one NVIDIA H100.

This package runs the cold, storeless, single-GPU session clustering of
``tse1m_tpu.cluster.cluster_sessions``, the wire v3 levers (host prefilter,
base-delta lane, rANS lanes) included, with its two MinHash kernels and its
rANS decode written by hand in CUDA C++ for Hopper
(``cluster/kernels/csrc/``).  It imports ``torch`` and ``numpy`` and nothing
of the JAX package.

Entry points run on the card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions; without a card they raise.
Ids, hash constants, signatures and band keys are int32 tensors carrying
uint32 bits (``tse1m_tpu_torch.device``).

    python -m tse1m_tpu_torch cluster --n 1000000
"""

from .cluster import ClusterParams, adjusted_rand_index, cluster_sessions
from .data import synth_session_sets
from .device import as_u32_numpy, narrow, resolve_device, u32_tensor, widen

__all__ = ["ClusterParams", "adjusted_rand_index", "as_u32_numpy",
           "cluster_sessions", "narrow", "resolve_device",
           "synth_session_sets", "u32_tensor", "widen"]
