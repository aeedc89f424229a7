"""tse1m_tpu_torch: the PyTorch/CUDA port of tse1m_tpu, for one NVIDIA H100.

This package runs the cold, storeless, single-GPU session clustering of
``tse1m_tpu.cluster.cluster_sessions`` under its three signature schemes
(kminhash, cminhash, weighted), the wire v3 levers (host prefilter,
base-delta lane, rANS lanes) included, and the single-shot exact top-k
agreement scoring ``topk_agreement``.  Every TPU kernel of those paths (the
two MinHash kernels, the one-permutation bin-min, the rANS decode and the
top-k scorer) is written by hand in CUDA C++ for Hopper
(``cluster/kernels/csrc/``).

It also runs the paper's RQ analysis: a sqlite study (``db/``, written by
``data/synth.py``) is extracted into per-project CSR arrays
(``data/columnar.py``) and answered by ``TorchBackend`` (``backend/``,
torch ops in ``ops/segment.py``), all six research questions in one pass
on the card with ``rq_suite``; the six drivers under ``analysis/`` write
every RQ's artifacts, as the JAX package's drivers do.
It imports ``torch`` and ``numpy`` and the standard library, and nothing of
the JAX package, pandas or matplotlib.

Entry points run on the card unless the caller passes ``device="cpu"``,
which runs the kernels' plain PyTorch versions; without a card they raise.
Ids, hash constants, signatures and band keys are int32 tensors carrying
uint32 bits (``tse1m_tpu_torch.device``).

    python -m tse1m_tpu_torch cluster --n 1000000
    python -m tse1m_tpu_torch synth --db study.sqlite
    python -m tse1m_tpu_torch all --db study.sqlite --result-dir out
"""

from .backend import TorchBackend
from .cluster import ClusterParams, adjusted_rand_index, cluster_sessions
from .cluster.kernels.score import topk_agreement
from .cluster.schemes import expand_weighted
from .data import synth_session_hitcounts, synth_session_sets
from .device import as_u32_numpy, narrow, resolve_device, u32_tensor, widen

__all__ = ["ClusterParams", "TorchBackend", "adjusted_rand_index",
           "as_u32_numpy", "cluster_sessions", "expand_weighted", "narrow",
           "resolve_device", "synth_session_hitcounts", "synth_session_sets",
           "topk_agreement", "u32_tensor", "widen"]
