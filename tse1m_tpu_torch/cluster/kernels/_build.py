"""Build the package's CUDA sources at first use.

``load_extension()`` compiles ``csrc/minhash.cu``, ``csrc/cminhash.cu``,
``csrc/rans.cu`` and ``csrc/score.cu`` (nvcc, ``sm_90a``) and
``csrc/binding.cpp`` (the host compiler; the one file that
includes PyTorch's headers) with one ``torch.utils.cpp_extension.load`` into
``build/tse1m_tpu_torch/`` beside the package, and imports the result.
The ``.cu`` files share ``csrc/sm90_async.cuh``.  ``load`` versions its
cache by the listed sources only, so a second process with unchanged
sources loads the library without compiling; an edit of the header alone
is seen through ninja's dependency file, which rebuilds the objects that
include it.  It builds nothing but these sources and is never called when
a module is imported.
"""

from __future__ import annotations

import os
import threading
import time

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = tuple(os.path.join(_CSRC, f)
                for f in ("minhash.cu", "cminhash.cu", "rans.cu", "score.cu",
                          "binding.cpp"))
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))), "build", "tse1m_tpu_torch")
CUDA_FLAGS = ["-O3", "-gencode=arch=compute_90a,code=sm_90a"]
# Dynamic shared memory one block may opt into on sm_90 (227 KB).
MAX_SMEM = 232448

_lock = threading.Lock()
_ext = None
build_seconds: float | None = None


def load_extension():
    """The compiled extension module (built on the first call)."""
    global _ext, build_seconds
    with _lock:
        if _ext is None:
            from torch.utils.cpp_extension import load

            os.makedirs(BUILD_DIR, exist_ok=True)
            t0 = time.perf_counter()
            _ext = load(name="tse1m_kernels_ext", sources=list(SOURCES),
                        build_directory=BUILD_DIR,
                        extra_cuda_cflags=CUDA_FLAGS)
            build_seconds = time.perf_counter() - t0
        return _ext
