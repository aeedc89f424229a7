"""The H100's peaks and the least time each stage's work needs.

Peaks: NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35 TB/s
of HBM3, and 67 TFLOP/s of float32 outside the tensor cores, which is
16.75e12 32-bit integer operations a second on each of the two integer
pipes (the FMA pipe and the ALU pipe) that issue side by side.

The count functions are copies of the kernel bounds the port's smoke run
times its kernels against (``minhash_bound``, ``cminhash_bound``,
``topk_bound``).  They take the cell's shapes, never the kernel that ran,
so a later kernel is read against the same work.  Each returns (least
milliseconds, "bytes" or "operations", whichever bounds it).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_PIPE_OPS_PER_S = 67e12 / 4
# Top-k state slots a query (the kernel's state tile), read and written
# once a pass.
TOPK_STATE_SLOTS = 128


def _larger(t_bytes_ms: float, t_ops_ms: float) -> tuple:
    return ((t_bytes_ms, "bytes") if t_bytes_ms >= t_ops_ms
            else (t_ops_ms, "operations"))


def minhash_bound(n: int, s: int, h: int, b: int,
                  in_bytes_per_id: int = 4) -> tuple:
    """K-permutation signatures and band keys of [n, s] ids: ids read
    once, (a, b) read once, signatures and keys written once; per (row,
    id, hash) one multiply-add and one minimum, per signature value one
    multiply and one xor of the band fold, on two pipes side by side."""
    nbytes = n * s * in_bytes_per_id + 2 * h * 4 + n * (h + b) * 4
    ops_per_pipe = n * s * h + n * h
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   ops_per_pipe / INT32_PIPE_OPS_PER_S * 1e3)


def cminhash_bound(n: int, s: int, h: int) -> tuple:
    """The one-permutation bin minima of [n, s] ids: ids read once, a0 and
    b0 once, the [n, h] bins and [n] row minima written once; per id one
    multiply-add and one minimum."""
    nbytes = n * s * 4 + 2 * 4 + n * (h + 1) * 4
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   n * s / INT32_PIPE_OPS_PER_S * 1e3)


def topk_bound(q: int, n: int, h: int) -> tuple:
    """One scan of q queries over n stored rows of h hashes: queries,
    stored rows and their row ids read once, the (count, row) state read
    and written once; per (query, row, hash) one compare and one add, on
    two pipes side by side."""
    nbytes = (q * h * 4 + n * h * 4 + n * 4
              + 2 * 2 * q * TOPK_STATE_SLOTS * 4)
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   q * n * h / INT32_PIPE_OPS_PER_S * 1e3)
