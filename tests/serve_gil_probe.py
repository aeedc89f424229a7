"""Ingest walls of a serving daemon on the CPU while request threads spin.

    JAX_PLATFORMS=cpu python tests/serve_gil_probe.py --package torch
    JAX_PLATFORMS=cpu python tests/serve_gil_probe.py --package jax
    JAX_PLATFORMS=cpu python tests/serve_gil_probe.py --package torch \\
        --per-id-loop

Opens a daemon of either package over a fresh store in a temporary
directory (n_hashes=32, n_bands=4, the kernels' plain versions), starts
``--spinners`` threads that loop as ``tests/test_serve.py::
test_concurrent_ingest_query_consistency``'s queriers do (no pause: a
tight loop until the first ack, then one-row queries of acked rows), and
ingests ``--batches`` batches of ``--rows`` rows of
``synth_session_sets(800, set_size=--set-size, seed=5)``.  Prints one
JSON line a batch: its wall on the host clock and the torch calls the
port's batch made (counted without spinners, before the run).

``--per-id-loop`` swaps the port's plain MinHash for one that steps over
the set's ids one column a call (a few torch calls an id), to show what
the number of torch calls costs: each one drops and retakes the GIL, and
the spinning threads keep it for a switch interval or more.  A batch
whose wall passes ``--batch-timeout`` ends the run.
"""

import argparse
import json
import tempfile
import threading
import time

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from tse1m_tpu.data.synth import synth_session_sets


class _TorchCalls(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def _per_id_minhash():
    """Replace the port's plain MinHash by a loop over the set's ids."""
    from tse1m_tpu_torch.cluster import minhash
    from tse1m_tpu_torch.cluster.kernels import minhash as kminhash
    from tse1m_tpu_torch.device import U32_MASK, narrow, widen

    def per_id(items, a, b):
        x, a64, b64 = widen(items), widen(a)[None, :], widen(b)[None, :]
        acc = torch.full((x.shape[0], a64.shape[1]), int(minhash.UMAX),
                         dtype=torch.int64, device=x.device)
        for i in range(x.shape[1]):
            h = (minhash.mul_u32(x[:, i:i + 1], a64) + b64) & U32_MASK
            acc = torch.minimum(acc, h)
        return narrow(acc)

    minhash.minhash_signatures = per_id
    kminhash.minhash_signatures = per_id


def _daemon(package: str, path: str):
    if package == "jax":
        from tse1m_tpu.cluster import ClusterParams
        from tse1m_tpu.serve import ServeDaemon
        return ServeDaemon(path, params=ClusterParams(
            n_hashes=32, n_bands=4, use_pallas="never"))
    from tse1m_tpu_torch.cluster.pipeline import ClusterParams
    from tse1m_tpu_torch.serve import ServeDaemon
    return ServeDaemon(path, params=ClusterParams(n_hashes=32, n_bands=4),
                       device="cpu")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--package", choices=("torch", "jax"), default="torch")
    ap.add_argument("--spinners", type=int, default=2)
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--rows", type=int, default=80)
    ap.add_argument("--set-size", type=int, default=64)
    ap.add_argument("--per-id-loop", action="store_true")
    ap.add_argument("--batch-timeout", type=float, default=300.0)
    args = ap.parse_args()
    if args.per_id_loop:
        _per_id_minhash()
    items = synth_session_sets(800, set_size=args.set_size, seed=5)[0]
    calls = None
    if args.package == "torch":
        with tempfile.TemporaryDirectory() as d:
            probe = _daemon("torch", d)
            probe._ingest_batch(items[:args.rows])
            with _TorchCalls() as mode:
                probe._ingest_batch(items[args.rows:2 * args.rows])
            calls = mode.n
    with tempfile.TemporaryDirectory() as d:
        dm = _daemon(args.package, d).start()
        acked, done = [0], threading.Event()

        def spin():
            rng = np.random.default_rng(17)
            while not done.is_set():
                hi = acked[0]
                if hi == 0:
                    continue
                i = int(rng.integers(0, hi))
                dm.query(items[i:i + 1])

        threads = [threading.Thread(target=spin, daemon=True)
                   for _ in range(args.spinners)]
        for th in threads:
            th.start()
        try:
            for b in range(args.batches):
                lo = b * args.rows
                t0 = time.perf_counter()
                try:
                    dm.ingest(items[lo:lo + args.rows],
                              timeout=args.batch_timeout)
                except TimeoutError:
                    print(json.dumps({"batch": b, "wall_s": None,
                                      "timed_out_after_s":
                                      args.batch_timeout}), flush=True)
                    break
                acked[0] = lo + args.rows
                print(json.dumps({
                    "package": args.package, "batch": b,
                    "rows": args.rows, "set_size": args.set_size,
                    "spinners": args.spinners,
                    "per_id_loop": args.per_id_loop,
                    "wall_s": time.perf_counter() - t0,
                    "torch_calls_a_batch": calls}), flush=True)
        finally:
            done.set()
            for th in threads:
                th.join(timeout=600)
            dm.stop(commit=False)


if __name__ == "__main__":
    main()
