#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code:

1. build: compile the port's CUDA sources (tse1m_tpu_torch/cluster/kernels/
   csrc/) at first use and time it;
2. kernel checks: hold each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance: exact), at the main-path chunk shape
   (250,368 rows x 64 ids, H=128, B=16) and at edge shapes;
3. main path: ``cluster_sessions`` on 1,000,000 planted sessions x 64 ids,
   once with 10-bit quantized ids (sub-byte chunks -> the uint32 kernel)
   and once with 24-bit ids (byte chunks -> the packed kernel).  First a
   20,000-row slice must give the same labels on the card as on the CPU
   through each kernel.  Then each 1M run must move its kernel's launch
   count (and only its), match the plain signatures and band keys over all
   rows, and reach ARI >= 0.98 against the planted truth;
4. timing: each kernel beside its plain version (CUDA events, median of 20
   after warm-up) at the main-path shape, with its bound;
5. the card's name and power limit from nvidia-smi.

The second-to-last lines are the ``kernels`` JSON and the card; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tse1m_tpu_torch import adjusted_rand_index, synth_session_sets
from tse1m_tpu_torch.cluster import pipeline
from tse1m_tpu_torch.cluster.encode import pack_chunk, quantize_ids
from tse1m_tpu_torch.cluster.kernels import _build
from tse1m_tpu_torch.cluster.kernels import minhash as kmod
from tse1m_tpu_torch.cluster.schemes import make_params
from tse1m_tpu_torch.device import u32_tensor, widen

N_SESSIONS = 1_000_000
SET_SIZE = 64
N_HASHES = 128
N_BANDS = 16
CHUNK_ROWS = 250_368          # the main path's chunk: 4 chunks of 1M rows
ARI_MIN = 0.98
# H100 SXM peaks at the 700 W limit.  HBM: 3.35 TB/s (NVIDIA data sheet).
# Integer: the data sheet's 67 TFLOP/s float32 is 132 SMs x 128 FMA lanes x
# 2 flops x a 1.98 GHz clock; a 32-bit integer multiply-add (IMAD) and a
# 32-bit min (IMNMX) each issue at 64 lanes a clock an SM (CUDA C++
# Programming Guide, arithmetic throughput for compute capability 9.0), a
# quarter of the float32 flop rate.  IMAD runs on the FMA pipe and IMNMX on
# the ALU pipe, so the two can overlap: the least time is the larger pipe's
# count over this rate.
HBM_BYTES_PER_S = 3.35e12
INT32_PIPE_OPS_PER_S = 67e12 / 4

KERNELS = {
    "minhash_and_keys": dict(
        wrapper=kmod.minhash_and_keys, plain=kmod.minhash_and_keys_plain,
        replaces="tse1m_tpu/cluster/minhash_pallas.py:27"),
    "minhash_and_keys_packed": dict(
        wrapper=kmod.minhash_and_keys_packed,
        plain=kmod.minhash_and_keys_packed_plain,
        replaces="tse1m_tpu/cluster/minhash_pallas.py:236"),
}
SOURCE = "tse1m_tpu_torch/cluster/kernels/csrc/minhash.cu"


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(got: tuple, want: tuple) -> int:
    """Largest |kernel - plain| over signatures and keys, as uint32."""
    return max(int((widen(g) - widen(w)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def check_kernel(name: str, args: tuple, label: str) -> int:
    """Kernel vs plain on the card, bit for bit; returns the max abs err."""
    k = KERNELS[name]
    got = k["wrapper"](*args)
    want = k["plain"](*args)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"{name} [{label}] differs from its plain "
                             f"version: max abs err {err}")
    log(f"  {name} [{label}]: bit-identical")
    return err


def u32_ids(rng, shape, high: int = 1 << 32) -> np.ndarray:
    return rng.integers(0, high, size=shape, dtype=np.uint64).astype(np.uint32)


def packed_args(rng, n: int, s: int, k: int, offset: int, consts, dev):
    vals = u32_ids(rng, (n, s), 1 << (8 * k))
    payload = np.ascontiguousarray(
        vals.astype("<u4")[..., None].view(np.uint8)[..., :k]).reshape(-1)
    return (torch.from_numpy(payload).to(dev), (n, s), k, offset, *consts)


def kernel_checks(dev, consts) -> dict:
    """Phase 2: main-path shapes, then the edges.  Returns {name: err}."""
    rng = np.random.default_rng(0)
    errs = {}
    a, b = consts
    main_ids = u32_tensor(u32_ids(rng, (CHUNK_ROWS, SET_SIZE)), dev)
    errs["minhash_and_keys"] = check_kernel(
        "minhash_and_keys", (main_ids, a, b, N_BANDS),
        f"{CHUNK_ROWS}x{SET_SIZE}, full uint32 range")
    errs["minhash_and_keys_packed"] = check_kernel(
        "minhash_and_keys_packed",
        (*packed_args(rng, CHUNK_ROWS, SET_SIZE, 3, 123_456, consts, dev),
         N_BANDS), f"{CHUNK_ROWS}x{SET_SIZE}, k=3, offset 123456")
    a32, b32 = (t[:32].contiguous() for t in consts)
    for n, s in ((1000, SET_SIZE), (1, SET_SIZE), (33, 13)):
        high = u32_tensor(u32_ids(rng, (n, s)) | np.uint32(1 << 31), dev)
        check_kernel("minhash_and_keys", (high, a, b, N_BANDS),
                     f"N={n}, S={s}, ids >= 2^31")
        check_kernel("minhash_and_keys", (high, a32, b32, 8),
                     f"N={n}, S={s}, H=32, B=8, ids >= 2^31")
    # S=300 needs 54 KB of shared memory a block: the opt-in launch path.
    wide = u32_tensor(u32_ids(rng, (100, 300)), dev)
    check_kernel("minhash_and_keys", (wide, a, b, N_BANDS), "N=100, S=300")
    for k, n, s, off in ((1, 777, SET_SIZE, 0), (2, 777, SET_SIZE, 65_000),
                         (3, 1, SET_SIZE, 7), (4, 1000, SET_SIZE, 0),
                         (3, 1000, SET_SIZE, 0xFFFFFF00), (3, 33, 13, 5)):
        check_kernel("minhash_and_keys_packed",
                     (*packed_args(rng, n, s, k, off, consts, dev), N_BANDS),
                     f"N={n}, S={s}, k={k}, offset {off}")
    return errs


def params_for(quant_bits: int) -> pipeline.ClusterParams:
    return pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                  encoding="pack24", entropy="off",
                                  prefilter="off", wire_quant_bits=quant_bits)


def small_input_check(items, dev) -> None:
    """Phase 3, first: labels of a 20,000-row slice on the card equal the
    CPU's (plain versions), through each kernel.  Also warms the card up."""
    small = items[:20_000]
    for quant_bits in (10, -1):
        params = params_for(quant_bits)
        on_card = pipeline.cluster_sessions(small, params, device=dev)
        on_cpu = pipeline.cluster_sessions(small, params, device="cpu")
        if not np.array_equal(on_card, on_cpu):
            raise AssertionError(f"card and CPU labels differ on 20k rows "
                                 f"(wire_quant_bits={quant_bits})")
        log(f"  20,000 rows, wire_quant_bits={quant_bits}: card labels == "
            "CPU labels")


def run_main_path(items, truth, quant_bits: int, kernel: str, consts,
                  dev) -> dict:
    """Phase 3, one run: drive cluster_sessions, read the launch counts,
    hold the signatures against the plain version and the labels against
    the planted truth."""
    params = params_for(quant_bits)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kmod.reset_launch_counts()
    t0 = time.perf_counter()
    labels, sig, keys = pipeline.cluster_sessions(
        items, params, device=dev, return_signatures=True)
    wall = time.perf_counter() - t0
    counts = kmod.launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    info = dict(pipeline.last_run_info)
    log(f"  wire_quant_bits={quant_bits}: wall {wall:.3f} s, launches "
        f"{counts}, chunk bits {info['chunk_bits']}, wire "
        f"{info['wire_mb']} MiB, peak device memory {peak_gib:.2f} GiB")
    log(f"  stages {json.dumps(info['stages'])}")
    others = [v for name, v in counts.items() if name != kernel]
    if counts[kernel] < 1 or any(others):
        raise AssertionError(f"expected launches of {kernel} only: {counts}")
    qbits = info["wire_quant_bits"]
    planned = quantize_ids(items, qbits) if qbits else items
    want = kmod.minhash_and_keys_plain(u32_tensor(planned, dev), *consts,
                                       N_BANDS)
    torch.cuda.synchronize()
    if not (torch.equal(sig, want[0]) and torch.equal(keys, want[1])):
        raise AssertionError("full-N signatures/keys differ from the plain "
                             "version")
    del want
    ari = adjusted_rand_index(labels, truth)
    log(f"  signatures and keys of all {len(labels)} rows bit-identical to "
        f"the plain version; ARI vs planted {ari:.6f}")
    if not (labels.shape == (len(items),) and ari >= ARI_MIN):
        raise AssertionError(f"ARI {ari} below {ARI_MIN}")
    return {"launches": counts[kernel], "wall_s": wall, "ari": ari,
            "stages": info["stages"]}


def time_ms(fn, warmup: int = 3, reps: int = 20) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n: int, s: int, in_bytes_per_id: int) -> tuple[float, str]:
    """Least time for the work: ids read once, signatures and keys written
    once; per (row, id, hash) one IMAD and one IMNMX, per signature value in
    the band fold one multiply (FMA pipe) and one XOR (ALU pipe), the two
    pipes running side by side at INT32_PIPE_OPS_PER_S each."""
    nbytes = (n * s * in_bytes_per_id + 2 * N_HASHES * 4
              + n * (N_HASHES + N_BANDS) * 4)
    ops_per_pipe = n * s * N_HASHES + n * N_HASHES
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_per_pipe / INT32_PIPE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def timing(items, dev, consts) -> dict:
    """Phase 4 at the main path's first-chunk inputs."""
    chunk = items[:CHUNK_ROWS]
    ids = u32_tensor(quantize_ids(chunk, 10), dev)
    wire = pack_chunk(chunk)
    if wire.bits != 24:
        raise AssertionError(f"first chunk ships {wire.bits}-bit ids, not 24")
    payload = torch.from_numpy(wire.payload).to(dev)
    args = {
        "minhash_and_keys": (ids, *consts, N_BANDS),
        "minhash_and_keys_packed": (payload, wire.shape, 3, wire.offset,
                                    *consts, N_BANDS),
    }
    out = {}
    for name, k in KERNELS.items():
        ms = time_ms(lambda: k["wrapper"](*args[name]))
        plain_ms = time_ms(lambda: k["plain"](*args[name]), warmup=1,
                           reps=10)
        b_ms, by = bound(CHUNK_ROWS, SET_SIZE,
                         4 if name == "minhash_and_keys" else 3)
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by}
        log(f"  {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms by {by})")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    log("phase 1: build")
    _build.load_extension()
    log(f"  built {', '.join(_build.SOURCES)} in {_build.build_seconds:.1f} s")

    consts = make_params("kminhash", N_HASHES, 0).to(dev).arrays
    log("phase 2: kernel checks (tolerance: exact)")
    errs = kernel_checks(dev, consts)

    log(f"phase 3: main path, {N_SESSIONS} sessions x {SET_SIZE} ids")
    items, truth = synth_session_sets(N_SESSIONS, SET_SIZE, seed=0)
    small_input_check(items, dev)
    runs = {
        "minhash_and_keys": run_main_path(items, truth, 0,
                                          "minhash_and_keys", consts, dev),
        "minhash_and_keys_packed": run_main_path(
            items, truth, -1, "minhash_and_keys_packed", consts, dev),
    }

    log("phase 4: timing (CUDA events, median)")
    times = timing(items, dev, consts)

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE,
        "replaces": KERNELS[name]["replaces"],
        "launches": runs[name]["launches"], "max_abs_err": errs[name],
        **times[name], "library_ms": None,
    } for name in KERNELS]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
