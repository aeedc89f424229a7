#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--calls-per-window N]

Phases, in order; any failure ends the run with a non-zero exit code:

1. build: compile the port's CUDA sources (tse1m_tpu_torch/cluster/kernels/
   csrc/) at first use and time it;
2. kernel checks: hold each kernel against its plain PyTorch version on the
   card, bit for bit (tolerance: exact).  The MinHash and bin-min kernels
   at the main-path chunk shape (250,368 rows x 64 ids, H=128, B=16) and at
   edge shapes; the rANS kernel at the lanes the default 1M run codes (its
   rep and counts lanes, encoded here by the port's host codec), each alone
   and both in one launch, at the edge shapes of the CPU tests, and with
   lanes of different lengths and plane counts in one launch, their words
   at odd offsets inside one staged buffer; the top-k kernel at cell (g)'s
   shape (64 queries over 1,000,448 columns, k=10), at the CPU tests'
   edges, and at 72 and 128 queries, H = 16 and 128 and column counts that
   are not a multiple of its 256-column tile (nor of 4); an H whose count
   block does not fit in shared memory must be refused at launch;
3. main path, on 1,000,000 planted sessions x 64 ids.  First, 20,000-row
   slices must give the same labels on the card as on the CPU: through
   each MinHash kernel on the plain wire, through every lane of wire v3
   (``encoding="delta", prefilter="on", entropy="force"``) under kminhash
   and cminhash, and through weighted rows on the plain wire.  Then the
   cells, each driven with the launch counts set to 0 just before and read
   just after:
   (a) the plain wire at 10 bits (sub-byte chunks -> the uint32 kernel) and
   (b) at 24 bits (byte chunks -> the packed kernel): each run must move
       its kernel's launch count (and only its), match the plain signatures
       and band keys over all rows, and reach ARI >= 0.98;
   (d) a forced wire v3 run on 100,000 sessions (every chunk and lane coded,
       the 24-bit full lane as three byte planes plus its offset): labels
       equal to the plain wire's, one rANS launch a coded chunk and one for
       all the metadata lanes;
   (c) the default ``ClusterParams`` at 1M rows, the path users get: the
       prefilter, the delta lane and the rANS lanes engage; launches of the
       rANS kernel (one, for the rep and counts lanes together) and the
       uint32 MinHash kernel only;
       signatures of every kept row equal to the plain version's; labels
       equal to the 10-bit plain run's element for element; ARI >= 0.98;
   (e) (c) with ``scheme="cminhash"``: the bin-min kernel on the full lane
       and on the delta rows, no MinHash kernel; signatures of every kept
       row equal to the plain version's; ARI >= 0.98;
   (f) ``scheme="weighted"`` over 200,000 sessions of their own, replica-
       expanded by their synthesized hit counts: the bin-min kernel only
       among the hashing kernels, signatures equal to the plain version's,
       ARI printed;
   (g) ``topk_agreement`` of 64 queries drawn from (a)'s 1M signatures,
       k=10: one launch of the top-k kernel, its state equal to the plain
       version's, each query's first hit at 128 agreements;
4. timing: each kernel beside its plain version (CUDA events around
   ``--calls-per-window`` back-to-back calls, 5 by default, median of 20
   windows after warm-up; 1 times each call alone, as earlier versions of
   this script did, wrapper's host work included; the plain
   versions one call a window) at the main-path shapes, with its bound,
   and the bin-min kernel beside ``scatter_reduce_`` (its library
   yardstick); the rANS kernel at the rep lane alone and at (c)'s one
   launch, with the SM clock read by nvidia-smi meanwhile and the cycles
   a step it gives; the top-k kernel whole and each of its passes alone;
5. the card's name and power limit from nvidia-smi.

The second-to-last lines are the ``kernels`` JSON and the card; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA device it exits 1 and
prints no result.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from tse1m_tpu_torch import (adjusted_rand_index, expand_weighted,
                             synth_session_hitcounts, synth_session_sets,
                             topk_agreement)
from tse1m_tpu_torch.cluster import entropy, kernels, pipeline
from tse1m_tpu_torch.cluster.encode import (pack_chunk, pack_delta_meta,
                                            quantize_ids)
from tse1m_tpu_torch.cluster.kernels import _build
from tse1m_tpu_torch.cluster.kernels import cminhash as kcm
from tse1m_tpu_torch.cluster.kernels import minhash as kmod
from tse1m_tpu_torch.cluster.kernels import rans as krans
from tse1m_tpu_torch.cluster.kernels import score as ksc
from tse1m_tpu_torch.cluster.minhash import mul_u32
from tse1m_tpu_torch.cluster.schemes import make_params
from tse1m_tpu_torch.device import U32_MASK, as_u32_numpy, u32_tensor, widen

N_SESSIONS = 1_000_000
N_FORCED = 100_000
N_SMALL = 20_000
N_WEIGHTED = 200_000          # cell (f): the host prefilter over ~43M ids
N_QUERIES = 64                # cell (g): the JAX bench's topk shape
TOPK_K = 10
SET_SIZE = 64
N_HASHES = 128
N_BANDS = 16
CHUNK_ROWS = 250_368          # the plain path's chunk: 4 chunks of 1M rows
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
# rANS decode: per symbol and plane, at least the slot mask, the state
# shift, the cumulative-frequency subtract and the renormalization compare
# issue on the ALU pipe (the multiply-add goes to the FMA pipe).
RANS_ALU_OPS_PER_SYMBOL = 4
# Back-to-back kernel calls a timing window (phase 4), by default.
KERNEL_INNER = 5

MINHASH_SOURCE = "tse1m_tpu_torch/cluster/kernels/csrc/minhash.cu"
KERNELS = {
    "minhash_and_keys": dict(
        wrapper=kmod.minhash_and_keys, plain=kmod.minhash_and_keys_plain,
        source=MINHASH_SOURCE,
        replaces="tse1m_tpu/cluster/minhash_pallas.py:27"),
    "cminhash_binmin": dict(
        wrapper=kcm.cminhash_binmin, plain=kcm.cminhash_binmin_plain,
        source="tse1m_tpu_torch/cluster/kernels/csrc/cminhash.cu",
        replaces="tse1m_tpu/cluster/minhash_pallas.py:133"),
    "minhash_and_keys_packed": dict(
        wrapper=kmod.minhash_and_keys_packed,
        plain=kmod.minhash_and_keys_packed_plain, source=MINHASH_SOURCE,
        replaces="tse1m_tpu/cluster/minhash_pallas.py:236"),
    "rans_decode": dict(
        wrapper=krans.rans_decode, plain=krans.rans_decode_plain,
        source="tse1m_tpu_torch/cluster/kernels/csrc/rans.cu",
        replaces="tse1m_tpu/cluster/kernels/rans.py:80"),
    "topk_chunk": dict(
        wrapper=ksc.topk_chunk, plain=ksc.topk_chunk_plain,
        source="tse1m_tpu_torch/cluster/kernels/csrc/score.cu",
        replaces="tse1m_tpu/cluster/kernels/score.py:155"),
}
WIRE_V3_FORCED = dict(encoding="delta", prefilter="on", entropy="force")


def log(msg: str) -> None:
    print(msg, flush=True)


def max_abs_err(got: tuple, want: tuple) -> int:
    """Largest |kernel - plain| over the outputs, as uint32."""
    return max(int((widen(g) - widen(w)).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def check_kernel(name: str, args: tuple, label: str) -> int:
    """Kernel vs plain on the card, bit for bit; returns the max abs err."""
    k = KERNELS[name]
    got = k["wrapper"](*args)
    want = k["plain"](*args)
    if name == "rans_decode":
        got, want = (got,), (want,)
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


def minhash_checks(dev, consts) -> dict:
    """Phase 2, MinHash: main-path shapes, then the edges."""
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


def rans_args(lane: entropy.EntropyLane, dev) -> tuple:
    """(planes, n, shift) of a coded lane, its arrays copied to ``dev``."""
    dtypes = {np.dtype(np.uint16): np.int16, np.dtype(np.uint32): np.int32}
    arrays = [torch.from_numpy(a.view(dtypes[a.dtype])).to(dev)
              for a in lane.wire_arrays()]
    planes = [arrays[3 * p:3 * p + 3] for p in range(len(lane.planes))]
    return planes, lane.n, 8 if lane.bits > entropy._DIRECT_BITS_MAX else 0


def default_run_lanes(items) -> dict:
    """The host half of the default 1M run, as cluster_sessions plans it:
    the prefilter's keep mask, the wire plan over the kept rows and the
    coded lanes.  Returns the keep mask, the coded lanes by name and the
    number of rANS launches the run must make (one for the coded metadata
    lanes together, one a coded chunk)."""
    params = pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS)
    keep = pipeline._prefilter_mask(items, params)
    _, enc, _ = pipeline._plan_wire(items[keep], params,
                                    pipeline._quant_bits(items, params))
    meta = pack_delta_meta(enc, entropy=params.entropy)
    chunks = pipeline._row_chunks(
        enc.full_rows, pipeline._stream_plan(enc.full_rows, params))
    coded = {name: lane.ent for name, lane in
             zip(("rep", "counts", "pos", "val"), (*meta.lanes(), meta.val))
             if lane.ent is not None}
    n_coded_chunks = sum(pack_chunk(c, entropy=params.entropy).ent
                         is not None for c in chunks)
    # One launch decodes every coded metadata lane; each coded chunk of the
    # full lane has its own.
    launches = int(bool(coded)) + n_coded_chunks
    log(f"  default run plan: {int(keep.sum())} rows kept, {enc.n_full} "
        f"full + {enc.n_delta} delta, coded lanes "
        + ", ".join(f"{k} ({v.n} x {v.bits} bits, {len(v.planes)} planes)"
                    for k, v in coded.items())
        + f", {n_coded_chunks} of {len(chunks)} full-lane chunks coded")
    if set(coded) != {"rep", "counts"} or n_coded_chunks:
        raise AssertionError("the default run codes other lanes than rep and "
                             f"counts: {sorted(coded)}, {n_coded_chunks}")
    return {"keep": keep, "lanes": coded, "launches": launches}


def skewed(rng, n: int, bits: int) -> np.ndarray:
    v = rng.geometric(0.2, size=n).astype(np.uint64) * 2654435761
    return (v % (1 << bits)).astype(np.uint32) if bits < 32 else \
        v.astype(np.uint32)


def check_lanes(lanes: list, label: str) -> int:
    """The batched rANS launch vs the plain version, lane by lane, bit for
    bit; one launch for up to 8 lanes.  Returns the max abs err."""
    kernels.reset_launch_counts()
    got = krans.rans_decode_lanes(lanes)
    launches = kernels.launch_counts()["rans_decode"]
    want = krans.rans_decode_lanes_plain(lanes)
    torch.cuda.synchronize()
    coded = sum(n > 0 for _, n, _ in lanes)
    if launches != -(-coded // 8):
        raise AssertionError(f"{coded} lanes took {launches} launches")
    err = max(max_abs_err((g,), (w,)) for g, w in zip(got, want))
    if err or not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"rans_decode_lanes [{label}] differs from its "
                             f"plain version: max abs err {err}")
    log(f"  rans_decode_lanes [{label}]: {len(lanes)} lanes in {launches} "
        "launch(es), each bit-identical")
    return err


def staged(lanes: list, dev, gaps=(1, 3, 5, 2, 7)) -> list:
    """The lanes' word arrays placed in one int16 buffer, each after a gap
    of a few words, so they start at 2-byte offsets that are not 16-byte
    aligned (x0 and freqs stay where they are)."""
    words = [w for planes, _, _ in lanes for w, _, _ in planes]
    offsets, at = [], 0
    for i, w in enumerate(words):
        at += gaps[i % len(gaps)]
        offsets.append(at)
        at += w.numel()
    buf = torch.zeros(at, dtype=torch.int16, device=dev)
    views = []
    for w, off in zip(words, offsets):
        buf[off:off + w.numel()] = w
        views.append(buf[off:off + w.numel()])
    views = iter(views)
    return [([(next(views), x0, f) for _, x0, f in planes], n, shift)
            for planes, n, shift in lanes]


def rans_checks(plan: dict, dev) -> int:
    """Phase 2, rANS: the default run's coded lanes, each alone and both in
    one launch; the CPU tests' edge shapes (direct planes up to 4,096
    symbols, byte planes, step boundaries, a one-symbol alphabet, an empty
    lane); then lanes of different lengths and plane counts in one launch,
    their words at odd offsets inside one staged buffer."""
    err = 0
    main = {name: rans_args(lane, dev) for name, lane in plan["lanes"].items()}
    for name, args in main.items():
        err = max(err, check_kernel("rans_decode", args,
                                    f"1M default run's {name} lane, "
                                    f"{args[1]} symbols"))
    err = max(err, check_lanes(list(main.values()),
                               "1M default run's " + " + ".join(main)
                               + " lanes in one launch"))
    rng = np.random.default_rng(1)
    edges = [(1, 4097), (5, 4097), (12, 4097), (13, 1000), (18, 1000),
             (24, 1000), (32, 1000), (5, 1), (5, 31), (5, 32), (5, 33),
             (18, 33)]
    edge_args = []
    for bits, n in edges:
        lane = entropy.encode_lane(skewed(rng, n, bits), bits, force=True)
        edge_args.append(rans_args(lane, dev))
        err = max(err, check_kernel("rans_decode", edge_args[-1],
                                    f"{bits}-bit lane, n={n}"))
    lane = entropy.encode_lane(np.full(100, 3, np.uint32), 5, force=True)
    edge_args.append(rans_args(lane, dev))
    err = max(err, check_kernel("rans_decode", edge_args[-1],
                                "one-symbol alphabet"))
    lane = entropy.encode_lane(np.zeros(0, np.uint32), 18, force=True)
    kernels.reset_launch_counts()
    if krans.rans_decode(*rans_args(lane, dev)).numel() or \
            kernels.launch_counts()["rans_decode"]:
        raise AssertionError("an empty lane launched the rANS kernel")
    edge_args.append(rans_args(lane, dev))
    odd = sum(int(w.numel() % 8 != 0) for planes, _, _ in edge_args
              for w, _, _ in planes)
    mixed = [edge_args[i] for i in (2, 4, 7, 10, 12, 13)] + [main["counts"]]
    err = max(err, check_lanes(
        staged(mixed, dev), "1 to 3 planes, n = 0 to 4,097 and the counts "
        "lane in one launch, words at odd offsets in one staged buffer"))
    err = max(err, check_lanes(
        staged(edge_args, dev, gaps=(3,)),
        f"all {len(edge_args)} edge lanes, words 6 bytes into their slots, "
        f"{odd} word arrays not a multiple of 16 bytes"))
    return err


def umax_id(a0: torch.Tensor, b0: torch.Tensor) -> int:
    """The id the one permutation maps to UMAX: (UMAX - b0) * a0^-1."""
    a, b = int(widen(a0)[0]), int(widen(b0)[0])
    return ((U32_MASK - b) * pow(a, -1, 1 << 32)) % (1 << 32)


def cminhash_checks(dev) -> int:
    """Phase 2, bin-min: cell (e)'s chunk shape over the full uint32 range
    (a row holding the id that permutes to UMAX, a row of nothing else),
    then H not a power of two, weighted replica widths, one row, one id a
    row."""
    rng = np.random.default_rng(2)
    err = 0
    for n, s, h, scheme in ((CHUNK_ROWS, SET_SIZE, N_HASHES, "cminhash"),
                            (1001, 13, 96, "cminhash"),
                            (5000, 216, N_HASHES, "weighted"),
                            (1, SET_SIZE, N_HASHES, "weighted"),
                            (33, 1, 96, "cminhash")):
        a0, b0 = make_params(scheme, h, 0).to(dev).arrays[:2]
        x = u32_ids(rng, (n, s))
        if n > 2:
            x[0, 0] = x[1, :] = umax_id(a0, b0)
            x[2] |= np.uint32(1 << 31)
        err = max(err, check_kernel(
            "cminhash_binmin", (u32_tensor(x, dev), a0, b0, h),
            f"{scheme} N={n}, S={s}, H={h}, ids >= 2^31 and the UMAX id"))
    return err


def topk_args(store: np.ndarray, queries: np.ndarray, dev, base: int = 0,
              state=None) -> tuple:
    """(q, s_t, rowids, topc, topr) as topk_agreement stages them."""
    n = store.shape[0]
    s_t, rid = ksc._stage_chunk(store, base, -(-n // 512) * 512, dev)
    q = u32_tensor(ksc._pad_queries(queries), dev)
    return (q, s_t, rid, *(state or ksc._init_state(q.shape[0], dev)))


def exact_topk_args(store: np.ndarray, queries: np.ndarray, dev,
                    base: int = 0, state=None) -> tuple:
    """(q, s_t, rowids, topc, topr) of a chunk of exactly the store's rows,
    not padded to a multiple of 512 columns."""
    n = store.shape[0]
    q = u32_tensor(ksc._pad_queries(queries), dev)
    s_t = u32_tensor(np.ascontiguousarray(store.T), dev)
    rid = torch.arange(base, base + n, dtype=torch.int32,
                       device=dev).reshape(1, n)
    return (q, s_t, rid, *(state or ksc._init_state(q.shape[0], dev)))


def topk_checks(dev) -> int:
    """Phase 2, top-k: cell (g)'s shape over a 4-value alphabet (counts
    near 32 of 128, so the top k end inside a crowd of ties), then the CPU
    tests' edges and the count pass's query groups, hash counts and ragged
    column counts, each chained into a second chunk as its incoming
    state."""
    rng = np.random.default_rng(3)
    store = u32_ids(rng, (N_SESSIONS, N_HASHES), 4)
    queries = store[rng.choice(N_SESSIONS, N_QUERIES, replace=False)]
    err = check_kernel("topk_chunk",
                       (*topk_args(store, queries, dev), TOPK_K),
                       f"{N_QUERIES} queries x {N_SESSIONS} rows, k=10, "
                       "4-value alphabet")
    del store
    for qn, n, h, k, high in ((5, 1000, 16, 7, 3), (8, 1000, 16, 128, 3),
                              (8, 5, 16, 10, 3), (3, 513, 128, 1, 1 << 32),
                              (7, 0, 16, 5, 3)):
        store = u32_ids(rng, (n, h), high)
        queries = u32_ids(rng, (qn, h), high)
        if n > 10:
            store[7] = store[9] = queries[0]
        args = topk_args(store, queries, dev)
        label = f"Q={qn}, N={n}, H={h}, k={k}"
        err = max(err, check_kernel("topk_chunk", (*args, k), label))
        state = ksc.topk_chunk_plain(*args, k)
        more = u32_ids(rng, (n + 100, h), high)
        err = max(err, check_kernel(
            "topk_chunk", (*topk_args(more, queries, dev, n, state), k),
            label + ", chained into a second chunk"))
    # The redesigned count pass: two 64-query groups (72 and 128 queries),
    # H = 16 and 128, column counts off its 256-column tile and off 4 (the
    # wrapper pads those), a tile count not a multiple of the grid.
    for qn, n, h, k in ((72, 1000, 128, 10), (128, 1000, 128, 10),
                        (5, 1001, 16, 7), (128, 3001, 16, 20),
                        (64, 70_003, 128, 10)):
        store = u32_ids(rng, (n, h), 4)
        queries = u32_ids(rng, (qn, h), 4)
        store[7] = store[9] = queries[qn - 1]
        args = exact_topk_args(store, queries, dev)
        label = f"Q={qn}, N={n} (exact columns), H={h}, k={k}"
        err = max(err, check_kernel("topk_chunk", (*args, k), label))
        state = ksc.topk_chunk_plain(*args, k)
        more = u32_ids(rng, (n + 37, h), 4)
        err = max(err, check_kernel(
            "topk_chunk", (*exact_topk_args(more, queries, dev, n, state), k),
            label + ", chained into a second chunk"))
    # H = 300 needs more shared memory than a count block may have: the
    # launch is refused, and no error is left behind for the next launch.
    try:
        ksc.topk_chunk(*topk_args(u32_ids(rng, (64, 300), 4),
                                  u32_ids(rng, (8, 300), 4), dev), 5)
    except RuntimeError as e:
        log(f"  topk_chunk at H=300 refused: {str(e).splitlines()[0]}")
    else:
        raise AssertionError("topk_chunk launched at H=300")
    err = max(err, check_kernel("topk_chunk", (*args, k),
                                label + ", after the refusal"))
    args = (*topk_args(store, queries, dev), 0)
    kernels.reset_launch_counts()
    got = ksc.topk_chunk(*args)
    if kernels.launch_counts()["topk_chunk"] or not all(
            torch.equal(g, w)
            for g, w in zip(got, ksc.topk_chunk_plain(*args))):
        raise AssertionError("k=0 launched the top-k kernel or differs")
    return err


def params_for(quant_bits: int,
               scheme: str = "kminhash") -> pipeline.ClusterParams:
    return pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                  encoding="pack24", entropy="off",
                                  prefilter="off", wire_quant_bits=quant_bits,
                                  scheme=scheme)


def small_input_check(items, truth, dev) -> None:
    """Phase 3, first: labels of a 20,000-row slice on the card equal the
    CPU's (plain versions), through each MinHash kernel, through every wire
    v3 lane under kminhash and cminhash, and through weighted rows.  Also
    warms the card up."""
    small = items[:N_SMALL]
    weighted = expand_weighted(small, synth_session_hitcounts(
        small, truth[:N_SMALL]))
    cases = [("plain wire, wire_quant_bits=10", small, params_for(10)),
             ("plain wire, wire_quant_bits=-1", small, params_for(-1)),
             ("wire v3 forced", small, pipeline.ClusterParams(
                 n_hashes=N_HASHES, n_bands=N_BANDS, **WIRE_V3_FORCED)),
             ("cminhash, wire v3 forced", small, pipeline.ClusterParams(
                 n_hashes=N_HASHES, n_bands=N_BANDS, scheme="cminhash",
                 **WIRE_V3_FORCED)),
             (f"weighted ({weighted.shape[1]} replica ids a row), plain "
              "wire, wire_quant_bits=10", weighted,
              params_for(10, "weighted"))]
    for label, rows, params in cases:
        on_card = pipeline.cluster_sessions(rows, params, device=dev)
        on_cpu = pipeline.cluster_sessions(rows, params, device="cpu")
        if not np.array_equal(on_card, on_cpu):
            raise AssertionError(f"card and CPU labels differ on "
                                 f"{N_SMALL} rows ({label})")
        log(f"  {N_SMALL} rows, {label}: card labels == CPU labels")


def drive(items, params, dev) -> dict:
    """Drive cluster_sessions once, the launch counts set to 0 just before
    and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    labels, sig, keys = pipeline.cluster_sessions(
        items, params, device=dev, return_signatures=True)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    info = dict(pipeline.last_run_info)
    log(f"  wall {wall:.3f} s, launches {counts}, encoding "
        f"{info['encoding']}, chunk bits {info['chunk_bits']}, wire "
        f"{info['wire_mb']} MiB ({info['wire_bytes']} B), prefilter dropped "
        f"{info['prefilter_rows_dropped']}, wire v3 saved "
        f"{info['wire_v3_saved_mb']} MiB, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"  stages {json.dumps(info['stages'])}")
    return {"labels": labels, "sig": sig, "keys": keys, "counts": counts,
            "wall_s": wall, "info": info}


def check_signatures(run: dict, rows, hp, dev) -> torch.Tensor:
    """The run's signatures and keys equal the plain version's of its
    scheme over the rows that went to the card, as the wire plan quantized
    them.  Returns the signatures."""
    qbits = run["info"]["wire_quant_bits"]
    planned = u32_tensor(quantize_ids(rows, qbits) if qbits else rows, dev)
    plain = (kmod.minhash_and_keys_plain if hp.scheme == "kminhash"
             else kcm.cminhash_and_keys_plain)
    want = plain(planned, *hp.arrays, N_BANDS)
    del planned
    torch.cuda.synchronize()
    # The run's signatures and keys go here, so later runs' peak device
    # memory does not count them.
    sig, keys = run.pop("sig"), run.pop("keys")
    if not (torch.equal(sig, want[0]) and torch.equal(keys, want[1])):
        raise AssertionError("signatures/keys differ from the plain version")
    log(f"  signatures and keys of all {len(rows)} rows that went to the "
        "card bit-identical to the plain version")
    return sig


def check_ari(labels, truth) -> float:
    ari = adjusted_rand_index(labels, truth)
    log(f"  ARI vs planted {ari:.6f}")
    if not (labels.shape == truth.shape and ari >= ARI_MIN):
        raise AssertionError(f"ARI {ari} below {ARI_MIN}")
    return ari


def expect_launches(counts: dict, want: dict) -> None:
    """Each kernel in ``want`` launched as often as given there (an int:
    exactly; a (least, None) pair: at least); the rest never."""
    for name, n in counts.items():
        w = want.get(name, 0)
        if not (n >= w[0] if isinstance(w, tuple) else n == w):
            raise AssertionError(f"launches {counts}, expected {want}")


def run_plain(items, truth, quant_bits: int, kernel: str, hp, dev):
    """Phase 3, one plain-wire 1M run through one MinHash kernel; its
    signatures go to the host (cell (g)'s store)."""
    log(f"  plain wire, wire_quant_bits={quant_bits}:")
    run = drive(items, params_for(quant_bits), dev)
    expect_launches(run["counts"], {kernel: (1, None)})
    run["sig"] = as_u32_numpy(check_signatures(run, items, hp, dev))
    run["ari"] = check_ari(run["labels"], truth)
    return run


def run_forced(dev) -> dict:
    """Phase 3: wire v3 forced on 100,000 planted sessions of their own (a
    slice of the 1M set would cut its planted clusters): every chunk and
    lane coded; labels equal to the plain wire's."""
    small, small_truth = synth_session_sets(N_FORCED, SET_SIZE, seed=0)
    log(f"  wire v3 forced, {N_FORCED} rows:")
    run = drive(small, pipeline.ClusterParams(
        n_hashes=N_HASHES, n_bands=N_BANDS, **WIRE_V3_FORCED), dev)
    info = run["info"]
    # One launch per full-lane chunk and one for the metadata lanes (rep,
    # counts, pos, val), all coded.
    expect_launches(run["counts"], {
        "minhash_and_keys": (2, None),
        "rans_decode": len(info["chunk_bits"]) + 1})
    if not (info["encoding"] == "delta" and info["prefilter_rows_dropped"]):
        raise AssertionError(f"forced run did not take wire v3: {info}")
    plain = pipeline.cluster_sessions(small, params_for(0), device=dev)
    if not np.array_equal(run["labels"], plain):
        raise AssertionError("forced wire v3 labels differ from the plain "
                             "wire's")
    log("  labels == the plain wire's")
    run["ari"] = check_ari(run["labels"], small_truth)
    return run


def run_default(items, truth, plan: dict, plain_labels, hp, dev) -> dict:
    """Phase 3: default ClusterParams at 1M rows, the path users get."""
    log("  default ClusterParams (wire v3 auto):")
    run = drive(items, pipeline.ClusterParams(n_hashes=N_HASHES,
                                              n_bands=N_BANDS), dev)
    info = run["info"]
    if not (info["encoding"] == "delta"
            and info["prefilter_rows_dropped"] > 0):
        raise AssertionError(f"default run did not take wire v3: {info}")
    # The full lane's chunks and the delta rows each go to the uint32
    # kernel; every chunk is decoded, so the packed kernel never runs.
    expect_launches(run["counts"], {"minhash_and_keys": (2, None),
                                    "rans_decode": plan["launches"]})
    check_signatures(run, items[plan["keep"]], hp, dev)
    if not np.array_equal(run["labels"], plain_labels):
        raise AssertionError("default-run labels differ from the 10-bit "
                             "plain wire's")
    log("  labels == the 10-bit plain wire run's, element for element")
    run["ari"] = check_ari(run["labels"], truth)
    return run


def run_cminhash(items, truth, plan: dict, dev) -> dict:
    """Phase 3, cell (e): default ClusterParams with scheme="cminhash" at
    1M rows.  The prefilter and the wire plan do not depend on the scheme,
    so the keep mask and the coded lanes are (c)'s."""
    log("  cminhash, default ClusterParams (wire v3 auto):")
    params = pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                    scheme="cminhash")
    run = drive(items, params, dev)
    info = run["info"]
    if not (info["encoding"] == "delta"
            and info["prefilter_rows_dropped"] > 0):
        raise AssertionError(f"cminhash run did not take wire v3: {info}")
    # One bin-min launch a full-lane chunk and one for the delta rows.
    expect_launches(run["counts"], {
        "cminhash_binmin": len(info["chunk_bits"]) + 1,
        "rans_decode": plan["launches"]})
    check_signatures(run, items[plan["keep"]],
                     make_params("cminhash", N_HASHES, 0).to(dev), dev)
    run["ari"] = check_ari(run["labels"], truth)
    return run


def run_weighted(dev) -> dict:
    """Phase 3, cell (f): scheme="weighted" over 200,000 sessions of their
    own, expanded by their synthesized hit counts (the replica rows the
    JAX command line builds)."""
    small, small_truth = synth_session_sets(N_WEIGHTED, SET_SIZE, seed=0)
    rows = expand_weighted(small, synth_session_hitcounts(small, small_truth))
    log(f"  weighted, default ClusterParams, {N_WEIGHTED} sessions as "
        f"{rows.shape[1]} replica ids a row ({rows.nbytes / 2**20:.1f} MiB):")
    params = pipeline.ClusterParams(n_hashes=N_HASHES, n_bands=N_BANDS,
                                    scheme="weighted")
    run = drive(rows, params, dev)
    info = run["info"]
    expect_launches(run["counts"], {
        "cminhash_binmin": len(info["chunk_bits"])
        + (info["encoding"] == "delta"),
        "rans_decode": (0, None)})
    keep = pipeline._prefilter_mask(rows, params)
    check_signatures(run, rows if keep is None else rows[keep],
                     make_params("weighted", N_HASHES, 0).to(dev), dev)
    run["ari"] = adjusted_rand_index(run["labels"], small_truth)
    log(f"  ARI vs planted {run['ari']:.6f} (printed, not gated)")
    return run


def run_topk(store: np.ndarray, dev) -> dict:
    """Phase 3, cell (g): topk_agreement of 64 queries drawn (seed 1) from
    (a)'s 1M signatures, k=10; then its state held against the plain
    version's on the same staged chunk."""
    rng = np.random.default_rng(1)
    queries = store[rng.choice(store.shape[0], N_QUERIES, replace=False)]
    log(f"  topk_agreement, {N_QUERIES} queries x {store.shape[0]} "
        f"signatures, k={TOPK_K}:")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    counts, rows = topk_agreement(queries, store, TOPK_K, device=dev)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    log(f"  wall {wall:.3f} s, launches {launches}")
    expect_launches(launches, {"topk_chunk": 1})
    if not (counts.shape == (N_QUERIES, TOPK_K)
            and (counts[:, 0] == N_HASHES).all() and (rows >= 0).all()):
        raise AssertionError("a query's first hit is not a full agreement")
    args = (*topk_args(store, queries, dev), TOPK_K)
    got = ksc.topk_chunk(*args)
    want = ksc.topk_chunk_plain(*args)
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError("top-k state differs from the plain version's")
    if not all(np.array_equal(a, b) for a, b in zip(
            (counts, rows), ksc._finalize(*want, N_QUERIES, TOPK_K))):
        raise AssertionError("topk_agreement differs from the plain state")
    log(f"  state == the plain version's; first hits 128 agreements, "
        f"k-th hit counts {int(counts[:, -1].min())}-"
        f"{int(counts[:, -1].max())}")
    return {"counts": launches, "wall_s": wall, "args": args}


def time_ms(fn, warmup: int = 3, reps: int = 20, inner: int = 1) -> float:
    """Median over ``reps`` windows of the card's time a call, CUDA events
    around ``inner`` back-to-back calls a window.  Kernels are timed with
    ``inner`` > 1, so the wrapper's host work overlaps the kernel before it
    and the window holds the kernels, not the host's enqueue."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def minhash_bound(n: int, s: int, in_bytes_per_id: int) -> tuple:
    """Least time for the work: ids read once, signatures and keys written
    once; per (row, id, hash) one IMAD and one IMNMX, per signature value in
    the band fold one multiply (FMA pipe) and one XOR (ALU pipe), the two
    pipes running side by side at INT32_PIPE_OPS_PER_S each."""
    nbytes = (n * s * in_bytes_per_id + 2 * N_HASHES * 4
              + n * (N_HASHES + N_BANDS) * 4)
    ops_per_pipe = n * s * N_HASHES + n * N_HASHES
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   ops_per_pipe / INT32_PIPE_OPS_PER_S * 1e3)


def rans_bound(lane: entropy.EntropyLane) -> tuple:
    """Least time for one lane's decode: words, states and frequencies read
    once, the [n] uint32 symbols written once; RANS_ALU_OPS_PER_SYMBOL ALU
    operations per symbol and plane."""
    nbytes = lane.nbytes + 4 * lane.n
    ops = RANS_ALU_OPS_PER_SYMBOL * lane.n * len(lane.planes)
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   ops / INT32_PIPE_OPS_PER_S * 1e3)


def cminhash_bound(n: int, s: int) -> tuple:
    """Least time for the bin-min: ids read once, a0 and b0 read once, the
    [N, H] bins and [N] row minima written once; per id one IMAD (FMA pipe)
    and one min (ALU pipe), the remainder not counted."""
    nbytes = n * s * 4 + 2 * 4 + n * (N_HASHES + 1) * 4
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   n * s / INT32_PIPE_OPS_PER_S * 1e3)


def topk_bound(args: tuple, n_rows: int) -> tuple:
    """Least time for one top-k chunk: queries, the transposed store, the
    row ids and the incoming state read once, the state written once; per
    (query, valid row, hash) one compare and one add, counted as issuing
    side by side on two integer pipes (the lower of the two readings: 0.98
    ms at cell (g) if they share one pipe)."""
    q, s_t, rid, topc, topr, _ = args
    nbytes = sum(t.numel() * 4 for t in (q, s_t, rid, topc, topr)) \
        + 2 * topc.numel() * 4
    ops_per_pipe = N_QUERIES * n_rows * q.shape[1]
    return _larger(nbytes / HBM_BYTES_PER_S * 1e3,
                   ops_per_pipe / INT32_PIPE_OPS_PER_S * 1e3)


def _larger(t_bytes: float, t_ops: float) -> tuple:
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def binmin_library(ids: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor):
    """The one PyTorch call that computes the bin-min: scatter_reduce_
    (amin) of the widened permuted ids into [N, H] int64 filled with UMAX.
    Returns it as a thunk over precomputed ids and bins (a yardstick
    only; the port never calls it)."""
    u64 = (mul_u32(widen(ids), widen(a0)) + widen(b0)) & U32_MASK
    bins = u64 % N_HASHES
    shape = (ids.shape[0], N_HASHES)
    return lambda: torch.full(shape, U32_MASK, dtype=torch.int64,
                              device=ids.device).scatter_reduce_(
                                  1, bins, u64, "amin")


def sm_clock_mhz(fn, seconds: float = 1.0) -> tuple:
    """Run ``fn`` back to back for ``seconds`` while nvidia-smi samples the
    SM clock every 20 ms; returns (median, least, most) MHz."""
    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,"
         "nounits", "-lms", "20"], stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(0.3)
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        out, _ = smi.communicate()
    mhz = [int(v) for v in out.split() if v.isdigit()]
    if not mhz:
        raise AssertionError("nvidia-smi gave no SM clock")
    return statistics.median(mhz), min(mhz), max(mhz)


def rans_timing(plan: dict, dev, inner: int) -> dict:
    """Phase 4, rANS: (c)'s lanes alone and in their one launch, with the
    SM clock read meanwhile and the cycles a step it gives."""
    lanes = {name: rans_args(lane, dev) for name, lane in
             plan["lanes"].items()}
    batch = list(lanes.values())
    out = {"batched_ms": time_ms(lambda: krans.rans_decode_lanes(batch),
                                 inner=inner)}
    mhz, lo, hi = sm_clock_mhz(lambda: krans.rans_decode_lanes(batch))
    out["sm_mhz"] = mhz
    steps = max(-(-n // entropy.N_STREAMS) for _, n, _ in batch)
    b_ms = sum(rans_bound(lane)[0] for lane in plan["lanes"].values())
    log(f"  rans_decode_lanes: {' + '.join(lanes)} in one launch "
        f"{out['batched_ms']:.4f} ms ({steps} steps on the longest chain: "
        f"{out['batched_ms'] * 1e-3 * mhz * 1e6 / steps:.1f} cycles a step "
        f"at the SM clock of {mhz} MHz, read {lo}-{hi} MHz; bound "
        f"{b_ms:.6f} ms by bytes)")
    return out


def topk_pass_timing(args: tuple, inner: int) -> dict:
    """Phase 4, top-k: each pass alone at cell (g)'s chunk (the scratch as
    the wrapper allocates it; the select pass reads one count pass's
    counts and histogram)."""
    q, s_t, rid, topc, topr, k = args
    qp, h = q.shape
    counts = torch.empty((qp, s_t.shape[1]), dtype=torch.int16,
                         device=q.device)
    hist = torch.zeros((qp, h + 1), dtype=torch.int32, device=q.device)
    outc, outr = torch.empty_like(topc), torch.empty_like(topr)
    ext = _build.load_extension()

    def run(passes: int):
        ext.topk_chunk(q, s_t, rid, topc, topr, k, counts, hist, outc, outr,
                       passes)

    # The count pass adds into the histogram; its values do not change
    # the count pass's work, so it is timed without zeroing.
    count_ms = time_ms(lambda: run(1), inner=inner)
    hist.zero_()
    run(1)
    select_ms = time_ms(lambda: run(2), inner=inner)
    log(f"  topk_chunk passes: count {count_ms:.4f} ms, select "
        f"{select_ms:.4f} ms")
    return {"count_ms": count_ms, "select_ms": select_ms}


def timing(items, plan: dict, dev, consts, topk: dict, inner: int) -> dict:
    """Phase 4: the MinHash and bin-min kernels at the plain path's first
    chunk, the rANS kernel at the default run's rep and counts lanes (each
    alone and both in one launch), the top-k kernel at cell (g)'s chunk
    (whole and by pass)."""
    chunk = items[:CHUNK_ROWS]
    ids = u32_tensor(quantize_ids(chunk, 10), dev)
    wire = pack_chunk(chunk)
    if wire.bits != 24:
        raise AssertionError(f"first chunk ships {wire.bits}-bit ids, not 24")
    payload = torch.from_numpy(wire.payload).to(dev)
    a0, b0 = make_params("cminhash", N_HASHES, 0).to(dev).arrays[:2]
    # The plain rANS decode takes seconds a lane (a launch of torch ops per
    # step), the plain top-k seconds a chunk (a launch of torch ops per
    # selection step and tile); phase 2 and cell (g) ran them on these
    # inputs already, so they get no warm-up.
    cases = {
        "minhash_and_keys": ((ids, *consts, N_BANDS),
                             minhash_bound(CHUNK_ROWS, SET_SIZE, 4), 1, 10),
        "cminhash_binmin": ((ids, a0, b0, N_HASHES),
                            cminhash_bound(CHUNK_ROWS, SET_SIZE), 1, 10),
        "minhash_and_keys_packed": (
            (payload, wire.shape, 3, wire.offset, *consts, N_BANDS),
            minhash_bound(CHUNK_ROWS, SET_SIZE, 3), 1, 10),
    }
    for name, lane in plan["lanes"].items():
        cases[f"rans_decode:{name}"] = (rans_args(lane, dev),
                                        rans_bound(lane), 0, 1)
    cases["topk_chunk"] = (topk["args"], topk_bound(topk["args"],
                                                    N_SESSIONS), 0, 1)
    library = {"cminhash_binmin": binmin_library(ids, a0, b0)}
    out = {}
    for case, (args, (b_ms, by), plain_warmup, plain_reps) in cases.items():
        name = case.split(":")[0]
        k = KERNELS[name]
        ms = time_ms(lambda: k["wrapper"](*args), inner=inner)
        plain_ms = time_ms(lambda: k["plain"](*args), warmup=plain_warmup,
                           reps=plain_reps)
        lib_ms = time_ms(library[name], inner=inner) \
            if name in library else None
        out[case] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": by, "library_ms": lib_ms}
        steps = ""
        if case.startswith("rans"):
            steps = f", {-(-args[1] // entropy.N_STREAMS)} serial steps"
        lib = "" if lib_ms is None else f", library {lib_ms:.4f} ms"
        log(f"  {case}: {ms:.4f} ms (plain {plain_ms:.3f} ms{lib}, bound "
            f"{b_ms:.6f} ms by {by}{steps})")
    out["rans_decode:rep"].update(rans_timing(plan, dev, inner))
    rep = out["rans_decode:rep"]
    steps = -(-plan["lanes"]["rep"].n // entropy.N_STREAMS)
    rep["cycles_per_step"] = rep["ms"] * 1e-3 * rep["sm_mhz"] * 1e6 / steps
    log(f"  rans_decode:rep: {rep['cycles_per_step']:.1f} cycles a step at "
        f"{rep['sm_mhz']} MHz")
    out["topk_chunk"].update(topk_pass_timing(topk["args"], inner))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls-per-window", type=int, default=KERNEL_INNER,
                    help="back-to-back kernel calls in each CUDA-event "
                    "timing window of phase 4 (default %(default)s)")
    args = ap.parse_args()
    if args.calls_per_window < 1:
        ap.error("--calls-per-window must be at least 1")
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

    hp = make_params("kminhash", N_HASHES, 0).to(dev)
    items, truth = synth_session_sets(N_SESSIONS, SET_SIZE, seed=0)
    log("phase 2: kernel checks (tolerance: exact)")
    errs = minhash_checks(dev, hp.arrays)
    errs["cminhash_binmin"] = cminhash_checks(dev)
    plan = default_run_lanes(items)
    errs["rans_decode"] = rans_checks(plan, dev)
    errs["topk_chunk"] = topk_checks(dev)

    log(f"phase 3: main path, {N_SESSIONS} sessions x {SET_SIZE} ids")
    small_input_check(items, truth, dev)
    plain10 = run_plain(items, truth, 0, "minhash_and_keys", hp, dev)
    plain24 = run_plain(items, truth, -1, "minhash_and_keys_packed", hp, dev)
    del plain24["sig"]
    run_forced(dev)
    default = run_default(items, truth, plan, plain10["labels"], hp, dev)
    cmin = run_cminhash(items, truth, plan, dev)
    run_weighted(dev)
    topk = run_topk(plain10.pop("sig"), dev)
    launches = {"minhash_and_keys": plain10["counts"]["minhash_and_keys"],
                "cminhash_binmin": cmin["counts"]["cminhash_binmin"],
                "minhash_and_keys_packed":
                    plain24["counts"]["minhash_and_keys_packed"],
                "rans_decode": default["counts"]["rans_decode"],
                "topk_chunk": topk["counts"]["topk_chunk"]}

    log(f"phase 4: timing (CUDA events around {args.calls_per_window} "
        "calls, median)")
    times = timing(items, plan, dev, hp.arrays, topk, args.calls_per_window)
    times["rans_decode"] = times["rans_decode:rep"]

    kernels_line = [{
        "name": name, "route": "cuda", "source": k["source"],
        "replaces": k["replaces"], "launches": launches[name],
        "max_abs_err": errs[name], **times[name],
    } for name, k in KERNELS.items()]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels_line}))
    print(card.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
