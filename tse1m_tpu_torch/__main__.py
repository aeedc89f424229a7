"""Command line of the port: storeless single-GPU session clustering.

    python -m tse1m_tpu_torch cluster --n 1000000 --seed 0 \
        [--wire-quant-bits N] [--prefilter {off,auto,on}] \
        [--entropy {off,auto,force}] \
        [--scheme {kminhash,cminhash,weighted}] [--device cuda]

Synthesizes planted near-duplicate sessions, clusters them with default
``ClusterParams`` (wire v3: at >= 64 MiB of ids the host prefilter, the
base-delta lane and the rANS lanes switch on), and prints one JSON line:
ARI against the planted truth, the wire chosen, the wall and the stage
walls.  ``--scheme weighted`` also synthesizes per-edge hit counts and
expands each session into replica ids on the host before clustering, as
the JAX package's command line does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .cluster import ClusterParams, adjusted_rand_index, cluster_sessions
from .cluster.pipeline import last_run_info
from .cluster.schemes import expand_weighted
from .data import synth_session_hitcounts, synth_session_sets
from .device import resolve_device


def _cmd_cluster(args) -> int:
    dev = resolve_device(args.device)
    items, truth = synth_session_sets(args.n, seed=args.seed)
    if args.scheme == "weighted":
        items = expand_weighted(
            items, synth_session_hitcounts(items, truth, seed=args.seed))
    params = ClusterParams(seed=args.seed, prefilter=args.prefilter,
                           entropy=args.entropy,
                           wire_quant_bits=args.wire_quant_bits,
                           scheme=args.scheme)
    t0 = time.perf_counter()
    labels = cluster_sessions(items, params, device=dev)
    wall = time.perf_counter() - t0
    report = {
        "n_sessions": args.n,
        "scheme": args.scheme,
        "set_width": int(items.shape[1]),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "n_clusters": int(np.unique(labels).size),
        "ari_vs_planted": round(float(adjusted_rand_index(labels, truth)), 5),
        "cluster_wall_s": round(wall, 4),
        "encoding": last_run_info.get("encoding"),
        "prefilter_rows_dropped": last_run_info.get("prefilter_rows_dropped"),
        "wire_quant_bits": last_run_info.get("wire_quant_bits"),
        "chunk_bits": last_run_info.get("chunk_bits"),
        "wire_mb": last_run_info.get("wire_mb"),
        "wire_v3_saved_mb": last_run_info.get("wire_v3_saved_mb"),
        **last_run_info.get("stages", {}),
    }
    print(json.dumps(report))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tse1m_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("cluster", help="MinHash+LSH session dedup on the GPU")
    p.add_argument("--n", type=int, default=100_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--wire-quant-bits", type=int, default=0,
                   help="0 = auto (10 bits at >= 64 MB of ids), -1 = never, "
                        "1..32 = forced")
    p.add_argument("--prefilter", default="auto",
                   choices=("off", "auto", "on"),
                   help="wire v3 host LSH prefilter: rows bucketed "
                        "singleton in every host band skip the wire; labels "
                        "stay equal to the unfiltered run's")
    p.add_argument("--entropy", default="auto",
                   choices=("off", "auto", "force"),
                   help="wire v3 rANS lane coding: 'auto' codes the lanes "
                        "that beat their bit-packed form; 'force' codes all")
    p.add_argument("--scheme", default="kminhash",
                   choices=("kminhash", "cminhash", "weighted"),
                   help="signature family: 'kminhash' = K multiply-add "
                        "hashes (default); 'cminhash' = one permutation + "
                        "densification; 'weighted' = weighted minwise over "
                        "synthesized per-edge hit counts (replica "
                        "expansion on the host)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu for the plain versions")
    args = ap.parse_args(argv)
    return _cmd_cluster(args)


if __name__ == "__main__":
    sys.exit(main())
