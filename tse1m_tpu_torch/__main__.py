"""Command line of the port: session clustering and the paper's RQ1.

    python -m tse1m_tpu_torch cluster --n 1000000 --seed 0 \
        [--wire-quant-bits N] [--prefilter {off,auto,on}] \
        [--entropy {off,auto,force}] \
        [--scheme {kminhash,cminhash,weighted}] [--device cuda]
    python -m tse1m_tpu_torch rq1 --db PATH --result-dir DIR \
        [--limit-date 2025-01-08] [--min-coverage-days 365] \
        [--test-mode] [--device cuda]

``cluster`` synthesizes planted near-duplicate sessions, clusters them
with default ``ClusterParams`` (wire v3: at >= 64 MiB of ids the host
prefilter, the base-delta lane and the rANS lanes switch on), and prints
one JSON line:
ARI against the planted truth, the wire chosen, the wall and the stage
walls.  ``--scheme weighted`` also synthesizes per-edge hit counts and
expands each session into replica ids on the host before clustering, as
the JAX package's command line does.

``rq1`` runs RQ1 over a sqlite study on the card: it prints the summary
lines of the reference transcript and writes
``<result-dir>/rq1/rq1_detection_rate_stats.csv`` and
``rq1_raw_issues_for_analysis.csv``.  The defaults of ``--db``,
``--result-dir`` and ``--test-mode`` come from TSE1M_SQLITE_PATH,
TSE1M_RESULT_DIR and TSE1M_TEST_MODE, else the JAX package's defaults.

Both run on the card unless ``--device cpu`` is given, and fail without
one.
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
from .config import DEFAULT_LIMIT_DATE, Config, load_config
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


def _cmd_rq1(args) -> int:
    from .analysis.rq1 import run_rq1

    resolve_device(args.device)
    cfg = Config(sqlite_path=args.db, result_dir=args.result_dir,
                 limit_date=args.limit_date,
                 min_coverage_days=args.min_coverage_days,
                 test_mode=args.test_mode)
    out = run_rq1(cfg, device=args.device)
    print(f"wrote {out['stats_csv']}")
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
    env = load_config()
    r = sub.add_parser("rq1", help="RQ1 detection rate over a sqlite study "
                       "on the GPU")
    r.add_argument("--db", default=env.sqlite_path,
                   help="sqlite study file (default %(default)s)")
    r.add_argument("--result-dir", default=env.result_dir,
                   help="artifact root; CSVs go to <dir>/rq1 "
                        "(default %(default)s)")
    r.add_argument("--limit-date", default=DEFAULT_LIMIT_DATE,
                   help="study cutoff (default %(default)s)")
    r.add_argument("--min-coverage-days", type=int, default=365,
                   help="eligibility: non-zero coverage days before the "
                        "cutoff (default %(default)s)")
    r.add_argument("--test-mode", action="store_true", default=env.test_mode,
                   help="first 10 eligible projects, 1 project an "
                        "iteration (the reference's TEST_MODE)")
    r.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return _cmd_rq1(args) if args.cmd == "rq1" else _cmd_cluster(args)


if __name__ == "__main__":
    sys.exit(main())
