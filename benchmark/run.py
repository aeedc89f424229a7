"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Sets up the cell (its inputs and hash constants from ``--seed``, the
program's kernels built or loaded, every shape it uses warmed), measures
for ``--seconds``, checks the answers of the window against the plain
reference in ``benchmark/reference/``, and prints one JSON object as the
last line of standard output; the compared numbers, each beside its
limit, are the last lines of standard error.  Exits non-zero, with no
result, without enough CUDA cards, or when the JAX package or JAX is
loaded in the process once the window has closed.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


def prepare_environment() -> None:
    """The program's settings for a run, before torch is imported: no
    INI, no machine calibration, no ``TSE1M_*`` setting from outside, and
    every build and kernel cache at a fixed path inside the checkout (the
    port's own extension builds into ``build/tse1m_tpu_torch/``)."""
    for key in [k for k in os.environ if k.startswith("TSE1M_")]:
        del os.environ[key]
    os.environ["TSE1M_ENVFILE"] = ""
    os.environ["TSE1M_ROUTER_CAL"] = ""
    cache = os.path.join(ROOT, "build", "bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(cache, "cuda")
    os.environ["NCCL_SHM_DISABLE"] = "1"
    os.environ["USE_FLAX"] = "0"
    # Import from the checkout's root, never from this directory.
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".")
                   != BENCH_DIR]
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    prepare_environment()

    import torch

    from benchmark.harness import cells, runner

    chips = int(cells.cell_entry(cells.manifest(), args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"workload {args.workload} needs {chips} CUDA card(s); this "
              f"machine has {have}", file=sys.stderr)
        return 2
    result = runner.run_cell(args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda",
                             t_process=T_PROCESS)
    bad = runner.forbidden_loaded()
    if bad:
        print(f"loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for line in runner.checks_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
