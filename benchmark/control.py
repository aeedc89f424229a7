"""The control of a cell at its own size, on the card.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

For each seed, makes the cell's inputs as a run does and judges the
control, the reference with one guarantee broken by a narrower type
(``params["control"]`` of the cell's workload file), by the cell's own
comparison.  Prints one JSON line a seed: the numbers compared, their
limits and whether the control fails them, as it has to.  Runs of the
benchmark itself never run it.
"""

import argparse
import json
import sys
import time

from run import prepare_environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    prepare_environment()

    import torch

    from benchmark.harness import cells, runner

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card; none is present",
              file=sys.stderr)
        return 2
    wl = cells.workload(args.workload)
    cfg = cells.config(wl["config"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = cells.driver(wl["driver"]).Cell(
            cfg, wl["params"], runner.seed_value(seed), "cuda", "")
        cell.make_inputs()
        verdict = cell.control()
        fails = any(v > wl["limits"][k]
                    for k, v in verdict["numbers"].items())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": wl["params"]["control"],
                          "numbers": verdict["numbers"],
                          "limits": wl["limits"],
                          "failed_calls": verdict["failed"],
                          "calls": verdict["attempted"],
                          "control_fails": fails,
                          "seconds": time.perf_counter() - t0}), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
