"""``python -m tse1m_tpu_torch.bench`` — the BENCH-trajectory toolbelt, a
port of ``tse1m_tpu/bench.py``.

Thin argparse front over :mod:`.observability.regress`: the committed
``BENCH_r*.json`` rounds are the paper's "measure the fleet over time"
artifact in miniature, and this is the tool that reads them.

    python -m tse1m_tpu_torch.bench diff BENCH_r08.json BENCH_r09.json
    python -m tse1m_tpu_torch.bench gate /tmp/bench.json \
        --baseline BENCH_baseline_smoke.json
    python -m tse1m_tpu_torch.bench baseline BENCH_baseline_smoke.json \
        run1.json run2.json run3.json --note "2k CPU smoke"
    python -m tse1m_tpu_torch.bench keys serve

``gate`` exits nonzero on a regression — that exit code IS the CI
perf-gate job.  (The top-level ``bench.py`` *produces* rounds; this
module *judges* them.  A round producer for the port is a further
subcommand to come.)
"""

from __future__ import annotations

import argparse
import json
import sys

from .observability import regress


def _load_one(path: str) -> dict:
    """One bench result: the last JSON line of the file (bench.py
    streams logs above its final JSON) or the whole file."""
    with open(path) as f:
        text = f.read().strip()
    if not text:
        raise ValueError("file is empty")
    try:
        return json.loads(text.splitlines()[-1])
    except json.JSONDecodeError:
        return json.loads(text)


def _fail_input(path: str, err: Exception) -> int:
    """A missing/truncated/corrupt input is an operator mistake, not a
    traceback: say which file, why, and how to mint a fresh baseline."""
    reason = str(err) or type(err).__name__
    print(f"bench: cannot read {path}: {reason} — check the path, or "
          f"regenerate with `python -m tse1m_tpu_torch.bench baseline "
          f"<out.json> <run.json>...`", file=sys.stderr)
    return 2


def _cmd_diff(args) -> int:
    rounds = []
    for path in (args.round_a, args.round_b):
        try:
            rounds.append(_load_one(path))
        except (OSError, ValueError) as e:  # JSONDecodeError is a ValueError
            return _fail_input(path, e)
    a, b = rounds
    print(regress.diff(a, b, name_a=args.round_a, name_b=args.round_b,
                       show_all=args.all))
    return 0


def _cmd_gate(args) -> int:
    try:
        current = _load_one(args.current)
    except (OSError, ValueError) as e:
        return _fail_input(args.current, e)
    try:
        baseline = regress.load_runs(args.baseline)
    except (OSError, ValueError) as e:
        return _fail_input(args.baseline, e)
    report = regress.gate(current, baseline)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(regress.format_gate_report(report))
    return 0 if report["ok"] else 1


def _cmd_baseline(args) -> int:
    runs = [_load_one(p) for p in args.runs]
    regress.write_baseline(args.out, runs, note=args.note)
    print(f"baseline: {len(runs)} run(s) -> {args.out}")
    return 0


def _cmd_keys(args) -> int:
    if args.context:
        for key in regress.required_keys(args.context):
            print(key)
    else:
        for key, spec in regress.BENCH_SCHEMA.items():
            flags = ",".join(spec["contexts"]) or "-"
            gate_s = (f" gate(tol={spec['tol']}, abs={spec['abs']})"
                      if spec["gate"] else "")
            print(f"{key:<32} [{flags}] {spec['dir'] or '-':<6}"
                  f"{gate_s}  {spec['desc']}")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tse1m_tpu_torch.bench",
        description="diff/gate the BENCH_r*.json trajectory")
    sub = p.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("diff", help="delta report between two rounds")
    d.add_argument("round_a")
    d.add_argument("round_b")
    d.add_argument("--all", action="store_true",
                   help="include <2%% deltas and ungated keys")
    d.set_defaults(fn=_cmd_diff)

    g = sub.add_parser("gate",
                       help="noise-aware regression gate vs a baseline")
    g.add_argument("current", help="fresh bench JSON to judge")
    g.add_argument("--baseline", required=True,
                   help="committed baseline (single run or "
                        "{'runs': [...]})")
    g.add_argument("--json", action="store_true",
                   help="machine-readable report")
    g.set_defaults(fn=_cmd_gate)

    b = sub.add_parser("baseline",
                       help="assemble a median-of-k baseline file")
    b.add_argument("out")
    b.add_argument("runs", nargs="+")
    b.add_argument("--note", default="")
    b.set_defaults(fn=_cmd_baseline)

    k = sub.add_parser("keys", help="print the bench-key schema")
    k.add_argument("context", nargs="?",
                   help="bench | degradation | fault | serve")
    k.set_defaults(fn=_cmd_keys)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
