"""The port's round toolbelt (tse1m_tpu_torch/observability/regress.py and
``python -m tse1m_tpu_torch.bench``) against the JAX package's: every
edge case of tests/test_regress.py on the port, and the diff text, gate
reports, baseline files, ``keys`` output and exit codes equal to JAX's
over the committed rounds.  The only difference is the module named in
the bad-input hint."""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys

import pytest

import tse1m_tpu.observability.regress as jreg
import tse1m_tpu_torch.observability.regress as treg
from tse1m_tpu.bench import main as jmain
from tse1m_tpu_torch.bench import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROUNDS = sorted(f for f in os.listdir(REPO)
                if f.startswith("BENCH_r") and f.endswith(".json"))


def _round(name: str) -> dict:
    with open(os.path.join(REPO, name)) as f:
        return json.load(f)


def test_schema_is_jax_data():
    assert treg.BENCH_SCHEMA == jreg.BENCH_SCHEMA
    for ctx in ("bench", "degradation", "fault", "serve", "nope"):
        assert treg.required_keys(ctx) == jreg.required_keys(ctx)
    assert treg.gated_keys() == jreg.gated_keys()
    for key in treg.gated_keys():
        spec = treg.BENCH_SCHEMA[key]
        assert spec["dir"] in ("lower", "higher") and spec["tol"] >= 0


def test_assert_bench_keys_names_the_offending_key():
    good = {k: 1 for k in treg.required_keys("serve")}
    treg.assert_bench_keys(good, "serve")
    del good["serve_p99_ms"]
    with pytest.raises(AssertionError, match="serve_p99_ms") as ei:
        treg.assert_bench_keys(good, "serve")
    assert "tse1m_tpu_torch/observability/regress.py" in str(ei.value)
    treg.assert_bench_keys(_round("BENCH_r08.json"), "bench")
    with pytest.raises(AssertionError, match="cluster_warm_wall_s|cache_"):
        treg.assert_bench_keys(_round("BENCH_r09.json"), "bench")


def _gate_cases():
    r09 = _round("BENCH_r09.json")
    r08 = _round("BENCH_r08.json")
    planted = dict(r09, stage_compute_s=r09["stage_compute_s"] * 2.0)
    dropped = dict(r09, ari_vs_planted=r09["ari_vs_planted"] - 0.2)
    improved = dict(r09, ari_vs_planted=min(1.0,
                                            r09["ari_vs_planted"] + 0.1))
    shrunk = {k: v for k, v in r09.items() if k != "stage_compute_s"}
    k = ("stage_compute_s",)
    hist = [{"stage_compute_s": v} for v in (1.5, 2.0, 2.5)]
    return {
        "own_r09": (r09, [r09], None), "own_r08": (r08, [r08], None),
        "planted_2x": (planted, [r09], None),
        "quality_drop": (dropped, [r09], None),
        "quality_rise": (improved, [r09], None),
        "shrunk": (shrunk, [r09], None), "grown": (r09, [shrunk], None),
        "zero_ok": ({"stage_compute_s": 0.4}, [{"stage_compute_s": 0.0}], k),
        "zero_red": ({"stage_compute_s": 0.9}, [{"stage_compute_s": 0.0}],
                     k),
        "nan_base": ({"stage_compute_s": 5.0},
                     [{"stage_compute_s": float("nan")}], k),
        "nan_cur": ({"stage_compute_s": float("nan")},
                    [{"stage_compute_s": 2.0}], k),
        "single": ({"stage_compute_s": 2.0}, [{"stage_compute_s": 2.0}], k),
        "mad_ok": ({"stage_compute_s": 5.4}, hist, k),
        "mad_red": ({"stage_compute_s": 5.6}, hist, k),
        "r08_vs_r09": (r08, [r09, r09], None),
    }


@pytest.mark.parametrize("case", list(_gate_cases()))
def test_gate_and_report_equal_jax(case):
    cur, base, keys = _gate_cases()[case]
    got = treg.gate(cur, base, keys=keys)
    want = jreg.gate(cur, base, keys=keys)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert treg.format_gate_report(got) == jreg.format_gate_report(want)
    expect_ok = {"planted_2x": False, "quality_drop": False,
                 "shrunk": False, "zero_red": False, "mad_red": False}
    if case in expect_ok:
        assert got["ok"] is expect_ok[case]


@pytest.mark.parametrize("pair", [(a, b) for a in ROUNDS[-4:]
                                  for b in ROUNDS[-4:] if a != b])
@pytest.mark.parametrize("show_all", [False, True])
def test_diff_equals_jax_over_committed_rounds(pair, show_all):
    a, b = (_round(p) for p in pair)
    got = treg.diff(a, b, name_a=pair[0], name_b=pair[1], show_all=show_all)
    assert got == jreg.diff(a, b, name_a=pair[0], name_b=pair[1],
                            show_all=show_all)
    assert got.startswith(f"bench diff: {pair[0]} -> {pair[1]}")


def test_diff_edge_cases_equal_jax():
    cases = [({"stage_compute_s": 2.0, "ari_vs_planted": 0.9,
               "cluster_encoding": "delta-v3"},
              {"stage_compute_s": 4.0, "ari_vs_planted": 0.99,
               "cluster_encoding": "delta-v4"}),
             ({"metric": "2k", "stage_compute_s": 0.0},
              {"metric": "1m", "stage_compute_s": 1.0}),
             ({"x": 1}, {"x": 1}), ({"x": True}, {"x": False})]
    for a, b in cases:
        for show_all in (False, True):
            assert treg.diff(a, b, show_all=show_all) == jreg.diff(
                a, b, show_all=show_all)
    assert "(no differences)" in treg.diff({"x": 1}, {"x": 1})


def test_baseline_files_equal_jax(tmp_path):
    runs = [_round(r) for r in ROUNDS[-3:]] + [{"stage_compute_s": 1.0}]
    treg.write_baseline(str(tmp_path / "t.json"), runs, note="history")
    jreg.write_baseline(str(tmp_path / "j.json"), runs, note="history")
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()
    assert treg.load_runs(str(tmp_path / "t.json")) == runs
    single = tmp_path / "single.json"
    single.write_text('{"stage_compute_s": 2.0}')
    assert treg.load_runs(str(single)) == [{"stage_compute_s": 2.0}]
    single.write_text("[]")
    with pytest.raises(ValueError):
        treg.load_runs(str(single))
    runs = treg.load_runs(os.path.join(REPO, "BENCH_baseline_smoke.json"))
    assert runs and all(math.isfinite(float(r["value"])) for r in runs)


def _cli(main, argv, capsys):
    rc = main(argv)
    cap = capsys.readouterr()
    return rc, cap.out, cap.err


def test_bench_cli_equals_jax(tmp_path, capsys):
    r08 = os.path.join(REPO, "BENCH_r08.json")
    r09 = os.path.join(REPO, "BENCH_r09.json")
    planted = dict(_round("BENCH_r09.json"))
    planted["stage_compute_s"] *= 2.0
    cur = str(tmp_path / "planted.json")
    with open(cur, "w") as f:
        json.dump(planted, f)
    smoke = os.path.join(REPO, "BENCH_baseline_smoke.json")
    for argv in (["diff", r08, r09], ["diff", r08, r09, "--all"],
                 ["gate", r09, "--baseline", smoke],
                 ["gate", cur, "--baseline", r09],
                 ["gate", cur, "--baseline", r09, "--json"],
                 ["gate", r09, "--baseline", r09],
                 ["keys"], ["keys", "serve"], ["keys", "bench"]):
        got = _cli(tmain, argv, capsys)
        assert got == _cli(jmain, argv, capsys), argv
    assert _cli(tmain, ["gate", cur, "--baseline", r09], capsys)[0] == 1
    for name, main in (("t", tmain), ("j", jmain)):
        rc, out, _ = _cli(main, ["baseline", str(tmp_path / f"{name}.json"),
                                 r08, r09, "--note", "two"], capsys)
        assert rc == 0 and out == (f"baseline: 2 run(s) -> "
                                   f"{tmp_path / f'{name}.json'}\n")
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


@pytest.mark.parametrize("make", ["missing", "empty", "corrupt"])
def test_bench_cli_bad_inputs_one_line_error(tmp_path, capsys, make):
    bad = str(tmp_path / "bad.json")
    if make == "empty":
        open(bad, "w").close()
    elif make == "corrupt":
        with open(bad, "w") as f:
            f.write('{"broken')
    good = os.path.join(REPO, "BENCH_r09.json")
    for argv in (["diff", bad, good], ["diff", good, bad],
                 ["gate", bad, "--baseline", good],
                 ["gate", good, "--baseline", bad]):
        rc, out, err = _cli(tmain, argv, capsys)
        jrc, jout, jerr = _cli(jmain, argv, capsys)
        assert rc == jrc == 2 and out == jout == ""
        assert err.count("\n") == 1 and err.startswith(
            f"bench: cannot read {bad}")
        assert "tse1m_tpu_torch.bench baseline" in err
        assert err.replace("tse1m_tpu_torch.bench", "tse1m_tpu.bench") == \
            jerr


def test_module_entry_point_runs_without_jax_or_pandas():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'pandas', 'tse1m_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from tse1m_tpu_torch.bench import main\n"
            "sys.exit(main(['keys', 'fault']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.split() == list(jreg.required_keys("fault"))
