"""The port's six RQ drivers and its ``all``/``synth`` commands on the CPU.

The frozen golden study (tests/goldens/generate_goldens.py) goes entirely
through tse1m_tpu_torch: its generator, sqlite writer, corpus-CSV writer,
extraction, TorchBackend and drivers must reproduce all eight
tests/goldens/synth8/ files byte for byte, in process and through
``python -m tse1m_tpu_torch all --device cpu``.  On the same sqlite file
and corpus CSV (the golden study in test mode, and the conftest study at
a 2-project iteration floor) the JAX package's drivers on its pandas
backend, the golden oracle, and the port's drivers must write byte-equal
CSVs, manifests whose statistics agree (integers and text exact, floats
within rtol = atol = 2e-5, the repo's cross-engine tolerance) and the same
printed lines.  Without a card every RQ command and driver raises before
it reads or writes anything."""

import contextlib
import importlib.util
import io
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from tse1m_tpu.analysis.rq1 import run_rq1 as j_rq1
from tse1m_tpu.analysis.rq2_changepoints import run_rq2_changepoints as j_rq2a
from tse1m_tpu.analysis.rq2_trends import run_rq2_trends as j_rq2b
from tse1m_tpu.analysis.rq3 import run_rq3 as j_rq3
from tse1m_tpu.analysis.rq4a import run_rq4a as j_rq4a
from tse1m_tpu.analysis.rq4b import run_rq4b as j_rq4b
from tse1m_tpu.config import Config as JConfig
from tse1m_tpu.data import synth as jsynth
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.analysis import RQ_DRIVERS, run_rqs
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data.synth import SynthSpec, generate_study
from tse1m_tpu_torch.utils.runner import StepRunner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GEN = os.path.join(REPO, "tests", "goldens", "generate_goldens.py")
_spec = importlib.util.spec_from_file_location("generate_goldens", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

TOL = 2e-5
# (spec, Config fields) of each study both packages run.
STUDIES = {
    "golden": (gen.SPEC, dict(test_mode=True)),
    "conftest": (dict(n_projects=16, days=420, seed=7),
                 dict(min_projects_per_iteration=2)),
}
CSVS = gen.FILES + ["rq3/non_detected_coverage_changes.csv"]
MANIFESTS = ("rq1/rq1_manifest.json", "rq3/rq2_changepoints_manifest.json",
             "rq2/rq2_trends_manifest.json", "rq3/rq3_manifest.json",
             "rq4/bug/rq4a_manifest.json",
             "rq4/coverage/rq4b_manifest.json")
# Run facts rather than results: each package's own.
RUN_KEYS = {"name", "backend", "device", "started_at", "wall_seconds",
            "host", "python", "jax", "torch", "timings", "artifacts"}
NEW_COMMANDS = ("rq2a", "rq2b", "rq3", "rq4a", "rq4b", "all")


def _write_study(spec: dict, d) -> tuple[str, str]:
    db_path, csv_path = str(d / "study.sqlite"), str(d / "corpus.csv")
    study = generate_study(SynthSpec(**spec))
    study.to_db(db_path)
    study.write_corpus_csv(csv_path)
    return db_path, csv_path


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    d = tmp_path_factory.mktemp("golden")
    db_path, csv_path = _write_study(gen.SPEC, d)
    out = str(d / "in_process")
    cfg = Config(sqlite_path=db_path, result_dir=out, test_mode=True,
                 corpus_csv=csv_path)
    runner = run_rqs(cfg, device="cpu")
    return {"db": db_path, "csv": csv_path, "out": out, "runner": runner,
            "dir": d}


@pytest.fixture(scope="module")
def golden_cli(golden):
    out = str(golden["dir"] / "cli")
    env = {k: v for k, v in os.environ.items() if not k.startswith("TSE1M_")}
    proc = subprocess.run(
        [sys.executable, "-m", "tse1m_tpu_torch", "all", "--db",
         golden["db"], "--result-dir", out, "--test-mode", "--corpus-csv",
         golden["csv"], "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    return proc, out


def _assert_file_equal(got_dir: str, want_dir: str, rel: str) -> None:
    with open(os.path.join(got_dir, rel), "rb") as f:
        got = f.read()
    with open(os.path.join(want_dir, rel), "rb") as f:
        want = f.read()
    assert got == want, rel


@pytest.mark.parametrize("rel", gen.FILES)
def test_all_in_process_reproduces_the_goldens(golden, rel):
    _assert_file_equal(golden["out"], gen.GOLDEN_DIR, rel)


@pytest.mark.parametrize("rel", gen.FILES)
def test_cli_all_on_cpu_reproduces_the_goldens(golden_cli, rel):
    proc, out = golden_cli
    assert proc.returncode == 0, proc.stderr[-3000:]
    _assert_file_equal(out, gen.GOLDEN_DIR, rel)


def test_all_records_every_step(golden, golden_cli):
    assert golden["runner"].exit_code() == 0
    for out in (golden["out"], golden_cli[1]):
        with open(os.path.join(out, "run_manifest.json")) as f:
            manifest = json.load(f)
        assert manifest["ok"] is True
        assert [s["name"] for s in manifest["steps"]] == list(RQ_DRIVERS)
        assert {s["status"] for s in manifest["steps"]} == {"ok"}


# -- the JAX package's drivers and the port's on the same files -------------

def _capture(fn) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn()
    return buf.getvalue().splitlines()


@pytest.fixture(scope="module", params=list(STUDIES))
def both(request, tmp_path_factory):
    spec, fields = STUDIES[request.param]
    d = tmp_path_factory.mktemp(f"both_{request.param}")
    db_path, csv_path = _write_study(spec, d)
    jout, tout = str(d / "jax"), str(d / "port")
    jcfg = JConfig(backend="pandas", engine="sqlite", sqlite_path=db_path,
                   result_dir=jout, corpus_csv=csv_path, **fields)

    def run_jax():
        j_rq1(jcfg)
        j_rq2a(jcfg)
        j_rq2b(jcfg, per_project_figures=False)
        j_rq3(jcfg)
        j_rq4a(jcfg)
        j_rq4b(jcfg)

    tcfg = Config(sqlite_path=db_path, result_dir=tout, corpus_csv=csv_path,
                  **fields)
    jlines = _capture(run_jax)
    tlines = _capture(lambda: run_rqs(tcfg, device="cpu"))
    return {"jax": jout, "port": tout, "jlines": jlines, "tlines": tlines,
            "study": request.param}


@pytest.mark.parametrize("rel", CSVS)
def test_csv_bytes_equal_jax(both, rel):
    _assert_file_equal(both["port"], both["jax"], rel)


def test_change_analysis_files_equal_jax(both):
    sub = os.path.join("rq3", "change_analysis")
    names = sorted(os.listdir(os.path.join(both["jax"], sub)))
    assert names and sorted(os.listdir(os.path.join(both["port"], sub))) \
        == names
    for name in names:
        _assert_file_equal(both["port"], both["jax"], os.path.join(sub, name))


def _assert_close(got, want, where: str) -> None:
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), where
        for k in want:
            _assert_close(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, (int, float)), where
        if math.isnan(want):
            assert math.isnan(got), where
        else:
            assert abs(got - want) <= TOL + TOL * abs(want), (where, got,
                                                              want)
    else:
        assert got == want and type(got) is type(want), (where, got, want)


@pytest.mark.parametrize("rel", MANIFESTS)
def test_manifest_statistics_match_jax(both, rel):
    with open(os.path.join(both["port"], rel)) as f:
        got = json.load(f)
    with open(os.path.join(both["jax"], rel)) as f:
        want = json.load(f)
    got = {k: v for k, v in got.items() if k not in RUN_KEYS}
    want = {k: v for k, v in want.items() if k not in RUN_KEYS}
    assert got, rel
    _assert_close(got, want, rel)


def test_printed_lines_equal_jax(both):
    assert len(both["tlines"]) > 100
    assert both["tlines"] == both["jlines"]


# -- entry points without a card --------------------------------------------

@pytest.mark.parametrize("cmd", NEW_COMMANDS)
def test_command_without_a_card_raises_and_writes_nothing(
        golden, tmp_path, monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    args = [cmd, "--db", golden["db"], "--result-dir", str(out)]
    if cmd in ("rq4a", "rq4b", "all"):
        args += ["--corpus-csv", golden["csv"]]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(args)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_rqs(Config(sqlite_path=golden["db"], result_dir=str(out)))
    assert not out.exists()


@pytest.mark.parametrize("name", list(RQ_DRIVERS))
def test_driver_without_a_card_raises_and_writes_nothing(
        golden, tmp_path, monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    cfg = Config(sqlite_path=golden["db"], result_dir=str(out),
                 corpus_csv=golden["csv"], test_mode=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RQ_DRIVERS[name](cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        RQ_DRIVERS[name](cfg, device="cuda:0")
    assert not out.exists()


def test_synth_is_host_work_and_writes_the_corpus_csv(tmp_path,
                                                      monkeypatch, capsys):
    """``synth`` touches no device: it runs without a card and writes the
    sqlite study and the corpus CSV pandas would write."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db_path, csv_path = tmp_path / "s.sqlite", tmp_path / "c" / "corpus.csv"
    monkeypatch.setenv("TSE1M_CORPUS_CSV", str(csv_path))
    assert cli_main(["synth", "--db", str(db_path), "--projects", "5",
                     "--days", "30", "--seed", "3"]) == 0
    assert f"corpus analysis CSV at {csv_path}" in capsys.readouterr().out
    want = tmp_path / "pandas.csv"
    jsynth.generate_study(jsynth.SynthSpec(
        n_projects=5, days=30, seed=3)).corpus_analysis.to_csv(
        want, index=False)
    assert csv_path.read_bytes() == want.read_bytes()
    assert db_path.stat().st_size > 0


# -- step isolation ---------------------------------------------------------

def test_failed_step_is_recorded_and_the_rest_run(golden, tmp_path):
    """Without the corpus CSV, RQ4a and RQ4b fail with their SystemExit;
    the other four still run, and the command exits 1."""
    out = tmp_path / "out"
    code = cli_main(["all", "--db", golden["db"], "--result-dir", str(out),
                     "--test-mode", "--corpus-csv",
                     str(tmp_path / "absent.csv"), "--device", "cpu"])
    assert code == 1
    with open(out / "run_manifest.json") as f:
        manifest = json.load(f)
    status = {s["name"]: s["status"] for s in manifest["steps"]}
    assert status == {"rq1": "ok", "rq2a": "ok", "rq2b": "ok", "rq3": "ok",
                      "rq4a": "failed", "rq4b": "failed"}
    assert manifest["ok"] is False
    failed = [s for s in manifest["steps"] if s["status"] == "failed"]
    assert all(s["error"].startswith("SystemExit: corpus analysis CSV not "
                                     "found") for s in failed)
    assert all("Traceback" in s["traceback"] for s in failed)
    assert (out / "rq3" / "detected_coverage_changes.csv").exists()


def test_step_runner_rewrites_the_manifest_after_each_step(tmp_path):
    path = str(tmp_path / "run_manifest.json")
    runner = StepRunner(path)
    seen = []

    def second():
        with open(path) as f:
            seen.append(json.load(f))

    runner.run("first", lambda: None)
    runner.run("second", second)
    assert [s["name"] for s in seen[0]["steps"]] == ["first", "second"]
    assert [s["status"] for s in seen[0]["steps"]] == ["ok", "running"]
    assert runner.exit_code() == 0 and runner.summary() == {"ok": 2}
    assert StepRunner(None).exit_code() == 1  # no step ran


def test_step_runner_records_an_interrupt_and_reraises(tmp_path):
    path = tmp_path / "run_manifest.json"
    runner = StepRunner(str(path))

    def interrupted():
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        runner.run("stop", interrupted)
    with open(path) as f:
        step, = json.load(f)["steps"]
    assert step["status"] == "failed" and step["error"] == \
        "KeyboardInterrupt"
    assert runner.exit_code() == 1
