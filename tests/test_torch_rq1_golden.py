"""The frozen golden study (tests/goldens/generate_goldens.py) entirely
through tse1m_tpu_torch on the CPU: the port's generator, sqlite writer,
extraction, TorchBackend and RQ1 driver must reproduce
tests/goldens/synth8/rq1/*.csv byte for byte (integer columns exactly, text
columns byte for byte), in process and through the command line; without
a card the command line refuses to run unless asked for the CPU."""

import importlib.util
import os
import subprocess
import sys

import pytest
import torch

from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.analysis.rq1 import run_rq1
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data.synth import SynthSpec, generate_study

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_GEN = os.path.join(REPO, "tests", "goldens", "generate_goldens.py")
_spec = importlib.util.spec_from_file_location("generate_goldens", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

RQ1_FILES = ("rq1_detection_rate_stats.csv",
             "rq1_raw_issues_for_analysis.csv")


@pytest.fixture(scope="module")
def golden_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("golden") / "golden.sqlite")
    generate_study(SynthSpec(**gen.SPEC)).to_db(path)
    return path


def _assert_golden(result_dir: str) -> None:
    for name in RQ1_FILES:
        with open(os.path.join(result_dir, "rq1", name), "rb") as f:
            got = f.read()
        with open(os.path.join(gen.GOLDEN_DIR, "rq1", name), "rb") as f:
            want = f.read()
        assert got == want, name


def test_frozen_study_reproduces_rq1_goldens(golden_db, tmp_path, capsys):
    cfg = Config(sqlite_path=golden_db, result_dir=str(tmp_path),
                 test_mode=True)
    out = run_rq1(cfg, device="cpu")
    _assert_golden(str(tmp_path))
    assert out["result"].iterations.size == 524
    text = capsys.readouterr().out
    assert "linked 72(98.63%) issues to buildlog data. 72/73" in text
    assert os.path.exists(tmp_path / "rq1" / "rq1_manifest.json")


def test_cli_rq1_on_cpu_reproduces_the_goldens(golden_db, tmp_path):
    env = dict(os.environ)
    for k in ("TSE1M_SQLITE_PATH", "TSE1M_RESULT_DIR", "TSE1M_TEST_MODE"):
        env.pop(k, None)
    proc = subprocess.run(
        [sys.executable, "-m", "tse1m_tpu_torch", "rq1", "--db", golden_db,
         "--result-dir", str(tmp_path), "--test-mode", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Retained 524 iterations for the final analysis." in proc.stdout
    _assert_golden(str(tmp_path))


def test_cli_rq1_reads_the_environment(golden_db, tmp_path, monkeypatch):
    monkeypatch.setenv("TSE1M_SQLITE_PATH", golden_db)
    monkeypatch.setenv("TSE1M_RESULT_DIR", str(tmp_path))
    monkeypatch.setenv("TSE1M_TEST_MODE", "1")
    assert cli_main(["rq1", "--device", "cpu"]) == 0
    _assert_golden(str(tmp_path))


def test_rq1_without_a_card_raises(golden_db, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_main(["rq1", "--db", golden_db, "--result-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_rq1(Config(sqlite_path=golden_db, result_dir=str(tmp_path)))
    assert not os.path.exists(tmp_path / "rq1")
