"""The port's ``load_config`` against the JAX package's, on the CPU: under
an INI at TSE1M_ENVFILE both read the same ``[FRAMEWORK]`` keys, the
environment overrides the INI in both, and the port's command line takes
its defaults (``--limit-date`` among them) from the loaded config.
Tolerance: exact."""

import os

import pytest

from tse1m_tpu import config as jconfig
from tse1m_tpu_torch import config as tconfig
from tse1m_tpu_torch.__main__ import build_parser, main as cli_main
from tse1m_tpu_torch.data.synth import SynthSpec, generate_study

SHARED = ("sqlite_path", "limit_date", "min_coverage_days",
          "min_projects_per_iteration", "result_dir", "corpus_csv",
          "analysis_iterations", "days_threshold", "test_mode")
ENV = {"sqlite_path": "TSE1M_SQLITE_PATH", "result_dir": "TSE1M_RESULT_DIR",
       "corpus_csv": "TSE1M_CORPUS_CSV", "test_mode": "TSE1M_TEST_MODE"}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in list(os.environ):
        if k.startswith("TSE1M_"):
            monkeypatch.delenv(k)


def _write_ini(path, **fw) -> str:
    lines = ["[FRAMEWORK]", "engine = sqlite"] + [
        f"{k} = {v}" for k, v in fw.items()]
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _ini_values(tmp_path) -> dict:
    return {"sqlite_path": str(tmp_path / "ini.sqlite"),
            "limit_date": "2024-09-01",
            "result_dir": str(tmp_path / "ini_results"),
            "corpus_csv": str(tmp_path / "ini_corpus.csv"),
            "test_mode": "true"}


def _shared(cfg) -> dict:
    return {k: getattr(cfg, k) for k in SHARED}


def test_defaults_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TSE1M_ENVFILE", str(tmp_path / "absent.ini"))
    assert _shared(tconfig.load_config()) == _shared(jconfig.load_config())
    assert _shared(tconfig.Config()) == _shared(jconfig.Config())


@pytest.mark.parametrize("field", ("sqlite_path", "limit_date", "result_dir",
                                   "corpus_csv", "test_mode"))
def test_ini_field_matches_jax(tmp_path, monkeypatch, field):
    values = _ini_values(tmp_path)
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(tmp_path / "env.ini",
                                                   **values))
    got, want = tconfig.load_config(), jconfig.load_config()
    assert getattr(got, field) == getattr(want, field)
    expect = True if field == "test_mode" else values[field]
    assert getattr(got, field) == expect
    assert _shared(got) == _shared(want)


def test_ini_path_argument_matches_jax(tmp_path):
    path = _write_ini(tmp_path / "given.ini", limit_date="2023-01-01")
    assert (tconfig.load_config(path).limit_date
            == jconfig.load_config(path).limit_date == "2023-01-01")


def test_ini_without_framework_section_keeps_defaults(tmp_path, monkeypatch):
    ini = tmp_path / "pg_only.ini"
    ini.write_text("[POSTGRES]\nPOSTGRES_DB = x\n")
    monkeypatch.setenv("TSE1M_ENVFILE", str(ini))
    assert _shared(tconfig.load_config()) == _shared(jconfig.load_config())
    assert tconfig.load_config() == tconfig.Config()


@pytest.mark.parametrize("field", sorted(ENV))
def test_environment_overrides_the_ini_as_jax(tmp_path, monkeypatch, field):
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(tmp_path / "env.ini",
                                                   **_ini_values(tmp_path)))
    value = "0" if field == "test_mode" else str(tmp_path / f"env_{field}")
    monkeypatch.setenv(ENV[field], value)
    got, want = tconfig.load_config(), jconfig.load_config()
    assert _shared(got) == _shared(want)
    assert getattr(got, field) == (False if field == "test_mode" else value)


@pytest.mark.parametrize("cmd", ("rq1", "rq2a", "rq2b", "rq3", "rq4a",
                                 "rq4b", "all"))
def test_cli_defaults_are_the_loaded_config(tmp_path, monkeypatch, cmd):
    values = _ini_values(tmp_path)
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(tmp_path / "env.ini",
                                                   **values))
    monkeypatch.setenv("TSE1M_CORPUS_CSV", str(tmp_path / "env_corpus.csv"))
    args = build_parser().parse_args([cmd])
    assert args.limit_date == "2024-09-01"
    assert (args.db, args.result_dir) == (values["sqlite_path"],
                                          values["result_dir"])
    assert args.test_mode is True and args.device == "cuda"
    assert args.corpus_csv == str(tmp_path / "env_corpus.csv")


@pytest.fixture(scope="module")
def small_db(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("cfg_db") / "small.sqlite")
    generate_study(SynthSpec(n_projects=3, days=460, seed=1,
                             ineligible_fraction=0.0)).to_db(path)
    return path


def test_cli_rq1_runs_on_the_ini(tmp_path, monkeypatch, capsys, small_db):
    """``rq1`` with no arguments but the device reads the INI's study up to
    its cutoff, in test mode, into its result directory."""
    out = tmp_path / "from_ini"
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(
        tmp_path / "env.ini", sqlite_path=small_db, limit_date="2024-09-01",
        result_dir=str(out), test_mode="true"))
    assert cli_main(["rq1", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "projects before 2024-09-01. (in study design)" in text
    assert "[TEST MODE] Limiting to the first 3 projects." in text
    assert os.path.exists(out / "rq1" / "rq1_detection_rate_stats.csv")
    # The command line still overrides the INI.
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(
        tmp_path / "env.ini", sqlite_path=small_db, limit_date="2024-09-01"))
    assert cli_main(["rq1", "--device", "cpu", "--limit-date", "2024-08-15",
                     "--result-dir", str(tmp_path / "cli")]) == 0
    assert "projects before 2024-08-15." in capsys.readouterr().out


@pytest.mark.parametrize("ini,env,want", [
    (None, None, None),
    ("ini_store", None, "ini_store"),
    (None, "env_store", "env_store"),
    ("ini_store", "env_store", "env_store"),
])
def test_sig_store_from_the_ini_and_the_environment_as_jax(
        tmp_path, monkeypatch, ini, env, want):
    """``sig_store``: the INI's ``[FRAMEWORK] sig_store``, then
    TSE1M_SIG_STORE, as JAX reads it; ``cluster --sig-store`` defaults to
    it and the command line overrides it."""
    fw = {"sig_store": str(tmp_path / ini)} if ini else {}
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(tmp_path / "env.ini",
                                                   **fw))
    if env:
        monkeypatch.setenv("TSE1M_SIG_STORE", str(tmp_path / env))
    expect = str(tmp_path / want) if want else None
    assert tconfig.load_config().sig_store == expect
    assert jconfig.load_config().sig_store == expect
    assert build_parser().parse_args(["cluster"]).sig_store == expect
    assert build_parser().parse_args(
        ["cluster", "--sig-store", "cli_store"]).sig_store == "cli_store"


@pytest.mark.parametrize("ini,env", [
    (None, None), ("auto", None), ("pandas", None), ("jax_tpu", None),
    (None, "auto"), ("auto", "jax_tpu"), ("pandas", "auto"),
])
def test_backend_from_the_ini_and_the_environment_as_jax(tmp_path,
                                                         monkeypatch, ini,
                                                         env):
    """``backend``: the default, then the INI's ``[FRAMEWORK] backend``,
    then TSE1M_BACKEND, as JAX reads it."""
    fw = {"backend": ini} if ini else {}
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(tmp_path / "env.ini",
                                                   **fw))
    if env:
        monkeypatch.setenv("TSE1M_BACKEND", env)
    want = env or ini or "pandas"
    assert tconfig.load_config().backend == want
    assert jconfig.load_config().backend == want
    assert tconfig.Config().backend == jconfig.Config().backend


@pytest.mark.parametrize("where", ["ini", "env"])
def test_unknown_backend_refused_in_jax_words(tmp_path, monkeypatch, where):
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(
        tmp_path / "env.ini", **({"backend": "cuda"} if where == "ini"
                                 else {})))
    if where == "env":
        monkeypatch.setenv("TSE1M_BACKEND", "cuda")
    for load in (tconfig.load_config, jconfig.load_config):
        with pytest.raises(ValueError, match="unknown backend 'cuda'; "
                           "expected 'pandas', 'jax_tpu' or 'auto'"):
            load()


@pytest.mark.parametrize("ini,env,want", [
    (None, None, None), ("ini_cal.json", None, "ini_cal.json"),
    (None, "env_cal.json", "env_cal.json"),
    ("ini_cal.json", "env_cal.json", "env_cal.json"),
])
def test_router_cal_path_from_the_ini_and_the_environment_as_jax(
        tmp_path, monkeypatch, ini, env, want):
    fw = {"router_cal_path": str(tmp_path / ini)} if ini else {}
    monkeypatch.setenv("TSE1M_ENVFILE", _write_ini(tmp_path / "env.ini",
                                                   **fw))
    if env:
        monkeypatch.setenv("TSE1M_ROUTER_CAL", str(tmp_path / env))
    expect = str(tmp_path / want) if want else None
    assert tconfig.load_config().router_cal_path == expect
    assert jconfig.load_config().router_cal_path == expect
