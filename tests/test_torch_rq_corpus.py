"""The port's corpus layer against the JAX package's, on the CPU: the
corpus-analysis CSV writer (bytes of pandas' ``to_csv``), the corpus
grouping without pandas (the synthetic CSVs and a hand-written one with
the time and number forms pandas coerces), the G4 pre/post windows and the
RQ4b coverage deltas, field by field, and the per-project ``segment``
views they read.  Tolerance: exact."""

import importlib.util
import os

import numpy as np
import pandas as pd
import pytest

from tse1m_tpu.analysis import corpus as jcorpus
from tse1m_tpu.analysis import rq4b as jrq4b
from tse1m_tpu.config import Config as JConfig
from tse1m_tpu.data import columnar as jcol
from tse1m_tpu.data import synth as jsynth
from tse1m_tpu.db.connection import DB
from tse1m_tpu_torch.analysis import corpus as tcorpus
from tse1m_tpu_torch.analysis import rq4b as trq4b
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data import columnar as tcol
from tse1m_tpu_torch.data import synth as tsynth
from tse1m_tpu_torch.db import connect

_GEN = os.path.join(os.path.dirname(__file__), "goldens",
                    "generate_goldens.py")
_spec = importlib.util.spec_from_file_location("generate_goldens", _GEN)
gen = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(gen)

# The golden study, the conftest study, and one with many G3/G4 projects.
SPECS = {"golden": gen.SPEC,
         "conftest": dict(n_projects=16, days=420, seed=7),
         "late_corpus": dict(n_projects=40, days=380, seed=5,
                             corpus_fractions=(0.1, 0.2, 0.3, 0.4))}

HAND_CSV = """\
project_name,is_Corpus,corpus_commit_time,corpus_merged_time,\
project_creation_time,time_elapsed_seconds,merged_time_elapsed_seconds
pa,True,2023-06-30T19:51:39,,2023-06-01 00:00:00,0.0,
pb,True,2023-06-30T19:51:39+09:00,,2023-06-01 00:00:00,864000,
pc,True,2023-06-30T19:51:39Z,,2023-06-01 00:00:00,100.5,
pd,True,2023-06-30 19:51:39.123456789,,2023-06-01 00:00:00,700000,
pe,True,not a time,,2023-06-01 00:00:00,900000,
pf,False,,,2023-06-01 00:00:00,,
pg,False,2023-06-30 10:00:00,,2023-06-01 00:00:00,abc,
ph,True,2023-06-30 10:00:00.5-05:30,,2023-06-01 00:00:00,1e6,

pa,True,2023-07-02 01:02:03,,2023-06-01 00:00:00,604800,
px,True,2023-07-02 01:02:03,,2023-06-01 00:00:00,0,
pi,True,2023-02-30 00:00:00,,2023-06-01 00:00:00,-5,
pj,True,2023-06-30 24:00:00,,2023-06-01 00:00:00,NaN,
pk,True, 2023-06-30 7:05 ,,2023-06-01 00:00:00,inf,
pl,True,2023-06-30,,2023-06-01 00:00:00,1_000,
pm,True,2023-06-30 01:00:00 UTC,,2023-06-01 00:00:00, 12 ,
pn,True,2023-06-30T01:00:00.25+0530,,2023-06-01 00:00:00,+5,
NA,True,2023-06-30 01:00:00,,2023-06-01 00:00:00,0,
"""
# Eligible: every row's project but px, plus 'pz', which has no row.
HAND_ELIGIBLE = {"pa", "pb", "pc", "pd", "pe", "pf", "pg", "ph", "pi", "pj",
                 "pk", "pl", "pm", "pn", "pz", "NA"}

TIMES = ["2023-06-30 19:51:39", "2023-06-30T19:51:39",
         "2023-06-30T19:51:39+09:00", "2023-06-30T19:51:39Z",
         "2023-06-30 19:51:39.123456789", "2023-06-30 19:51:39.5",
         "2023-06-30", "2023-06-30 19:51", "2023-06-30T19:51:39.25-05:30",
         "2023-06-30T19:51:39+0900", "2023-06-30 19:51:39 +09:00",
         " 2023-06-30 19:51:39", "2023-06-30 19:51:39 UTC",
         "2023-06-30 7:05:03", "1969-12-31 23:59:59.999",
         "2024-02-29 12:00:00", "not a date", "", "2023-13-01",
         "2023-02-30 00:00:00", "2023-06-30 24:00:00",
         "2023-06-30 19:60:00", "2023-06-30 19:51:61"]
NUMBERS = ["12", "1e5", " 7 ", "inf", "-inf", "nan", "1_000", "0x10",
           "abc", "", "+5", ".5", "5.", "1,5", "-0.0", "417099.67179306684"]


@pytest.fixture(scope="module", params=list(SPECS))
def studies(request):
    spec = SPECS[request.param]
    return (request.param, jsynth.generate_study(jsynth.SynthSpec(**spec)),
            tsynth.generate_study(tsynth.SynthSpec(**spec)))


def test_corpus_csv_bytes_equal_pandas(studies, tmp_path):
    _, jstudy, tstudy = studies
    want, got = tmp_path / "pandas.csv", tmp_path / "sub" / "port.csv"
    jstudy.corpus_analysis.to_csv(want, index=False)
    tstudy.write_corpus_csv(str(got))
    assert got.read_bytes() == want.read_bytes()


@pytest.mark.parametrize("text", TIMES)
def test_parse_time_matches_pandas(text):
    t = pd.to_datetime(pd.Series([text], dtype=object), errors="coerce",
                       utc=True, format="mixed")[0]
    assert tcorpus.parse_time_ns(text) == (None if pd.isna(t) else t.value)


@pytest.mark.parametrize("text", NUMBERS)
def test_parse_number_matches_pandas(text):
    """NaN where pandas gives NaN, else the same number: to 2 units in the
    last place, since pandas' fast string-to-double parser is not
    correctly rounded (417099.67179306684 reads as 417099.6717930669)."""
    want = pd.to_numeric(pd.Series([text, "x"], dtype=object),
                         errors="coerce")[0]
    got = tcorpus.parse_number(text)
    if np.isnan(want) or np.isinf(want):
        assert got == want or (np.isnan(got) and np.isnan(want))
    else:
        assert abs(got - want) <= 2 * np.spacing(abs(want))


def _assert_groups_equal(got, want) -> None:
    assert got.groups == want.groups
    assert got.corpus_time_ns == want.corpus_time_ns
    index = {p: i for i, p in enumerate(sorted(
        set().union(*want.groups.values())))}
    for key in want.groups:
        np.testing.assert_array_equal(got.indices(key, index),
                                      want.indices(key, index))


@pytest.mark.parametrize("days_threshold", (1, 7, 30))
def test_load_corpus_groups_matches_jax_on_the_synthetic_csv(
        studies, tmp_path, days_threshold):
    _, jstudy, tstudy = studies
    path = str(tmp_path / "corpus.csv")
    tstudy.write_corpus_csv(path)
    names = list(tstudy.corpus_analysis["project_name"])
    for eligible in (set(names), set(names[::2]) | {"absent"}):
        _assert_groups_equal(
            tcorpus.load_corpus_groups(path, eligible, days_threshold),
            jcorpus.load_corpus_groups(path, eligible, days_threshold))


@pytest.mark.parametrize("days_threshold", (1, 7, 30))
def test_load_corpus_groups_matches_jax_on_a_hand_written_csv(
        tmp_path, days_threshold):
    path = tmp_path / "hand.csv"
    path.write_text(HAND_CSV)
    got = tcorpus.load_corpus_groups(str(path), HAND_ELIGIBLE,
                                     days_threshold)
    _assert_groups_equal(got, jcorpus.load_corpus_groups(
        str(path), HAND_ELIGIBLE, days_threshold))
    # The cases the CSV holds: a missing eligible project, the non-numbers
    # and the project named as pandas' missing marker are G1, the
    # ineligible row is nowhere, the duplicated project is in both of its
    # groups with its later row's time.
    assert {"pz", "pf", "pg", "pj", "pl", "NA"} == got.groups["group1"]
    assert "px" not in set().union(*got.groups.values())
    assert "pa" in got.groups["group2"]
    assert "pe" not in got.corpus_time_ns and "pi" not in got.corpus_time_ns
    assert got.corpus_time_ns["pa"] == tcorpus.parse_time_ns(
        "2023-07-02 01:02:03")


def test_missing_corpus_csv_exits_with_the_fix(tmp_path):
    path = str(tmp_path / "absent.csv")
    with pytest.raises(SystemExit, match="python -m tse1m_tpu_torch synth"):
        tcorpus.load_corpus_groups(path, {"p"})
    with pytest.raises(SystemExit, match=f"not found at {path}"):
        tcorpus.load_corpus_groups(path, {"p"})


@pytest.fixture(scope="module")
def arrays(studies, tmp_path_factory):
    """Each package's extraction of the same sqlite file, and its corpus
    CSV from the port's writer."""
    name, _, tstudy = studies
    d = tmp_path_factory.mktemp(f"corpus_{name}")
    db_path, csv_path = str(d / "study.sqlite"), str(d / "corpus.csv")
    tstudy.to_db(db_path)
    tstudy.write_corpus_csv(csv_path)
    jdb = DB(config=JConfig(engine="sqlite", sqlite_path=db_path)).connect()
    want = jcol.StudyArrays.from_db(jdb, JConfig(engine="sqlite",
                                                 sqlite_path=db_path))
    jdb.closeConnection()
    with connect(db_path) as db:
        got = tcol.StudyArrays.from_db(db, Config(sqlite_path=db_path))
    return got, want, csv_path


def _cell(v):
    return list(v.materialize()) if hasattr(v, "materialize") else v


@pytest.mark.parametrize("table", ("fuzz", "covb", "issues", "cov"))
def test_segment_matches_jax(arrays, table):
    got, want, _ = arrays
    assert got.project_index() == want.project_index()
    for p in range(want.n_projects):
        g = getattr(got, table).segment(p)
        w = getattr(want, table).segment(p)
        assert list(g) == list(w)
        for col in w:
            wv = _cell(w[col])
            np.testing.assert_array_equal(np.asarray(_cell(g[col]),
                                                     dtype=object),
                                          np.asarray(wv, dtype=object),
                                          err_msg=f"{table}.{col} p={p}")


def _groups(arrays, days_threshold=7):
    got, want, csv_path = arrays
    eligible = set(want.projects)
    return (tcorpus.load_corpus_groups(csv_path, eligible, days_threshold),
            jcorpus.load_corpus_groups(csv_path, eligible, days_threshold))


@pytest.mark.parametrize("n_windows", (1, 3, 7))
def test_g4_prepost_matches_jax(arrays, n_windows):
    got_arrays, want_arrays, _ = arrays
    tg, jg = _groups(arrays)
    lim = int(np.datetime64("2025-01-08", "ns").astype(np.int64))
    got = tcorpus.g4_prepost(got_arrays, lim, tg, n_windows)
    want = jcorpus.g4_prepost(want_arrays, lim, jg, n_windows)
    np.testing.assert_array_equal(got.steps, want.steps)
    np.testing.assert_array_equal(got.detect, want.detect)
    assert got.detect.dtype == want.detect.dtype
    assert got.kept_projects == want.kept_projects
    assert got.missing_pre == want.missing_pre
    assert got.intro_iteration == want.intro_iteration
    assert got.transition_counts() == want.transition_counts()
    np.testing.assert_array_equal(got.step_rates(), want.step_rates())


@pytest.mark.parametrize("n_iters", (1, 3, 7))
def test_coverage_deltas_match_jax(arrays, n_iters):
    got_arrays, want_arrays, _ = arrays
    tg, jg = _groups(arrays)
    got = trq4b.coverage_deltas(got_arrays, tg, n_iters)
    want = jrq4b.coverage_deltas(want_arrays, jg, n_iters)
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            assert g == w, key
