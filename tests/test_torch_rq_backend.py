"""tse1m_tpu_torch's TorchBackend (on the CPU) against the JAX package's
JaxBackend(mesh=None) and PandasBackend on the conftest fixture study:
each of the six RQ methods at two cutoffs (RQ1 and RQ4a also at two
min_projects), the fused suite against the six single calls, degenerate
studies, and the per-study device cache.

Both backends read one extraction: the JAX package's, carried over by
``study_arrays_from_numpy``.  Every dataclass field is compared with its
numpy dtype.  Tolerance: exact for integer fields and every field of
RQ2cp, RQ3, RQ4a and RQ4b and the RQ2 percentiles; Spearman and the mean
(float32 sums in another order) within rtol = atol = 2e-5, the repo's
cross-engine tolerance (tests/test_value_goldens.py:33-40), as are the
RQ2 percentiles against the pandas backend's float64 ones."""

import numpy as np
import pytest

from tse1m_tpu.backend.jax_backend import JaxBackend
from tse1m_tpu.backend.pandas_backend import PandasBackend
from tse1m_tpu.config import Config as JConfig
from tse1m_tpu.data.columnar import StudyArrays as JStudyArrays
from tse1m_tpu_torch.backend import TorchBackend
from tse1m_tpu_torch.backend import torch_backend as tb
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data.columnar import StudyArrays, study_arrays_from_numpy
from tse1m_tpu_torch.db import connect

CUTOFFS = ("2025-01-08", "2024-03-15")
RQS = ("rq1", "rq2cp", "rq2tr", "rq3", "rq4a", "rq4b")
# Float fields from float32 device sums: tolerance, not exact.
CLOSE = {("rq2tr", "spearman"), ("rq2tr", "mean")}
TOL = dict(rtol=2e-5, atol=2e-5, equal_nan=True)


def _ns(date: str) -> int:
    return int(np.datetime64(date, "ns").astype(np.int64))


def _fields(arrays) -> dict:
    def plain(col):
        return col.materialize() if hasattr(col, "materialize") else col
    out = {"projects": arrays.projects}
    for t in ("fuzz", "covb", "issues", "cov"):
        seg = getattr(arrays, t)
        out[t] = {"offsets": seg.offsets,
                  "columns": {k: plain(v) for k, v in seg.columns.items()}}
    return out


@pytest.fixture(scope="module")
def jarrays(study_db, study_cfg):
    return JStudyArrays.from_db(study_db, study_cfg)


@pytest.fixture(scope="module")
def tarrays(jarrays):
    return study_arrays_from_numpy(_fields(jarrays))


@pytest.fixture(scope="module")
def groups(jarrays):
    P = jarrays.n_projects
    return np.arange(0, P, 2), np.arange(1, P, 2)


def _call(backend, arrays, rq, limit_ns, min_projects, groups):
    g1, g2 = groups
    return {
        "rq1": lambda: backend.rq1_detection(arrays, limit_ns, min_projects),
        "rq2cp": lambda: backend.rq2_change_points(arrays, limit_ns),
        "rq2tr": lambda: backend.rq2_trends(arrays, limit_ns),
        "rq3": lambda: backend.rq3_coverage_at_detection(arrays, limit_ns),
        "rq4a": lambda: backend.rq4a_detection_trend(arrays, limit_ns, g1, g2,
                                                     min_projects),
        "rq4b": lambda: backend.rq4b_group_trends(arrays, limit_ns, g1, g2),
    }[rq]()


def assert_result_equal(got, want, rq: str, pandas: bool = False):
    """Every field with its dtype; exact unless (rq, field) is in CLOSE
    (and the RQ2 percentiles against pandas)."""
    assert type(got).__name__ == type(want).__name__, rq
    for f in want.__dataclass_fields__:
        x, y = getattr(got, f), getattr(want, f)
        if not isinstance(y, np.ndarray):
            assert x == y, f"{rq}.{f}"
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, (
            f"{rq}.{f}", x.dtype, y.dtype, x.shape, y.shape)
        close = (rq, f) in CLOSE or (pandas and (rq, f) == ("rq2tr",
                                                            "percentiles"))
        if close:
            np.testing.assert_allclose(x, y, err_msg=f"{rq}.{f}", **TOL)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f"{rq}.{f}")


_MEMO: dict = {}


def _reference(name, arrays, rq, limit_ns, min_projects, groups):
    """JAX and pandas results, each computed once per argument set."""
    key = (name, rq, limit_ns, min_projects)
    if key not in _MEMO:
        backend = JaxBackend(mesh=None) if name == "jax" else PandasBackend()
        _MEMO[key] = _call(backend, arrays, rq, limit_ns, min_projects,
                           groups)
    return _MEMO[key]


CASES = [(rq, cut, mp) for rq in RQS for cut in CUTOFFS
         for mp in ((1, 4) if rq in ("rq1", "rq4a") else (1,))]


@pytest.mark.parametrize("rq,cutoff,min_projects", CASES)
def test_rq_matches_jax_and_pandas(jarrays, tarrays, groups, rq, cutoff,
                                   min_projects):
    limit_ns = _ns(cutoff)
    got = _call(TorchBackend("cpu"), tarrays, rq, limit_ns, min_projects,
                groups)
    assert_result_equal(got, _reference("jax", jarrays, rq, limit_ns,
                                        min_projects, groups), rq)
    assert_result_equal(got, _reference("pandas", jarrays, rq, limit_ns,
                                        min_projects, groups), rq,
                        pandas=True)


@pytest.mark.parametrize("cutoff", CUTOFFS)
def test_fused_suite_matches_single_calls_jax_and_pandas(jarrays, tarrays,
                                                          groups, cutoff):
    """The fused suite equals the six single calls field for field, as
    tests/test_rq_suite.py:40 holds JAX's, and JAX's and pandas' suites."""
    limit_ns = _ns(cutoff)
    g1, g2 = groups
    be = TorchBackend("cpu")
    fused = be.rq_suite(tarrays, limit_ns, 1, g1, g2)
    assert set(fused) == set(RQS)
    want = JaxBackend(mesh=None).rq_suite(jarrays, limit_ns, 1, g1, g2)
    host = PandasBackend().rq_suite(jarrays, limit_ns, 1, g1, g2)
    for rq in RQS:
        assert_result_equal(fused[rq], host[rq], rq, pandas=True)
        single = _call(be, tarrays, rq, limit_ns, 1, groups)
        for f in single.__dataclass_fields__:
            x, y = getattr(fused[rq], f), getattr(single, f)
            if isinstance(y, np.ndarray):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y, err_msg=f"{rq}.{f}")
            else:
                assert x == y
        assert_result_equal(fused[rq], want[rq], rq)


def test_port_extraction_gives_the_same_results(study_cfg, tarrays, groups):
    """The port's own from_db on the same file feeds TorchBackend to the
    same suite as the JAX extraction."""
    cfg = Config(sqlite_path=study_cfg.sqlite_path,
                 limit_date=study_cfg.limit_date)
    with connect(cfg.sqlite_path) as db:
        own = StudyArrays.from_db(db, cfg)
    limit_ns = _ns(CUTOFFS[0])
    be = TorchBackend("cpu")
    got = be.rq_suite(own, limit_ns, 1, *groups)
    want = be.rq_suite(tarrays, limit_ns, 1, *groups)
    for rq in RQS:
        assert_result_equal(got[rq], want[rq], rq)


@pytest.mark.parametrize("case", ["no_groups", "empty_study", "no_issues"])
def test_degenerate_suite_matches_jax(study_db, jarrays, groups, case):
    """Shapes the fused pass cannot take go to the six single calls, whose
    guards give JAX's results."""
    g1, g2 = groups
    arrays = jarrays
    if case == "no_groups":
        g1 = g2 = np.empty(0, np.int64)
    elif case == "empty_study":
        cfg = JConfig(engine="sqlite", sqlite_path=study_db.config.sqlite_path,
                      min_coverage_days=10_000)
        arrays = JStudyArrays.from_db(study_db, cfg)
        g1 = g2 = np.empty(0, np.int64)
    else:
        cfg = JConfig(engine="sqlite", sqlite_path=study_db.config.sqlite_path,
                      limit_date="2023-01-01", min_coverage_days=0)
        arrays = JStudyArrays.from_db(study_db, cfg, projects=jarrays.projects)
        assert len(arrays.issues) == 0 and len(arrays.fuzz) > 0
    limit_ns = _ns(CUTOFFS[0])
    got = TorchBackend("cpu").rq_suite(
        study_arrays_from_numpy(_fields(arrays)), limit_ns, 1, g1, g2)
    want = JaxBackend(mesh=None).rq_suite(arrays, limit_ns, 1, g1, g2)
    for rq in RQS:
        assert_result_equal(got[rq], want[rq], rq)


def test_device_cache_reuses_and_evicts(jarrays, groups):
    """A second call at one cutoff adds no cache entry; a third cutoff
    evicts the first cutoff's entries (two stay resident); the
    cutoff-independent arrays stay."""
    arrays = study_arrays_from_numpy(_fields(jarrays))
    be = TorchBackend("cpu")
    a, b, c = (_ns(d) for d in ("2025-01-08", "2024-06-01", "2024-03-15"))
    be.rq_suite(arrays, a, 1, *groups)
    cache = tb._study_cache(arrays, be.device)
    keys = set(cache)
    assert any(k.endswith(f":{a}") for k in keys) and "fuzz" in keys
    be.rq_suite(arrays, a, 1, *groups)
    be.rq1_detection(arrays, a, 1)
    assert set(cache) == keys
    be.rq_suite(arrays, b, 1, *groups)
    assert any(k.endswith(f":{a}") for k in cache)
    be.rq_suite(arrays, c, 1, *groups)
    assert not any(k.endswith(f":{a}") for k in cache)
    assert any(k.endswith(f":{b}") for k in cache)
    assert any(k.endswith(f":{c}") for k in cache)
    assert {"fuzz", "issues", "cov_valid"} <= set(cache)
    assert cache["_limits"] == [b, c]
    # Keyed by device, under the port's own attribute.
    assert set(arrays._torch_dev_cache["devices"]) == {"cpu"}
    assert not hasattr(arrays, "_jax_dev_cache")


def test_shallow_copy_with_a_new_table_gets_its_own_cache(jarrays):
    import copy

    arrays = study_arrays_from_numpy(_fields(jarrays))
    be = TorchBackend("cpu")
    limit_ns = _ns(CUTOFFS[0])
    be.rq1_detection(arrays, limit_ns, 1)
    twin = copy.copy(arrays)
    twin.issues = copy.copy(arrays.issues)
    twin.issues._cache_token = None
    be.rq1_detection(twin, limit_ns, 1)
    assert tb._study_cache(twin, be.device) is not tb._study_cache(
        arrays, be.device)


def test_backend_defaults_to_the_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchBackend()
    assert TorchBackend("cpu").name == "torch_cuda"
