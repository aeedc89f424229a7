"""The port's RQ reductions over a mesh on the CPU: every function of
``tse1m_tpu_torch/parallel/rq_mesh.py`` and ``TorchBackend(mesh=)`` over
gloo worlds of 3 and 4 ranks, against the JAX package's ``rq_mesh`` and
``JaxBackend(mesh=)`` on as many forced CPU devices, and against the
port's single-device results.

Each world is spawned once for the file; its workers run ``WORKER``
(imports only ``tse1m_tpu_torch``) over the inputs the parent saved (the
cases of tests/test_mesh_rq.py:55-300: NaN-heavy, adversarial columns,
+inf routed to the host, -inf on the ranks, empty inputs, a scalar q,
query counts that do not divide the world) and over the conftest study,
extracted by the port from its sqlite file, and write every result as
``.npz``.  Tolerance: exact (bit for bit) for every result against the
port's single-device one and against JAX's, except the float32 means and
Spearman correlations against JAX's: those sum in another order on the
two packages' single devices already, and are held within rtol = atol =
2e-5, the repo's cross-engine tolerance (tests/test_torch_rq_backend.py)."""

import json
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tse1m_tpu.backend.jax_backend import JaxBackend
from tse1m_tpu.config import Config as JConfig
from tse1m_tpu.data.columnar import StudyArrays as JStudyArrays
from tse1m_tpu.data.columnar import ns_to_device_pair
from tse1m_tpu.backend.jax_backend import masked_csr
from tse1m_tpu.ops.segment import masked_percentile as j_masked_percentile
from tse1m_tpu.parallel import rq_mesh as jrq
from tse1m_tpu_torch.backend import TorchBackend
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data.columnar import StudyArrays
from tse1m_tpu_torch.db import connect
from tse1m_tpu_torch.ops import segment as tseg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (3, 4)
WORLD_TIMEOUT_S = 240
LIMIT = "2025-01-08"
TOL = dict(rtol=2e-5, atol=2e-5, equal_nan=True)
Q5 = np.array([5.0, 25.0, 50.0, 75.0, 95.0], dtype=np.float32)
Q_GRID = np.array([0.0, 25.0, 50.0, 75.0, 90.0, 100.0])
RQS = ("rq1", "rq2cp", "rq2tr", "rq3", "rq4a", "rq4b")
# Float32 sums in another order than JAX's (see the module docstring).
CLOSE = {"mean", "spearman", "rq2tr.spearman", "rq2tr.mean"}

WORKER = r'''
import json, os, sys
import numpy as np
import torch

torch.set_num_threads(1)
from tse1m_tpu_torch.backend import TorchBackend
from tse1m_tpu_torch.config import Config
from tse1m_tpu_torch.data.columnar import StudyArrays
from tse1m_tpu_torch.db import connect
from tse1m_tpu_torch.parallel import multihost, rq_mesh

a = json.loads(sys.argv[1])
os.environ["TSE1M_NUM_PROCESSES"] = str(a["world"])
os.environ["TSE1M_PROCESS_ID"] = str(a["rank"])
assert multihost.initialize_from_env(device="cpu", init_method=a["init"])
mesh = rq_mesh.auto_mesh()
assert mesh is not None and mesh.size == a["world"]
x = dict(np.load(os.path.join(a["out"], "inputs.npz")))
res = {}
res["pct"] = rq_mesh.percentile_by_session_mesh(x["pct_cols"], x["pct_mask"],
                                                x["q5"], mesh)
res["pct_scalar"] = rq_mesh.percentile_by_session_mesh(
    x["pct_cols"], x["pct_mask"], 50.0, mesh)
res["mean"] = rq_mesh.mean_by_session_mesh(x["mean_cols"], x["mean_mask"],
                                           mesh)
res["counts"] = rq_mesh.counts_by_project_psum(x["counts_mask"], mesh)
res["spearman"] = rq_mesh.spearman_by_project_mesh(x["sp_matrix"],
                                                   x["sp_mask"], mesh)
for name in ("nan_heavy", "adversarial", "posinf", "neginf"):
    res["nanpct_" + name] = rq_mesh.nanpercentile_by_session_mesh(
        x["sub_" + name], x["q_grid"], mesh)
res["nanpct_scalar"] = rq_mesh.nanpercentile_by_session_mesh(
    x["sub_scalar"], 50.0, mesh)
res["nanpct_empty_rows"] = rq_mesh.nanpercentile_by_session_mesh(
    np.empty((0, 5)), x["q_grid"], mesh)
res["nanpct_empty_cols"] = rq_mesh.nanpercentile_by_session_mesh(
    np.empty((4, 0)), x["q_grid"], mesh)
for side in ("left", "right"):
    res["ss_" + side] = rq_mesh.segment_searchsorted_mesh(
        mesh, x["ss_vals"], x["ss_off"], x["ss_q"], x["ss_seg"], side,
        x["ss_vals_lo"], x["ss_q_lo"])
res["ss_empty"] = rq_mesh.segment_searchsorted_mesh(
    mesh, x["ss_vals"], x["ss_off"], np.empty(0, np.int32),
    np.empty(0, np.int32), "left", x["ss_vals_lo"], np.empty(0, np.int32))
it, link, det = rq_mesh.rq1_kernel_mesh(
    mesh, x["r1_fs"], x["r1_fns"], x["r1_foff"], x["r1_oks"], x["r1_okns"],
    x["r1_okoff"], x["r1_okidx"], x["r1_is"], x["r1_ins"], x["r1_seg"],
    int(x["r1_P"]), int(x["r1_max_iter"]))
res.update(rq1_it=it, rq1_link=link, rq1_det=det)

cfg = Config(sqlite_path=a["db"], limit_date=a["limit"])
with connect(cfg.sqlite_path) as db:
    arrays = StudyArrays.from_db(db, cfg)
be = TorchBackend("cpu")
assert be._mesh is not None
limit_ns = int(np.datetime64(a["limit"], "ns").astype(np.int64))
P = arrays.n_projects
g1, g2 = np.arange(0, P, 2), np.arange(1, P, 2)
got = {
    "rq1": be.rq1_detection(arrays, limit_ns, 1),
    "rq2cp": be.rq2_change_points(arrays, limit_ns),
    "rq2tr": be.rq2_trends(arrays, limit_ns),
    "rq3": be.rq3_coverage_at_detection(arrays, limit_ns),
    "rq4a": be.rq4a_detection_trend(arrays, limit_ns, g1, g2, 1),
    "rq4b": be.rq4b_group_trends(arrays, limit_ns, g1, g2),
}
suite = be.rq_suite(arrays, limit_ns, 1, g1, g2)
for rq, r in got.items():
    for f in r.__dataclass_fields__:
        v = getattr(r, f)
        if isinstance(v, np.ndarray):
            res[f"{rq}.{f}"] = v
            res[f"suite.{rq}.{f}"] = getattr(suite[rq], f)
np.savez(os.path.join(a["out"], f"out.r{a['rank']}.npz"), **res)
multihost.shutdown()
'''


def ragged(rng, rows, cols, frac_valid=0.7):
    x = rng.normal(50.0, 20.0, size=(rows, cols)).astype(np.float32)
    mask = rng.random((rows, cols)) < frac_valid
    mask[rng.integers(0, rows)] = False
    if rows > 1:
        mask[rng.integers(0, rows)] = True
    return x, mask


def _inputs(jarrays) -> dict:
    x = {"q5": Q5, "q_grid": Q_GRID}
    x["pct_cols"], x["pct_mask"] = ragged(np.random.default_rng(11), 37, 16)
    x["mean_cols"], x["mean_mask"] = ragged(np.random.default_rng(12), 41, 9)
    x["counts_mask"] = np.random.default_rng(13).random((29, 14)) < 0.4
    x["sp_matrix"], x["sp_mask"] = ragged(np.random.default_rng(14), 27, 40)
    rng = np.random.default_rng(15)
    sub = rng.normal(0.0, 100.0, size=(23, 53))
    sub[rng.random(sub.shape) < 0.5] = np.nan
    x["sub_nan_heavy"] = sub
    rng = np.random.default_rng(16)
    sub = rng.normal(0.0, 1.0, size=(7, 19))
    sub[:, 0] = np.nan
    sub[1:, 1] = np.nan
    sub[:, 2] = 3.25
    sub[:3, 3] = 1e-300
    sub[3:, 3] = np.nan
    x["sub_adversarial"] = sub
    rng = np.random.default_rng(17)
    sub = rng.normal(0.0, 1.0, size=(5, 11))
    sub[2, 4] = np.inf
    sub[0, 7] = np.nan
    x["sub_posinf"] = sub
    rng = np.random.default_rng(18)
    sub = rng.normal(0.0, 1.0, size=(6, 13))
    sub[1, 3] = -np.inf
    sub[4, 9] = np.nan
    x["sub_neginf"] = sub
    rng = np.random.default_rng(19)
    sub = rng.normal(size=(9, 10))
    sub[rng.random(sub.shape) < 0.3] = np.nan
    x["sub_scalar"] = sub
    rng = np.random.default_rng(33)
    P = 5
    counts = rng.integers(0, 40, size=P)
    off = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    vals = np.sort(rng.integers(0, 1000, size=off[-1]).astype(np.int32))
    vals = np.concatenate([np.sort(vals[a:b]) for a, b in zip(off, off[1:])])
    vals_lo = rng.integers(0, 10, size=off[-1]).astype(np.int32)
    vals_lo = np.concatenate(
        [np.sort(vals_lo[a:b]) for a, b in zip(off, off[1:])])
    q = 101
    x.update(ss_vals=vals, ss_off=off, ss_vals_lo=vals_lo,
             ss_seg=rng.integers(0, P, size=q).astype(np.int32),
             ss_q=rng.integers(0, 1000, size=q).astype(np.int32),
             ss_q_lo=rng.integers(0, 10, size=q).astype(np.int32))
    # RQ1's kernel inputs in the JAX package's two-lane form.
    limit_ns = _ns(LIMIT)
    t = jarrays.fuzz.columns["time_ns"]
    fs, fns = ns_to_device_pair(t)
    ok_pos, ok_off = masked_csr(jarrays.fuzz.offsets,
                                jarrays.fuzz.columns["ok"] & (t < limit_ns))
    is_, ins = ns_to_device_pair(jarrays.issues.columns["time_ns"])
    x.update(r1_fs=fs, r1_fns=fns, r1_foff=jarrays.fuzz.offsets,
             r1_oks=fs[ok_pos], r1_okns=fns[ok_pos], r1_okoff=ok_off,
             r1_okidx=ok_pos, r1_is=is_, r1_ins=ins,
             r1_seg=np.repeat(np.arange(jarrays.n_projects),
                              jarrays.issues.counts()),
             r1_P=np.int64(jarrays.n_projects),
             r1_max_iter=np.int64(jarrays.fuzz.counts().max()))
    return x


def _ns(date: str) -> int:
    return int(np.datetime64(date, "ns").astype(np.int64))


def _jmesh(world: int):
    return jax.sharding.Mesh(np.array(jax.devices()[:world]), ("data",))


@pytest.fixture(scope="module")
def jarrays(study_db):
    cfg = JConfig(engine="sqlite", sqlite_path=study_db.config.sqlite_path,
                  limit_date=LIMIT)
    return JStudyArrays.from_db(study_db, cfg)


@pytest.fixture(scope="module")
def tarrays(study_db):
    cfg = Config(sqlite_path=study_db.config.sqlite_path, limit_date=LIMIT)
    with connect(cfg.sqlite_path) as db:
        return StudyArrays.from_db(db, cfg)


@pytest.fixture(scope="module")
def inputs(jarrays):
    return _inputs(jarrays)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory, study_db, inputs):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    out = {}
    for world in WORLDS:
        tmp = tmp_path_factory.mktemp(f"meshrq{world}")
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        args = {"world": world, "init": f"file://{tmp}/rendezvous",
                "out": str(tmp), "db": study_db.config.sqlite_path,
                "limit": LIMIT}
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER, json.dumps(dict(args, rank=r))],
            cwd=str(tmp), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(world)]
        logs = []
        for p in procs:
            try:
                logs.append((p.communicate(timeout=WORLD_TIMEOUT_S)[0],
                             p.returncode))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        assert all(rc == 0 for _, rc in logs), [t[-3000:] for t, _ in logs]
        out[world] = [dict(np.load(os.path.join(tmp, f"out.r{r}.npz"),
                                   allow_pickle=False))
                      for r in range(world)]
    return out


def _same(got, want, key: str, close: bool = False) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (key, got.shape, want.shape)
    if close:
        np.testing.assert_allclose(got, want, err_msg=key, **TOL)
    else:
        assert got.dtype == want.dtype, (key, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=key)


def _nanpct(sub, q):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return np.nanpercentile(sub, np.atleast_1d(q), axis=0)


@pytest.mark.parametrize("world", WORLDS)
def test_rq_mesh_functions_equal_jax(worlds, inputs, world):
    x = inputs
    m = _jmesh(world)
    want = {
        "pct": jrq.percentile_by_session_mesh(x["pct_cols"], x["pct_mask"],
                                              x["q5"], m),
        "pct_scalar": jrq.percentile_by_session_mesh(
            x["pct_cols"], x["pct_mask"], 50.0, m),
        "mean": jrq.mean_by_session_mesh(x["mean_cols"], x["mean_mask"], m),
        "counts": jrq.counts_by_project_psum(x["counts_mask"], m),
        "spearman": jrq.spearman_by_project_mesh(x["sp_matrix"],
                                                 x["sp_mask"], m),
        "nanpct_scalar": jrq.nanpercentile_by_session_mesh(
            x["sub_scalar"], 50.0, m),
        "nanpct_empty_rows": jrq.nanpercentile_by_session_mesh(
            np.empty((0, 5)), x["q_grid"], m),
        "nanpct_empty_cols": jrq.nanpercentile_by_session_mesh(
            np.empty((4, 0)), x["q_grid"], m),
        "ss_empty": jrq.segment_searchsorted_mesh(
            m, x["ss_vals"], x["ss_off"], np.empty(0, np.int32),
            np.empty(0, np.int32), "left", x["ss_vals_lo"],
            np.empty(0, np.int32)),
    }
    for name in ("nan_heavy", "adversarial", "posinf", "neginf"):
        want["nanpct_" + name] = jrq.nanpercentile_by_session_mesh(
            x["sub_" + name], x["q_grid"], m)
    for side in ("left", "right"):
        want["ss_" + side] = jrq.segment_searchsorted_mesh(
            m, x["ss_vals"], x["ss_off"], x["ss_q"], x["ss_seg"], side,
            x["ss_vals_lo"], x["ss_q_lo"])
    it, link, det = jrq.rq1_kernel_mesh(
        m, x["r1_fs"], x["r1_fns"], x["r1_foff"], x["r1_oks"], x["r1_okns"],
        x["r1_okoff"], x["r1_okidx"], x["r1_is"], x["r1_ins"], x["r1_seg"],
        n_projects=int(x["r1_P"]), max_iter=int(x["r1_max_iter"]))
    want.update(rq1_it=it, rq1_link=link, rq1_det=det)
    for res in worlds[world]:
        for key, w in want.items():
            _same(res[key], w, key, close=key in CLOSE)


@pytest.mark.parametrize("world", WORLDS)
def test_rq_mesh_functions_equal_single_device_and_oracles(worlds, inputs,
                                                           world):
    x = inputs
    pct = tseg.masked_percentile(torch.from_numpy(x["pct_cols"]),
                                 torch.from_numpy(x["pct_mask"]), x["q5"])
    jpct = np.asarray(j_masked_percentile(jnp.asarray(x["pct_cols"]),
                                          jnp.asarray(x["pct_mask"]),
                                          x["q5"]), dtype=np.float64)
    want = {
        "pct": jpct,
        "mean": tseg.masked_mean(torch.from_numpy(x["mean_cols"]),
                                 torch.from_numpy(x["mean_mask"])
                                 ).numpy().astype(np.float64),
        "counts": x["counts_mask"].sum(axis=0),
        "spearman": tseg.masked_spearman(torch.from_numpy(x["sp_matrix"]),
                                         torch.from_numpy(x["sp_mask"])
                                         ).numpy().astype(np.float64),
        "nanpct_scalar": _nanpct(x["sub_scalar"], 50.0),
        "nanpct_empty_cols": np.empty((Q_GRID.size, 0)),
    }
    for name in ("nan_heavy", "adversarial", "posinf", "neginf"):
        want["nanpct_" + name] = _nanpct(x["sub_" + name], x["q_grid"])
    key = lambda hi, lo: hi.astype(np.int64) * (1 << 32) + lo  # noqa: E731
    for side in ("left", "right"):
        want["ss_" + side] = tseg.segment_searchsorted(
            torch.from_numpy(key(x["ss_vals"], x["ss_vals_lo"])),
            torch.from_numpy(x["ss_off"]),
            torch.from_numpy(key(x["ss_q"], x["ss_q_lo"])),
            torch.from_numpy(x["ss_seg"].astype(np.int64)), side).numpy()
    # The port's eager masked_percentile rounds as JAX's does.
    np.testing.assert_allclose(pct.numpy(), jpct, **TOL)
    for res in worlds[world]:
        for k, w in want.items():
            _same(res[k], w, k)
        assert np.isnan(res["nanpct_empty_rows"]).all()
        assert res["nanpct_empty_rows"].shape == (Q_GRID.size, 5)
        assert res["ss_empty"].size == 0


@pytest.mark.parametrize("world", WORLDS)
def test_backend_on_a_mesh_equals_single_device_and_jax(worlds, jarrays,
                                                        tarrays, world):
    limit_ns = _ns(LIMIT)
    P = tarrays.n_projects
    g1, g2 = np.arange(0, P, 2), np.arange(1, P, 2)

    def calls(be, arrays):
        return {
            "rq1": be.rq1_detection(arrays, limit_ns, 1),
            "rq2cp": be.rq2_change_points(arrays, limit_ns),
            "rq2tr": be.rq2_trends(arrays, limit_ns),
            "rq3": be.rq3_coverage_at_detection(arrays, limit_ns),
            "rq4a": be.rq4a_detection_trend(arrays, limit_ns, g1, g2, 1),
            "rq4b": be.rq4b_group_trends(arrays, limit_ns, g1, g2),
        }

    single = calls(TorchBackend("cpu", mesh=None), tarrays)
    jax_mesh = calls(JaxBackend(mesh=_jmesh(world)), jarrays)
    for res in worlds[world]:
        for rq in RQS:
            for f in single[rq].__dataclass_fields__:
                one = getattr(single[rq], f)
                if not isinstance(one, np.ndarray):
                    continue
                key = f"{rq}.{f}"
                _same(res[key], one, key)
                _same(res["suite." + key], one, "suite." + key)
                _same(res[key], getattr(jax_mesh[rq], f), key,
                      close=key in CLOSE)


def test_backend_mesh_argument_checks():
    with pytest.raises(TypeError, match="parallel.Mesh"):
        TorchBackend("cpu", mesh=object())
    assert TorchBackend("cpu")._mesh is None  # no world started here
