"""tse1m_tpu_torch ``cluster_sessions`` (on the CPU, through the kernels'
plain versions) against the JAX package's, whose Pallas kernels run in
interpret mode: the plain wire and wire v3 (the host prefilter, the
base-delta lane, the rANS lanes) under each signature scheme, the wire
plan, the levers that are not ported, the copied host modules and the
command line.  Tolerance: exact labels and exact wire accounting."""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from tse1m_tpu.cluster import encode as jenc
from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.cluster import schemes as jschemes
from tse1m_tpu.cluster.metrics import adjusted_rand_index as j_ari
from tse1m_tpu.data.synth import synth_session_hitcounts as j_hitcounts
from tse1m_tpu.data.synth import synth_session_sets as j_synth
from tse1m_tpu.utils import calibration as jcal
from tse1m_tpu_torch import adjusted_rand_index, synth_session_sets
from tse1m_tpu_torch.__main__ import main as cli_main
from tse1m_tpu_torch.cluster import encode as tenc
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.cluster import schemes as tschemes
from tse1m_tpu_torch.cluster.kernels import cminhash as kcm
from tse1m_tpu_torch.cluster.kernels import minhash as kmod
from tse1m_tpu_torch.device import u32_tensor
from tse1m_tpu_torch.utils import calibration as tcal

PLAIN_WIRE = dict(encoding="pack24", entropy="off", prefilter="off")


@pytest.fixture(autouse=True)
def _no_calibration(monkeypatch):
    # The JAX pipeline's calibrated quant floor and chunk clamp read nothing.
    monkeypatch.setenv("TSE1M_ROUTER_CAL", "")


@pytest.fixture(scope="module")
def sets():
    return j_synth(2000, set_size=32, seed=3)


def _both(items, wire=PLAIN_WIRE, **kw):
    """(JAX labels, port labels, port last_run_info) for one parameter set."""
    want = jpipe.cluster_sessions(items, jpipe.ClusterParams(
        use_pallas="interpret", block_n=128, **wire, **kw))
    got = tpipe.cluster_sessions(items, tpipe.ClusterParams(
        block_n=128, **wire, **kw), device="cpu")
    return want, got, dict(tpipe.last_run_info)


# The wire accounting the port must share with the JAX package.
INFO_KEYS = ("encoding", "n_full", "n_delta", "chunk_bits", "wire_bytes",
             "wire_quant_bits", "prefilter_rows_dropped", "entropy_saved_mb",
             "prefilter_saved_mb", "wire_v3_saved_mb", "wire_version")


def _assert_info_matches_jax(info):
    for key in INFO_KEYS:
        assert info.get(key) == jpipe.last_run_info.get(key), key


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("quant_bits", [10, -1])
@pytest.mark.parametrize("entropy", ["off", "auto", "force"])
@pytest.mark.parametrize("prefilter", ["on", "off"])
def test_delta_wire_matches_jax(sets, prefilter, entropy, quant_bits,
                                chunks):
    """encoding="delta": labels, lanes and wire bytes equal JAX's under
    every wire v3 lever; force codes every lane and chunk, the 24-bit
    full lane as three byte planes with the chunk's offset."""
    items, _ = sets
    items = items[:1200]
    want, got, info = _both(
        items, wire=dict(encoding="delta", prefilter=prefilter,
                         entropy=entropy),
        wire_quant_bits=quant_bits, h2d_chunks=chunks)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    _assert_info_matches_jax(info)
    assert info["encoding"] == "delta" and info["n_delta"] > 0
    assert (info["prefilter_rows_dropped"] > 0) == (prefilter == "on")
    assert (len(info["chunk_bits"]) > 1) == (chunks == 4
                                             and info["n_full"] >= 256)
    assert ("stage_entropy_s" in info["stages"]) == (entropy != "off")
    assert ("stage_prefilter_s" in info["stages"]) == (prefilter == "on")


def test_default_params_engage_wire_v3_as_jax(sets, monkeypatch):
    """Default ClusterParams with the auto size gate lowered in both
    packages: the prefilter, the delta lane, 10-bit quantization and the
    rANS gate engage at a few thousand rows, as at 64 MiB."""
    items, truth = sets
    for mod in (jpipe, jenc, tpipe, tenc):
        monkeypatch.setattr(mod, "_AUTO_MIN_BYTES", 4096)
    want = jpipe.cluster_sessions(items, jpipe.ClusterParams(
        use_pallas="interpret"))
    got = tpipe.cluster_sessions(items, device="cpu")
    np.testing.assert_array_equal(got, want)
    info = dict(tpipe.last_run_info)
    _assert_info_matches_jax(info)
    assert info["encoding"] == "delta"
    assert info["wire_quant_bits"] == 10
    assert info["prefilter_rows_dropped"] > 0
    assert "stage_entropy_s" in info["stages"]
    assert adjusted_rand_index(got, truth) >= 0.98


@pytest.mark.parametrize("quant_bits,chunks", [(10, 1), (10, 4), (-1, 1),
                                               (-1, 4)])
def test_cluster_sessions_matches_jax(sets, quant_bits, chunks):
    items, truth = sets
    items = items[:700]
    want, got, info = _both(items, wire_quant_bits=quant_bits,
                            h2d_chunks=chunks)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert info["chunk_bits"] == jpipe.last_run_info["chunk_bits"]
    assert info["chunk_bits"][0] == (10 if quant_bits == 10 else 24)
    # 700 rows asked into 4 chunks cut on 128-row boundaries: 256+256+188.
    assert len(info["chunk_bits"]) == (3 if chunks == 4 else 1)


def test_raw_32bit_lane_matches_jax(sets):
    """Ids >= 2^24 ship raw (4 bytes an id); some are >= 2^31."""
    items, _ = sets
    items = items[:700] | np.uint32(1 << 31)
    want, got, info = _both(items, wire_quant_bits=-1, h2d_chunks=4)
    np.testing.assert_array_equal(got, want)
    assert info["chunk_bits"] == [32, 32, 32]


@pytest.mark.parametrize("n,chunks,overlap", [(200, 4, True),
                                              (1000, 3, False)])
def test_small_and_ragged_streams_match_jax(sets, n, chunks, overlap):
    """N < 2*block_n ships one chunk; N=1000 in 3 chunks ends ragged."""
    items, _ = sets
    want, got, info = _both(items[:n], wire_quant_bits=10,
                            h2d_chunks=chunks, overlap=overlap)
    np.testing.assert_array_equal(got, want)
    assert len(info["chunk_bits"]) == (1 if n == 200 else 3)


def test_planted_quality_stages_and_signatures(sets):
    items, truth = sets
    labels, sig, keys = tpipe.cluster_sessions(
        items, tpipe.ClusterParams(**PLAIN_WIRE), device="cpu",
        return_signatures=True)
    assert adjusted_rand_index(labels, truth) >= 0.98
    hp = tschemes.make_params("kminhash", 128)
    want = kmod.minhash_and_keys_plain(u32_tensor(items), *hp.arrays, 16)
    assert torch.equal(sig, want[0]) and torch.equal(keys, want[1])
    stages = tpipe.last_run_info["stages"]
    for stage in ("encode", "h2d", "compute", "d2h"):
        assert f"stage_{stage}_s" in stages
    assert tpipe.last_run_info["wire_bytes"] == 2000 * 32 * 3


def test_wire_plan_matches_jax_at_full_size():
    """At 1M x 64 (a broadcast view: no memory) auto quantization picks 10
    bits and the stream cuts 4 chunks of 250,368 rows, as in JAX."""
    big = np.broadcast_to(np.uint32(1 << 23), (1_000_000, 64))
    for q in (0, -1, 12):
        p_t = tpipe.ClusterParams(wire_quant_bits=q, **PLAIN_WIRE)
        p_j = jpipe.ClusterParams(wire_quant_bits=q, **PLAIN_WIRE)
        assert tpipe._quant_bits(big, p_t) == jpipe._quant_bits(big, p_j)
    assert tpipe._quant_bits(big, tpipe.ClusterParams()) == 10
    step = tpipe._stream_plan(big, tpipe.ClusterParams())
    assert step == jpipe._stream_plan(big, jpipe.ClusterParams()) == 250_368


def test_params_keep_jax_fields_and_defaults():
    jax_fields = {f.name: f.default
                  for f in dataclasses.fields(jpipe.ClusterParams)}
    del jax_fields["use_pallas"]
    port_fields = {f.name: f.default
                   for f in dataclasses.fields(tpipe.ClusterParams)}
    assert port_fields == jax_fields


@pytest.mark.parametrize("kw,shape,item", [
    (dict(PLAIN_WIRE, sig_store="pod_root"), (8, 4), "Multi-GPU"),
])
def test_levers_not_ported_raise(tmp_path, kw, shape, item):
    """The store lever runs since the warm path was ported; a pod-sharded
    store root (its pod_topology.json) still waits for Multi-GPU."""
    root = tmp_path / kw["sig_store"]
    root.mkdir()
    (root / "pod_topology.json").write_text('{"n_ranges": 2}')
    kw = dict(kw, sig_store=str(root))
    items = np.zeros(shape, np.uint32)
    with pytest.raises(NotImplementedError,
                       match=f'ROADMAP.md Queue 1, "{item}"'):
        tpipe.cluster_sessions(items, tpipe.ClusterParams(**kw), device="cpu")


def _write_calibration(path, state: str, monkeypatch) -> None:
    """The machine calibration as the JAX package writes it: a persisted
    8-bit floor, fresh, stale (older than the TTL) or of another schema;
    or no file at all."""
    if state == "none":
        return
    if state == "stale":
        monkeypatch.setattr(jcal, "_now", lambda: time.time() - 7 * 3600)
    jcal.update_calibration(str(path), wire={"quant_bits": 8})
    monkeypatch.setattr(jcal, "_now", time.time)
    if state == "schema":
        saved = json.loads(path.read_text())
        saved["schema_version"] = jcal.SCHEMA_VERSION - 1
        path.write_text(json.dumps(saved))


@pytest.mark.parametrize("state", ["floor", "none", "stale", "schema"])
@pytest.mark.parametrize("quant_bits", [0, -1, 12, 6])
def test_quant_bits_clamp_to_calibrated_floor_as_jax(tmp_path, monkeypatch,
                                                      state, quant_bits):
    """The degraded floor in the machine calibration clamps the port's
    storeless wire width as it clamps JAX's: 0 and 12 drop to the 8-bit
    floor, -1 and 6 keep theirs; a stale entry or another schema is no
    floor."""
    path = tmp_path / "cal.json"
    _write_calibration(path, state, monkeypatch)
    monkeypatch.setenv("TSE1M_ROUTER_CAL", str(path))
    items = np.random.default_rng(11).integers(
        0, 1 << 24, size=(1000, 64), dtype=np.uint32)
    want = jpipe._quant_bits(items, jpipe.ClusterParams(
        wire_quant_bits=quant_bits))
    got = tpipe._quant_bits(items, tpipe.ClusterParams(
        wire_quant_bits=quant_bits))
    assert got == want
    assert got == (8 if state == "floor" and quant_bits in (0, 12)
                   else max(quant_bits, 0))


def test_calibration_path_from_the_ini_as_jax(tmp_path, monkeypatch):
    ini = tmp_path / "envFile.ini"
    ini.write_text(f"[FRAMEWORK]\nrouter_cal_path = {tmp_path / 'c.json'}\n")
    monkeypatch.delenv("TSE1M_ROUTER_CAL")
    monkeypatch.setenv("TSE1M_ENVFILE", str(ini))
    assert tcal.calibration_path() == jcal.calibration_path() == str(
        tmp_path / "c.json")
    monkeypatch.setenv("TSE1M_ENVFILE", str(tmp_path / "absent.ini"))
    assert tcal.calibration_path() is None is jcal.calibration_path()


def test_labels_with_calibrated_floor_match_jax(sets, tmp_path, monkeypatch):
    """With the floor present both packages quantize a small storeless run
    to 8 bits and give equal labels.  Each clears the floor after its clean
    clamped run (the device healed), so the floor is written again before
    the JAX run."""
    path = tmp_path / "cal.json"
    _write_calibration(path, "floor", monkeypatch)
    monkeypatch.setenv("TSE1M_ROUTER_CAL", str(path))
    items, _ = sets
    items = items[:600]
    got = tpipe.cluster_sessions(items, tpipe.ClusterParams(
        block_n=128, **PLAIN_WIRE), device="cpu")
    assert tpipe.last_run_info["wire_quant_bits"] == 8
    assert "quant_bits" not in jcal.load_calibration(str(path))["wire"]
    _write_calibration(path, "floor", monkeypatch)
    want = jpipe.cluster_sessions(items, jpipe.ClusterParams(
        use_pallas="interpret", block_n=128, **PLAIN_WIRE))
    assert jpipe.last_run_info["wire_quant_bits"] == 8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [dict(prefilter="on", sig_store="/store"),
                                dict(prefilter="on", threshold=0.0)])
def test_prefilter_on_refusals_match_jax(kw):
    """prefilter="on" with a store or without a verifying threshold is a
    ValueError before anything else (the store's own refusal included)."""
    items = np.zeros((8, 4), np.uint32)
    with pytest.raises(ValueError) as want:
        jpipe.cluster_sessions(items, jpipe.ClusterParams(**kw))
    with pytest.raises(ValueError) as got:
        tpipe.cluster_sessions(items, tpipe.ClusterParams(**kw),
                               device="cpu")
    assert str(got.value) == str(want.value)


def _scheme_rows(scheme: str, n: int):
    items, truth = j_synth(n, set_size=24, seed=5)
    if scheme == "weighted":
        items = jschemes.expand_weighted(
            items, j_hitcounts(items, truth, seed=5))
    return items, truth


@pytest.mark.parametrize("scheme", ["cminhash", "weighted"])
@pytest.mark.parametrize("wire,kw", [
    (PLAIN_WIRE, dict(wire_quant_bits=10)),
    (PLAIN_WIRE, dict(wire_quant_bits=-1, h2d_chunks=3)),
    (dict(encoding="delta", prefilter="on", entropy="force"), {}),
])
def test_one_permutation_schemes_match_jax(scheme, wire, kw):
    """cminhash and weighted labels equal JAX's on the plain wire (sub-byte
    chunks to the bin-min kernel; byte chunks decoded, then hashed) and
    under forced wire v3 (every lane rANS-coded, delta rows hashed after
    the full lane)."""
    items, truth = _scheme_rows(scheme, 800)
    want, got, info = _both(items, wire=wire, scheme=scheme, **kw)
    np.testing.assert_array_equal(got, want)
    _assert_info_matches_jax(info)
    assert adjusted_rand_index(got, truth) >= 0.9


@pytest.mark.parametrize("scheme", ["cminhash", "weighted"])
def test_one_permutation_signatures_of_kept_rows(scheme):
    """return_signatures gives the plain version's signatures and keys of
    the rows that went to the card, in their row order."""
    items, _ = _scheme_rows(scheme, 600)
    labels, sig, keys = tpipe.cluster_sessions(
        items, tpipe.ClusterParams(scheme=scheme, **PLAIN_WIRE,
                                   wire_quant_bits=-1),
        device="cpu", return_signatures=True)
    hp = tschemes.make_params(scheme, 128)
    want = kcm.cminhash_and_keys_plain(u32_tensor(items), *hp.arrays, 16)
    assert torch.equal(sig, want[0]) and torch.equal(keys, want[1])


def test_weighted_rows_keep_the_chunk_plan():
    """Weighted rows are wider (~8x the set at full weight); the chunk plan
    is the same function of their bytes as in JAX."""
    items, _ = _scheme_rows("weighted", 800)
    assert items.shape[1] > 24
    for chunks in (0, 3):
        p_t = tpipe.ClusterParams(scheme="weighted", h2d_chunks=chunks,
                                  block_n=128)
        p_j = jpipe.ClusterParams(scheme="weighted", h2d_chunks=chunks,
                                  block_n=128)
        assert tpipe._stream_plan(items, p_t) == jpipe._stream_plan(items,
                                                                    p_j)
    wide = np.broadcast_to(np.uint32(1), (200_000, 216))
    assert tpipe._stream_plan(wide, tpipe.ClusterParams()) == \
        jpipe._stream_plan(wide, jpipe.ClusterParams()) == 67_072


def test_mesh_and_unknown_values_raise():
    items = np.zeros((8, 4), np.uint32)
    with pytest.raises(NotImplementedError, match='Queue 1, "Multi-GPU"'):
        tpipe.cluster_sessions(items, tpipe.ClusterParams(**PLAIN_WIRE),
                               mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="unknown signature scheme"):
        tpipe.cluster_sessions(items, tpipe.ClusterParams(
            **dict(PLAIN_WIRE, scheme="minhash")), device="cpu")
    with pytest.raises(ValueError, match="unknown encoding"):
        tpipe.cluster_sessions(items, tpipe.ClusterParams(
            **dict(PLAIN_WIRE, encoding="zstd")), device="cpu")
    # Below 64 MiB the auto levers stay off, as in JAX: no refusal (and
    # eight equal rows form one cluster).
    labels = tpipe.cluster_sessions(
        items, tpipe.ClusterParams(entropy="off"), device="cpu")
    assert labels.tolist() == [0] * 8


def test_synth_and_ari_match_jax():
    items_t, truth_t = synth_session_sets(3000, 16, seed=9)
    items_j, truth_j = j_synth(3000, 16, seed=9)
    np.testing.assert_array_equal(items_t, items_j)
    np.testing.assert_array_equal(truth_t, truth_j)
    noisy = truth_t.copy()
    noisy[::7] = 0
    assert adjusted_rand_index(noisy, truth_t) == j_ari(noisy, truth_t)


def _cli_report(capsys, *flags, ari_min: float = 0.98) -> dict:
    assert cli_main(["cluster", "--n", "3000", "--device", "cpu",
                     *flags]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report["device"] == "cpu"
    assert report["ari_vs_planted"] >= ari_min
    assert "stage_compute_s" in report
    assert "stage_entropy_s" in report   # auto and force offer every chunk
    assert report["wire_v3_saved_mb"] is not None
    return report


def test_cli_cluster_on_cpu(capsys):
    """Default ClusterParams: below 64 MiB the auto levers stay off."""
    report = _cli_report(capsys)
    assert report["encoding"] == "plain"
    assert report["prefilter_rows_dropped"] == 0


def test_cli_wire_v3_flags_on_cpu(capsys):
    """--prefilter on drops rows; --entropy force codes each chunk."""
    report = _cli_report(capsys, "--prefilter", "on", "--entropy", "force")
    assert report["encoding"] == "plain"
    assert report["prefilter_rows_dropped"] > 0


@pytest.mark.parametrize("scheme,ari_min", [("cminhash", 0.98),
                                             ("weighted", 0.95)])
def test_cli_scheme_on_cpu(capsys, scheme, ari_min):
    """--scheme: cminhash over the synthesized sets; weighted over their
    replica expansion, as the JAX command line builds it (weighted labels
    equal JAX's, test_one_permutation_schemes_match_jax; the planted truth
    is set membership, which the count profiles blur: 0.957 here)."""
    report = _cli_report(capsys, "--scheme", scheme, ari_min=ari_min)
    assert report["scheme"] == scheme
    assert (report["set_width"] > 64) == (scheme == "weighted")
