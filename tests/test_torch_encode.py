"""tse1m_tpu_torch wire encodings (the base-delta lane and the wire v3
lane forms) against the JAX package's ``tse1m_tpu.cluster.encode``.
Tolerance: exact, field for field.  Inputs are made with numpy from a
seed."""

import zlib

import numpy as np
import pytest

from tse1m_tpu.cluster import encode as jenc
from tse1m_tpu.cluster import entropy as jent
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu_torch.cluster import encode as tenc

JAX_CRC_IS_ZLIB = jent._crc_update is zlib.crc32
DELTA_FIELDS = ("n", "set_size", "mask_bits", "full_rows", "rep_in_full",
                "counts", "pos_flat", "val_flat")


@pytest.fixture(scope="module")
def planted():
    items, _ = synth_session_sets(2500, set_size=32, seed=5)
    return items


@pytest.fixture(scope="module")
def planted_20k():
    """Large enough that auto codes the rep (14-bit, two byte planes) and
    counts lanes, as at the study's scale."""
    items, _ = synth_session_sets(20_000, set_size=32, seed=5)
    return items


def _assert_same(got, want):
    """Equal arrays (values and dtypes) or equal scalars."""
    if isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _assert_ent_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert (got.n, got.bits) == (want.n, want.bits)
    for a, b in zip(got.wire_arrays(), want.wire_arrays(), strict=True):
        _assert_same(a, b)
    if JAX_CRC_IS_ZLIB:
        assert got.crc == want.crc


def _assert_chunk_equal(got, want):
    for name in ("payload", "n_values", "bits", "offset", "shape"):
        _assert_same(getattr(got, name), getattr(want, name))
    _assert_ent_equal(got.ent, want.ent)
    assert got.nbytes == want.nbytes


@pytest.mark.parametrize("n,set_size,kw", [
    (2500, 32, {}), (2500, 32, dict(max_diffs=4, n_probes=1)),
    (800, 64, dict(n_probes=4)), (300, 8, {})])
def test_encode_delta_matches_jax(planted, n, set_size, kw):
    if set_size == 32:
        items = planted[:n]
    else:
        items, _ = synth_session_sets(n, set_size=set_size, seed=n)
    got = tenc.encode_delta(items, **kw)
    want = jenc.encode_delta(items, use_native=False, **kw)
    assert got is not None and want is not None
    for name in DELTA_FIELDS:
        _assert_same(getattr(got, name), getattr(want, name))
    assert (got.n_full, got.n_delta) == (want.n_full, want.n_delta)
    assert got.n_delta > 0
    np.testing.assert_array_equal(tenc.decode_host(got), items)


@pytest.mark.parametrize("case", ["one_row", "wide_sets", "tiny_sets",
                                  "below_fraction", "no_duplicates"])
def test_encode_delta_declines_as_jax(planted, case):
    rng = np.random.default_rng(3)
    items, kw = {
        "one_row": (planted[:1], {}),
        "wide_sets": (rng.integers(0, 99, (10, 256)).astype(np.uint32), {}),
        "tiny_sets": (np.zeros((50, 3), np.uint32), {}),
        "below_fraction": (planted[:500], dict(min_delta_fraction=0.99)),
        "no_duplicates": (rng.integers(0, 1 << 24, (200, 32)).astype(
            np.uint32), {}),
    }[case]
    assert jenc.encode_delta(items, use_native=False, **kw) is None
    assert tenc.encode_delta(items, **kw) is None


def test_sketch_keys_match_jax(planted):
    for probe in range(len(tenc._PROBES)):
        np.testing.assert_array_equal(tenc.sketch_keys(planted, probe),
                                      jenc.sketch_keys(planted, probe))
    assert tenc._AUTO_MIN_DELTA_FRACTION == jenc._AUTO_MIN_DELTA_FRACTION


@pytest.mark.parametrize("entropy", ["off", "auto", "force"])
@pytest.mark.parametrize("quant_bits", [0, 10])
def test_pack_delta_meta_matches_jax(planted_20k, entropy, quant_bits):
    enc_t = tenc.encode_delta(planted_20k)
    enc_j = jenc.encode_delta(planted_20k, use_native=False)
    if quant_bits:
        enc_t = tenc.DeltaEncoding(**{
            **{f: getattr(enc_t, f) for f in DELTA_FIELDS},
            "val_flat": tenc.quantize_ids(enc_t.val_flat, quant_bits)})
        enc_j = jenc.DeltaEncoding(**{
            **{f: getattr(enc_j, f) for f in DELTA_FIELDS},
            "val_flat": jenc.quantize_ids(enc_j.val_flat, quant_bits)})
    stats_t, stats_j = {}, {}
    got = tenc.pack_delta_meta(enc_t, entropy=entropy, stats=stats_t)
    want = jenc.pack_delta_meta(enc_j, entropy=entropy, stats=stats_j)
    for lt, lj in zip(got.lanes(), want.lanes(), strict=True):
        assert (lt.n, lt.bits) == (lj.n, lj.bits)
        if lj.packed is None:
            assert lt.packed is None
        else:
            _assert_same(lt.packed, lj.packed)
        _assert_ent_equal(lt.ent, lj.ent)
    _assert_chunk_equal(got.val, want.val)
    assert got.nbytes == want.nbytes
    assert stats_t.get("entropy_saved_bytes") == stats_j.get(
        "entropy_saved_bytes")
    if entropy == "force":
        assert all(lane.ent is not None for lane in got.lanes())
    if entropy == "auto":
        assert [lane.ent is not None for lane in got.lanes()] == [
            True, True, False]
    if entropy == "off":
        assert stats_t == {}


@pytest.mark.parametrize("entropy", ["off", "auto", "force"])
@pytest.mark.parametrize("kind", ["skewed_offset", "uniform_10bit",
                                  "byte_planes", "empty"])
def test_pack_chunk_v3_matches_jax(entropy, kind):
    rng = np.random.default_rng(11)
    chunk = {
        "skewed_offset": (rng.geometric(0.3, (300, 16)) + 70_000).astype(
            np.uint32),
        "uniform_10bit": rng.integers(0, 1 << 10, (300, 16)).astype(
            np.uint32),
        "byte_planes": (rng.geometric(0.01, (200, 16)) * 40_503
                        + 5).astype(np.uint32) & np.uint32(0xFFFFFF),
        "empty": np.zeros((0, 16), np.uint32),
    }[kind]
    got = tenc.pack_chunk(chunk, entropy=entropy)
    want = jenc.pack_chunk(chunk, 1 << 24, entropy=entropy)
    _assert_chunk_equal(got, want)
    if entropy == "force":
        assert got.ent is not None
        assert got.wire_arrays() == got.ent.wire_arrays()
    else:
        assert got.wire_arrays()[0] is got.payload or got.ent is not None
    if entropy == "auto":
        assert (got.ent is not None) == (kind == "skewed_offset")
    if kind == "skewed_offset":
        assert got.offset == int(chunk.min()) > 0
