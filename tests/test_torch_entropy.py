"""tse1m_tpu_torch rANS codec and decode against the JAX package's.

The host codec (``cluster/entropy.py``) must give the same tables, words,
states and gate decisions as ``tse1m_tpu.cluster.entropy``; the plain
version of the rANS kernel (``kernels/rans.py:rans_decode_plain``) must give
the symbols of the JAX Pallas kernel in interpret mode and of the numpy
oracle.  Tolerance: exact.  Inputs are made with numpy from a seed."""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tse1m_tpu.cluster import entropy as jent
from tse1m_tpu.cluster.kernels import rans as jrans
from tse1m_tpu_torch.cluster import entropy as tent
from tse1m_tpu_torch.cluster import kernels
from tse1m_tpu_torch.cluster.kernels import rans as trans
from tse1m_tpu_torch.cluster.pipeline import _put
from tse1m_tpu_torch.device import as_u32_numpy

# The JAX codec's CRC is CRC-32C when that wheel is installed; the port's
# is always zlib's CRC-32.  Frames are compared by CRC only when they agree.
JAX_CRC_IS_ZLIB = jent._crc_update is zlib.crc32


def _skewed(rng, n: int, bits: int) -> np.ndarray:
    """Geometric values spread over the width: skewed, so auto codes them."""
    v = rng.geometric(0.2, size=n).astype(np.uint64) * 2654435761
    return (v % (1 << bits)).astype(np.uint32) if bits < 32 else \
        v.astype(np.uint32)


def _lane_arrays(lane):
    """A lane's wire arrays as the CPU tensors the pipeline hands over."""
    return _put(lane.wire_arrays(), torch.device("cpu"), None)


def _assert_lanes_equal(got, want):
    assert (got is None) == (want is None)
    if want is None:
        return
    assert (got.n, got.bits, len(got.planes)) == (want.n, want.bits,
                                                  len(want.planes))
    for pg, pw in zip(got.planes, want.planes):
        for name in ("words", "x0", "freqs"):
            a, b = getattr(pg, name), getattr(pw, name)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    if JAX_CRC_IS_ZLIB:
        assert got.crc == want.crc


@pytest.mark.parametrize("case", ["random", "skewed", "one", "sparse",
                                  "rounding"])
def test_normalize_freqs_matches_jax(case):
    rng = np.random.default_rng(1)
    counts = {
        "random": rng.integers(0, 50, 256),
        "skewed": np.bincount(rng.geometric(0.3, 5000), minlength=40),
        "one": np.array([0, 0, 7, 0]),
        "sparse": np.where(rng.random(4096) < 0.01, 1, 0) + np.eye(
            1, 4096, 5, dtype=np.int64)[0] * 10**6,
        "rounding": np.full(3, 1),
    }[case]
    got = tent.normalize_freqs(counts)
    want = jent.normalize_freqs(counts)
    assert got.dtype == np.uint16 and int(got.sum()) == tent._M
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("alphabet,n", [(2, 1), (32, 33), (256, 5000),
                                        (4096, 4097)])
def test_rans_encode_matches_jax(alphabet, n):
    rng = np.random.default_rng(alphabet + n)
    sym = (rng.geometric(0.1, size=n) % alphabet).astype(np.uint32)
    freqs = jent.normalize_freqs(np.bincount(sym, minlength=alphabet))
    words, x0 = tent.rans_encode(sym, freqs)
    want_words, want_x0 = jent.rans_encode(sym, freqs)
    np.testing.assert_array_equal(words, want_words)
    np.testing.assert_array_equal(x0, want_x0)
    assert words.dtype == np.uint16 and x0.dtype == np.uint32


@pytest.mark.parametrize("case,force", [
    ("skewed", False), ("skewed", True), ("uniform", False),
    ("uniform", True), ("empty", False), ("empty", True),
    ("wide", False), ("wide", True)])
def test_encode_lane_gates_match_jax(case, force):
    """auto codes skewed lanes and returns None for uniform and empty ones;
    force codes everything; the frames are the JAX package's."""
    rng = np.random.default_rng(7)
    vals, bits = {
        "skewed": (_skewed(rng, 5000, 10), 10),
        "uniform": (rng.integers(0, 1 << 10, 3000).astype(np.uint32), 10),
        "empty": (np.zeros(0, np.uint32), 18),
        "wide": (_skewed(rng, 4000, 18), 18),
    }[case]
    got = tent.encode_lane(vals, bits, force=force)
    want = jent.encode_lane(vals, bits, force=force)
    _assert_lanes_equal(got, want)
    if case == "uniform" and not force:
        assert got is None
    if case in ("skewed", "wide") or force:
        assert got is not None
        np.testing.assert_array_equal(tent.decode_lane_host(got), vals)


def test_verify_frame_refuses_a_flipped_byte():
    lane = tent.encode_lane(_skewed(np.random.default_rng(2), 500, 8), 8,
                            force=True)
    tent.verify_frame(lane)
    lane.planes[0].words[3] ^= np.uint16(1)
    with pytest.raises(tent.EntropyFrameError, match="crc"):
        tent.verify_frame(lane)


# Direct planes (bits <= 12, A = 2^bits) and byte planes (bits > 12, A =
# 256), across the step boundaries of 32 streams.
@pytest.mark.parametrize("bits,n", [
    (1, 4097), (5, 4097), (12, 4097), (13, 1000), (18, 1000), (24, 1000),
    (32, 1000), (5, 1), (5, 31), (5, 32), (5, 33), (18, 33)])
def test_rans_decode_plain_matches_jax(bits, n):
    rng = np.random.default_rng(bits * 10_000 + n)
    vals = _skewed(rng, n, bits)
    lane = tent.encode_lane(vals, bits, force=True)
    shift = 8 if bits > 12 else 0
    arrays = _lane_arrays(lane)
    planes = [arrays[3 * p:3 * p + 3] for p in range(len(lane.planes))]
    if bits == 12:
        assert lane.planes[0].freqs.shape == (4096,)
    got = trans.rans_decode_plain(planes, n, shift)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(as_u32_numpy(got), vals)
    np.testing.assert_array_equal(as_u32_numpy(got),
                                  jent.decode_lane_host(lane))
    for p, pc in enumerate(lane.planes):
        one = trans.rans_decode_plain([planes[p]], n, 0)
        want = np.asarray(jrans._rans_decode_pallas(
            jnp.asarray(pc.words), jnp.asarray(pc.x0), jnp.asarray(pc.freqs),
            n, True))
        np.testing.assert_array_equal(as_u32_numpy(one), want)
        np.testing.assert_array_equal(
            want, jent.rans_decode_host(pc.words, pc.x0, pc.freqs, n))


def test_one_symbol_alphabet_consumes_no_word():
    vals = np.full(100, 3, np.uint32)
    lane = tent.encode_lane(vals, 5, force=True)
    pc = lane.planes[0]
    assert pc.words.size == 0 and int(pc.freqs[3]) == tent._M
    got = trans.decode_lane_device(lane, _lane_arrays(lane))
    want = np.asarray(jrans._rans_decode_pallas(
        jnp.asarray(pc.words), jnp.asarray(pc.x0), jnp.asarray(pc.freqs),
        100, True))
    np.testing.assert_array_equal(as_u32_numpy(got), want)
    np.testing.assert_array_equal(want, vals)


@pytest.mark.parametrize("bits,n", [(6, 777), (20, 500), (32, 64), (9, 0)])
def test_decode_lane_device_on_cpu_matches_host(bits, n):
    rng = np.random.default_rng(bits)
    vals = _skewed(rng, n, bits)
    lane = tent.encode_lane(vals, bits, force=True)
    kernels.reset_launch_counts()
    got = trans.decode_lane_device(lane, _lane_arrays(lane))
    assert kernels.launch_counts()["rans_decode"] == 0
    np.testing.assert_array_equal(as_u32_numpy(got),
                                  tent.decode_lane_host(lane))
    np.testing.assert_array_equal(as_u32_numpy(got), vals)


def test_rans_decode_rejects_bad_inputs():
    w = torch.zeros(4, dtype=torch.int16)
    x0 = torch.full((32,), 1 << 16, dtype=torch.int32)
    f = torch.zeros(256, dtype=torch.int16)
    for planes, n, shift, match in [
        ([], 5, 0, "planes"),
        ([(w, x0, f)] * 5, 5, 8, "planes"),
        ([(w, x0, f)] * 4, 5, 11, "past bit 31"),
        ([(w.to(torch.int32), x0, f)], 5, 0, "words"),
        ([(w, x0[:8], f)], 5, 0, "x0 of 32"),
        ([(w, x0, f), (w, x0, f[:16])], 5, 8, "alphabet"),
        ([(w, x0, torch.zeros(5000, dtype=torch.int16))], 5, 0, "alphabet"),
        ([(w, x0, f)], -1, 0, "count"),
    ]:
        with pytest.raises(ValueError, match=match):
            trans.rans_decode(planes, n, shift)
    lane = tent.encode_lane(np.arange(40, dtype=np.uint32), 18, force=True)
    with pytest.raises(ValueError, match="arrays for 3 planes"):
        trans.decode_lane_device(lane, _lane_arrays(lane)[:-1])
