"""tse1m_tpu_torch host prefilter against the JAX package's
``tse1m_tpu.cluster.prefilter``.  Tolerance: exact."""

import numpy as np
import pytest

from tse1m_tpu.cluster import prefilter as jpf
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu_torch.cluster import prefilter as tpf


@pytest.fixture(scope="module")
def planted():
    return synth_session_sets(3000, set_size=24, seed=8)


def test_constants_match_jax():
    assert (tpf.N_BANDS, tpf.HASHES_PER_BAND, tpf.KEY_BITS) == (
        jpf.N_BANDS, jpf.HASHES_PER_BAND, jpf.KEY_BITS)


@pytest.mark.parametrize("seed", [0, 5])
def test_band_keys_host_matches_jax(planted, seed, monkeypatch):
    items, _ = planted
    # Two row blocks, the second ragged.
    monkeypatch.setattr(tpf, "_ROW_CHUNK", 1024)
    got = tpf.band_keys_host(items, seed)
    assert got.dtype == np.uint32 and got.shape == (3000, tpf.N_BANDS)
    np.testing.assert_array_equal(got, jpf.band_keys_host(items, seed))


@pytest.mark.parametrize("seed", [0, 5])
def test_collide_mask_and_recall_match_jax(planted, seed):
    items, truth = planted
    got = tpf.collide_mask(items, seed)
    want = jpf.collide_mask(items, seed)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < got.size   # keeps the planted, drops isolated
    assert tpf.prefilter_recall(got, truth) == jpf.prefilter_recall(
        want, truth) == 1.0


def test_edge_cases_match_jax():
    one = np.arange(8, dtype=np.uint32)[None]
    assert tpf.collide_mask(one).tolist() == jpf.collide_mask(one).tolist() \
        == [False]
    dup = np.tile(np.arange(8, dtype=np.uint32), (4, 1))
    assert tpf.collide_mask(dup).all() and jpf.collide_mask(dup).all()
    keep = np.array([True, False, True])
    for truth in (np.array([0, 1, 2]), np.array([0, 0, 2])):
        assert tpf.prefilter_recall(keep, truth) == jpf.prefilter_recall(
            keep, truth)


@pytest.mark.parametrize("scheme", ["kminhash", "cminhash", "weighted"])
def test_collide_mask_takes_the_scheme_as_jax(planted, scheme):
    """The mask is one for every scheme; the scheme is validated."""
    items, _ = planted
    np.testing.assert_array_equal(
        tpf.collide_mask(items, 1, scheme=scheme),
        jpf.collide_mask(items, 1, scheme=scheme))
    np.testing.assert_array_equal(tpf.collide_mask(items, 1, scheme=scheme),
                                  tpf.collide_mask(items, 1))


def test_collide_mask_rejects_an_unknown_scheme():
    items = np.zeros((4, 8), np.uint32)
    with pytest.raises(ValueError) as want:
        jpf.collide_mask(items, scheme="minhash")
    with pytest.raises(ValueError) as got:
        tpf.collide_mask(items, scheme="minhash")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_prefilter_that_keeps_no_row(n):
    """Rows that share no band key with each other are all dropped by the
    prefilter.  The port then labels each row alone, which is the
    ``prefilter="off"`` answer; JAX raises on the empty wire instead."""
    from tse1m_tpu.cluster import pipeline as jpipe
    from tse1m_tpu_torch.cluster import pipeline as tpipe

    items = np.arange(4 * n, dtype=np.uint32).reshape(n, 4)
    got = tpipe.cluster_sessions(items, tpipe.ClusterParams(prefilter="on"),
                                 device="cpu")
    want = jpipe.cluster_sessions(
        items, jpipe.ClusterParams(prefilter="off", use_pallas="never"))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jpipe.cluster_sessions(
            items, jpipe.ClusterParams(prefilter="on", use_pallas="never"))
