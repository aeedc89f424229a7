"""tse1m_tpu_torch.ops.segment against tse1m_tpu.ops.segment on seeded
numpy inputs, on the CPU: ties, empty segments, queries before and after
every value, both sides of the search, and rows with fewer than 2 valid
entries.  Tolerance: integer results and percentiles exact; masked mean
and Spearman within rtol = atol = 2e-5, the repo's cross-engine tolerance
(tests/test_value_goldens.py:33-40)."""

import numpy as np
import pytest
import torch

from tse1m_tpu.data.columnar import ns_to_device_pair
from tse1m_tpu.ops import segment as jseg
from tse1m_tpu_torch.ops import segment as tseg

TOL = dict(rtol=2e-5, atol=2e-5, equal_nan=True)


def _csr(rng, n_segments: int, max_len: int):
    """Segments of random lengths (some empty) of int64 ns times, sorted
    within each, with repeated values; offsets [P+1]."""
    lens = rng.integers(0, max_len + 1, size=n_segments)
    lens[rng.random(n_segments) < 0.25] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    base = np.datetime64("2023-06-01", "ns").astype(np.int64)
    vals = [np.sort(base + rng.integers(0, 50, size=n) * 3_600_000_000_000
                    + rng.integers(0, 3, size=n) * 500_000_000)
            for n in lens]
    values = np.concatenate(vals) if vals else np.empty(0, np.int64)
    return values.astype(np.int64), offsets


def _queries(rng, values, offsets, n_q: int):
    """Queries on every segment: equal to a value (ties), one ns either
    side of it, and before and after every value."""
    P = offsets.size - 1
    seg = rng.integers(0, P, size=n_q)
    pick = rng.integers(0, max(values.size, 1), size=n_q)
    q = values[pick] if values.size else np.zeros(n_q, np.int64)
    q = q + rng.integers(-1, 2, size=n_q)
    lo = values.min() if values.size else 0
    hi = values.max() if values.size else 0
    q[:4] = [lo - 10**12, lo, hi, hi + 10**12]
    return q.astype(np.int64), seg.astype(np.int64)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("seed,n_segments,max_len", [
    (0, 12, 30), (1, 40, 5), (2, 3, 200), (3, 7, 0)])
def test_segment_searchsorted_matches_jax(side, seed, n_segments, max_len):
    rng = np.random.default_rng(seed)
    values, offsets = _csr(rng, n_segments, max_len)
    q, seg = _queries(rng, values, offsets, 300)
    vs, vns = ns_to_device_pair(values)
    qs, qns = ns_to_device_pair(q)
    want = np.asarray(jseg.segment_searchsorted(
        vs, offsets.astype(np.int32), qs, seg.astype(np.int32), side=side,
        values_lo=vns, queries_lo=qns))
    got = tseg.segment_searchsorted(
        torch.from_numpy(values), torch.from_numpy(offsets),
        torch.from_numpy(q), torch.from_numpy(seg), side=side)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # And the brute-force count within each segment.
    starts, ends = offsets[seg], offsets[seg + 1]
    brute = [np.searchsorted(values[a:b], v, side=side)
             for a, b, v in zip(starts, ends, q)]
    np.testing.assert_array_equal(got.numpy(), brute)


def test_segment_searchsorted_single_lane_matches_jax():
    """One lane both sides: the JAX op's int32 lane against the same values
    as int64 here."""
    rng = np.random.default_rng(5)
    values, offsets = _csr(rng, 20, 25)
    values = (values // 1_000_000_000 % 1_000_000).astype(np.int64)
    for p in range(20):  # re-sort within segments after the reduction
        values[offsets[p]:offsets[p + 1]].sort()
    q, seg = _queries(rng, values, offsets, 200)
    q = np.clip(q, -2**31, 2**31 - 1)  # the int32 lane's range
    for side in ("left", "right"):
        want = np.asarray(jseg.segment_searchsorted(
            values.astype(np.int32), offsets.astype(np.int32),
            q.astype(np.int32), seg.astype(np.int32), side=side))
        got = tseg.segment_searchsorted(
            torch.from_numpy(values), torch.from_numpy(offsets),
            torch.from_numpy(q), torch.from_numpy(seg), side=side)
        np.testing.assert_array_equal(got.numpy(), want)


def test_segment_searchsorted_refuses_unknown_side():
    t = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="side"):
        tseg.segment_searchsorted(t, t, t, torch.zeros(1, dtype=torch.int64),
                                  side="middle")


@pytest.mark.parametrize("max_k", [1, 7, 40])
def test_counts_to_survival_matches_jax(max_k):
    counts = np.random.default_rng(max_k).integers(0, 30, size=57)
    counts[:5] = 0
    want = np.asarray(jseg.counts_to_survival(counts, max_k))
    got = tseg.counts_to_survival(torch.from_numpy(counts), max_k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("max_k", [1, 9, 25])
def test_unique_pairs_count_per_iteration_matches_jax(max_k):
    """Duplicate (segment, iteration) pairs count once; iterations 0,
    negative or above max_k are dropped."""
    rng = np.random.default_rng(max_k)
    seg = rng.integers(0, 11, size=400)
    it = rng.integers(-2, max_k + 4, size=400)
    want = np.asarray(jseg.unique_pairs_count_per_iteration(
        seg.astype(np.int32), it.astype(np.int32), 11, max_k))
    got = tseg.unique_pairs_count_per_iteration(
        torch.from_numpy(seg), torch.from_numpy(it), 11, max_k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _padded(rng, R: int, C: int, ties: bool):
    """[R, C] float32 values and a prefix mask: rows with 0, 1, 2 and more
    valid entries, a constant row (zero variance) and tied values."""
    x = rng.uniform(10, 90, size=(R, C)).astype(np.float32)
    if ties:
        x = np.round(x / 8) * 8
    n_valid = rng.integers(0, C + 1, size=R)
    n_valid[:3] = [0, 1, 2]
    mask = np.arange(C)[None, :] < n_valid[:, None]
    x[3] = 42.0
    x = np.where(mask, x, np.nan).astype(np.float32)
    return x, mask


@pytest.mark.parametrize("R,C,ties", [(9, 17, False), (30, 64, True),
                                      (5, 1, False), (4, 0, False)])
def test_masked_mean_and_spearman_match_jax(R, C, ties):
    x, mask = _padded(np.random.default_rng(R + C), R, C, ties)
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    if C:
        np.testing.assert_allclose(tseg.masked_mean(tx, tm).numpy(),
                                   np.asarray(jseg.masked_mean(x, mask)),
                                   **TOL)
    got = tseg.masked_spearman(tx, tm)
    assert got.dtype == torch.float32 and got.shape == (R,)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jseg.masked_spearman(x, mask)),
                               **TOL)


@pytest.mark.parametrize("q", [50, (5, 25, 50, 75, 95), (0, 100, 33.3)])
@pytest.mark.parametrize("R,C,ties", [(9, 17, False), (30, 64, True),
                                      (4, 0, False)])
def test_masked_percentile_matches_jax_exactly(q, R, C, ties):
    x, mask = _padded(np.random.default_rng(R * C + 1), R, C, ties)
    want = np.asarray(jseg.masked_percentile(x, mask, q))
    got = tseg.masked_percentile(torch.from_numpy(x), torch.from_numpy(mask),
                                 q)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
