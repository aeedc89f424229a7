"""tse1m_tpu_torch one-permutation schemes (cminhash, weighted) against the
JAX package: the bin-min kernel's plain version against the Pallas kernel
in interpret mode (called directly, not through its breaker), signatures
and band keys against the JAX reference and the numpy host oracle, the
hash constants, the weighted expansion and the hit-count synth.
Tolerance: exact, element for element."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tse1m_tpu.cluster import encode as jenc
from tse1m_tpu.cluster import schemes as jschemes
from tse1m_tpu.cluster.host import host_band_keys, host_cminhash_signatures
from tse1m_tpu.cluster.minhash_pallas import _cminhash_binmin_pallas
from tse1m_tpu.cluster.minhash_pallas import cminhash_and_keys as j_cminhash
from tse1m_tpu.data.synth import synth_session_hitcounts as j_hitcounts
from tse1m_tpu.data.synth import synth_session_sets as j_synth
from tse1m_tpu_torch import expand_weighted, synth_session_hitcounts
from tse1m_tpu_torch.cluster import kernels
from tse1m_tpu_torch.cluster import schemes as tschemes
from tse1m_tpu_torch.cluster.kernels import cminhash as kcm
from tse1m_tpu_torch.cluster.kernels import minhash as kmod
from tse1m_tpu_torch.device import as_u32_numpy, u32_tensor

BLOCK_N = 128


def _ids(rng, shape, low=0, high=1 << 32):
    return rng.integers(low, high, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _umax_id(jhp) -> int:
    """The id the one permutation maps to UMAX: (UMAX - b0) * a0^-1."""
    a0, b0 = int(jhp.arrays[0][0]), int(jhp.arrays[1][0])
    return ((0xFFFFFFFF - b0) * pow(a0, -1, 1 << 32)) % (1 << 32)


def _pallas_binmin(items, jhp, h):
    """The Pallas kernel in interpret mode, rows padded to BLOCK_N and
    sliced off, as the JAX package calls it."""
    n = items.shape[0]
    padded = np.zeros((-(-n // BLOCK_N) * BLOCK_N, items.shape[1]), np.uint32)
    padded[:n] = items
    consts = jnp.concatenate([jnp.asarray(jhp.arrays[0], jnp.uint32),
                              jnp.asarray(jhp.arrays[1], jnp.uint32)])
    binmin, rowmin = _cminhash_binmin_pallas(jnp.asarray(padded), consts, h,
                                             BLOCK_N, True)
    return np.asarray(binmin)[:n], np.asarray(rowmin)[:n, 0]


@pytest.mark.parametrize("scheme", ["cminhash", "weighted"])
@pytest.mark.parametrize("n_hashes,seed", [(96, 0), (128, 7)])
def test_hash_params_carry_over_bit_for_bit(scheme, n_hashes, seed):
    jhp = jschemes.make_params(scheme, n_hashes, seed)
    carried = tschemes.params_from_numpy(scheme, n_hashes, jhp.arrays)
    own = tschemes.make_params(scheme, n_hashes, seed)
    a0, b0, jmap, offs = own.arrays
    assert (a0.dtype, b0.dtype, jmap.dtype, offs.dtype) == (
        torch.int32, torch.int32, torch.int64, torch.int32)
    assert jmap.shape == (12, n_hashes)
    for want, got_carried, got_own in zip(jhp.arrays, carried.arrays,
                                          own.arrays):
        if got_own.dtype == torch.int64:
            np.testing.assert_array_equal(got_own.numpy(), want)
            np.testing.assert_array_equal(got_carried.numpy(), want)
        else:
            np.testing.assert_array_equal(as_u32_numpy(got_own), want)
            np.testing.assert_array_equal(as_u32_numpy(got_carried), want)


def test_scheme_streams_differ():
    c = tschemes.make_params("cminhash", 64, 0).arrays
    w = tschemes.make_params("weighted", 64, 0).arrays
    assert not torch.equal(c[0], w[0]) or not torch.equal(c[3], w[3])
    with pytest.raises(ValueError, match="unknown signature scheme"):
        tschemes.make_params("minhash", 64)


@pytest.mark.parametrize("n,s,h,low,umax", [
    (300, 20, 96, 0, True),          # H not a power of two, ragged N
    (129, 16, 128, 1 << 31, False),  # ids >= 2^31
    (1, 7, 128, 0, True),            # one row holding the UMAX id
    (200, 1, 96, 0, False),          # one id a row: one bin filled
])
def test_binmin_plain_matches_pallas(n, s, h, low, umax):
    rng = np.random.default_rng(n + s)
    items = _ids(rng, (n, s), low)
    jhp = jschemes.make_params("cminhash", h, seed=3)
    if umax:
        x = _umax_id(jhp)
        items[0, 0] = x             # a genuine UMAX among other values
        if n > 2:
            items[2, :] = x         # a row whose every value is UMAX
    want_bins, want_rows = _pallas_binmin(items, jhp, h)
    hp = tschemes.params_from_numpy("cminhash", h, jhp.arrays)
    got_bins, got_rows = kcm.cminhash_binmin(u32_tensor(items), hp.arrays[0],
                                             hp.arrays[1], h)
    assert got_bins.shape == (n, h) and got_rows.shape == (n,)
    np.testing.assert_array_equal(as_u32_numpy(got_bins), want_bins)
    np.testing.assert_array_equal(as_u32_numpy(got_rows), want_rows)
    if umax and n > 2:
        assert (as_u32_numpy(got_bins[2]) == 0xFFFFFFFF).all()


def _scheme_items(scheme: str, quant: int, s: int = 24):
    items, truth = j_synth(400, set_size=s, seed=11)
    if scheme == "weighted":
        items = jschemes.expand_weighted(items,
                                         j_hitcounts(items, truth, seed=11))
    if quant:
        items = jenc.quantize_ids(items, quant)
    return items


@pytest.mark.parametrize("scheme", ["cminhash", "weighted"])
@pytest.mark.parametrize("quant", [0, 10, 8])
def test_signatures_and_keys_match_jax_and_host(scheme, quant):
    items = _scheme_items(scheme, quant)
    jhp = jschemes.make_params(scheme, 128, seed=2)
    want_sig, want_keys = j_cminhash(items, *jhp.arrays, 16,
                                     use_pallas="never")
    hp = tschemes.make_params(scheme, 128, seed=2)
    sig, keys = tschemes.scheme_sig_and_keys(u32_tensor(items), hp, 16)
    np.testing.assert_array_equal(as_u32_numpy(sig), np.asarray(want_sig))
    np.testing.assert_array_equal(as_u32_numpy(keys), np.asarray(want_keys))
    host = host_cminhash_signatures(items, *jhp.arrays)
    np.testing.assert_array_equal(as_u32_numpy(sig), host)
    np.testing.assert_array_equal(as_u32_numpy(keys),
                                  host_band_keys(host, 16))


@pytest.mark.parametrize("s", [1, 3])
def test_sparse_rows_take_the_circulant_fallback_as_jax(s):
    """Rows of 1-3 ids fill few of the 96 bins: densification leaves bins
    empty and the rowmin + offs fallback fills them, as in JAX."""
    rng = np.random.default_rng(s)
    items = _ids(rng, (64, s))
    jhp = jschemes.make_params("cminhash", 96, seed=4)
    want = host_cminhash_signatures(items, *jhp.arrays)
    hp = tschemes.params_from_numpy("cminhash", 96, jhp.arrays)
    sig = tschemes.scheme_sig_and_keys(u32_tensor(items), hp, 8)[0]
    np.testing.assert_array_equal(as_u32_numpy(sig), want)
    binmin = kcm.cminhash_binmin(u32_tensor(items), *hp.arrays[:2], 96)[0]
    assert (binmin == -1).any()   # some bins were empty before densify


@pytest.mark.parametrize("k,offset", [(2, 65_000), (3, 0xFFFFFF00)])
def test_packed_chunks_decode_then_hash(k, offset):
    """The one-permutation schemes decode a byte-packed chunk, then hash:
    the same as hashing the decoded ids."""
    rng = np.random.default_rng(k)
    vals = _ids(rng, (90, 16), high=1 << (8 * k))
    payload = torch.from_numpy(np.ascontiguousarray(
        vals.astype("<u4")[..., None].view(np.uint8)[..., :k]).reshape(-1))
    hp = tschemes.make_params("cminhash", 64, seed=1)
    got = tschemes.scheme_sig_and_keys_packed(payload, (90, 16), k, offset,
                                              hp, 8)
    decoded = kmod.combine_bytes(payload, (90, 16), k, offset)
    want = kcm.cminhash_and_keys_plain(decoded, *hp.arrays, 8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("seed", [0, 3])
def test_expand_weighted_and_hitcounts_match_jax(seed):
    items, truth = j_synth(500, set_size=16, seed=seed)
    w_t = synth_session_hitcounts(items, truth, seed=seed)
    w_j = j_hitcounts(items, truth, seed=seed)
    assert w_t.dtype == np.uint32 and w_t.min() >= 1 and w_t.max() <= 8
    np.testing.assert_array_equal(w_t, w_j)
    got = expand_weighted(items, w_t)
    np.testing.assert_array_equal(got, jschemes.expand_weighted(items, w_j))
    assert got.shape[1] == int(np.clip(w_t, 1, 8).sum(1).max())
    assert tschemes.MAX_WEIGHT == jschemes.MAX_WEIGHT
    assert expand_weighted(items[:0], w_t[:0]).shape == (0, 16)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(5)
    items = u32_tensor(_ids(rng, (70, 12)))
    hp = tschemes.make_params("weighted", 32)
    kernels.reset_launch_counts()
    got = kcm.cminhash_and_keys(items, *hp.arrays, 4)
    want = kcm.cminhash_and_keys_plain(items, *hp.arrays, 4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.launch_counts()["cminhash_binmin"] == 0


def test_wrapper_rejects_bad_inputs():
    a0, b0, jmap, offs = tschemes.make_params("cminhash", 32).arrays
    ids = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kcm.cminhash_binmin(ids.to(torch.int64), a0, b0, 32)
    with pytest.raises(ValueError, match="at least one id"):
        kcm.cminhash_binmin(ids[:, :0], a0, b0, 32)
    with pytest.raises(ValueError, match=r"\[1\] int32"):
        kcm.cminhash_binmin(ids, offs, b0, 32)
    with pytest.raises(ValueError, match="divisible"):
        kcm.cminhash_and_keys(ids, a0, b0, jmap, offs, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        kcm.cminhash_binmin(ids.to("meta"), a0.to("meta"), b0.to("meta"), 32)
