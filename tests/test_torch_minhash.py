"""tse1m_tpu_torch MinHash kernels (plain versions on the CPU) against the
JAX package's Pallas kernels in interpret mode, and the wire codec against
the JAX codec.  Tolerance: exact, element for element."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tse1m_tpu.cluster import encode as jenc
from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.cluster import schemes as jschemes
from tse1m_tpu.cluster.minhash_pallas import _combine_bytes
from tse1m_tpu.cluster.minhash_pallas import minhash_and_keys as j_minhash
from tse1m_tpu.cluster.minhash_pallas import \
    minhash_and_keys_packed as j_minhash_packed
from tse1m_tpu_torch.cluster import encode as tenc
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.cluster import schemes as tschemes
from tse1m_tpu_torch.cluster import kernels
from tse1m_tpu_torch.cluster.kernels import minhash as kmod
from tse1m_tpu_torch.device import as_u32_numpy, u32_tensor


def _ids(rng, shape, low=0, high=1 << 32):
    return rng.integers(low, high, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _payload(vals: np.ndarray, k: int) -> np.ndarray:
    return np.ascontiguousarray(
        vals.astype("<u4")[..., None].view(np.uint8)[..., :k]).reshape(-1)


def _assert_same(got: tuple, want: tuple):
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(as_u32_numpy(g), np.asarray(w))


@pytest.mark.parametrize("n_hashes,seed", [(32, 0), (128, 7)])
def test_hash_params_carry_over_bit_for_bit(n_hashes, seed):
    jhp = jschemes.make_params("kminhash", n_hashes, seed)
    carried = tschemes.params_from_numpy("kminhash", n_hashes, jhp.arrays)
    own = tschemes.make_params("kminhash", n_hashes, seed)
    for want, got_carried, got_own in zip(jhp.arrays, carried.arrays,
                                          own.arrays):
        assert got_own.dtype == torch.int32
        np.testing.assert_array_equal(as_u32_numpy(got_carried), want)
        np.testing.assert_array_equal(as_u32_numpy(got_own), want)


@pytest.mark.parametrize("n,s,h,bands,low", [
    (300, 16, 32, 8, 0),            # ragged vs block_n=128
    (129, 32, 128, 16, 1 << 31),    # ids >= 2^31
    (1, 7, 32, 4, 1 << 24),         # one row, odd S, ids >= 2^24
])
def test_minhash_and_keys_matches_pallas(n, s, h, bands, low):
    rng = np.random.default_rng(n)
    items = _ids(rng, (n, s), low)
    jhp = jschemes.make_params("kminhash", h, seed=3)
    want = j_minhash(items, *jhp.arrays, bands, use_pallas="interpret",
                     block_n=128)
    hp = tschemes.params_from_numpy("kminhash", h, jhp.arrays)
    _assert_same(kmod.minhash_and_keys(u32_tensor(items), *hp.arrays, bands),
                 want)


@pytest.mark.parametrize("k,offset", [(1, 0), (2, 65_000), (3, 123_456),
                                      (4, 0), (3, 0xFFFFFF00)])
def test_minhash_and_keys_packed_matches_pallas(k, offset):
    rng = np.random.default_rng(k)
    n, s, bands = 200, 16, 8
    payload = _payload(_ids(rng, (n, s), high=1 << (8 * k)), k)
    jhp = jschemes.make_params("kminhash", 32, seed=1)
    want = j_minhash_packed(jnp.asarray(payload), (n, s), k, offset,
                            *jhp.arrays, bands, use_pallas="interpret")
    hp = tschemes.params_from_numpy("kminhash", 32, jhp.arrays)
    got = kmod.minhash_and_keys_packed(torch.from_numpy(payload), (n, s), k,
                                       offset, *hp.arrays, bands)
    _assert_same(got, want)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_combine_bytes_matches_jax(k):
    rng = np.random.default_rng(10 + k)
    payload = _payload(_ids(rng, (33, 5), high=1 << (8 * k)), k)
    offset = 0xFFFFFFF0
    want = _combine_bytes(jnp.asarray(payload), (33, 5), k, np.uint32(offset))
    got = kmod.combine_bytes(torch.from_numpy(payload), (33, 5), k, offset)
    np.testing.assert_array_equal(as_u32_numpy(got), np.asarray(want))


def test_wrappers_on_cpu_run_plain_and_count_no_launch():
    rng = np.random.default_rng(5)
    items = u32_tensor(_ids(rng, (70, 12)))
    a, b = tschemes.make_params("kminhash", 32).arrays
    kernels.reset_launch_counts()
    got = kmod.minhash_and_keys(items, a, b, 4)
    for g, w in zip(got, kmod.minhash_and_keys_plain(items, a, b, 4)):
        assert torch.equal(g, w)
    payload = torch.from_numpy(_payload(_ids(rng, (70, 12), high=1 << 16),
                                        2))
    got = kmod.minhash_and_keys_packed(payload, (70, 12), 2, 9, a, b, 4)
    want = kmod.minhash_and_keys_packed_plain(payload, (70, 12), 2, 9, a, b,
                                              4)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert kernels.launch_counts() == {"minhash_and_keys": 0,
                                       "cminhash_binmin": 0,
                                       "minhash_and_keys_packed": 0,
                                       "rans_decode": 0, "topk_chunk": 0}


def test_wrappers_reject_bad_inputs():
    a, b = tschemes.make_params("kminhash", 32).arrays
    ids = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        kmod.minhash_and_keys(ids.to(torch.int64), a, b, 4)
    with pytest.raises(ValueError, match="divisible"):
        kmod.minhash_and_keys(ids, a, b, 5)
    with pytest.raises(ValueError, match="cannot hold"):
        kmod.minhash_and_keys_packed(torch.zeros(10, dtype=torch.uint8),
                                     (4, 8), 3, 0, a, b, 4)
    with pytest.raises(ValueError, match="unsupported device"):
        kmod.minhash_and_keys(ids.to("meta"), a.to("meta"), b.to("meta"), 4)


@pytest.mark.parametrize("bits", [1, 3, 7, 10, 13, 8, 16, 24, 32])
def test_unpack_bits_matches_jax(bits):
    rng = np.random.default_rng(bits)
    n = 1001
    vals = _ids(rng, (n,), high=1 << bits)
    packed = jenc.pack_bits_host(vals, bits)
    offset = 4_000_000_000
    want = jpipe._unpack_bits(jnp.asarray(packed), n, bits,
                              jnp.uint32(offset))
    got = tpipe._unpack_bits(torch.from_numpy(packed), n, bits, offset)
    np.testing.assert_array_equal(as_u32_numpy(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["quant10", "id24", "id32", "narrow_high"])
def test_pack_chunk_matches_jax(kind):
    rng = np.random.default_rng(0)
    if kind == "quant10":
        chunk = jenc.quantize_ids(_ids(rng, (90, 16)), 10)
    elif kind == "id24":
        chunk = _ids(rng, (90, 16), high=1 << 24)
    elif kind == "id32":
        chunk = _ids(rng, (90, 16), low=1 << 31)
    else:
        chunk = _ids(rng, (90, 16), low=(1 << 24) - 5000, high=1 << 24)
    want = jenc.pack_chunk(chunk, jpipe._PACK_LIMIT, entropy="off")
    got = tenc.pack_chunk(chunk)
    assert tenc._PACK_LIMIT == jpipe._PACK_LIMIT
    assert (got.bits, got.offset, got.shape, got.n_values) == (
        want.bits, want.offset, want.shape, want.n_values)
    np.testing.assert_array_equal(got.payload, want.payload)
    np.testing.assert_array_equal(tenc.unpack_chunk_host(got), chunk)
