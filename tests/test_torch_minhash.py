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
    # Band widths H/B = 1, 4, 16, 32: the kernel's register groups of a
    # band's hashes (8, then 4, 2, 1).
    (150, 16, 32, 32, 0),
    (150, 16, 128, 32, 1 << 31),
    (150, 16, 128, 8, 0),
    (150, 16, 128, 4, 0),
    (70, 1, 128, 16, 0),            # one id a row
    (70, 13, 128, 16, 1 << 31),     # S not a multiple of 4
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


_PACKED_SHAPE = (200, 16, 32, 8)    # n, S, H, B


@pytest.mark.parametrize("k,offset,shape", [
    *(pytest.param(k, off, _PACKED_SHAPE, id=f"{k}-{off}")
      for k, off in ((1, 0), (2, 65_000), (3, 123_456), (4, 0),
                     (3, 0xFFFFFF00))),
    # Band widths H/B = 1, 4, 16, 32; one id a row; S not a multiple of 4.
    pytest.param(3, 0xFFFFFF00, (150, 16, 32, 32), id="H32-B32"),
    pytest.param(2, 7, (150, 16, 128, 32), id="H128-B32"),
    pytest.param(3, 5, (150, 16, 128, 8), id="H128-B8"),
    pytest.param(1, 0xFFFFFF00, (150, 16, 128, 4), id="H128-B4"),
    pytest.param(2, 65_000, (70, 1, 128, 16), id="S1"),
    pytest.param(3, 0xFFFFFF00, (70, 13, 128, 16), id="S13"),
])
def test_minhash_and_keys_packed_matches_pallas(k, offset, shape):
    rng = np.random.default_rng(k)
    n, s, h, bands = shape
    payload = _payload(_ids(rng, (n, s), high=1 << (8 * k)), k)
    jhp = jschemes.make_params("kminhash", h, seed=1)
    want = j_minhash_packed(jnp.asarray(payload), (n, s), k, offset,
                            *jhp.arrays, bands, use_pallas="interpret")
    hp = tschemes.params_from_numpy("kminhash", h, jhp.arrays)
    got = kmod.minhash_and_keys_packed(torch.from_numpy(payload), (n, s), k,
                                       offset, *hp.arrays, bands)
    _assert_same(got, want)


# (warps a block, bytes) worked out by hand from the carve-up of
# csrc/minhash.cu (minhash_smem): a and b, then per warp two stages (an
# mbarrier and its unit number in 16 bytes, an 8-row unit's bytes from their
# 16-byte floor) and an id buffer of 8 rows of S rounded up to 4 (+4 where
# that is a multiple of 8).
@pytest.mark.parametrize("s,h,k,warps,smem", [
    (64, 128, 4, 4, 26_368),      # the main-path chunk, uint32 ids
    (64, 128, 3, 4, 22_272),      # the plain wire's 24-bit chunks
    (300, 128, 4, 4, 116_480),    # wide rows still take 4 warps a block
    (300, 128, 3, 4, 97_280),
    (1000, 128, 4, 2, 193_408),   # wider rows take fewer warps a block
    (1000, 128, 3, 2, 161_408),
    (2000, 128, 4, 1, 193_216),
    (2000, 128, 3, 1, 161_216),
    (2409, 128, 4, 1, 232_448),   # the widest uint32 row: exactly MAX_SMEM
])
def test_block_smem_fits(s, h, k, warps, smem):
    assert kmod.MAX_SMEM == 232_448
    assert kmod.block_smem(s, h, k) == (warps, smem)
    kmod.check_fits(s, h, k)


@pytest.mark.parametrize("s,h,k", [(2410, 128, 4), (2500, 128, 4),
                                   (4000, 128, 3), (64, 32768, 4)])
def test_block_smem_refuses_what_does_not_fit(s, h, k):
    warps, smem = kmod.block_smem(s, h, k)
    assert warps == 0 and smem > kmod.MAX_SMEM
    with pytest.raises(ValueError, match="shared memory"):
        kmod.check_fits(s, h, k)


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
