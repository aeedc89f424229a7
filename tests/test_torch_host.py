"""tse1m_tpu_torch's numpy host oracle (``cluster/host.py``) against the
JAX package's, and its band-key fold against the port's device fold on
the CPU: the warm merge folds a tail's keys on the host where the union
run folds them on the card, so the two must agree bit for bit.
Tolerance: exact."""

import numpy as np
import pytest

from tse1m_tpu.cluster import host as jhost
from tse1m_tpu.cluster import schemes as jschemes
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu_torch.cluster import host as thost
from tse1m_tpu_torch.cluster import schemes as tschemes
from tse1m_tpu_torch.cluster.kernels import cminhash as kcm
from tse1m_tpu_torch.cluster.kernels import minhash as kmod
from tse1m_tpu_torch.cluster.minhash import band_keys
from tse1m_tpu_torch.device import as_u32_numpy, u32_tensor


@pytest.mark.parametrize("n,h,b", [(500, 128, 16), (33, 32, 8),
                                   (7, 16, 16), (1, 8, 1), (0, 32, 4)])
def test_host_band_keys_match_jax_and_the_device_fold(n, h, b):
    sig = np.random.default_rng(n + h).integers(
        0, 1 << 32, size=(n, h), dtype=np.uint64).astype(np.uint32)
    sig[: n // 2, 0] |= np.uint32(1 << 31)
    got = thost.host_band_keys(sig, b)
    assert got.dtype == np.uint32 and got.shape == (n, b)
    np.testing.assert_array_equal(got, jhost.host_band_keys(sig, b))
    np.testing.assert_array_equal(
        got, as_u32_numpy(band_keys(u32_tensor(sig), b)))


@pytest.mark.parametrize("scheme", ["kminhash", "cminhash", "weighted"])
def test_scheme_host_signatures_match_jax_and_the_plain_kernels(scheme):
    items, _ = synth_session_sets(300, set_size=16, seed=2)
    items[:20] |= np.uint32(1 << 31)
    hp = tschemes.make_params(scheme, 64, 3)
    got = tschemes.scheme_host_signatures(items, hp)
    want = jschemes.scheme_host_signatures(
        items, jschemes.make_params(scheme, 64, 3))
    np.testing.assert_array_equal(got, want)
    plain = (kmod.minhash_and_keys_plain if scheme == "kminhash"
             else kcm.cminhash_and_keys_plain)
    sig, keys = plain(u32_tensor(items), *hp.arrays, 8)
    np.testing.assert_array_equal(got, as_u32_numpy(sig))
    np.testing.assert_array_equal(thost.host_band_keys(got, 8),
                                  as_u32_numpy(keys))


@pytest.mark.parametrize("scheme", ["kminhash", "cminhash", "weighted"])
@pytest.mark.parametrize("n_hashes,n_bands,threshold", [(32, 8, 0.5),
                                                        (64, 16, 0.3)])
def test_host_cluster_matches_jax(scheme, n_hashes, n_bands, threshold):
    items, _ = synth_session_sets(800, set_size=16, seed=4)
    got = thost.host_cluster(items, n_hashes, n_bands, threshold, seed=1,
                             scheme=scheme)
    want = jhost.host_cluster(items, n_hashes, n_bands, threshold, seed=1,
                              scheme=scheme)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(got)) < items.shape[0]    # it found clusters
