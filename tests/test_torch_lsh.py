"""tse1m_tpu_torch LSH tail (hub election, estimated Jaccard, label
propagation) against the JAX package's.  Tolerance: exact; the float32
estimated Jaccard is compared bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tse1m_tpu.cluster import lsh as jlsh
from tse1m_tpu.cluster import pipeline as jpipe
from tse1m_tpu.cluster.minhash import band_keys as j_band_keys
from tse1m_tpu.cluster.minhash import make_hash_params
from tse1m_tpu.cluster.minhash import minhash_signatures as j_signatures
from tse1m_tpu.data.synth import synth_session_sets
from tse1m_tpu_torch.cluster import lsh as tlsh
from tse1m_tpu_torch.cluster import pipeline as tpipe
from tse1m_tpu_torch.device import u32_tensor


@pytest.fixture(scope="module")
def sig_keys():
    """Signatures and band keys of planted sessions, from the JAX side."""
    items, _ = synth_session_sets(1500, set_size=24, seed=11)
    a, b = make_hash_params(64, seed=2)
    sig = np.asarray(j_signatures(items, a, b))
    return sig, np.asarray(j_band_keys(sig, 16))


def test_bucket_representatives_small():
    keys = np.array([[5], [9], [5], [1], [9], [5]], dtype=np.uint32)
    reps = tlsh.bucket_representatives(u32_tensor(keys))[:, 0]
    assert reps.tolist() == [0, 1, 0, 3, 1, 0]


def test_bucket_representatives_matches_jax():
    rng = np.random.default_rng(4)
    # Few distinct keys per band, half of them >= 2^31, so runs are long
    # and the signed sort of the bit patterns is exercised.
    keys = rng.choice(np.array([0, 7, 1 << 31, 0xFFFFFFFF, 12345],
                               np.uint32), size=(800, 6))
    want = np.asarray(jlsh.bucket_representatives(jnp.asarray(keys)))
    got = tlsh.bucket_representatives(u32_tensor(keys))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_bucket_representatives_by_original_index_matches_jax(sig_keys, seed):
    """Rows in a permuted (lane) order elect the hub of minimum original
    index, mapped back into row order, as the JAX package does."""
    _, keys = sig_keys
    rng = np.random.default_rng(seed)
    n = keys.shape[0]
    lane_of = rng.permutation(n).astype(np.int32)   # original -> row
    orig = np.empty(n, np.int32)
    orig[lane_of] = np.arange(n, dtype=np.int32)    # row -> original
    lane_keys = keys[orig]
    want = np.asarray(jlsh.bucket_representatives(
        jnp.asarray(lane_keys), orig=jnp.asarray(orig),
        lane_of=jnp.asarray(lane_of)))
    got = tlsh.bucket_representatives(
        u32_tensor(lane_keys), orig=torch.from_numpy(orig).long(),
        lane_of=torch.from_numpy(lane_of).long())
    np.testing.assert_array_equal(got.numpy(), want)
    # The election does not depend on the order: mapped back, it is the
    # unpermuted election.
    plain = tlsh.bucket_representatives(u32_tensor(keys)).numpy()
    np.testing.assert_array_equal(orig[got.numpy()[lane_of]], plain)


def test_estimated_jaccard_bit_equal(sig_keys):
    sig, keys = sig_keys
    reps = np.array(jlsh.bucket_representatives(jnp.asarray(keys)))
    want = np.asarray(jlsh.estimated_jaccard(jnp.asarray(sig),
                                             jnp.asarray(reps)))
    got = tlsh.estimated_jaccard(u32_tensor(sig), torch.from_numpy(reps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("n_iters", [1, 2, 64])
def test_propagate_labels_matches_jax(n_iters):
    rng = np.random.default_rng(n_iters)
    n, bands = 600, 4
    # Star edges to random lower-or-equal indices, so chains form and a
    # small iteration cap stops before convergence in both packages.
    reps = (rng.random((n, bands)) * np.arange(n)[:, None]).astype(np.int32)
    valid = rng.random((n, bands)) < 0.3
    want = np.asarray(jlsh.propagate_labels(jnp.asarray(reps),
                                            jnp.asarray(valid),
                                            n_iters=n_iters))
    got = tlsh.propagate_labels(torch.from_numpy(reps),
                                torch.from_numpy(valid), n_iters=n_iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_cluster_from_sig_matches_jax(sig_keys, threshold):
    sig, keys = sig_keys
    want = np.asarray(jpipe._cluster_from_sig_jit(
        jnp.asarray(sig), jnp.asarray(keys), threshold, 12))
    got = tpipe._cluster_from_sig(u32_tensor(sig), u32_tensor(keys),
                                  threshold, 12)
    np.testing.assert_array_equal(got.numpy(), want)
