"""tse1m_tpu_torch exact top-k agreement scoring against the JAX package:
the kernel's plain version against the Pallas kernel in interpret mode
(called directly, not through its breaker), both states normalised, and
``topk_agreement`` against the JAX jnp reference and the numpy host oracle
over the edge cases.  Tolerance: exact, element for element."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tse1m_tpu.cluster.kernels import score as jscore
from tse1m_tpu_torch import topk_agreement
from tse1m_tpu_torch.cluster import kernels
from tse1m_tpu_torch.cluster.kernels import score as ksc
from tse1m_tpu_torch.device import u32_tensor

BLOCK_N = 128


def _sigs(rng, shape, alphabet):
    """Signatures over a small alphabet: many agreements and many ties."""
    return rng.integers(0, alphabet, size=shape, dtype=np.uint64).astype(
        np.uint32)


def _chunk(store: np.ndarray, base: int):
    """The JAX staging layout: [H, Np] transposed, ROW_INF row ids on
    padding, Np a multiple of BLOCK_N."""
    n, h = store.shape
    np_ = max(1, -(-n // BLOCK_N)) * BLOCK_N
    s_t = np.zeros((h, np_), np.uint32)
    s_t[:, :n] = store.T
    rid = np.full((1, np_), jscore.ROW_INF, np.int32)
    rid[0, :n] = np.arange(base, base + n)
    return s_t, rid


def _normalised(c, r):
    c, r = np.array(c, np.int32), np.array(r, np.int32)
    empty = c < 0
    c[empty] = -1
    r[empty] = ksc.ROW_INF
    return c, r


def test_constants_match_jax():
    assert ksc.K_PAD == jscore.K_PAD and ksc.ROW_INF == int(jscore.ROW_INF)


@pytest.mark.parametrize("qn,n,h,k,alphabet", [
    (5, 1000, 16, 7, 3),      # Q not a power of two, N ragged vs BLOCK_N
    (8, 300, 16, 128, 2),     # k = K_PAD: exhausted slots
    (3, 5, 8, 10, 4),         # N < k
    (4, 256, 32, 1, 1 << 32), # full-range values: ties at count 0
])
def test_topk_chunk_plain_matches_pallas(qn, n, h, k, alphabet):
    rng = np.random.default_rng(qn * n + k)
    q = _sigs(rng, (qn, h), alphabet)
    stores = [_sigs(rng, (n, h), alphabet), _sigs(rng, (n + 37, h), alphabet)]
    stores[0][3] = q[0]
    topc = np.full((qn, ksc.K_PAD), -1, np.int32)
    topr = np.full((qn, ksc.K_PAD), jscore.ROW_INF, np.int32)
    jc, jr = jnp.asarray(topc), jnp.asarray(topr)
    tc, tr = torch.from_numpy(topc), torch.from_numpy(topr)
    base = 0
    # Two chunks: the second merges into the first one's state.
    for store in stores:
        s_t, rid = _chunk(store, base)
        base += store.shape[0]
        jc, jr = jscore._topk_chunk_pallas(jnp.asarray(q), jnp.asarray(s_t),
                                           jnp.asarray(rid), jc, jr, k,
                                           BLOCK_N, True)
        tc, tr = ksc.topk_chunk(u32_tensor(q), u32_tensor(s_t),
                                torch.from_numpy(rid), tc, tr, k)
        want = _normalised(jc, jr)
        np.testing.assert_array_equal(tc.numpy(), want[0])
        np.testing.assert_array_equal(tr.numpy(), want[1])
    assert (tc[:, k:] == -1).all() and (tr[:, k:] == ksc.ROW_INF).all()


def test_plain_tiling_does_not_change_the_state():
    rng = np.random.default_rng(1)
    q = u32_tensor(_sigs(rng, (6, 16), 3))
    s_t, rid = _chunk(_sigs(rng, (900, 16), 3), 0)
    args = (q, u32_tensor(s_t), torch.from_numpy(rid),
            *ksc._init_state(6, torch.device("cpu")), 9)
    one = ksc.topk_chunk_plain(*args, block_n=s_t.shape[1])
    for block_n in (128, 384):
        for g, w in zip(ksc.topk_chunk_plain(*args, block_n=block_n), one):
            assert torch.equal(g, w)


@pytest.mark.parametrize("qn,n,k", [
    (5, 1000, 7), (1, 1000, 128), (6, 3, 10), (3, 513, 0), (0, 10, 4),
    (4, 0, 4), (9, 700, 1),
])
def test_topk_agreement_matches_jax_and_host(qn, n, k):
    rng = np.random.default_rng(qn + n + k)
    store = _sigs(rng, (n, 16), 3)
    q = _sigs(rng, (qn, 16), 3)
    if n and qn:
        q[0] = store[n // 2]     # a full-agreement hit
    got = topk_agreement(q, store, k, device="cpu", block_n=BLOCK_N)
    want = jscore.topk_agreement(q, store, k, use_pallas="never",
                                 block_n=BLOCK_N)
    host = jscore.score_topk_host(q, store, k)
    for g, w, o in zip(got, want, host):
        assert g.dtype == np.int32 and g.shape == (qn, k)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, o)
    if n and qn and k:
        assert got[0][0, 0] == 16 and got[1][0, 0] == n // 2


def test_k_out_of_range_and_shapes_raise():
    q = np.zeros((2, 8), np.uint32)
    with pytest.raises(ValueError, match="outside"):
        topk_agreement(q, q, 129, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        topk_agreement(q, q, -1, device="cpu")
    with pytest.raises(ValueError, match=r"\[Q, H\]"):
        topk_agreement(q, np.zeros((2, 4), np.uint32), 1, device="cpu")
    state = ksc._init_state(2, torch.device("cpu"))
    s_t = torch.zeros((8, 4), dtype=torch.int32)
    rid = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="rowids"):
        ksc.topk_chunk(u32_tensor(q), s_t, rid[:, :3], *state, 1)
    with pytest.raises(ValueError, match="state"):
        ksc.topk_chunk(u32_tensor(q), s_t, rid, state[0][:1], state[1], 1)


def test_topk_agreement_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    q = np.zeros((2, 8), np.uint32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topk_agreement(q, q, 1)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    rng = np.random.default_rng(2)
    s_t, rid = _chunk(_sigs(rng, (200, 16), 3), 0)
    args = (u32_tensor(_sigs(rng, (8, 16), 3)), u32_tensor(s_t),
            torch.from_numpy(rid), *ksc._init_state(8, torch.device("cpu")),
            5)
    kernels.reset_launch_counts()
    for g, w in zip(ksc.topk_chunk(*args), ksc.topk_chunk_plain(*args)):
        assert torch.equal(g, w)
    assert kernels.launch_counts()["topk_chunk"] == 0
