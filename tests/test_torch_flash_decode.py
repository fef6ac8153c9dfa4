"""K2, K3, K4 — flash-decode attention — held against the TPU kernels.

The same numpy inputs go through ``repro.kernels.ops.flash_decode`` /
``flash_decode_paged`` (Pallas in interpret mode) and the port's
wrappers with ``device="cpu"`` (the kernels' plain versions).  The two
sum in different orders (XLA's dot against the port's pinned pairwise
trees), so they agree within RTOL/ATOL; within the port, the paged path
is bitwise equal to the dense one at ``block_kv == ps``.  The CUDA
kernels are held to these plain versions bitwise in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as J  # noqa: E402
from repro.serve import PagedKVPool as JPool  # noqa: E402
from repro_torch.core.trees import pairwise_tree_sum  # noqa: E402
from repro_torch.kernels import ops as T  # noqa: E402
from repro_torch.kernels.flash_decode import (  # noqa: E402
    NEG, flash_decode_paged_torch, flash_decode_torch)
from repro_torch.kernels.ref import flash_decode_ref  # noqa: E402
from repro_torch.serve import PagedKVPool  # noqa: E402

#: port against reference: f32 sums of <= 1,024 terms of magnitude ~1 in
#: two orders (measured max difference 1.8e-7 on these shapes)
RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, b, h, kh, s, d):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, d).astype(np.float32),
            rng.randn(b, s, kh, d).astype(np.float32),
            rng.randn(b, s, kh, d).astype(np.float32))


def _both(q, k, v, kv_len, **kw):
    want = J.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(kv_len), **kw)
    got = T.flash_decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         torch.tensor(kv_len), device="cpu", **kw)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("b,h,k,s,d,window", [
    (2, 8, 4, 700, 64, None),
    (1, 4, 4, 512, 128, None),
    (2, 8, 2, 300, 32, 128),
    (3, 6, 6, 1024, 64, None),
])
def test_flash_decode_matches_reference(b, h, k, s, d, window):
    q, kk, vv = _inputs(b * s, b, h, k, s, d)
    kv_len = np.random.RandomState(s).randint(s // 2, s + 1, b)
    want, got = _both(q, kk, vv, kv_len, sm_scale=d ** -0.5, window=window,
                      block_kv=256)
    assert got.shape == (b, h, d) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("chunks", (2, 3))
def test_partial_chunks_match_reference_and_single_stream(chunks):
    q, k, v = _inputs(7, 2, 4, 2, 96, 32)
    kv_len = np.asarray([96, 41])
    want, got = _both(q, k, v, kv_len, sm_scale=0.125, block_kv=16,
                      partial_chunks=chunks)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    fused = T.flash_decode(torch.tensor(q), torch.tensor(k),
                           torch.tensor(v), torch.tensor(kv_len),
                           sm_scale=0.125, block_kv=16, device="cpu")
    np.testing.assert_allclose(got, fused.numpy(), rtol=RTOL, atol=ATOL)


def test_masked_prefix_and_empty_request_match_reference():
    """-1e30, never -inf: a fully masked first block is wiped by the
    first valid block's alpha = 0; a request with kv_len = 0 gets the mean
    of V over the padded S (zero rows included), not NaN."""
    q, k, v = _inputs(9, 3, 4, 2, 1000, 32)
    kv_len = np.asarray([900, 0, 300])
    want, got = _both(q, k, v, kv_len, sm_scale=0.2, window=150,
                      block_kv=128)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    padded = np.concatenate([v, np.zeros((3, 24, 2, 32), np.float32)], 1)
    mean_v = padded[1].mean(0)                       # (K, d)
    np.testing.assert_allclose(got[1].reshape(2, 2, 32),
                               np.repeat(mean_v[:, None], 2, 1),
                               rtol=1e-5, atol=1e-6)


def _shuffled_pool(pool_cls, b, nb, ps, kv_len):
    """The reference's construction: interleaved alloc/free, so physical
    pages land in a non-trivial order."""
    pool = pool_cls(num_pages=b * nb + 2, page_size=ps)
    pool.alloc(99, 2 * ps)
    tables = []
    for bi in range(b):
        pool.alloc(bi, int(kv_len[bi]))
        if bi == 0:
            pool.free(99)
        tables.append(pool.page_table(bi, max_pages=nb))
    return pool, np.stack(tables)


def test_paged_matches_dense_bitwise_and_reference():
    b, h, kh, d, ps, nb = 3, 8, 2, 32, 16, 4
    q, k, v = _inputs(3, b, h, kh, nb * ps, d)
    kv_len = np.asarray([5, 37, 64], np.int32)
    pool, tables = _shuffled_pool(PagedKVPool, b, nb, ps, kv_len)
    kp = np.zeros((pool.num_pages, ps, kh, d), np.float32)
    vp = np.zeros((pool.num_pages, ps, kh, d), np.float32)
    for bi in range(b):
        for j, pg in enumerate(pool.pages_of(bi)):
            kp[pg] = k[bi, j * ps:(j + 1) * ps]
            vp[pg] = v[bi, j * ps:(j + 1) * ps]
    args = (torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
            torch.tensor(tables), torch.tensor(kv_len))
    paged = T.flash_decode_paged(*args, sm_scale=0.125, device="cpu")
    dense = T.flash_decode(torch.tensor(q), torch.tensor(k),
                           torch.tensor(v), torch.tensor(kv_len),
                           sm_scale=0.125, block_kv=ps, device="cpu")
    assert torch.equal(paged, dense), "paged gather diverged bitwise"
    want = J.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp),
                                jnp.asarray(vp), jnp.asarray(tables),
                                jnp.asarray(kv_len), sm_scale=0.125)
    np.testing.assert_allclose(paged.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_paged_clamps_out_of_pool_pages_into_the_pool():
    """FREE_PAGE (-1) reads page 0; an entry past the pool reads the last
    page: no read leaves the pool."""
    q, k, _ = _inputs(4, 1, 2, 1, 32, 8)
    kp = torch.tensor(k.reshape(4, 8, 1, 8))
    bias = torch.zeros((1, 24))
    tab = torch.tensor([[-1, 3, 7]], dtype=torch.int32)
    got = flash_decode_paged_torch(torch.tensor(q), kp, kp, bias, tab,
                                   sm_scale=0.3)
    same = flash_decode_paged_torch(torch.tensor(q), kp, kp, bias,
                                    torch.tensor([[0, 3, 3]],
                                                 dtype=torch.int32),
                                    sm_scale=0.3)
    assert torch.equal(got, same)


def test_plain_version_matches_materialized_oracle():
    """Each (batch, kv-head) pair of the plain K2 against the materialized
    softmax of ``ref.flash_decode_ref``."""
    q, k, v = _inputs(5, 2, 6, 3, 200, 16)
    bias = torch.where(torch.arange(200)[None] < torch.tensor([[150], [7]]),
                       0.0, NEG).to(torch.float32)
    got = flash_decode_torch(torch.tensor(q), torch.tensor(k),
                             torch.tensor(v), bias, sm_scale=0.25,
                             block_kv=64)
    for bi in range(2):
        for kh in range(3):
            o = flash_decode_ref(torch.tensor(q[bi, 2 * kh:2 * kh + 2]),
                                 torch.tensor(k[bi, :, kh]),
                                 torch.tensor(v[bi, :, kh]), bias[bi:bi + 1],
                                 sm_scale=0.25)
            np.testing.assert_allclose(got[bi, 2 * kh:2 * kh + 2].numpy(),
                                       o.numpy(), rtol=RTOL, atol=ATOL)


def _kernel_tree(x):
    """The CUDA kernels' sum, emulated in float32: 8-leaf subtrees pushed
    at level 3, leftover leaves at level 0, on a binary-counter stack;
    closed by a fold from the top of the stack down."""
    stk, cnt = [], 0

    def push(v, lvl):
        nonlocal cnt
        cnt += 1 << lvl
        low = cnt & -cnt
        for _ in range(low.bit_length() - 1 - lvl):
            v = np.float32(stk.pop() + v)
        stk.append(v)

    i = 0
    while i + 8 <= len(x):
        t = x[i:i + 8]
        push(np.float32(np.float32(np.float32(t[0] + t[1])
                                   + np.float32(t[2] + t[3]))
                        + np.float32(np.float32(t[4] + t[5])
                                     + np.float32(t[6] + t[7]))), 3)
        i += 8
    for t in x[i:]:
        push(t, 0)
    v = stk[-1]
    for t in reversed(stk[:-1]):
        v = np.float32(t + v)
    return v


@pytest.mark.parametrize("n", [1, 2, 3, 7, 8, 9, 13, 31, 64, 100, 129, 200])
def test_kernel_tree_order_is_the_plain_pairwise_tree(n):
    """The in-block order the CUDA kernels build is bit for bit
    ``pairwise_tree_sum``, the order of the plain versions."""
    x = (np.random.RandomState(n).randn(n)
         * 2.0 ** np.random.RandomState(n + 1).randint(-20, 20, n)
         ).astype(np.float32)
    want = pairwise_tree_sum(torch.tensor(x)).numpy()
    assert _kernel_tree(x).tobytes() == want.tobytes()


def test_bad_shapes_raise_with_the_reference_messages():
    q = torch.zeros(2, 4, 32)
    k = torch.zeros(2, 64, 2, 32)
    bias = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="expected q"):
        flash_decode_torch(q[0], k, k, bias, sm_scale=1.0)
    with pytest.raises(ValueError, match="must match"):
        flash_decode_torch(q, k, torch.zeros(2, 32, 2, 32), bias,
                           sm_scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        flash_decode_torch(torch.zeros(2, 4, 16), k, k, bias, sm_scale=1.0)
    with pytest.raises(ValueError, match="bias"):
        flash_decode_torch(q, k, k, torch.zeros(2, 12), sm_scale=1.0)
    kp = torch.zeros(8, 16, 2, 16)
    qp = torch.zeros(2, 4, 16)
    for pkg, arr in ((T, torch.tensor), (J, jnp.asarray)):
        kw = {"device": "cpu"} if pkg is T else {}
        with pytest.raises(ValueError, match="page_tables"):
            pkg.flash_decode_paged(arr(qp.numpy()), arr(kp.numpy()),
                                   arr(kp.numpy()),
                                   arr(np.zeros((3, 4), np.int32)),
                                   arr(np.ones(2, np.int32)), sm_scale=1.0,
                                   **kw)
        with pytest.raises(ValueError, match="expected q"):
            pkg.flash_decode_paged(arr(qp[0].numpy()), arr(kp.numpy()),
                                   arr(kp.numpy()),
                                   arr(np.zeros((2, 4), np.int32)),
                                   arr(np.ones(2, np.int32)), sm_scale=1.0,
                                   **kw)


def test_pool_matches_reference_pool():
    """The same alloc/extend/free sequence gives the reference's tables,
    free counts and errors."""
    pools = [JPool(num_pages=12, page_size=4), PagedKVPool(12, 4)]
    steps = [("alloc", 0, 10), ("alloc", 1, 3), ("extend", 0, 17),
             ("alloc", 2, 1), ("free", 1), ("alloc", 3, 9),
             ("extend", 2, 6), ("free", 0), ("alloc", 4, 30),
             ("alloc", 5, 5)]
    for step in steps:
        out = []
        for pool in pools:
            try:
                r = getattr(pool, step[0])(*step[1:])
                out.append(("ok", r, pool.free_pages, pool.live_requests,
                            [pool.page_table(i, 8).tolist()
                             for i in range(6) if pool.owns(i)]))
            except Exception as e:          # the error is the result
                out.append((type(e).__name__, str(e)))
        assert out[0] == out[1], step
    assert repr(pools[0]) == repr(pools[1])
