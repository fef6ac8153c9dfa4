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

import importlib

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


# ---------------------------------------------------------------------------
# the split, skip and merge order of K2 and K4
# ---------------------------------------------------------------------------

from repro_torch.core.segmented import (  # noqa: E402
    combine_flash_partials_tree, flash_partial_combine)
FD = importlib.import_module("repro_torch.kernels.flash_decode")


def _bias(kv_len, s, window=None):
    return T.length_bias(torch.tensor(kv_len), s, window)


@pytest.mark.parametrize("s,block,split_rows,window,kv_len", [
    (1000, 64, 128, None, [1000, 0, 333]),      # S not a split multiple
    (1000, 64, 128, 150, [900, 0, 300]),        # dead splits at both ends
    (700, 32, 32, 100, [700, 401, 1]),          # per = 1
    (640, 128, 64, 200, [640, 639, 129]),       # block > split_rows
    (5000, 256, None, 1000, [5000, 2100, 0]),   # the default SPLIT_ROWS
])
def test_split_order_plain_matches_reference(s, block, split_rows, window,
                                             kv_len):
    q, k, v = _inputs(s + block, 3, 4, 2, s, 16)
    kw = {} if split_rows is None else {"split_rows": split_rows}
    got = FD.flash_decode_torch(torch.tensor(q), torch.tensor(k),
                                torch.tensor(v), _bias(kv_len, s, window),
                                sm_scale=0.25, block_kv=block, **kw)
    want = J.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          jnp.asarray(kv_len), sm_scale=0.25, window=window,
                          block_kv=block)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


def test_split_liveness_reads_the_bias_only():
    """Dead: every entry exactly -1e30 (the padded rows past S count as
    -1e30); a request with no live split computes all of them."""
    bias = torch.full((3, 10), NEG)
    bias[0, 4] = 0.0
    bias[1, 9] = -1e29
    comp = FD.split_liveness(bias, 2, 5, 2)          # splits of 4 rows
    assert comp.tolist() == [[False, True, False], [False, False, True],
                             [True, True, True]]


def test_split_order_bitwise_independent_of_the_batch():
    """A request's output is the same bits alone and beside requests of
    other lengths (its splits and their liveness are its own)."""
    s, block = 900, 64
    q, k, v = _inputs(17, 4, 6, 3, s, 16)
    kv_len = [900, 77, 0, 512]
    for window in (None, 120):
        bias = _bias(kv_len, s, window)
        batch = FD.flash_decode_torch(torch.tensor(q), torch.tensor(k),
                                      torch.tensor(v), bias, sm_scale=0.3,
                                      block_kv=block, split_rows=128)
        for bi in range(4):
            alone = FD.flash_decode_torch(
                torch.tensor(q[bi:bi + 1]), torch.tensor(k[bi:bi + 1]),
                torch.tensor(v[bi:bi + 1]), bias[bi:bi + 1], sm_scale=0.3,
                block_kv=block, split_rows=128)
            assert torch.equal(alone[0], batch[bi]), (window, bi)


def test_no_dead_split_is_bitwise_partial_chunks():
    """Where no split is dead, ``flash_decode()`` is bitwise
    ``flash_decode(partial_chunks=C)``: the same chunks, merged in the same
    tree (``merge_tree`` of ``FlashAccumulator``)."""
    s, block = 6144, 512                            # nb 12, per 2, C 6
    q, k, v = _inputs(23, 2, 4, 2, s, 8)
    kv_len = np.asarray([6144, 5121])               # every split live
    per, c = FD.split_shape(-(-s // block), block)
    assert (per, c) == (2, 6)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v),
            torch.tensor(kv_len))
    whole = T.flash_decode(*args, sm_scale=0.3, block_kv=block,
                           device="cpu")
    chunks = T.flash_decode(*args, sm_scale=0.3, block_kv=block,
                            partial_chunks=c, device="cpu")
    assert torch.equal(whole, chunks)


@pytest.mark.parametrize("split_rows", (16, 32, 48))
def test_paged_bitwise_dense_with_dead_splits(split_rows):
    b, h, kh, d, ps, nb = 3, 4, 2, 16, 16, 7
    q, k, v = _inputs(41, b, h, kh, nb * ps, d)
    kv_len = np.asarray([100, 0, 17], np.int32)
    pool, tables = _shuffled_pool(PagedKVPool, b, nb, ps, kv_len)
    kp = np.random.RandomState(1).randn(pool.num_pages, ps, kh, d) \
        .astype(np.float32)
    vp = np.random.RandomState(2).randn(pool.num_pages, ps, kh, d) \
        .astype(np.float32)
    idx = np.clip(tables, 0, None)
    k_asm = kp[idx].reshape(b, nb * ps, kh, d)
    v_asm = vp[idx].reshape(b, nb * ps, kh, d)
    for window in (None, 40):
        bias = _bias(kv_len, nb * ps, window)
        paged = FD.flash_decode_paged_torch(
            torch.tensor(q), torch.tensor(kp), torch.tensor(vp), bias,
            torch.tensor(tables), sm_scale=0.2, split_rows=split_rows)
        dense = FD.flash_decode_torch(
            torch.tensor(q), torch.tensor(k_asm), torch.tensor(v_asm), bias,
            sm_scale=0.2, block_kv=ps, split_rows=split_rows)
        assert torch.equal(paged, dense), (split_rows, window)
        want = J.flash_decode(jnp.asarray(q), jnp.asarray(k_asm),
                              jnp.asarray(v_asm), jnp.asarray(kv_len),
                              sm_scale=0.2, window=window, block_kv=ps)
        np.testing.assert_allclose(paged.numpy(), np.asarray(want),
                                   rtol=RTOL, atol=ATOL)


def _slot_push(slot, v, n, combine):
    """The kernels' binary-counter push: merge ``slot[L] + v`` while bit L
    of the count n (before the push) is set, then store."""
    lvl = 0
    while (n >> lvl) & 1:
        v = combine(slot[lvl], v)
        lvl += 1
    slot[lvl] = v


def _slot_close(slot, n, combine):
    """The kernels' close: fold the set slots from the smallest up."""
    v = None
    for lvl in range(n.bit_length()):
        if (n >> lvl) & 1:
            v = slot[lvl] if v is None else combine(slot[lvl], v)
    return v


@pytest.mark.parametrize("c", [1, 2, 3, 5, 8, 13, 16, 31])
def test_merge_kernel_emulation_bitwise_the_pinned_tree(c):
    """``merge_kernel``: read the request's flags, keep the computed
    partials in order (all of them when none is live), push each into the
    slots and close; bitwise ``combine_flash_partials_tree`` over them,
    then ``o / max(l, 1e-30)``."""
    rng = np.random.RandomState(c)
    m = torch.tensor((rng.randn(c, 5) * 4).astype(np.float32))
    m[rng.rand(c, 5) < 0.2] = NEG
    l = torch.tensor(rng.rand(c, 5).astype(np.float32) * 30)
    o = torch.tensor(rng.randn(c, 5, 7).astype(np.float32))
    for live in (rng.rand(c) < 0.6, np.zeros(c, bool), np.ones(c, bool)):
        keep = [i for i in range(c) if live[i] or not live.any()]

        def comb(x, y):
            return flash_partial_combine(*x, *y)

        slot, n = {}, 0
        for i in keep:
            _slot_push(slot, (m[i], l[i], o[i]), n, comb)
            n += 1
        _, lk, ok = _slot_close(slot, n, comb)
        _, lt, ot = combine_flash_partials_tree(m[keep], l[keep], o[keep])
        assert torch.equal(ok / torch.clamp_min(lk, 1e-30)[..., None],
                           ot / torch.clamp_min(lt, 1e-30)[..., None])


@pytest.mark.parametrize("rows", [1, 5, 16, 31, 32, 33, 96, 100, 256, 500])
def test_split_kernel_tile_trees_emulation_bitwise(rows):
    """``split_kernel``'s trees over a block's rows: a fully unrolled
    32-row subtree per staged tile pushed at level 5, the rows of a short
    last tile at level 0, closed from the smallest slot up; and the score
    over d: tree8 chunks at level 3, leftover columns at level 0.  Both
    bitwise ``pairwise_tree_sum``."""
    rng = np.random.RandomState(rows)
    x = (rng.randn(rows) * 2.0 ** rng.randint(-20, 20, rows)) \
        .astype(np.float32)

    def add(a, b):
        return np.float32(a + b)

    def tree32(t):
        return _kernel_tree(t)                    # a full 32-leaf tree

    tiles, short = {}, {}
    full, rem = divmod(rows, 32)
    for t in range(full):
        _slot_push(tiles, tree32(x[32 * t:32 * t + 32]), t, add)
    for j in range(rem):
        _slot_push(short, x[32 * full + j], j, add)
    v = _slot_close(short, rem, add)
    for lvl in range(full.bit_length()):          # continue up the tiles
        if (full >> lvl) & 1:
            v = tiles[lvl] if v is None else add(tiles[lvl], v)
    want = pairwise_tree_sum(torch.tensor(x)).numpy()
    assert np.float32(v).tobytes() == want.tobytes()
    chunks, left = {}, {}
    nc, rem8 = divmod(rows, 8)
    for i in range(nc):
        _slot_push(chunks, _kernel_tree(x[8 * i:8 * i + 8]), i, add)
    for j in range(rem8):
        _slot_push(left, x[8 * nc + j], j, add)
    v = _slot_close(left, rem8, add)
    for lvl in range(nc.bit_length()):
        if (nc >> lvl) & 1:
            v = chunks[lvl] if v is None else add(chunks[lvl], v)
    assert np.float32(v).tobytes() == want.tobytes()


def test_smem_mirror_and_launch_limits():
    """The Python mirror of the split pass's shared memory, and the
    limits the wrapper checks before a launch."""
    assert FD.smem_bytes(6, 128, 512) == 4 * (2 * 32 * 132 + 8 * 128
                                              + 6 * 512 + 24)
    assert FD.smem_bytes(16, 30, 18) == 4 * (2 * 32 * 36 + 8 * 32
                                             + 8 * 20 + 24)
    assert [FD.group_rows(g) for g in (1, 6, 8, 9, 10, 11, 12, 16, 24)] \
        == [1, 6, 8, 3, 5, 1, 6, 8, 8]
    assert FD.split_shape(64, 512) == (2, 32)
    assert FD.split_shape(128, 256) == (4, 32)
    assert FD.split_shape(64, 512, 2048) == (4, 16)
    assert FD.split_shape(3, 4096) == (1, 3)
    q = torch.zeros(1, 2, 300)
    k = torch.zeros(1, 8, 1, 300)
    with pytest.raises(ValueError, match="CUDA"):
        FD.flash_decode_cuda(q, k, k, torch.zeros(1, 8), sm_scale=1.0)
