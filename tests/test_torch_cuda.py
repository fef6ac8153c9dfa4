"""GPU-only tests of the port: K1 against its plain version on the card.

Every test here carries the ``cuda`` marker and skips where
``torch.cuda.is_available()`` is False.  The file imports no JAX, so it
runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.kernels import jugglepac_segsum as K  # noqa: E402
from repro_torch.reduce import get_policy, plan_program  # noqa: E402

POLICIES = ("fast", "compensated", "exact", "exact2", "procrastinate")
S = 48


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: torch.cuda.is_available() is "
                    "False (the kernel has no CPU mode; chip_smoke.py runs "
                    "the same comparison on the GPU)")
    return torch.device("cuda")


def _stream(seed, n, d, s):
    rng = np.random.RandomState(seed)
    vals = (rng.randn(n, d) * 2.0 ** rng.randint(-6, 6, (n, 1))) \
        .astype(np.float32)
    ids = rng.randint(-1, s, n).astype(np.int32)
    return vals, ids


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_kernel_bitwise_plain_version(policy, cuda):
    """Every tier x {dot, lanes} x block sizes {64, 128, 512}, on a ragged
    stream (4,000 rows: the kernel reads the missing rows of the last
    block as sentinel rows; the plain version is given them padded)."""
    vals, ids = _stream(11, 4000, 16, S)
    pol = get_policy(policy)
    dom, _ = pol.prepare(torch.tensor(vals, device=cuda), len(ids))
    tids = torch.tensor(ids, device=cuda)
    for contrib in ("dot", "lanes"):
        for block in (64, 128, 512):
            prog = plan_program(pol, num_segments=S,
                                domain_width=dom.shape[1], block_size=block,
                                contrib=contrib)
            pad = (-len(ids)) % block
            pdom = torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))])
            pids = torch.cat([tids, tids.new_full((pad,), -1)])
            plain = K.segsum_policy_torch(pdom, pids, S, policy=pol,
                                          program=prog, block_rows=block)
            kern = K.segsum_policy_cuda(dom, tids, S, policy=pol,
                                        program=prog, block_rows=block)
            torch.cuda.synchronize()
            for a, b in zip(plain, kern):
                assert torch.equal(a, b), (policy, contrib, block)


def _runs_stream(seed, n, d, s, block):
    """Back-to-back runs of s labels with 5% sentinel rows, one whole
    schedule block of sentinels (rows [block, 2 * block)), magnitudes
    2^-30..2^30, 10% of the values -0.0 and every row of label 5 -0.0."""
    rng = np.random.RandomState(seed)
    cuts = np.sort(rng.choice(np.arange(1, n), size=4 * s, replace=False))
    ids = np.empty(n, np.int32)
    for r, rows in enumerate(np.split(np.arange(n), cuts)):
        ids[rows] = r % s
    ids[rng.rand(n) < 0.05] = -1
    ids[block:2 * block] = -1
    vals = rng.randn(n, d) * 2.0 ** rng.randint(-30, 31, (n, d))
    vals[rng.rand(n, d) < 0.1] = -0.0
    vals[ids == 5] = -0.0
    return vals.astype(np.float32), ids


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ("fast", "compensated"))
def test_cuda_float_tree_bitwise_on_runs(policy, cuda):
    """The float tiers' shared tree and per-label descent, {dot, lanes} x
    block sizes {96, 4096} (several tree chunks per lane), on a ragged
    stream of back-to-back runs with an all-sentinel block and -0.0
    values, 20 columns (a ragged column tile) and 2 label tiles."""
    pol = get_policy(policy)
    for block in (96, 4096):
        vals, ids = _runs_stream(13, 3 * 4096 + 1234, 20, S, block)
        dom = torch.tensor(vals, device=cuda)
        tids = torch.tensor(ids, device=cuda)
        pad = (-len(ids)) % block
        pdom = torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))])
        pids = torch.cat([tids, tids.new_full((pad,), -1)])
        for contrib in ("dot", "lanes"):
            prog = plan_program(pol, num_segments=S,
                                domain_width=dom.shape[1], block_size=block,
                                contrib=contrib)
            plain = K.segsum_policy_torch(pdom, pids, S, policy=pol,
                                          program=prog, block_rows=block)
            kern = K.segsum_policy_cuda(dom, tids, S, policy=pol,
                                        program=prog, block_rows=block)
            torch.cuda.synchronize()
            for a, b in zip(plain, kern):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                    (policy, contrib, block)


@pytest.mark.cuda
@pytest.mark.parametrize("block", (64, 96, 512, 4096))
def test_cuda_block_ranges_bitwise_plain(block, cuda):
    """K1's pre-pass alone against ``block_label_ranges_torch``: a ragged
    N, labels outside the label space and the int32 extremes, an
    all-sentinel block, the whole space and a window at an offset."""
    rng = np.random.RandomState(block)
    n = 4 * block + block // 2 + 1
    ids = rng.randint(-5, 45, n).astype(np.int32)
    ids[block:2 * block] = -1
    ids[0], ids[-1] = -2 ** 31, 2 ** 31 - 1
    tids = torch.tensor(ids, device=cuda)
    for off, s in ((0, 40), (7, 13)):
        got = K.block_label_ranges_cuda(tids, block, s, off)
        want = K.block_label_ranges_torch(tids, block, s, off)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (off, s)


def _int_case(case, policy, device):
    """(domain, ids, num_segments, seg_offset, block) of one integer-tier
    case; see ``test_cuda_int_tiers_bitwise_plain``."""
    rng = np.random.RandomState(31)
    pol = get_policy(policy)
    n, d, s, off, block = 4000, 16, S, 0, 512
    if case == "random":
        n, d, s = 20000, 64, 4096
    elif case in ("d20", "d18"):
        d, block = int(case[1:]), 128
    elif case == "ragged":
        n, block = 3 * 4096 + 1234, 4096
    elif case == "offset":
        s, off, block = 16, 24, 128
    space = 40 if case == "offset" else s
    if case in ("d20", "d18", "ragged"):
        vals, ids = _runs_stream(14, n, d, s, block)
    else:
        vals, ids = _stream(15, n, d, space)
    if case == "wrap":       # half the entries near +-2^30: sums wrap
        w = pol.parts * d
        near = (2 ** 30 - 64 * rng.randint(0, 1024, (n, w))) \
            * rng.choice([-1, 1], (n, w))
        dom = np.where(rng.rand(n, w) < 0.5, near,
                       rng.randint(-2 ** 20, 2 ** 20, (n, w)))
        dom = torch.tensor(dom.astype(np.float32 if policy == "exact2"
                                      else np.int32), device=device)
    else:
        dom, _ = pol.prepare(torch.tensor(vals, device=device), n)
    return dom, torch.tensor(ids, device=device), s, off, block


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("wrap", "random", "d20", "d18", "ragged",
                                  "offset"))
@pytest.mark.parametrize("policy", ("exact", "exact2", "procrastinate"))
def test_cuda_int_tiers_bitwise_plain(policy, case, cuda):
    """The integer tiers' register runs, every carry component bitwise:
    ``wrap`` a domain near +-2^30 whose ``ovf`` ends nonzero; ``random``
    labels at S=4,096, D=64 (every block touches every label tile);
    ``d20`` a ragged 4-column tile of 16-byte loads; ``d18`` the scalar
    loads; ``ragged`` N at B=4,096; ``offset`` a label window at 24."""
    pol = get_policy(policy)
    dom, tids, s, off, block = _int_case(case, policy, cuda)
    pad = (-len(tids)) % block
    pdom = torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))])
    pids = torch.cat([tids, tids.new_full((pad,), -1)])
    for contrib in ("dot", "lanes"):
        prog = plan_program(pol, num_segments=s, domain_width=dom.shape[1],
                            block_size=block, contrib=contrib)
        plain = K.segsum_policy_torch(pdom, pids, s, policy=pol,
                                      program=prog, block_rows=block,
                                      seg_offset=off)
        kern = K.segsum_policy_cuda(dom, tids, s, policy=pol, program=prog,
                                    block_rows=block, seg_offset=off)
        torch.cuda.synchronize()
        for a, b in zip(plain, kern):
            assert torch.equal(a, b), (policy, case, contrib)
    if case == "wrap" and policy != "exact":
        assert kern[-1].any()


@pytest.mark.cuda
def test_reduce_runs_on_the_card_by_default(cuda):
    """``device=None`` means the card: the result lives there, K1 ran, and
    it equals the plain ``blocked`` executor's bits for every tier."""
    vals, ids = _stream(12, 3000, 8, 40)
    for policy in POLICIES:
        before = K.LAUNCHES
        out = repro_torch.reduce(torch.tensor(vals),
                                 segment_ids=torch.tensor(ids),
                                 num_segments=40, policy=policy)
        assert out.is_cuda and K.LAUNCHES == before + 1
        plain = repro_torch.reduce(torch.tensor(vals, device=cuda),
                                   segment_ids=torch.tensor(ids,
                                                            device=cuda),
                                   num_segments=40, policy=policy,
                                   backend="blocked")
        assert torch.equal(out, plain), policy


def _one_label_stream(seed, n, d, block, device):
    """Labels mostly 0, 10% sentinels and 5% of label 1, an all-sentinel
    schedule block where N allows; values over 2^-30..2^30, 10% -0.0."""
    rng = np.random.RandomState(seed)
    ids = np.zeros(n, np.int32)
    u = rng.rand(n)
    ids[u < 0.1] = -1
    ids[(u >= 0.1) & (u < 0.15)] = 1
    if n >= 3 * block:
        ids[block:2 * block] = -1
    vals = rng.randn(n, d) * 2.0 ** rng.randint(-30, 31, (n, d))
    vals[rng.rand(n, d) < 0.1] = -0.0
    return (torch.tensor(vals.astype(np.float32), device=device),
            torch.tensor(ids, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", POLICIES)
def test_cuda_one_label_bitwise_plain_and_blocked(policy, cuda):
    """K1's one-label schedule, every carry component bitwise the plain
    version, at B = 1 (one CUDA kernel: 4 rows, 16-byte and scalar loads)
    and B = 512 (contributions, then the fold: a ragged N with an
    all-sentinel block), dot and lane forms; the integer tiers also on a
    domain near +-2^30 (``ovf`` ends nonzero at 1,024 columns; 4 rows of
    18 columns may not wrap); ``reduce`` on the
    ``cuda`` backend bitwise ``blocked`` at one label.  A two-label
    launch (the label schedule) stays bitwise its plain version."""
    pol = get_policy(policy)
    rng = np.random.RandomState(41)
    for block, n in ((1, 4), (512, 3 * 512 + 77)):
        for d in (1024, 18):
            vals, ids = _one_label_stream(block + d, n, d, block, cuda)
            doms = [pol.prepare(vals, n)[0]]
            if pol.integer:
                w = pol.parts * d
                near = (2 ** 30 - 64 * rng.randint(0, 1024, (n, w))) \
                    * rng.choice([-1, 1], (n, w))
                dom = np.where(rng.rand(n, w) < 0.5, near,
                               rng.randint(-2 ** 20, 2 ** 20, (n, w)))
                doms.append(torch.tensor(
                    dom.astype(np.float32 if policy == "exact2"
                               else np.int32), device=cuda))
            pad = (-n) % block
            pids = torch.cat([ids, ids.new_full((pad,), -1)])
            for k, dom in enumerate(doms):
                pdom = torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))])
                for contrib in ("dot", "lanes"):
                    prog = plan_program(pol, num_segments=1,
                                        domain_width=dom.shape[1],
                                        block_size=block, contrib=contrib)
                    before = K.LAUNCHES
                    kern = K.segsum_policy_cuda(dom, ids, 1, policy=pol,
                                                program=prog,
                                                block_rows=block)
                    assert K.LAUNCHES == before + 1
                    plain = K.segsum_policy_torch(pdom, pids, 1, policy=pol,
                                                  program=prog,
                                                  block_rows=block)
                    torch.cuda.synchronize()
                    for a, b in zip(plain, kern):
                        assert torch.equal(a.view(torch.int32),
                                           b.view(torch.int32)), \
                            (block, d, k, contrib)
                if k == 1 and policy != "exact" and d == 1024:
                    assert kern[-1].any(), block    # the carry wrapped
            for contrib in ("dot", "lanes"):
                got, want = (repro_torch.reduce(
                    vals, segment_ids=ids, num_segments=1, policy=policy,
                    block_size=block, contrib=contrib, backend=backend)
                    for backend in ("cuda", "blocked"))
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (block, d)
    vals, ids = _stream(16, 3000, 16, 2)
    dom, _ = pol.prepare(torch.tensor(vals, device=cuda), len(ids))
    tids = torch.tensor(ids, device=cuda)
    assert not isinstance(K.launch_plan(pol, 2, dom.shape[1], 3000, 512),
                          K.WidePlan)
    pad = (-3000) % 512
    plain = K.segsum_policy_torch(
        torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))]),
        torch.cat([tids, tids.new_full((pad,), -1)]), 2, policy=pol,
        block_rows=512)
    kern = K.segsum_policy_cuda(dom, tids, 2, policy=pol, block_rows=512)
    torch.cuda.synchronize()
    for a, b in zip(plain, kern):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# K2-K5 against their plain versions
# ---------------------------------------------------------------------------


def _decode_inputs(seed, b, h, kh, s, d, device):
    rng = np.random.RandomState(seed)
    q = torch.tensor(rng.randn(b, h, d).astype(np.float32), device=device)
    k = torch.tensor(rng.randn(b, s, kh, d).astype(np.float32),
                     device=device)
    v = torch.tensor(rng.randn(b, s, kh, d).astype(np.float32),
                     device=device)
    kv_len = rng.randint(0, s + 1, b)
    kv_len[0] = 0                       # a request with no valid key
    return q, k, v, torch.tensor(kv_len, device=device)


def _fd():
    import importlib
    return importlib.import_module("repro_torch.kernels.flash_decode")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 8, 2, 1000, 64, 256),
                                   (2, 12, 2, 700, 128, 512),
                                   (2, 4, 4, 300, 30, 16),
                                   (3, 14, 2, 1000, 128, 256)],
                         ids=["G4", "G6", "odd-d", "G7"])
def test_cuda_flash_decode_bitwise_plain_version(shape, cuda):
    """K2 and K3 (chunks of 1 and 3 blocks) to the bit of their plain
    versions, window and masked rows included; G7 is qwen2-vl-7b's group
    of 7 query heads a KV head at its head width (one group of 7 rows a
    CUDA block, a thread's last row past the group's end)."""
    from repro_torch.kernels import ops
    fd = _fd()
    b, h, kh, s, d, block = shape
    q, k, v, kv_len = _decode_inputs(21, b, h, kh, s, d, cuda)
    for window in (None, 200):
        bias = ops.length_bias(kv_len, s, window)
        want = fd.flash_decode_torch(q, k, v, bias, sm_scale=d ** -0.5,
                                     block_kv=block)
        got = fd.flash_decode_cuda(q, k, v, bias, sm_scale=d ** -0.5,
                                   block_kv=block)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (shape, window)
        for per in (1, 3):
            want = fd.flash_decode_partial_torch(
                q, k, v, bias, sm_scale=d ** -0.5, block_kv=block, per=per)
            got = fd.flash_decode_partial_cuda(
                q, k, v, bias, sm_scale=d ** -0.5, block_kv=block, per=per)
            torch.cuda.synchronize()
            for a, c in zip(want, got):
                assert torch.equal(a, c), (shape, window, per)


@pytest.mark.cuda
def test_cuda_paged_bitwise_plain_and_dense(cuda):
    """K4 to the bit of its plain version, and of K2 at block_kv == ps on
    the logically assembled cache, from a shuffled pool."""
    from repro_torch.kernels import ops
    from repro_torch.serve import PagedKVPool
    b, h, kh, d, ps, nb = 3, 8, 2, 64, 16, 6
    q, k, v, kv_len = _decode_inputs(22, b, h, kh, nb * ps, d, cuda)
    pool = PagedKVPool(num_pages=b * nb + 4, page_size=ps)
    pool.alloc(99, 3 * ps)
    for bi in range(b):
        pool.alloc(bi, int(kv_len[bi]))
        if bi == 0:
            pool.free(99)
    tables = torch.tensor(np.stack([pool.page_table(bi, max_pages=nb)
                                    for bi in range(b)]), device=cuda)
    kp = torch.randn((pool.num_pages, ps, kh, d), device=cuda)
    vp = torch.randn((pool.num_pages, ps, kh, d), device=cuda)
    idx = tables.clamp_min(0).long()
    k_asm = kp[idx].reshape(b, nb * ps, kh, d)
    v_asm = vp[idx].reshape(b, nb * ps, kh, d)
    fd = _fd()
    before = fd.LAUNCHES["paged"]
    paged = ops.flash_decode_paged(q, kp, vp, tables, kv_len,
                                   sm_scale=0.125)
    dense = ops.flash_decode(q, k_asm, v_asm, kv_len, sm_scale=0.125,
                             block_kv=ps)
    plain = ops.flash_decode_paged(q.cpu(), kp.cpu(), vp.cpu(),
                                   tables.cpu(), kv_len.cpu(),
                                   sm_scale=0.125, device="cpu")
    torch.cuda.synchronize()
    assert fd.LAUNCHES["paged"] == before + 1
    assert torch.equal(paged, dense)
    bias = ops.length_bias(kv_len, nb * ps)
    want = fd.flash_decode_paged_torch(q, kp, vp, bias, tables.int(),
                                       sm_scale=0.125)
    assert torch.equal(paged, want)
    assert torch.allclose(paged.cpu(), plain, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("split_rows", (32, 128, 1024))
def test_cuda_split_order_bitwise_plain(split_rows, cuda):
    """K2 and K4 with per = 1 and > 1: dead splits at both ends (window),
    a request with kv_len = 0, S not a multiple of the split, a head dim
    of 30 (4-byte copies) and G = 10 (two query-row groups)."""
    from repro_torch.kernels import ops
    fd = _fd()
    for b, h, kh, s, d, block in ((4, 12, 2, 1000, 64, 32),
                                  (3, 10, 1, 700, 30, 64),
                                  (2, 8, 2, 300, 128, 16)):
        q, k, v, kv_len = _decode_inputs(31, b, h, kh, s, d, cuda)
        for window in (None, 100):
            bias = ops.length_bias(kv_len, s, window)
            want = fd.flash_decode_torch(q, k, v, bias, sm_scale=0.2,
                                         block_kv=block,
                                         split_rows=split_rows)
            got = fd.flash_decode_cuda(q, k, v, bias, sm_scale=0.2,
                                       block_kv=block, split_rows=split_rows)
            torch.cuda.synchronize()
            assert torch.equal(want, got), (b, s, d, window, split_rows)
    ps, nb = 16, 9
    q, k, v, kv_len = _decode_inputs(32, 3, 8, 2, nb * ps, 64, cuda)
    tables = torch.randint(0, 40, (3, nb), device=cuda, dtype=torch.int32)
    tables[0, 5:] = -1
    kp = torch.randn((40, ps, 2, 64), device=cuda)
    vp = torch.randn((40, ps, 2, 64), device=cuda)
    for window in (None, 50):
        bias = ops.length_bias(kv_len, nb * ps, window)
        want = fd.flash_decode_paged_torch(q, kp, vp, bias, tables,
                                           sm_scale=0.2,
                                           split_rows=split_rows)
        got = fd.flash_decode_paged_cuda(q, kp, vp, bias, tables,
                                         sm_scale=0.2, split_rows=split_rows)
        torch.cuda.synchronize()
        assert torch.equal(want, got), (window, split_rows)


@pytest.mark.cuda
def test_cuda_split_order_batch_independent_and_partial_chunks(cuda):
    """On the card: a request's bits alone equal its bits in a batch, and
    with no dead split ``flash_decode()`` equals
    ``flash_decode(partial_chunks=C)``."""
    from repro_torch.kernels import ops
    fd = _fd()
    q, k, v, _ = _decode_inputs(33, 4, 8, 2, 6144, 64, cuda)
    kv_len = torch.tensor([6144, 300, 0, 4500], device=cuda)
    batch = ops.flash_decode(q, k, v, kv_len, sm_scale=0.125, window=2000)
    for bi in range(4):
        alone = ops.flash_decode(q[bi:bi + 1], k[bi:bi + 1], v[bi:bi + 1],
                                 kv_len[bi:bi + 1], sm_scale=0.125,
                                 window=2000)
        assert torch.equal(alone[0], batch[bi]), bi
    full = torch.tensor([6144, 5121, 5500, 6000], device=cuda)
    per, c = fd.split_shape(12, 512)
    assert (per, c) == (2, 6)
    assert torch.equal(
        ops.flash_decode(q, k, v, full, sm_scale=0.125),
        ops.flash_decode(q, k, v, full, sm_scale=0.125, partial_chunks=c))


@pytest.mark.cuda
def test_cuda_intac_bitwise_plain_and_int64(cuda):
    import importlib
    ia = importlib.import_module("repro_torch.kernels.intac_accum")
    from repro_torch.kernels import ops
    rng = np.random.RandomState(23)
    x = torch.tensor((rng.randn(5000, 300) * 8).astype(np.float32),
                     device=cuda)
    before = ia.LAUNCHES
    a = ops.intac_accum(x, 2.0 ** 20, block_rows=64)
    c = ops.intac_accum(x, 2.0 ** 20)
    torch.cuda.synchronize()
    assert ia.LAUNCHES == before + 2
    assert torch.equal(a, c)
    assert torch.equal(a, ia.intac_accum_torch(x, 2.0 ** 20))
    q = torch.round(x * 2.0 ** 20).to(torch.int64).sum(0)
    assert torch.equal(a[0].long() * 32768 + a[1].long(), q)
    # an empty stream launches nothing and counts nothing
    for shape in ((0, 300), (5000, 0)):
        e = ia.intac_accum_cuda(torch.zeros(shape, device=cuda), 2.0 ** 20)
        assert e.shape == (2, shape[1]) and not e.any()
    assert ia.LAUNCHES == before + 2


@pytest.mark.cuda
def test_cuda_serve_engine_runs_k2_each_step_and_k1_for_the_mean(cuda):
    """The smoke engine on the card: K2's count rises by one a layer at
    every decode step, K1's by one when ``_finalize_logprobs`` takes the
    mean; greedy tokens the same alone as batched."""
    import importlib
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.serve import Engine, Request
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    cfg = get_smoke_config("stablelm-1.6b")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(5)
    model = init_params(cfg, generator=gen, device=cuda)
    steps = []
    model.blocks[0].core.decode_attn.register_forward_hook(
        lambda *a: steps.append(fd.LAUNCHES["dense"]))
    rng = np.random.RandomState(3)
    reqs = [Request(prompt=rng.randint(1, cfg.vocab, n).tolist(),
                    max_new_tokens=6) for n in (5, 40, 17)]
    eng = Engine(cfg, model, max_len=96, device=cuda)
    for r in reqs:
        eng.submit(r)
    k1, k2 = [], []
    before = fd.LAUNCHES["dense"]
    K.LAUNCHES = 0

    def on_step(e, step):
        k1.append(K.LAUNCHES)
        k2.append(fd.LAUNCHES["dense"])

    res = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    assert steps and fd.LAUNCHES["dense"] == before + len(steps) \
        * cfg.n_layers
    assert all(b - a == cfg.n_layers for a, b in zip(steps, steps[1:]))
    assert set(k1) == {0} and K.LAUNCHES == 1
    assert k2 == sorted(k2) and k2[-1] == fd.LAUNCHES["dense"]
    assert all(np.isfinite(r.mean_logprob) for r in res)
    alone = Engine(cfg, model, max_len=96, device=cuda).generate(reqs[1:2])
    assert alone[0].tokens == res[1].tokens


@pytest.mark.cuda
def test_cuda_k2_on_a_wrapped_ring_bitwise_plain(cuda):
    """mixtral's SMOKE model (window 16, experts) on the card: nine decode
    steps after a 21-token prefill, so every step reads a wrapped ring.
    K2 launches once a layer a step, reads ``kv_len = W`` rows (the live
    slots, in slot order), and each of its outputs in the last layer is
    bitwise its plain version on the same ring; the MoE router's
    ``exact`` normalization through K1 is bitwise ``blocked``'s."""
    import dataclasses
    import importlib
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, moe
    from repro_torch.models import model as TM
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    cfg = get_smoke_config("mixtral-8x22b")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(9)
    model = init_params(cfg, generator=gen, device=cuda)
    seen = []
    model.blocks[-1].core.decode_attn.register_forward_hook(
        lambda mod, args, out: seen.append(
            ([a.clone() if torch.is_tensor(a) else a for a in args],
             out.clone())))
    toks = torch.randint(1, cfg.vocab, (3, 30), generator=gen, device=cuda)
    _, caches, _ = TM.forward(model, tokens=toks[:, :21], mode="prefill",
                              moe_impl="dense")
    before = fd.LAUNCHES["dense"]
    for i in range(21, 30):
        _, caches = TM.decode_step(model, toks[:, i:i + 1], caches, i,
                                   moe_impl="dense")
    torch.cuda.synchronize()
    assert fd.LAUNCHES["dense"] == before + 9 * cfg.n_layers
    assert len(seen) == 9
    for (q, k, v, kv_len, sc), out in seen:
        assert k.shape[1] == cfg.window
        assert kv_len.tolist() == [cfg.window] * 3
        bias = ops.length_bias(kv_len, k.shape[1], None, cuda)
        plain = fd.flash_decode_torch(q.float().contiguous(), k, v, bias,
                                      sm_scale=sc, block_kv=512)
        assert torch.equal(out, plain)
    m = dataclasses.replace(cfg.moe, router_norm_topk=True,
                            router_norm_policy="exact")
    x = torch.randn(300, cfg.d_model, generator=gen, device=cuda)
    router = model.blocks[0].mlp.router
    K.LAUNCHES = 0
    w, idx, _ = moe.router_topk(router, x, m)
    assert K.LAUNCHES == 1
    wb, idxb, _ = moe.router_topk(router, x, m, backend="blocked")
    assert torch.equal(idx, idxb) and torch.equal(w, wb)


@pytest.mark.cuda
def test_cuda_train_step_launches_k1_37_times_with_both_knobs(cuda):
    """A train step on the card (the SMOKE model in bf16: the narrow
    matmul and its backward): with ``grad_reduce`` and ``norm_policy``
    set, K1's count rises by 12 (one microbatch mean per reference leaf)
    + 25 (two per leaf and one across the leaves for the norm) = 37; with
    both unset by 0; the loss finite either way, and the exact step's
    grad norm bitwise the blocked executor's on the same gradients."""
    import dataclasses
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import init_state, make_train_step
    cfg = dataclasses.replace(get_smoke_config("stablelm-1.6b"),
                              dtype="bfloat16")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    model = init_params(cfg, generator=gen, device=cuda)
    batch = {"tokens": np.random.RandomState(2).randint(
        0, cfg.vocab, (4, 32)).astype(np.int32)}
    lr = adamw.cosine_schedule(1e-3, 1, 5)
    for kw, want in (({}, 0), ({"grad_reduce": "exact",
                                "norm_policy": "exact"}, 37)):
        step = make_train_step(cfg, lr_fn=lr, num_microbatches=2,
                               device=cuda, **kw)
        state = init_state(model)
        K.LAUNCHES = 0
        model, state, met = step(model, state, batch)
        torch.cuda.synchronize()
        assert K.LAUNCHES == want, (kw, K.LAUNCHES)
        assert bool(torch.isfinite(met["loss"])) and \
            bool(torch.isfinite(met["grad_norm"]))
    grads = {k: v.to(torch.bfloat16) for k, v in state.mu.items()}
    assert torch.equal(adamw.global_norm(grads, policy="exact"),
                       adamw.global_norm(grads, policy="exact",
                                         backend="blocked"))


@pytest.mark.cuda
@pytest.mark.parametrize("out_dtype", ("float32", "bfloat16"))
def test_cuda_narrow_matmul_backward_within_bf16_ulps_of_widened(out_dtype,
                                                                 cuda):
    """``layers._NarrowMatmul``'s hand-written backward (bf16 x and w on
    the card; the output float32 as ``matmul_f32`` gives it, or rounded
    to bf16 as ``dense`` does) against autograd through the same product
    on float32 copies of the operands: gx and gw, both bf16, within two
    bf16 ulps of the widened result plus the worst-case float32
    reordering error of a k-term sum, 2 k 2^-24 sum|terms| (k the summed
    dimension: the two paths may sum in different orders)."""
    from repro_torch.models import layers
    rng = np.random.RandomState(5)
    t, d, f = 96, 512, 384
    dt = getattr(torch, out_dtype)
    x0 = torch.tensor(rng.randn(t, d).astype(np.float32),
                      device=cuda).to(torch.bfloat16)
    w0 = torch.tensor((rng.randn(d, f) * 0.05).astype(np.float32),
                      device=cuda).to(torch.bfloat16)
    g = torch.tensor(rng.randn(t, f).astype(np.float32), device=cuda).to(dt)
    x, w = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    y = layers.matmul_f32(x, w) if dt == torch.float32 \
        else layers.dense(w, x)
    seen, todo = set(), [y.grad_fn]
    while todo:                          # the nodes of y's graph
        fn = todo.pop()
        seen.add(type(fn).__name__)
        todo += [n for n, _ in fn.next_functions if n is not None]
    assert y.dtype == dt and "_NarrowMatmulBackward" in seen, seen
    gx, gw = torch.autograd.grad(y, (x, w), g)
    xr, wr = x0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
    rx, rw = torch.autograd.grad(torch.mm(xr.float(), wr.float()).to(dt),
                                 (xr, wr), g)
    assert gx.dtype == gw.dtype == rx.dtype == rw.dtype == torch.bfloat16
    ga = g.float().abs()
    for got, want, terms, k in ((gx, rx, ga @ w0.float().abs().t(), f),
                                (gw, rw, x0.float().abs().t() @ ga, t)):
        want = want.float()
        ulp = torch.ldexp(torch.ones_like(want),
                          torch.frexp(want).exponent - 8)
        bound = 2 * ulp + 2 * k * 2.0 ** -24 * terms
        err = (got.float() - want).abs()
        assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
def test_cuda_narrow_bmm_backward_within_a_bf16_ulp_of_float64(cuda):
    """``layers.bmm_f32`` on bf16 operands on the card (the experts' FFN)
    runs ``_NarrowBmm``, whose forward is ``bmm(out_dtype=float32)`` bit
    for bit and whose backward gives ga and gb in bf16: each within one
    bf16 ulp of the float64 product rounded once to bf16, plus the
    float32 sum's error, 2 k 2^-24 sum|terms| (k the summed
    dimension)."""
    from repro_torch.models import layers
    rng = np.random.RandomState(6)
    e, m, k, n = 4, 96, 256, 192
    a0 = torch.tensor(rng.randn(e, m, k).astype(np.float32),
                      device=cuda).to(torch.bfloat16)
    b0 = torch.tensor((rng.randn(e, k, n) * 0.05).astype(np.float32),
                      device=cuda).to(torch.bfloat16)
    g = torch.tensor(rng.randn(e, m, n).astype(np.float32), device=cuda)
    a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
    y = layers.bmm_f32(a, b)
    assert y.dtype == torch.float32
    assert type(y.grad_fn).__name__ == "_NarrowBmmBackward", y.grad_fn
    assert torch.equal(y.detach(),
                       torch.bmm(a0, b0, out_dtype=torch.float32))
    ga, gb = torch.autograd.grad(y, (a, b), g)
    assert ga.dtype == gb.dtype == torch.bfloat16
    gd, ad, bd = g.double(), a0.double(), b0.double()
    for got, want, terms, kk in (
            (ga, gd @ bd.transpose(1, 2),
             gd.abs() @ bd.abs().transpose(1, 2), n),
            (gb, ad.transpose(1, 2) @ gd,
             ad.abs().transpose(1, 2) @ gd.abs(), m)):
        rounded = want.to(torch.bfloat16).double()
        ulp = torch.ldexp(torch.ones_like(rounded),
                          torch.frexp(rounded).exponent - 8)
        bound = ulp + 2 * kk * 2.0 ** -24 * terms
        err = (got.double() - rounded).abs()
        assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
def test_cuda_checkpoint_of_card_leaves_restores_bitwise(cuda, tmp_path):
    """A tree of CUDA leaves (f32, bf16, an int32 scalar, a leaf of many
    compression chunks) saved and restored: onto the card by default,
    onto ``device=`` when given, and in place into other CUDA tensors."""
    from repro_torch.ckpt import checkpoint as ckpt
    g = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(3000, 1000, generator=g, device=cuda),
            "b": [torch.randn(64, generator=g, device=cuda)
                  .to(torch.bfloat16),
                  torch.tensor(7, dtype=torch.int32, device=cuda)]}
    ckpt.save(tmp_path, 1, tree, extra={"next_step": 2})
    back, manifest = ckpt.restore(tmp_path, 1, tree)
    assert manifest["extra"]["next_step"] == 2
    for key, leaf in ckpt.flatten(back).items():
        want = ckpt.flatten(tree)[key]
        assert leaf.is_cuda and leaf.dtype == want.dtype
        assert torch.equal(leaf, want), key
    host, _ = ckpt.restore(tmp_path, 1, tree, device="cpu")
    assert torch.equal(host["w"], tree["w"].cpu())
    live = {"w": torch.zeros_like(tree["w"]),
            "b": [torch.zeros_like(tree["b"][0]),
                  torch.zeros_like(tree["b"][1])]}
    same, _ = ckpt.restore(tmp_path, 1, live, inplace=True)
    assert same is live and torch.equal(live["w"], tree["w"])
    assert torch.equal(live["b"][0], tree["b"][0]) and int(live["b"][1]) == 7


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["KahanAccumulator", "LimbAccumulator",
                                  "Limb3Accumulator", "BinAccumulator",
                                  "CascadeAccumulator"])
def test_cuda_accumulators_bitwise_their_cpu_run(name, cuda):
    """Each accumulator pushed row by row on the card: every state field
    and the finalize bitwise the same pushes on the CPU; LimbAccumulator
    also bitwise K5 (``intac_accum``) in canonical form."""
    import repro_torch.reduce as R
    from repro_torch.core import intac as I
    from repro_torch.kernels import ops
    rng = np.random.RandomState(5)
    x = (rng.randn(300, 70) * np.exp2(rng.randint(-10, 4, (300, 70)))
         ).astype(np.float32)
    arg = {"LimbAccumulator": 2.0 ** 20, "Limb3Accumulator": 2.0 ** 20,
           "BinAccumulator": float(np.abs(x).max()),
           "CascadeAccumulator": 3}.get(name)
    acc = getattr(R, name)() if arg is None else getattr(R, name)(arg)

    def run(t):
        st = acc.init(t[0])
        for row in t:
            st = acc.push(st, row)
        return st

    xc = torch.from_numpy(x)
    st_g, st_c = run(xc.to(cuda)), run(xc)

    def parts(st):
        out = []
        for p in (st if isinstance(st, tuple) else (st,)):
            out += list(p) if isinstance(p, (tuple, list)) else [p]
        return [p for p in out if p is not None]
    for a, b in zip(parts(st_g), parts(st_c)):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(acc.finalize(st_g).cpu(), acc.finalize(st_c))
    if name == "LimbAccumulator":
        k5 = ops.intac_accum(xc.to(cuda), arg)
        for a, b in zip(I.limbs_canonical(st_g.hi, st_g.lo),
                        I.limbs_canonical(k5[0], k5[1])):
            assert torch.equal(a, b)


def _mamba_smoke(device, dtype="float32"):
    """Layer 0 of jamba-v0.1-52b's SMOKE model (a Mamba block, di 256,
    d_state 4) drawn on the CPU, and a copy of it on ``device``."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    cfg = get_smoke_config("jamba-v0.1-52b").scaled(dtype=dtype)
    core = init_params(cfg, generator=torch.Generator().manual_seed(9),
                       device="cpu").blocks[0].core
    return cfg, core, copy.deepcopy(core).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
def test_cuda_mamba_layer_matches_its_cpu_run(dtype, cuda):
    """One Mamba layer on the card against the same layer on the CPU:
    prefill of 70 rows in chunks of 16 (ragged last chunk) and three
    decode steps.  The card sums its products in another order (cuBLAS,
    its reductions), so the float32 outputs and states agree within 2e-5
    (values of about 1, a 7-layer-deep scan tree); in bf16 the projections
    round to bf16 on each side, so within 2 bf16 ulps of the outputs'
    largest value (2^-7 relative)."""
    from repro_torch.models import ssm
    cfg, cpu_core, card_core = _mamba_smoke(cuda, dtype)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(np.random.RandomState(4).randn(2, 73, 128)
                         .astype(np.float32)).to(dt)
    tol = 2e-5 if dtype == "float32" else 2.0 ** -7

    def run(core, dev):
        xs = x.to(dev)
        y, st = ssm.mamba_apply(core, xs[:, :70], cfg.mamba, mode="prefill",
                                chunk=16)
        st = ssm.MambaState(st.h.clone(), st.conv.float())
        ys = [y]
        for i in range(70, 73):
            yi, st = ssm.mamba_apply(core, xs[:, i:i + 1], cfg.mamba,
                                     mode="decode", state=st)
            ys.append(yi)
        return torch.cat(ys, 1).float().cpu(), st.h.cpu(), st.conv.cpu()

    errs = [float((a - b).abs().max()) / max(float(a.abs().max()), 1.0)
            for a, b in zip(run(cpu_core, "cpu"), run(card_core, cuda))]
    assert max(errs) <= tol, f"y, h, conv: {errs}"


@pytest.mark.cuda
def test_cuda_mamba_decode_active_mask_bitwise(cuda):
    """On the card, a decode step with ``active`` [True, False, True]
    keeps the inactive row's h and conv bitwise, and the active rows'
    outputs and states equal an unmasked step's bitwise."""
    from repro_torch.models import ssm
    cfg, _, core = _mamba_smoke(cuda)
    x = torch.from_numpy(np.random.RandomState(6).randn(3, 10, 128)
                         .astype(np.float32)).to(cuda)
    _, st = ssm.mamba_apply(core, x[:, :9], cfg.mamba, mode="prefill")
    free = ssm.MambaState(st.h.clone(), st.conv.clone())
    masked = ssm.MambaState(st.h.clone(), st.conv.clone())
    active = torch.tensor([True, False, True], device=cuda)
    y_free, _ = ssm.mamba_apply(core, x[:, 9:], cfg.mamba, mode="decode",
                                state=free)
    y_mask, _ = ssm.mamba_apply(core, x[:, 9:], cfg.mamba, mode="decode",
                                state=masked, active=active)
    for r in (0, 2):
        assert torch.equal(y_mask[r], y_free[r])
        assert torch.equal(masked.h[r], free.h[r])
        assert torch.equal(masked.conv[r], free.conv[r])
    assert torch.equal(masked.h[1], st.h[1])
    assert torch.equal(masked.conv[1], st.conv[1])
    assert not torch.equal(masked.h[0], st.h[0])


@pytest.mark.cuda
def test_cuda_xlstm_forward_and_decode_match_their_cpu_run(cuda):
    """xlstm-125m's SMOKE model (4 layers: three mLSTM and an sLSTM;
    float32; 8-row scan chunks) on the card against the same model on
    the CPU (a copy moved, since ``nn.Module.to`` moves in place): the
    train-mode logits over 20 tokens, then prefill of 12 and four decode
    steps, each step's logits and every state field at the end.  The
    card sums its products and the chunk's contractions in other orders
    (the gates' prefix sum is the same elementwise tree on both), so
    they agree within 2e-5 of each tensor's largest value."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    cfg = get_smoke_config("xlstm-125m").scaled(scan_chunk=8)
    cpu_model = init_params(cfg, generator=torch.Generator().manual_seed(3),
                            device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        1, cfg.vocab, (2, 20)))

    def run(model, dev):
        t = toks.to(dev)
        out = [M.forward(model, tokens=t)[0]]
        _, caches, _ = M.forward(model, tokens=t[:, :12], mode="prefill")
        for i in range(12, 16):
            logits, caches = M.decode_step(model, t[:, i:i + 1], caches, i)
            out.append(logits)
        out += [f for c in caches for f in c["core"]]
        return [o.float().cpu() for o in out]

    with torch.no_grad():
        errs = [float((a - b).abs().max()) / max(float(a.abs().max()), 1e-30)
                for a, b in zip(run(cpu_model, "cpu"),
                                run(card_model, cuda))]
    assert max(errs) <= 2e-5, errs


@pytest.mark.cuda
def test_cuda_k2_at_the_cross_attention_shape_bitwise_plain(cuda):
    """K2 at seamless-m4t-large-v2's cross-attention shape: 8 requests, 16
    heads on 16 KV heads (G = 1), hd 64, every request reading all 4,096
    rows of its memory (4 live splits of 1,024 rows): bitwise its plain
    version, through the wrapper and the model's ``DecodeAttention``
    (which launches it once)."""
    from repro_torch.kernels import ops
    from repro_torch.models.attention import DecodeAttention
    fd = _fd()
    b, h, kh, t, d = 8, 16, 16, 4096, 64
    q, k, v, _ = _decode_inputs(29, b, h, kh, t, d, cuda)
    kv_len = torch.full((b,), t, dtype=torch.int32, device=cuda)
    bias = ops.length_bias(kv_len, t, None, cuda)
    want = fd.flash_decode_torch(q, k, v, bias, sm_scale=d ** -0.5,
                                 block_kv=512)
    before = fd.LAUNCHES["dense"]
    got = DecodeAttention()(q, k, v, kv_len, d ** -0.5)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["dense"] == before + 1
    assert torch.equal(want, got)
    assert torch.equal(want, fd.flash_decode_cuda(q, k, v, bias,
                                                  sm_scale=d ** -0.5,
                                                  block_kv=512))


@pytest.mark.cuda
def test_cuda_seamless_prefill_and_decode_with_enc_out_match_the_cpu(cuda):
    """seamless-m4t-large-v2's SMOKE model (2 encoder and 2 decoder
    layers, float32) on the card against the same model on the CPU (a
    copy moved): ``make_prefill_step`` on ``tokens`` and ``enc_embeds``,
    then ``pad_caches_to`` and four ``make_decode_step(enc_out=encode)``
    steps, whose cross-attention runs K2 on the card and its plain version
    on the CPU.  The card sums its products, and K2 its splits, in other
    orders, so each step's logits agree within 2e-5 of their largest
    value (logits about N(0, 1) through four float32 layers), and the
    card's decode steps launch K2 twice a layer."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.models import model as M
    from repro_torch.train import make_decode_step, make_prefill_step
    fd = _fd()
    cfg = get_smoke_config("seamless-m4t-large-v2")
    cpu_model = init_params(cfg, generator=torch.Generator().manual_seed(5),
                            device="cpu")
    card_model = copy.deepcopy(cpu_model).to(cuda)
    rng = np.random.RandomState(6)
    toks = torch.from_numpy(rng.randint(1, cfg.vocab, (2, 14)))
    mem = torch.from_numpy(rng.randn(2, 40, cfg.d_model).astype(np.float32))
    launches = []

    def run(model, dev):
        prefill = make_prefill_step(cfg, device=dev)
        dstep = make_decode_step(cfg, device=dev)
        logits, caches = prefill(model, {"tokens": toks[:, :10],
                                         "enc_embeds": mem})
        out = [logits]
        caches = M.pad_caches_to(cfg, caches, 16)
        enc_out = M.encode(model, mem.to(dev))
        before = fd.LAUNCHES["dense"]
        for i in range(10, 14):
            logits, caches = dstep(model, toks[:, i:i + 1], caches, i,
                                   enc_out=enc_out)
            out.append(logits)
        launches.append(fd.LAUNCHES["dense"] - before)
        return [o.float().cpu() for o in out]

    with torch.no_grad():
        want, got = run(cpu_model, "cpu"), run(card_model, cuda)
    errs = [float((a - b).abs().max()) / float(a.abs().max())
            for a, b in zip(want, got)]
    assert max(errs) <= 2e-5, errs
    assert launches[1] == 4 * 2 * cfg.n_layers


@pytest.mark.cuda
def test_cuda_sharded_reduce_over_two_ranks_bitwise_one_process(cuda,
                                                                tmp_path):
    """Phase 21's check 1 at a small size: 2 ranks (fresh interpreters,
    gloo, every payload staged through the host) each folding their slice
    of the reference's split with K1; the integer tiers bitwise this
    process's ``reduce(backend="cuda")`` of the whole stream."""
    from pathlib import Path
    from repro_torch.distributed import spawn
    vals, ids = _stream(21, 3000, 4, 7)
    outs = spawn.run_ranks(
        "torch_dist_workers:sharded_reduce", 2, workdir=tmp_path / "w2",
        kwargs={"stream": vals, "ids": ids, "nseg": 7, "block": 128,
                "device": "cuda"},
        paths=[str(Path(__file__).resolve().parent)], timeout=600)
    for p in ("exact", "exact2", "procrastinate"):
        one = repro_torch.reduce(torch.tensor(vals, device=cuda),
                                 segment_ids=torch.tensor(ids, device=cuda),
                                 num_segments=7, policy=p, block_size=128,
                                 backend="cuda").cpu()
        assert torch.equal(outs[0][p], one) and torch.equal(outs[1][p], one)


@pytest.mark.cuda
def test_cuda_elastic_resume_from_two_ranks_onto_four_bitwise(cuda,
                                                              tmp_path):
    """Phase 21's check 3 at SMOKE size: xlstm's elastic step with its
    reductions on K1, 4 steps on 2 ranks with a snapshot after step 2,
    steps 3 and 4 from it on 4 ranks: the parameters and losses bit for
    bit the uninterrupted run's."""
    from pathlib import Path
    from repro_torch.distributed import spawn
    tests = [str(Path(__file__).resolve().parent)]
    kw = {"tree": None, "ckpt_dir": str(tmp_path / "ck"), "device": "cuda"}
    two = spawn.run_ranks("torch_dist_workers:elastic_run", 2,
                          workdir=tmp_path / "w2",
                          kwargs=dict(kw, steps=4, save_at=2), paths=tests,
                          timeout=600)
    four = spawn.run_ranks("torch_dist_workers:elastic_run", 4,
                           workdir=tmp_path / "w4",
                           kwargs=dict(kw, steps=2, restore=True),
                           paths=tests, timeout=600)
    for k, v in two[0]["last"].items():
        assert torch.equal(four[0]["last"][k], v), k
    for a, b in zip(four[0]["losses"], two[0]["losses"][2:]):
        assert torch.equal(a, b)


def _fsm_streams(seed, b, t):
    """B circuits of T cycles: random sets with idle gaps, ignored
    starts, -0.0, +-Inf and NaN; circuit 0 holds 20 back-to-back sets
    of 5 (at R = 2 the FIFO overflows and its count passes 4)."""
    rng = np.random.RandomState(seed)
    v = rng.randint(-40, 40, (b, t)).astype(np.float32)
    st = rng.rand(b, t) < 0.06
    va = rng.rand(b, t) < 0.9
    k = rng.rand(b, t)
    v[k < 0.05] = -0.0
    v[(k >= 0.05) & (k < 0.06)] = np.inf
    v[(k >= 0.06) & (k < 0.07)] = -np.inf
    v[(k >= 0.07) & (k < 0.08)] = np.nan
    v[0], st[0], va[0] = 1.0, False, False
    st[0, 0:100:5], va[0, :100] = True, True
    return v, st, va


@pytest.mark.cuda
def test_cuda_jugglepac_fsm_bitwise_plain_on_overflowing_batch(cuda):
    """The JugglePAC kernel against its plain version on the card: all
    four per-cycle outputs bitwise (``res_v`` as int32 bits), at B = 67
    circuits (two CUDA blocks, the second ragged) and T = 301 cycles
    (ten tiles, the last ragged), at three (L, R)."""
    from repro_torch.kernels import jugglepac_fsm as fsm
    v, st, va = (torch.tensor(x, device=cuda)
                 for x in _fsm_streams(31, 67, 301))
    for lat, regs in ((14, 2), (2, 4), (1, 1)):
        before = fsm.LAUNCHES
        kern = fsm.jugglepac_fsm_cuda(v, st, va, latency=lat,
                                      num_registers=regs)
        torch.cuda.synchronize()
        assert fsm.LAUNCHES == before + 1
        plain = fsm.jugglepac_fsm_torch(v, st, va, latency=lat,
                                        num_registers=regs)
        assert torch.equal(kern[0].view(torch.int32),
                           plain[0].view(torch.int32))
        for a, b in zip(kern[1:], plain[1:]):
            assert torch.equal(a, b)
        if lat == 14:
            assert kern[3][0].sum() > 1
    with pytest.raises(ValueError, match="<= 64"):
        fsm.jugglepac_fsm_cuda(v, st, va, latency=65)
    with pytest.raises(ValueError, match="float32"):
        fsm.jugglepac_fsm_cuda(v.double(), st, va)


@pytest.mark.cuda
def test_cuda_run_sets_launches_the_kernel_once_and_equals_python(cuda):
    """``circuit_scan.run_sets(device=None)`` runs on the card through one
    kernel launch and gives the Python ``JugglePAC.run``'s results."""
    import random
    from repro_torch.core import circuit, circuit_scan
    from repro_torch.kernels import jugglepac_fsm as fsm
    rng = random.Random(5)
    sets = [[float(rng.randrange(1, 50))
             for _ in range(rng.randrange(30, 120))] for _ in range(12)]
    before = fsm.LAUNCHES
    got, ovf = circuit_scan.run_sets(sets, latency=14, num_registers=4)
    assert fsm.LAUNCHES == before + 1 and not ovf
    pac = circuit.JugglePAC(14, 4)
    assert got == [(r.set_index, r.value, r.cycle) for r in pac.run(sets)]
    assert pac.fifo_overflows == 0 and len(got) == 12


@pytest.mark.cuda
def test_cuda_jugglepac_fsm_shared_state_bitwise_plain_across_blocks(cuda):
    """The kernel, its circuits' state in shared memory, against its
    plain version: all four per-cycle outputs bitwise (``res_v`` as int32
    bits) at (L, R) = (64, 64) (the largest shared-memory opt-in), (32,
    16) and (14, 4), on three CUDA blocks of ``THREADS`` circuits plus 5
    in a ragged fourth, and T not a multiple of ``CHUNK``: 4-byte aligned
    rows (the flags move as words) and, one cycle shorter, unaligned ones
    (as bytes); one launch a call, and four blocks an SM at the design
    point."""
    from repro_torch.kernels import jugglepac_fsm as fsm
    b, t = 3 * fsm.THREADS + 5, 20 * fsm.CHUNK + 4
    streams = _fsm_streams(41, b, t)
    for tt in (t, t - 1):
        v, st, va = (torch.tensor(x[:, :tt].copy(), device=cuda)
                     for x in streams)
        for lat, regs in ((64, 64), (32, 16), (14, 4)):
            before = fsm.LAUNCHES
            kern = fsm.jugglepac_fsm_cuda(v, st, va, latency=lat,
                                          num_registers=regs)
            torch.cuda.synchronize()
            assert fsm.LAUNCHES == before + 1
            plain = fsm.jugglepac_fsm_torch(v, st, va, latency=lat,
                                            num_registers=regs)
            assert torch.equal(kern[0].view(torch.int32),
                               plain[0].view(torch.int32))
            for a, c in zip(kern[1:], plain[1:]):
                assert torch.equal(a, c)
            assert kern[2][-5:].any(1).all()
    assert fsm.blocks_per_sm(14, 4) >= 4
