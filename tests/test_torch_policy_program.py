"""repro_torch's policies and block programs against the reference's.

* ``to_domain``: bitwise for all five tiers;
* integer tiers: the carry after every block, bitwise;
* ``plan_program``: the same decisions and cost hints;
* integer tiers: the dot and lane gathers, bitwise equal to each other;
* float tiers: the two pinned gathers within the tree's error bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.reduce import block_contrib as j_contrib  # noqa: E402
from repro.reduce import get_policy as j_policy  # noqa: E402
from repro.reduce import plan_program as j_plan  # noqa: E402
from repro_torch.reduce import block_contrib as t_contrib  # noqa: E402
from repro_torch.reduce import get_policy as t_policy  # noqa: E402
from repro_torch.reduce import plan_program as t_plan  # noqa: E402
from repro_torch.reduce.program import LANE_MIN_SEGMENTS  # noqa: E402

POLICIES = ("fast", "compensated", "exact", "exact2", "procrastinate")
INT_POLICIES = ("exact", "exact2", "procrastinate")


def _rows(seed=0, n=512, d=4):
    rng = np.random.RandomState(seed)
    v = (rng.randn(n, d) * 2.0 ** rng.randint(-10, 10, (n, d)))
    return v.astype(np.float32)


@pytest.mark.parametrize("policy", POLICIES)
def test_to_domain_bitwise(policy):
    v = _rows(1)
    jd, jctx = j_policy(policy).prepare(jnp.asarray(v), v.shape[0])
    td, tctx = t_policy(policy).prepare(torch.tensor(v), v.shape[0])
    jd, td = np.asarray(jd), td.numpy()
    assert jd.dtype == td.dtype and jd.shape == td.shape
    assert np.array_equal(jd, td)
    if jctx is not None:
        assert np.array_equal(np.asarray(jctx), tctx.numpy())
    assert t_policy(policy).domain_width(4) == jd.shape[1]


@pytest.mark.parametrize("contrib", ("dot", "lanes"))
@pytest.mark.parametrize("policy", INT_POLICIES)
def test_integer_carry_after_every_block_bitwise(policy, contrib):
    v = _rows(2)
    rng = np.random.RandomState(3)
    s, b = 40, 64
    ids = rng.randint(-1, s, v.shape[0]).astype(np.int32)
    jp, tp = j_policy(policy), t_policy(policy)
    dom = np.asarray(jp.prepare(jnp.asarray(v), v.shape[0])[0])
    w = dom.shape[1]
    jprog = j_plan(jp, num_segments=s, domain_width=w, block_size=b,
                   contrib=contrib)
    tprog = t_plan(tp, num_segments=s, domain_width=w, block_size=b,
                   contrib=contrib)
    jc = jp.init(s, w)
    tc = tp.init(s, w)
    for k in range(v.shape[0] // b):
        blk = slice(k * b, (k + 1) * b)
        jc = jp.update(jc, j_contrib(jnp.asarray(dom[blk]),
                                     jnp.asarray(ids[blk]), s, jp, jprog))
        tc = tp.update(tc, t_contrib(torch.tensor(dom[None, blk]),
                                     torch.tensor(ids[None, blk]), s, tp,
                                     tprog)[0])
        for a, c in zip(jc, tc):
            assert np.array_equal(np.asarray(a), c.numpy()), (k, policy)
    st_j, st_t = jp.carry_status(jc), tp.carry_status(tc)
    assert bool(st_j) == bool(st_t)


@pytest.mark.parametrize("policy", POLICIES)
def test_plan_program_decisions_match(policy):
    for s in (1, 16, LANE_MIN_SEGMENTS - 1, LANE_MIN_SEGMENTS, 48, 4096):
        for contrib in ("auto", "dot", "lanes"):
            for b in (64, 512):
                kw = dict(num_segments=s, domain_width=24, block_size=b,
                          contrib=contrib, op="moments")
                jp = j_plan(policy, **kw)
                tp = t_plan(policy, **kw)
                assert (jp.contrib, jp.lanes, jp.block_size,
                        jp.num_segments, jp.domain_width, jp.op) == \
                    (tp.contrib, tp.lanes, tp.block_size, tp.num_segments,
                     tp.domain_width, tp.op)
                for a, c in zip(jp.stages, tp.stages):
                    assert (a.name, a.bound, a.bytes, a.flops) == \
                        (c.name, c.bound, c.bytes, c.flops)
    with pytest.raises(ValueError, match="contrib"):
        t_plan(policy, num_segments=4, domain_width=4, contrib="scatter")


@pytest.mark.parametrize("policy", INT_POLICIES)
def test_integer_dot_and_lanes_bitwise(policy):
    v = _rows(4, n=640)
    rng = np.random.RandomState(5)
    ids = torch.tensor(rng.randint(-1, 48, 640).astype(np.int32))
    tp = t_policy(policy)
    dom, _ = tp.prepare(torch.tensor(v), 640)
    vb, ib = dom.reshape(5, 128, -1), ids.reshape(5, 128)
    dot = t_contrib(vb, ib, 48, tp, t_plan(tp, num_segments=48,
                                           domain_width=dom.shape[1],
                                           contrib="dot"))
    lanes = t_contrib(vb, ib, 48, tp, t_plan(tp, num_segments=48,
                                             domain_width=dom.shape[1],
                                             contrib="lanes"))
    assert torch.equal(dot, lanes)


@pytest.mark.parametrize("policy", ("fast", "compensated"))
def test_float_gathers_follow_the_pinned_tree(policy):
    """The dot gather is the pairwise tree over the block's rows: check
    one cell against a hand-built tree, and the lane gather against the
    lane fold of hand-built trees."""
    rng = np.random.RandomState(6)
    b, s = 12, 3                                 # 12 rows: padded to 16
    vals = rng.randn(1, b, 1).astype(np.float32)
    ids = rng.randint(-1, s, (1, b)).astype(np.int32)
    tp = t_policy(policy)

    def tree(x):
        x = list(x) + [np.float32(0)] * ((1 << (len(x) - 1).bit_length())
                                         - len(x))
        while len(x) > 1:
            x = [np.float32(x[i] + x[i + 1]) for i in range(0, len(x), 2)]
        return x[0]

    leaves = [np.where(ids[0] == c, vals[0, :, 0], np.float32(0))
              for c in range(s)]
    dot = t_contrib(torch.tensor(vals), torch.tensor(ids), s, tp)
    for c in range(s):
        assert dot[0, c, 0].item() == tree(leaves[c])
    lanes = t_contrib(torch.tensor(vals), torch.tensor(ids), s, tp,
                      t_plan(tp, num_segments=s, domain_width=1,
                             block_size=b, contrib="lanes", lanes=4))
    for c in range(s):
        parts = [tree(leaves[c][k * 3:(k + 1) * 3]) for k in range(4)]
        want = parts[0]
        for p in parts[1:]:
            want = np.float32(want + p)
        assert lanes[0, c, 0].item() == want


def test_float_dot_and_lanes_within_tree_bound():
    v = _rows(7, n=512)
    ids = torch.tensor(np.random.RandomState(8).randint(0, 8, 512)
                       .astype(np.int32)).reshape(4, 128)
    tp = t_policy("fast")
    vb = torch.tensor(v).reshape(4, 128, -1)
    dot = t_contrib(vb, ids, 8, tp).numpy().astype(np.float64)
    lanes = t_contrib(vb, ids, 8, tp, t_plan(tp, num_segments=8,
                                             domain_width=4,
                                             contrib="lanes")).numpy()
    absum = np.zeros((4, 8, 4))
    for k in range(4):
        np.add.at(absum[k], ids[k].numpy(), np.abs(v[k * 128:(k + 1) * 128]))
    assert (np.abs(dot - lanes) <= 2 * (7 + 4) * 2.0 ** -24 * absum).all()


def test_policy_registry_and_bounds_match():
    from repro.reduce.policy import POLICIES as JP
    from repro_torch.reduce.policy import POLICIES as TP
    assert sorted(JP) == sorted(TP)
    for name in JP:
        a, b = JP[name], TP[name]
        assert (a.carry_len, a.max_block_size, a.max_blocks, a.max_terms,
                a.escalation, a.needs_max_stat, a.update_ops_per_elem) == \
            (b.carry_len, b.max_block_size, b.max_blocks, b.max_terms,
             b.escalation, b.needs_max_stat, b.update_ops_per_elem), name
        assert [np.dtype(d).name for d in a.carry_dtypes] == \
            [str(d).replace("torch.", "") for d in b.carry_dtypes]
    with pytest.raises(ValueError, match="psychic"):
        t_policy("psychic")


def test_cuda_device_picks_the_kernel_or_raises():
    """On a CUDA device the auto-choice is the kernel for every tier it
    implements; a tier it does not implement raises instead of running
    the plain version on the card.  The CPU gets ``blocked``."""
    from repro_torch.reduce import policy as P
    from repro_torch.reduce.backends import select_local_backend
    for name in POLICIES:
        assert select_local_backend(t_policy(name), "cuda").name == "cuda"
        assert select_local_backend(t_policy(name), "cpu").name == "blocked"

    class DummyPolicy(P.FastPolicy):
        name = "dummy"

    dummy = DummyPolicy()
    with pytest.raises(ValueError, match="'dummy'.*backend='blocked'"):
        select_local_backend(dummy, "cuda")
    assert select_local_backend(dummy, "cpu").name == "blocked"


def test_reduce_plans_a_program_only_for_staged_backends(monkeypatch):
    import repro_torch
    from repro_torch.reduce import backends as B
    seen = []

    def run(values, segment_ids, num_segments, **kw):
        seen.append(sorted(kw))
        return B.get_backend("blocked").run(values, segment_ids,
                                            num_segments, **kw)

    monkeypatch.setitem(B.BACKENDS, "unstaged", B.Backend(
        name="unstaged", run=run, policies=frozenset({"*"})))
    vals = torch.tensor(_rows(seed=3, n=300, d=2))
    ids = torch.arange(300) % 7
    for policy in POLICIES:
        got = repro_torch.reduce(vals, segment_ids=ids, num_segments=7,
                                 policy=policy, backend="unstaged",
                                 block_size=64, contrib="dot", device="cpu")
        want = repro_torch.reduce(vals, segment_ids=ids, num_segments=7,
                                  policy=policy, backend="blocked",
                                  block_size=64, contrib="dot", device="cpu")
        assert torch.equal(got, want), policy
    assert seen == [["block_size", "policy"]] * len(POLICIES)
