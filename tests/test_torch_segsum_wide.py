"""K1's one-label schedule (``num_segments == 1``), emulated on the CPU.

The CUDA kernels of the one-label schedule (``wide_contrib_kernel`` and
``wide_fold_kernel`` in ``csrc/segsum.cu``) run only on a GPU.  Here
numpy repeats them step by step and is held bitwise to the plain version
``segsum_policy_torch`` (what the ``blocked`` executor runs):

* phase 2, a schedule block's contribution where B > 1: the integer tiers
  as the 8 warps' int32 wrapping sums over interleaved 16-row runs, then
  the warps' sums added; the float tiers per lane as chunks of up to 512
  padded rows, 16-row groups summed level by level "in registers", the
  group sums joined level by level in place "in shared memory" (node i of
  level h at i << h), chunk sums on the binary-counter stack, lanes
  folded in lane order;
* phase 1, the ordered fold of each block's contribution per carry cell
  (at B = 1 the row itself: the value where the label is the launch's, 0
  or +0 elsewhere), with the tier's update written out as the kernel
  does it: wrap flags, ``limb_split``, ``ovf``.

The inputs have a ragged N, sentinel rows and rows of other labels, an
all-sentinel schedule block, -0.0 values, and for the integer tiers a
domain near +-2^30 so that ``ovf`` counts.  Also pinned: the launch plan
at the train path's shapes, the shared-memory mirror, and the plain
version at one label against the reference's Pallas kernel (integer
tiers, bitwise).  The kernels themselves are held to the plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.jugglepac_segsum import segsum_policy_pallas  # noqa: E402
from repro.reduce import get_policy as j_policy  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import jugglepac_segsum as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.reduce import get_policy as t_policy  # noqa: E402
from repro_torch.reduce import plan_program as t_plan  # noqa: E402
from repro_torch.reduce.policy import lane_bounds  # noqa: E402

POLICIES = ("fast", "compensated", "exact", "exact2", "procrastinate")
WARPS = ops.WIDE_THREADS // 32
GROUP = ops.GROUP_ROWS
D = 8


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The two kernels, emulated
# ---------------------------------------------------------------------------


def _as_int(vals):
    """The integer tiers' contribution type: exact2's f32 domain rounded
    to int32 (``__float2int_rn``; the domain holds integers)."""
    if vals.dtype == np.float32:
        return np.rint(vals).astype(np.int32)
    return vals


def _int_contrib(vals, ids, r0, block, label):
    """``wide_contrib_kernel``'s integer path for one schedule block: warp
    w sums the 16-row runs w, w + 8, ... wrapping, then warp 0 adds the
    other warps' sums to its own."""
    n, w = vals.shape
    sums = []
    for warp in range(WARPS):
        acc = np.zeros(w, np.int32)
        for j0 in range(warp * GROUP, block, WARPS * GROUP):
            for u in range(GROUP):
                g = r0 + j0 + u
                if j0 + u < block and g < n and ids[g] == label:
                    acc = acc + _as_int(vals[g])
        sums.append(acc)
    acc = sums[0]
    for s in sums[1:]:
        acc = acc + s
    return acc


def _push_leaf(stk, cnt, v):
    """``push_leaf_vec``: after leaf i, merge ctz(i + 1) times, left
    first."""
    cnt += 1
    c = cnt
    while c % 2 == 0:
        v = stk.pop() + v
        c //= 2
    stk.append(v)
    return cnt


def _close_tree(stk, cnt, w):
    p2 = 1
    while p2 < cnt:
        p2 *= 2
    while cnt < p2:
        cnt = _push_leaf(stk, cnt, np.zeros(w, np.float32))
    return stk[0]


def _float_contrib(vals, ids, r0, block, label, lanes):
    """``wide_contrib_kernel``'s float path for one schedule block."""
    n, w = vals.shape
    bounds = lane_bounds(block, lanes)
    total = None
    for ln, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        length = hi - lo
        size = 1 << max(0, (length - 1).bit_length())
        chunk = min(size, ops.TREE_ROWS)
        g_rows = min(chunk, GROUP)
        groups = chunk // g_rows
        stk, cnt = [], 0
        for c0 in range(0, length, chunk):
            tree = [None] * groups
            for warp in range(WARPS):
                for grp in range(warp, groups, WARPS):
                    j0 = c0 + grp * g_rows
                    v = np.zeros((GROUP, w), np.float32)
                    for u in range(GROUP):
                        g = r0 + lo + j0 + u
                        if u < g_rows and j0 + u < length and g < n \
                                and ids[g] == label:
                            v[u] = vals[g]
                    m = GROUP // 2
                    while m >= 1 and GROUP // m <= g_rows:  # log_g levels
                        v[:m] = v[0:2 * m:2] + v[1:2 * m:2]
                        m //= 2
                    tree[grp] = v[0].copy()
            h = 1
            while groups >> h:                              # in place
                half = 1 << (h - 1)
                for i in range(groups >> h):
                    tree[i << h] = tree[i << h] + tree[(i << h) + half]
                h += 1
            cnt = _push_leaf(stk, cnt, tree[0])
        part = _close_tree(stk, cnt, w)
        total = part if ln == 0 else total + part
    return total


def _contribs(policy, vals, ids, block, label, lanes):
    """Each schedule block's contribution, (nb, W), as phase 1 reads it:
    at B = 1 the row itself (value or 0 / +0), else phase 2's output."""
    pol = t_policy(policy)
    n, w = vals.shape
    if block == 1:
        keep = (ids == label)[:, None]
        if pol.integer:
            return np.where(keep, _as_int(vals), np.int32(0))
        return np.where(keep, vals, np.float32(0.0))
    nb = -(-n // block)
    make = _int_contrib if pol.integer else \
        (lambda *a: _float_contrib(*a, lanes))
    return np.stack([make(vals, ids, b * block, block, label)
                     for b in range(nb)])


def _wrap_add(a, b, flags):
    s = a + b
    return s, flags + (((a ^ s) & (b ^ s)) < 0).astype(np.int32)


def _fold(policy, contribs, d):
    """``wide_fold_kernel``: every column's carry, block by block in
    order, each tier's update as the kernel writes it."""
    z32 = np.zeros(d, np.int32)
    if policy == "fast":
        acc = np.zeros(d, np.float32)
        for c in contribs:
            acc = acc + c
        return (acc,)
    if policy == "compensated":
        acc, comp = np.zeros(d, np.float32), np.zeros(d, np.float32)
        for c in contribs:
            s = acc + c
            bp = s - acc
            e = (acc - (s - bp)) + (c - bp)
            acc, comp = s, comp + e
        return acc, comp
    if policy == "exact":
        acc = z32.copy()
        for c in contribs:
            acc = acc + c
        return (acc,)
    planes = t_policy(policy).parts
    bins = [z32.copy() for _ in range(planes)]
    hi, lo, ovf = z32.copy(), z32.copy(), z32.copy()
    for c in contribs:
        c = c.reshape(planes, d)
        wb = z32.copy()
        if policy == "exact2":
            hi, wb = _wrap_add(hi, c[0] >> 15, wb)
            lo, wb = _wrap_add(lo, c[0] & 0x7fff, wb)
        first = 1 if policy == "exact2" else 0
        for p in range(first, planes):
            bins[p], wb = _wrap_add(bins[p], c[p], wb)
        ovf = ovf + wb
    if policy == "exact2":
        return hi, lo, np.concatenate(bins[1:]), ovf
    return np.concatenate(bins), ovf


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def _stream(policy, n, block, label, rng):
    """A one-label stream: labels mostly ``label``, 10% sentinels, 10% of
    two other labels, one all-sentinel schedule block; float values over
    2^-30..2^30 with 10% -0.0 and one block's label rows all -0.0, or an
    integer domain with half its entries near +-2^30."""
    ids = np.full(n, label, np.int32)
    u = rng.rand(n)
    ids[u < 0.1] = -1
    ids[(u >= 0.1) & (u < 0.15)] = label + 1
    ids[(u >= 0.15) & (u < 0.2)] = label - 1
    if n >= 3 * block:
        ids[block:2 * block] = -1
    pol = t_policy(policy)
    w = pol.parts * D
    if pol.integer:
        near = (2 ** 30 - 64 * rng.randint(0, 1024, (n, w))) \
            * rng.choice([-1, 1], (n, w))
        vals = np.where(rng.rand(n, w) < 0.5, near,
                        rng.randint(-2 ** 20, 2 ** 20, (n, w)))
        return vals.astype(np.float32 if policy == "exact2" else np.int32), \
            ids
    vals = rng.randn(n, w) * 2.0 ** rng.randint(-30, 31, (n, w))
    vals[rng.rand(n, w) < 0.1] = -0.0
    last = (n - 1) // block * block
    vals[last:][ids[last:] == label] = -0.0
    return vals.astype(np.float32), ids


def _plain(policy, vals, ids, block, label, contrib):
    """``segsum_policy_torch`` at one label, the ragged N padded with
    sentinel rows (which the kernels read past N)."""
    pol = t_policy(policy)
    pad = (-len(ids)) % block
    pv = np.concatenate([vals, np.zeros((pad, vals.shape[1]), vals.dtype)])
    pi = np.concatenate([ids, np.full(pad, -1, np.int32)])
    prog = t_plan(pol, num_segments=1, domain_width=vals.shape[1],
                  block_size=block, contrib=contrib)
    return K.segsum_policy_torch(torch.tensor(pv), torch.tensor(pi), 1,
                                 policy=pol, program=prog, block_rows=block,
                                 seg_offset=label)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_wide_schedule_emulation_bitwise_plain(policy):
    """The two kernels' order gives the plain version's bits: every carry
    component, at B in {1, 64, 96, 512} (and 1,200 for the float tiers:
    several tree chunks a lane, one never visited), dot and lane forms,
    the label at 0 and at an offset; ``ovf`` counts on the wrapping
    integer domain."""
    pol = t_policy(policy)
    blocks = (1, 64, 96, 512) + (() if pol.integer else (1200,))
    for block in blocks:
        rng = np.random.RandomState(block + len(policy))
        n = 37 if block == 1 else 3 * block + block // 2 + 1
        for label in (0, 5):
            vals, ids = _stream(policy, n, block, label, rng)
            for contrib in ("dot", "lanes"):
                lanes = 4 if contrib == "lanes" else 1
                nl = len(lane_bounds(block, lanes)) - 1
                got = _fold(policy, _contribs(policy, vals, ids, block,
                                              label, nl), D)
                want = _plain(policy, vals, ids, block, label, contrib)
                assert len(got) == len(want)
                for a, b in zip(got, want):
                    b = b.numpy()[0]
                    assert a.dtype == b.dtype
                    assert np.array_equal(a.view(np.int32),
                                          b.view(np.int32)), \
                        (block, label, contrib)
            if pol.integer and policy != "exact":
                assert want[-1].any(), block       # the carry wrapped


def test_wide_plan_at_the_train_shapes():
    """The microbatch mean of the largest leaf, (4, 276,824,064) at B = 1:
    one CUDA kernel of ceil(d / 1,024) CUDA blocks.  Its norm stream,
    (270,336, 1,024) at B = 512: a (528, 8) contribution grid into a
    (528, 1,024) tensor, then a fold of 16 CUDA blocks (one column a
    thread, 64 threads a CUDA block).  A raw width
    that is no multiple of 4, or an unaligned base, loads one column a
    thread.  More than one label keeps the label schedule."""
    d = 276_824_064
    exact, exact2, fast = (t_policy(p) for p in ("exact", "exact2", "fast"))
    plan = K.launch_plan(exact, 1, d, 4, 1)
    assert isinstance(plan, K.WidePlan)
    assert plan.kernels == 1 and plan.vec == 4
    assert plan.fold_grid == -(-d // 1024) == 270_336
    assert plan.contrib_grid is None and plan.contrib_shape is None
    plan = K.launch_plan(exact2, 1, 8 * d, 4, 1)
    assert (plan.kernels, plan.fold_grid) == (1, 270_336)
    for pol, smem in ((exact, 4096), (fast, 16384)):
        plan = K.launch_plan(pol, 1, 1024, 270_336, 512)
        assert plan.kernels == 2 and plan.vec == 4
        assert plan.contrib_grid == (528, 8)
        assert plan.contrib_shape == (528, 1024)
        assert plan.fold_grid == 16 and plan.smem == smem
    plan = K.launch_plan(exact2, 1, 8 * 1024, 270_336, 512)
    assert plan.contrib_grid == (528, 64) and plan.contrib_shape == (528,
                                                                     8192)
    # the 13 small folds of a norm: (1,024, 1) and (12, 1) at B = 512
    assert K.launch_plan(fast, 1, 1, 1024, 512) == \
        K.WidePlan(1, (2, 1), (2, 1), 1, 4096)
    assert K.launch_plan(fast, 1, 1, 12, 512).contrib_grid == (1, 1)
    assert K.launch_plan(exact, 1, 6, 4, 1).vec == 1
    assert K.launch_plan(exact, 1, 8, 4, 1, aligned=False).vec == 1
    assert K.launch_plan(exact, 1024, 64, 4_000_000, 512) == \
        K.launch_shape(exact, 1024, 64)


def test_wide_smem_bytes_mirror_the_source():
    """``ops.wide_smem_bytes`` and the constants it reads are the CUDA
    source's, and every contribution-kernel CUDA block fits the 48 KB a
    launch takes without opting in to more."""
    src = (_build.CSRC / "segsum.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("TREE_ROWS") == ops.TREE_ROWS
    assert const("GROUP_ROWS") == ops.GROUP_ROWS
    assert const("WIDE_THREADS") == ops.WIDE_THREADS
    assert const("FOLD_THREADS") == ops.FOLD_THREADS
    assert "rows * 32 * static_cast<size_t>(vec) * 4" in src
    for vec in (1, 4):
        assert ops.wide_smem_bytes(True, vec) == 4 * 8 * 32 * vec
        assert ops.wide_smem_bytes(False, vec) == 4 * 32 * 32 * vec
        for integer in (True, False):
            assert ops.wide_smem_bytes(integer, vec) <= 48 * 1024


@pytest.mark.parametrize("policy", ("exact", "exact2", "procrastinate"))
def test_one_label_plain_matches_pallas_kernel(policy):
    """At one label the plain version the new schedule is held to is the
    reference's Pallas kernel to the bit, for the integer tiers: the
    microbatch mean's shape (4 rows, B = 1) and a padded stream at
    B = 64, on the wrapping domain."""
    for n, block in ((4, 1), (192, 64)):
        rng = np.random.RandomState(n)
        vals, ids = _stream(policy, n, block, 0, rng)
        want = segsum_policy_pallas(jnp.asarray(vals), jnp.asarray(ids), 1,
                                    policy=j_policy(policy),
                                    block_rows=block, interpret=True)
        got = _plain(policy, vals, ids, block, 0, "dot")
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b)), (n, block)
