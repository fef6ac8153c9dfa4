"""K1 — the block-schedule kernel — held against the TPU kernel.

The plain PyTorch version of K1 (``segsum_policy_torch``, what the
``blocked`` executor runs) is compared with the reference's
``segsum_policy_pallas(..., interpret=True)`` on the same domain stream,
for 5 tiers x {dot, lanes} x block sizes {64, 128, 512}:

* integer tiers: the carry tuple, bitwise;
* float tiers: within the sum of the two orders' error bounds per cell,
  (B + nb + log2(B) + lanes + 2) * 2^-24 * sum|x| — the reference's
  one-hot dot and carry fold (B + nb adds deep at most) against the
  port's pinned pairwise tree, lane fold and carry fold.

The CUDA kernel itself is compared with this plain version, bitwise, in
``tests/test_torch_cuda.py`` (GPU only) and by ``chip_smoke.py`` at the
main path's shapes.  Here, ``_kernel_float_block`` emulates the kernel's
float path step by step (padded lanes, chunked unmasked trees with a pure
label per node, the per-label descent, the chunk-level binary-counter
stack, the lane fold) and is held bitwise to ``policy.float_contrib``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.jugglepac_segsum import segsum_policy_pallas  # noqa: E402
from repro.reduce import get_policy as j_policy  # noqa: E402
from repro.reduce import plan_program as j_plan  # noqa: E402
from repro_torch.kernels import jugglepac_segsum as K  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ref import segsum_ref  # noqa: E402
from repro_torch.reduce import get_policy as t_policy  # noqa: E402
from repro_torch.reduce import plan_program as t_plan  # noqa: E402
from repro_torch.reduce.policy import float_contrib, lane_bounds  # noqa: E402

POLICIES = ("fast", "compensated", "exact", "exact2", "procrastinate")
INT_POLICIES = ("exact", "exact2", "procrastinate")
N, D, S = 1024, 3, 48


def _stream(seed=0, n=N, d=D, s=S):
    rng = np.random.RandomState(seed)
    vals = (rng.randn(n, d) * 2.0 ** rng.randint(-6, 6, (n, 1))) \
        .astype(np.float32)
    ids = rng.randint(-1, s, n).astype(np.int32)
    ids[ids < 0] = -1
    return vals, ids


def _domain(policy, vals):
    """The reference's domain stream as numpy (both kernels get it)."""
    dom, _ = j_policy(policy).prepare(jnp.asarray(vals), vals.shape[0])
    return np.asarray(dom)


def _tolerance(vals, ids, s, block, lanes):
    nb = vals.shape[0] // block
    absum = np.zeros((s, vals.shape[1]))
    keep = (ids >= 0) & (ids < s)
    np.add.at(absum, ids[keep], np.abs(vals[keep].astype(np.float64)))
    depth = block + nb + np.log2(block) + lanes + 2
    return depth * 2.0 ** -24 * absum


@pytest.mark.parametrize("block", (64, 128, 512))
@pytest.mark.parametrize("contrib", ("dot", "lanes"))
@pytest.mark.parametrize("policy", POLICIES)
def test_plain_k1_matches_pallas_kernel(policy, contrib, block):
    vals, ids = _stream(seed=block)
    dom = _domain(policy, vals)
    w = dom.shape[1]
    jp = j_plan(policy, num_segments=S, domain_width=w, block_size=block,
                contrib=contrib)
    tp = t_plan(policy, num_segments=S, domain_width=w, block_size=block,
                contrib=contrib)
    want = segsum_policy_pallas(jnp.asarray(dom), jnp.asarray(ids), S,
                                policy=j_policy(policy), block_rows=block,
                                interpret=True, program=jp)
    got = K.segsum_policy_torch(torch.tensor(dom), torch.tensor(ids), S,
                                policy=t_policy(policy), program=tp,
                                block_rows=block)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        if policy in INT_POLICIES:
            assert np.array_equal(a, b)
        elif policy == "fast":
            tol = _tolerance(vals, ids, S, block, tp.lanes)
            assert (np.abs(a.astype(np.float64) - b) <= tol).all()
    if policy == "compensated":
        fa = np.asarray(want[0], np.float64) + np.asarray(want[1])
        fb = got[0].numpy().astype(np.float64) + got[1].numpy()
        tol = _tolerance(vals, ids, S, block, tp.lanes)
        assert (np.abs(fa - fb) <= tol).all()


@pytest.mark.parametrize("policy", POLICIES)
def test_plain_k1_label_offset_matches_pallas_kernel(policy):
    """A label tile [seg_offset, seg_offset + S) of a wider label space,
    as the reference's pallas backend launches it."""
    vals, ids = _stream(seed=7, s=40)
    dom = _domain(policy, vals)
    off, s = 24, 16
    want = segsum_policy_pallas(jnp.asarray(dom), jnp.asarray(ids), s,
                                policy=j_policy(policy), block_rows=128,
                                seg_offset=off, interpret=True)
    got = K.segsum_policy_torch(torch.tensor(dom), torch.tensor(ids), s,
                                policy=t_policy(policy), block_rows=128,
                                seg_offset=off)
    for a, b in zip(want, got):
        if policy in INT_POLICIES:
            assert np.array_equal(np.asarray(a), b.numpy())
        else:
            np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_fast_segment_sum_matches_math_oracle():
    vals, ids = _stream(seed=3, n=1000)
    got = ops.segment_sum(torch.tensor(vals), torch.tensor(ids), S,
                          device="cpu")
    want = segsum_ref(torch.tensor(vals), torch.tensor(ids), S)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    one = ops.segment_sum(torch.tensor(vals[:, 0]), torch.tensor(ids), S,
                          device="cpu")
    assert one.shape == (S,)
    assert torch.equal(one, got[:, 0])


def test_cuda_wrapper_refuses_cpu_tensors():
    vals, ids = _stream()
    with pytest.raises(ValueError, match="CUDA"):
        K.segsum_policy_cuda(torch.tensor(vals), torch.tensor(ids), S,
                             policy=t_policy("fast"), block_rows=64)


@pytest.mark.parametrize("s,d,parts", [(48, 16, 1), (48, 16, 8),
                                       (1024, 64, 8), (4096, 64, 8),
                                       (1024, 64, 6), (1, 1, 1),
                                       (100000, 3, 2)])
def test_label_tile_fits_the_block(s, d, parts):
    ct = ops.col_tile_for(d)
    # the integer tiers: INT_THREADS carry cells, two scratch buffers
    st = ops.seg_tile_for(s, d, parts)
    assert 1 <= st <= s and st * ct <= ops.INT_THREADS
    assert ops.segsum_smem_bytes(st, ct, parts) <= ops.SMEM_BYTES
    # the float tiers (one plane) hold a chunk's tree instead
    st = ops.seg_tile_for(s, d, 1, float_tree=True)
    assert 1 <= st <= s and st * ct <= ops.BLOCK_THREADS
    for block in (512, 4096):
        for lanes in (1, 4):
            chunk = ops.tree_rows_for(block, lanes)
            assert chunk == min(block // lanes, ops.TREE_ROWS)
            assert ops.segsum_smem_bytes(st, ct, 1, chunk) <= ops.SMEM_BYTES


def test_main_path_launch_shape():
    """The main path's shapes: 1,024 labels, 64 columns -> 4 column
    tiles; exact2's eight planes in 64 label tiles of 16 labels
    (256 threads), the float tiers in 32 tiles of 32 (512 threads)."""
    ct, st, grid = K.launch_shape(t_policy("exact2"), 1024, 8 * 64)
    assert (ct, st, grid) == (16, 16, (4, 64))
    assert K.launch_shape(t_policy("fast"), 1024, 64) == (16, 32, (4, 32))


def _ranges_loop(ids, block, s, off):
    """Each block's least and greatest label of [off, off + s), row by
    row; rows past len(ids) are sentinels."""
    nb = -(-len(ids) // block)
    out = np.empty((nb, 2), np.int64)
    for b in range(nb):
        lo, hi = 2 ** 31 - 1, -2 ** 31
        for lab in ids[b * block:(b + 1) * block]:
            if off <= lab < off + s:
                lo, hi = min(lo, int(lab)), max(hi, int(lab))
        out[b] = lo, hi
    return out.astype(np.int32)


@pytest.mark.parametrize("block", (64, 96, 512, 4096))
def test_block_label_ranges_match_numpy_loop(block):
    """K1's pre-pass, plainly: a ragged N, labels outside the label space
    (and the int32 extremes), an all-sentinel block, a block of only
    out-of-space labels, the whole space and a window at an offset."""
    rng = np.random.RandomState(block)
    s_all = 40
    n = 4 * block + block // 2 + 1
    ids = rng.randint(-5, s_all + 5, n).astype(np.int32)
    ids[block:2 * block] = -1
    ids[2 * block:3 * block] = s_all + 3
    ids[0], ids[-1] = -2 ** 31, 2 ** 31 - 1
    for off, s in ((0, s_all), (7, 13), (0, 1)):
        got = K.block_label_ranges_torch(torch.tensor(ids), block, s, off)
        want = _ranges_loop(ids, block, s, off)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want), (off, s)
    assert np.array_equal(
        K.block_label_ranges_torch(torch.tensor(ids), block, s_all)[1],
        np.array(K.NO_RANGE, np.int32))


# ---------------------------------------------------------------------------
# The kernel's integer path, emulated
# ---------------------------------------------------------------------------


def _wrap_add(a, b):
    """intac.wrap_add on int32 arrays: the wrapped sum and its flags."""
    s = a + b
    return s, (((a ^ s) & (b ^ s)) < 0).astype(np.int32)


def _int_fold(policy, carry, c, d):
    """One touched block's fold of the tile's int32 contribution c
    (tile_segs, P * d) into the carry, cell by cell as the kernel does."""
    if policy == "exact":
        return [carry[0] + c]
    if policy == "exact2":
        hi, lo, rb, ovf = carry
        hi, w1 = _wrap_add(hi, c[:, :d] >> 15)
        lo, w2 = _wrap_add(lo, c[:, :d] & 0x7fff)
        rb, w3 = _wrap_add(rb, c[:, d:])
        return [hi, lo, rb, ovf + w1 + w2 + w3.reshape(len(c), -1, d).sum(1,
                                                                 dtype=np.int32)]
    bins, ovf = carry
    bins, w = _wrap_add(bins, c)
    return [bins, ovf + w.reshape(len(c), -1, d).sum(1, dtype=np.int32)]


def _kernel_int_carry(policy, dom, ids, block, s_all, tile0, tile_segs,
                      runs):
    """The kernel's integer path for one label tile: the range test on the
    pre-pass's ranges, then for each touched block `runs` row runs, each
    summed in registers (wrapping int32) while consecutive rows carry one
    label of the tile and flushed into the scratch where the label
    changes and at the end; then every touched block folds, zero
    included."""
    pol = t_policy(policy)
    n, w = dom.shape
    d = w // pol.parts
    vals = dom.astype(np.int32) if dom.dtype == np.float32 else dom
    ranges = K.block_label_ranges_torch(torch.tensor(ids), block,
                                        s_all).numpy()
    carry = [c.numpy() for c in pol.init(tile_segs, w)]
    run_rows = -(-block // runs)
    for b, (lo, hi) in enumerate(ranges):
        if not (lo <= tile0 + tile_segs - 1 and hi >= tile0):
            continue
        scratch = np.zeros((tile_segs, w), np.int32)
        for r in range(runs):
            cur, acc = -1, None
            for g in range(b * block + r * run_rows,
                           b * block + min(block, (r + 1) * run_rows)):
                loc = int(ids[g]) - tile0
                if not 0 <= loc < tile_segs:
                    continue
                if loc != cur:
                    if cur >= 0:
                        scratch[cur] += acc
                    cur, acc = loc, np.zeros(w, np.int32)
                acc += vals[g]
            if cur >= 0:
                scratch[cur] += acc
        carry = _int_fold(policy, carry, scratch, d)
    return carry


def _wrapping_domain(policy, n, d, rng):
    """A domain of the tier's dtype and width where half the entries lie
    near +-2^30: block sums and carries wrap."""
    w = t_policy(policy).parts * d
    big = rng.rand(n, w) < 0.5
    near = (2 ** 30 - 64 * rng.randint(0, 1024, (n, w))) \
        * rng.choice([-1, 1], (n, w))
    vals = np.where(big, near, rng.randint(-2 ** 20, 2 ** 20, (n, w)))
    return vals.astype(np.float32 if policy == "exact2" else np.int32)


@pytest.mark.parametrize("layout", ("runs", "random", "sentinel_runs",
                                    "other_tiles", "sentinel"))
@pytest.mark.parametrize("block", (64, 96, 512))
@pytest.mark.parametrize("policy", INT_POLICIES)
def test_kernel_int_path_emulation_bitwise_update(policy, block, layout):
    """Register runs and flushes, any split of the rows, untouched blocks
    skipped and touched ones folded unconditionally: bitwise
    ``block_contrib`` then ``Policy.update``, ``ovf`` included, for the
    whole label space and for a tile of it.  Block 1 is all sentinel;
    ``other_tiles`` blocks hold no label of the tile (2..4) but span it."""
    rng = np.random.RandomState(block + len(layout))
    s_all, d, nb = 8, 2, 4
    ids = np.concatenate([
        _layout_ids("sentinel" if k == 1 else
                    "runs" if layout == "other_tiles" else layout,
                    block, s_all, rng) for k in range(nb)])
    if layout == "other_tiles":
        ids[(ids >= 2) & (ids < 5)] += 3
    dom = _wrapping_domain(policy, nb * block, d, rng)
    for tile0, tile_segs in ((0, s_all), (2, 3)):
        want = K.segsum_policy_torch(torch.tensor(dom), torch.tensor(ids),
                                     tile_segs, policy=t_policy(policy),
                                     block_rows=block, seg_offset=tile0)
        for runs in (1, 3, 32):
            got = _kernel_int_carry(policy, dom, ids, block, s_all, tile0,
                                    tile_segs, runs)
            assert len(got) == len(want)
            for a, b in zip(got, want):
                assert np.array_equal(a, b.numpy()), (tile0, runs)
        if tile0 == 0 and policy != "exact" and layout != "sentinel":
            assert want[-1].any()          # the carry wrapped: ovf != 0


# ---------------------------------------------------------------------------
# The kernel's float path, emulated step by step
# ---------------------------------------------------------------------------

WILD, MIXED = -1, -2
TREE_DEPTH = 9          # the descent's register stack in csrc/segsum.cu


def _push_leaf(stk, cnt, v):
    """``push_leaf``: after leaf i, merge ctz(i + 1) times, left first."""
    cnt += 1
    c = cnt
    while c % 2 == 0:
        v = stk.pop() + v
        c //= 2
    stk.append(v)
    return cnt


def _close_tree(stk, cnt, zero):
    p2 = 1
    while p2 < cnt:
        p2 *= 2
    while cnt < p2:
        cnt = _push_leaf(stk, cnt, zero)
    return stk[0]


def _pure_label(a, b):
    return torch.where(a == b, a, torch.where(
        a == WILD, b, torch.where(b == WILD, a, torch.full_like(a, MIXED))))


def _descend(labs, vals, s, zero):
    """``descend``: the masked sum for label s from the chunk's root,
    walking MIXED nodes only, with the kernel's stack of left siblings."""
    top = len(labs) - 1
    h, i, stk = top, 0, []
    while True:
        lab = int(labs[h][i])
        if lab == MIXED:
            h, i = h - 1, 2 * i
            continue
        v = vals[h][i] if lab == s else zero
        while i % 2:
            v = stk.pop() + v
            i, h = i // 2, h + 1
        if h == top:
            return v
        stk.append(v)
        assert len(stk) <= TREE_DEPTH
        i += 1


def _kernel_float_block(ids, vals, tile0, tile_segs, lanes, chunk_rows):
    """One schedule block through the kernel's float path, for the label
    tile [tile0, tile0 + tile_segs): ids (B,) int32, vals (B, W) f32 ->
    (tile_segs, W) f32."""
    b, w = vals.shape
    zero = torch.zeros(w, dtype=torch.float32)
    loc = ids.to(torch.int64) - tile0
    wild = (loc < 0) | (loc >= tile_segs)
    lab_rows = torch.where(wild, torch.full_like(loc, WILD), loc)
    val_rows = torch.where(wild[:, None], zero, vals)
    bounds = lane_bounds(b, lanes)
    total = [None] * tile_segs
    for k, (lo, hi) in enumerate(zip(bounds, bounds[1:])):
        n_rows = hi - lo
        size = 1 << max(0, (n_rows - 1).bit_length())
        chunk = min(size, chunk_rows)
        stacks = [([], 0) for _ in range(tile_segs)]
        for c0 in range(0, n_rows, chunk):
            real = min(chunk, n_rows - c0)
            lab = torch.full((chunk,), WILD, dtype=torch.int64)
            lab[:real] = lab_rows[lo + c0:lo + c0 + real]
            x = torch.zeros((chunk, w), dtype=torch.float32)
            x[:real] = val_rows[lo + c0:lo + c0 + real]
            labs, xs = [lab], [x]
            while len(labs[-1]) > 1:
                labs.append(_pure_label(labs[-1][0::2], labs[-1][1::2]))
                xs.append(xs[-1][0::2] + xs[-1][1::2])
            present = set(lab.tolist())
            for s in range(tile_segs):
                part = _descend(labs, xs, s, zero) if s in present else zero
                stk, cnt = stacks[s]
                stacks[s] = (stk, _push_leaf(stk, cnt, part))
        for s in range(tile_segs):
            part = _close_tree(*stacks[s], zero)
            total[s] = part if k == 0 else total[s] + part
    return torch.stack(total)


def _layout_ids(layout, b, s, rng):
    """Labels of one schedule block in [-1, s) (-1: a sentinel row)."""
    if layout == "sentinel":
        return np.full(b, -1, np.int32)
    if layout == "one_label":
        return np.full(b, s - 1, np.int32)
    if layout == "random":
        return rng.randint(-1, s, b).astype(np.int32)
    cuts = np.sort(rng.choice(np.arange(1, b), size=min(2 * s, b - 1),
                              replace=False))
    runs = np.split(np.arange(b), cuts)
    ids = np.empty(b, np.int32)
    for r, rows in enumerate(runs):
        ids[rows] = rng.randint(0, s)
        if layout == "sentinel_runs" and r % 3 == 1:
            ids[rows] = -1
    ids[rng.rand(b) < 0.05] = -1
    return ids


def _adversarial_vals(ids, w, rng):
    """Magnitudes 2^-30..2^30 with 10% -0.0 and 10% +0.0 entries, and
    every row of the largest label all -0.0."""
    vals = rng.randn(len(ids), w) * 2.0 ** rng.randint(-30, 31, (len(ids), w))
    u = rng.rand(len(ids), w)
    vals[u < 0.1] = -0.0
    vals[(u >= 0.1) & (u < 0.2)] = 0.0
    vals[ids == ids.max()] = -0.0
    return vals.astype(np.float32)


@pytest.mark.parametrize("policy", ("fast", "compensated"))
def test_float_fold_of_zero_is_idempotent(policy):
    """The kernel folds one +0 for a run of schedule blocks that hold none
    of a tile's labels, where the plain version folds +0 once per block:
    the same bits, since ``Policy.update`` with +0 twice is once, for
    every carry part in {+-0, +-subnormal, +-1.5, +-max, +-inf, NaN}."""
    pol = t_policy(policy)
    vals = torch.tensor([0.0, -0.0, 1e-45, -1e-45, 1.5, -1.5, 3.4e38,
                         -3.4e38, float("inf"), float("-inf"),
                         float("nan")], dtype=torch.float32)
    parts = torch.meshgrid(*[vals] * pol.carry_len, indexing="ij")
    carry = tuple(c.reshape(-1, 1) for c in parts)
    zero = torch.zeros_like(carry[0])
    once = pol.update(carry, zero)
    twice = pol.update(once, zero)
    for a, b in zip(once, twice):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert not torch.signbit(once[0][carry[0] == 0]).any()


@pytest.mark.parametrize("layout", ("runs", "random", "sentinel_runs",
                                    "sentinel", "one_label"))
@pytest.mark.parametrize("block,lanes", [(64, 1), (64, 4), (96, 1), (96, 4),
                                         (130, 4), (512, 1), (512, 4),
                                         (4096, 1), (4096, 4)])
def test_kernel_float_path_emulation_bitwise_float_contrib(layout, block,
                                                           lanes):
    """The kernel's shared-tree-and-descent order gives the pinned order's
    bits, for the whole label space and for a label tile of it (the other
    labels wild), with the kernel's chunk of up to 512 rows and with a
    16-row chunk (many chunks per lane).  ``one_label``: every row -0.0
    of one label, whose sum stays -0.0 where no lane is padded."""
    rng = np.random.RandomState(block * 10 + lanes)
    s, w = 8, 3
    ids = _layout_ids(layout, block, s, rng)
    vals = _adversarial_vals(ids, w, rng)
    tid, tval = torch.tensor(ids), torch.tensor(vals)
    want = float_contrib(tid[None], tval[None], s, lanes=lanes)[0]
    for chunk_rows in (ops.tree_rows_for(block, lanes), 16):
        for tile0, tile_segs in ((0, s), (2, 3)):
            got = _kernel_float_block(tid, tval, tile0, tile_segs, lanes,
                                      chunk_rows)
            ref = want[tile0:tile0 + tile_segs]
            assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
                (layout, block, lanes, chunk_rows, tile0)
    if layout == "one_label" and block % lanes == 0 \
            and (block // lanes) & (block // lanes - 1) == 0:
        assert torch.signbit(want[s - 1]).all()
