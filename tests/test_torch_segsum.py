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
    for int_lanes in (False, True):
        st = ops.seg_tile_for(s, d, parts, int_lanes=int_lanes)
        assert 1 <= st <= s and st * ct <= ops.BLOCK_THREADS
        assert ops.segsum_smem_bytes(st, ct, parts, int_lanes) \
            <= ops.SMEM_BYTES
    # the float tiers (one plane) hold a chunk's tree instead
    st = ops.seg_tile_for(s, d, 1, int_lanes=False, float_tree=True)
    assert 1 <= st <= s and st * ct <= ops.BLOCK_THREADS
    for block in (512, 4096):
        for lanes in (1, 4):
            chunk = ops.tree_rows_for(block, lanes)
            assert chunk == min(block // lanes, ops.TREE_ROWS)
            assert ops.segsum_smem_bytes(st, ct, 1, False, chunk,
                                         float_tree=True) <= ops.SMEM_BYTES


def test_main_path_launch_shape():
    """The main path's shapes: 1,024 labels, 64 columns, exact2's eight
    planes -> 4 column tiles x 32 label tiles of 32 labels."""
    ct, st, grid = K.launch_shape(t_policy("exact2"), 1024, 8 * 64,
                                  t_plan("exact2", num_segments=1024,
                                         domain_width=512))
    assert (ct, st, grid) == (16, 32, (4, 32))


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
