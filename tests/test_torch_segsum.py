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
main path's shapes.
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
    for int_lanes in (False, True):
        st = ops.seg_tile_for(s, d, parts, int_lanes=int_lanes)
        ct = ops.col_tile_for(d)
        assert 1 <= st <= s and st * ct <= ops.BLOCK_THREADS
        assert ops.segsum_smem_bytes(st, ct, parts, int_lanes) \
            <= ops.SMEM_BYTES


def test_main_path_launch_shape():
    """The main path's shapes: 1,024 labels, 64 columns, exact2's eight
    planes -> 4 column tiles x 32 label tiles of 32 labels."""
    ct, st, grid = K.launch_shape(t_policy("exact2"), 1024, 8 * 64,
                                  t_plan("exact2", num_segments=1024,
                                         domain_width=512))
    assert (ct, st, grid) == (16, 32, (4, 32))
