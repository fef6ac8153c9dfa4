"""The port's gradient juggler against the reference, on the CPU.

``repro_torch.core.juggler`` and ``TreeAccumulator`` keep the reference's
schedule (the incoming value merges with the occupied slots lowest level
first, ``finalize`` folds low to high from zeros), with the carry chain
resolved on the host.  Every sum is an elementwise IEEE add of the leaf
dtype in a fixed order, so the results are held bitwise, float32 and
bfloat16 alike, given the same pushes in the same order.  Inputs are
numpy draws from fixed seeds, magnitudes spread over 2^-12..2^12 so that
the adds round.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import juggler as RJ  # noqa: E402
from repro.reduce import accumulator as RACC  # noqa: E402
from repro_torch.core import juggler as TJ  # noqa: E402
from repro_torch.reduce import accumulator as TACC  # noqa: E402

SHAPES = ((3, 257), (64,))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _grads(m, seed):
    rng = np.random.default_rng(seed)
    return [[(rng.standard_normal(s) * np.exp2(rng.uniform(-12, 12, s)))
             .astype(np.float32) for s in SHAPES] for _ in range(m)]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _ref_state(grads, k, jdt):
    st = RJ.juggler_init([jnp.zeros(s, jdt) for s in SHAPES], k)
    for g in grads:
        st = RJ.juggler_push(st, [jnp.asarray(x).astype(jdt) for x in g])
    return st


def _port_state(grads, k, tdt):
    st = TJ.juggler_init([torch.zeros(s, dtype=tdt) for s in SHAPES], k)
    for g in grads:
        st = TJ.juggler_push(st, [torch.from_numpy(x).to(tdt) for x in g])
    return st


def _same(ref_leaves, port_leaves):
    for r, p in zip(ref_leaves, port_leaves):
        r = np.asarray(jnp.asarray(r).astype(jnp.float32))
        assert np.array_equal(_bits(r), _bits(p.float().numpy())), \
            float(np.abs(r - p.float().numpy()).max())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m", (1, 2, 3, 5, 8))
def test_juggler_bitwise_reference(m, dtype):
    """push x m, then finalize with and without the mean: the same bits
    as ``repro.core.juggler`` in the leaf dtype."""
    jdt, tdt = DTYPES[dtype]
    grads = _grads(m, seed=m)
    k = RJ.num_slots_for(m)
    ref, port = _ref_state(grads, k, jdt), _port_state(grads, k, tdt)
    assert port.occupancy == [bool(o) for o in np.asarray(ref.occupancy)]
    assert port.count == int(ref.count) == m
    for mean in (False, True):
        _same(RJ.juggler_finalize(ref, mean=mean),
              TJ.juggler_finalize(port, mean=mean))


def test_juggler_schedule_written_out():
    """The pairing, written by hand in the leaf dtype: four pushes give
    (0 + ((g1 + g2) + (g3 + g4))) / 4, three give ((0 + (g1 + g2)) + g3)."""
    for dtype in (torch.float32, torch.bfloat16):
        g = [[torch.from_numpy(x).to(dtype) for x in gs]
             for gs in _grads(4, seed=11)]
        st = TJ.juggler_init(g[0], TJ.num_slots_for(4))
        for i, gi in enumerate(g):
            st = TJ.juggler_push(st, gi)
            if i == 2:
                three = TJ.juggler_finalize(st)
        four = TJ.juggler_finalize(st, mean=True)
        for j in range(len(SHAPES)):
            zero = torch.zeros_like(g[0][j])
            want4 = (zero + ((g[0][j] + g[1][j]) + (g[2][j] + g[3][j]))) \
                / torch.tensor(4.0, dtype=dtype)
            want3 = (zero + (g[0][j] + g[1][j])) + g[2][j]
            assert torch.equal(four[j], want4)
            assert torch.equal(three[j], want3)


def test_num_slots_for_matches_reference():
    for m in range(0, 70):
        assert TJ.num_slots_for(m) == RJ.num_slots_for(m)
    assert TACC.TreeAccumulator.for_count(8).num_slots == \
        RACC.TreeAccumulator.for_count(8).num_slots == 4


@pytest.mark.parametrize("split", ((1, 1), (3, 2), (2, 5), (4, 4)))
def test_tree_accumulator_merge_bitwise_reference(split):
    """``merge`` folds b to one partial and pushes it into a (an
    unbalanced pairing): the same bits and count as the reference."""
    na, nb = split
    grads = _grads(na + nb, seed=100 + na * 10 + nb)
    k = RJ.num_slots_for(na + nb)
    racc, tacc = RACC.TreeAccumulator(k), TACC.TreeAccumulator(k)
    ra = _ref_state(grads[:na], k, jnp.float32)
    rb = _ref_state(grads[na:], k, jnp.float32)
    ta = _port_state(grads[:na], k, torch.float32)
    tb = _port_state(grads[na:], k, torch.float32)
    rm, tm = racc.merge(ra, rb), tacc.merge(ta, tb)
    assert tm.count == int(rm.count) == na + nb
    assert tm.occupancy == [bool(o) for o in np.asarray(rm.occupancy)]
    _same(racc.finalize(rm, mean=True), tacc.finalize(tm, mean=True))


def test_accumulate_microbatch_grads_bitwise_reference():
    """``accumulate_microbatch_grads`` over five stacked microbatches:
    the mean gradient bitwise the reference's, the aux stacked in order."""
    m = 5
    grads = _grads(m, seed=7)
    stacked = [np.stack([g[j] for g in grads]) for j in range(len(SHAPES))]

    def ref_fn(p, mb):
        return {"a": mb[0] * p, "b": mb[1] * p}, mb[1].sum()

    def port_fn(p, mb):
        return {"a": mb[0] * p, "b": mb[1] * p}, mb[1].sum()

    rg, raux = RACC.accumulate_microbatch_grads(
        ref_fn, jnp.float32(1.0), [jnp.asarray(s) for s in stacked],
        num_microbatches=m)
    tg, taux = TACC.accumulate_microbatch_grads(
        port_fn, 1.0, [torch.from_numpy(s) for s in stacked],
        num_microbatches=m)
    assert list(tg) == ["a", "b"]
    _same([rg["a"], rg["b"]], [tg["a"], tg["b"]])
    assert taux.shape == (m,)
