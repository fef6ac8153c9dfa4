"""The accumulator layer of slice 2 held against the reference: the fixed
pairing trees, the flash-partial combines, ``FlashAccumulator`` with
``merge_tree`` and ``scan_accumulate``, and the segment oracles.

Pure additions on normal floats are bitwise (both packages add
elementwise in the same tree); anything through ``exp`` agrees within
EXP_RTOL, since XLA's and PyTorch's CPU ``exp`` may differ in the last
bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import segmented as JS  # noqa: E402
from repro.core import trees as JT  # noqa: E402
from repro.reduce import FlashAccumulator as JFlash  # noqa: E402
from repro.reduce import merge_tree as j_merge_tree  # noqa: E402
from repro.reduce import scan_accumulate as j_scan  # noqa: E402
from repro_torch.core import segmented as TS  # noqa: E402
from repro_torch.core import trees as TT  # noqa: E402
from repro_torch.reduce import (Accumulator, FlashAccumulator,  # noqa: E402
                                merge_tree, scan_accumulate)

#: a few ulp of f32 after a handful of exp-weighted adds
EXP_RTOL, EXP_ATOL = 1e-6, 1e-7


def _partials(seed, n, g=3, d=5):
    rng = np.random.RandomState(seed)
    m = (rng.randn(n, g) * 3).astype(np.float32)
    m[0, 0] = -1e30                      # an all-masked partial
    l = rng.rand(n, g).astype(np.float32) * 10 + 0.5
    o = rng.randn(n, g, d).astype(np.float32)
    return m, l, o


@pytest.mark.parametrize("n", [1, 2, 5, 8, 13])
def test_pairwise_tree_sum_bitwise_reference(n):
    x = np.random.RandomState(n).randn(n, 7).astype(np.float32)
    for axis in (0, 1):
        want = np.asarray(JT.pairwise_tree_sum(jnp.asarray(x), axis=axis))
        got = TT.pairwise_tree_sum(torch.tensor(x), axis=axis).numpy()
        assert want.tobytes() == got.tobytes()
    items = [(x[i], {"a": x[i] * 2}) for i in range(n)]
    want = JT.pairwise_tree_sum_pytree(
        [(jnp.asarray(a), {"a": jnp.asarray(b["a"])}) for a, b in items])
    got = TT.pairwise_tree_sum_pytree(
        [(torch.tensor(a), {"a": torch.tensor(b["a"])}) for a, b in items])
    assert np.asarray(want[0]).tobytes() == got[0].numpy().tobytes()
    assert np.asarray(want[1]["a"]).tobytes() == \
        got[1]["a"].numpy().tobytes()
    assert TT.tree_depth(n) == JT.tree_depth(n)
    mx = TT.tree_combine(torch.tensor(x), 0, torch.maximum)
    assert torch.equal(mx, torch.tensor(x).amax(0))


def test_empty_trees_raise():
    with pytest.raises(ValueError):
        TT.pairwise_tree_sum(torch.zeros(0, 3))
    with pytest.raises(ValueError):
        TT.pairwise_tree_sum_pytree([])
    with pytest.raises(ValueError):
        merge_tree(FlashAccumulator(), [])


def test_flash_partial_combines_match_reference():
    m, l, o = _partials(1, 2)
    want = JS.flash_partial_combine(*(jnp.asarray(t[0]) for t in (m, l, o)),
                                    *(jnp.asarray(t[1]) for t in (m, l, o)))
    got = TS.flash_partial_combine(*(torch.tensor(t[0]) for t in (m, l, o)),
                                   *(torch.tensor(t[1]) for t in (m, l, o)))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=EXP_RTOL,
                                   atol=EXP_ATOL)
    want = JS.streaming_logsumexp_combine(*(jnp.asarray(t) for t in
                                            (m[0], l[0], m[1], l[1])))
    got = TS.streaming_logsumexp_combine(*(torch.tensor(t) for t in
                                           (m[0], l[0], m[1], l[1])))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=EXP_RTOL,
                                   atol=EXP_ATOL)


@pytest.mark.parametrize("n", [1, 3, 4, 7])
def test_partials_tree_and_accumulator_match_reference(n):
    m, l, o = _partials(n, n)
    want = JS.combine_flash_partials_tree(jnp.asarray(m), jnp.asarray(l),
                                          jnp.asarray(o))
    got = TS.combine_flash_partials_tree(torch.tensor(m), torch.tensor(l),
                                         torch.tensor(o))
    for a, b in zip(want, got):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=EXP_RTOL,
                                   atol=EXP_ATOL)
    # merge_tree pairs exactly as the stacked tree does: the same bits
    acc = FlashAccumulator()
    states = [(torch.tensor(m[i]), torch.tensor(l[i]), torch.tensor(o[i]))
              for i in range(n)]
    merged = merge_tree(acc, states)
    for a, b in zip(got, merged):
        assert torch.equal(a, b)
    jacc = JFlash()
    jwant = jacc.finalize(j_merge_tree(
        jacc, [(jnp.asarray(m[i]), jnp.asarray(l[i]), jnp.asarray(o[i]))
               for i in range(n)]))
    np.testing.assert_allclose(acc.finalize(merged).numpy(),
                               np.asarray(jwant), rtol=EXP_RTOL,
                               atol=EXP_ATOL)
    jscan = j_scan(jacc, (jnp.asarray(m), jnp.asarray(l), jnp.asarray(o)))
    tscan = scan_accumulate(acc, (torch.tensor(m), torch.tensor(l),
                                  torch.tensor(o)))
    np.testing.assert_allclose(tscan.numpy(), np.asarray(jscan),
                               rtol=EXP_RTOL, atol=EXP_ATOL)
    assert isinstance(acc, Accumulator)


def test_flash_accumulator_init_is_the_identity():
    m, l, o = _partials(2, 1)
    acc = FlashAccumulator()
    part = (torch.tensor(m[0]), torch.tensor(l[0]), torch.tensor(o[0]))
    st = acc.init(part)
    assert float(st[0].max()) == np.float32(-1e30)
    assert not st[1].any() and not st[2].any()
    out = acc.push(st, part)
    np.testing.assert_allclose(out[2].numpy(), o[0], rtol=EXP_RTOL,
                               atol=EXP_ATOL)
    fin = acc.finalize((part[0], torch.zeros_like(part[1]), part[2]))
    assert torch.isfinite(fin).all()          # l = 0 divides by 1e-30


def test_segment_oracles_match_reference():
    rng = np.random.RandomState(4)
    vals = rng.randn(300, 3).astype(np.float32)
    ids = rng.randint(-1, 9, 300).astype(np.int32)
    valid = rng.rand(300) < 0.8
    want = JS.segment_sum_ref(jnp.asarray(vals), jnp.asarray(ids), 8)
    got = TS.segment_sum_ref(torch.tensor(vals), torch.tensor(ids), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    want = JS.segment_count_ref(jnp.asarray(ids), 8, jnp.asarray(valid))
    got = TS.segment_count_ref(torch.tensor(ids), 8, torch.tensor(valid))
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert TS.max_live_segments(512) == JS.max_live_segments(512) == 513
