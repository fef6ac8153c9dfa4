"""The five accumulators of repro_torch.reduce (Kahan, Limb, Limb3, Bin,
Cascade) held against repro.reduce's, pushed row by row, through
``scan_accumulate`` and through ``merge_tree``.

Integer states (limbs, bins) and every ``finalize`` of an integer
accumulator are bitwise.  The float states follow the reference's IEEE
operations in the same order: Kahan's finalize is held within
KAHAN_RTOL and, like every state and Cascade's, bitwise too (the same
elementwise adds in the same order).  Cascade against itself in another
order (a merge tree) is held within CASCADE_RTOL of its weighted
absolute sum.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro.reduce as JR  # noqa: E402
import repro_torch.core as TC  # noqa: E402
import repro_torch.reduce as TR  # noqa: E402
from repro_torch.core import intac as TI  # noqa: E402

#: Kahan against the reference: two-sums in the same order, so a few
#: ulps at most (the sums are O(1), the compensation O(2^-24))
KAHAN_RTOL = 2.0 ** -22
#: Cascade against itself in another order (a merge tree against the
#: one-shot stream): stage k's float32 error is at most about
#: k * n * 2^-24 of its weighted absolute sum ``cascade_weights @ |x|``;
#: against the reference (the same order) it is bitwise
CASCADE_RTOL = 2.0 ** -20

NAMES = ("KahanAccumulator", "LimbAccumulator", "Limb3Accumulator",
         "BinAccumulator", "CascadeAccumulator")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b), (a[a != b][:5], b[a != b][:5])


def _close(a, b, rtol):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol)


def _stream(seed, n=33, d=7, lo=-6, hi=4):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * np.exp2(rng.randint(lo, hi, (n, d)))).astype(
        np.float32)
    x[0, :2] = (0.0, -0.0)
    return x


def _pair(name, x):
    """(reference accumulator, port accumulator) for the stream ``x``."""
    if name in ("LimbAccumulator", "Limb3Accumulator"):
        arg = 2.0 ** 20
    elif name == "BinAccumulator":
        arg = float(np.abs(x).max())
    elif name == "CascadeAccumulator":
        arg = 3
    else:
        return getattr(JR, name)(), getattr(TR, name)()
    return getattr(JR, name)(arg), getattr(TR, name)(arg)


def _check_state(name, js, ts):
    if name in ("LimbAccumulator", "Limb3Accumulator"):
        for f in js._fields:
            _same(getattr(js, f), getattr(ts, f))
    elif name == "BinAccumulator":
        _same(js, ts)
    elif name == "KahanAccumulator":
        for a, b in zip(js, ts):
            _same(a, b)
    else:
        _same(js[0], ts[0])
        for a, b in zip(js[1], ts[1]):
            _same(a, b)


def _check_final(name, jf, tf):
    if name == "KahanAccumulator":
        _close(jf, tf, KAHAN_RTOL)
    _same(jf, tf)


@pytest.mark.parametrize("name", NAMES)
def test_push_row_by_row_and_finalize(name):
    """Every state after every push, and the finalize, bitwise the
    reference's (Kahan's also within KAHAN_RTOL)."""
    x = _stream(0)
    ja, ta = _pair(name, x)
    js, ts = ja.init(jnp.asarray(x[0])), ta.init(torch.from_numpy(x[0]))
    for row in x:
        js = ja.push(js, jnp.asarray(row))
        ts = ta.push(ts, torch.from_numpy(row))
        _check_state(name, js, ts)
    _check_final(name, ja.finalize(js), ta.finalize(ts))


@pytest.mark.parametrize("name", NAMES)
def test_scan_accumulate_and_merge_tree(name):
    """``scan_accumulate`` over the stream and ``merge_tree`` over five
    chunks' states against the reference's; the integer accumulators'
    tree merge is bitwise their scan (order-free), Cascade's within
    CASCADE_RTOL (its merge concatenates in argument order)."""
    x = _stream(1, n=40)
    ja, ta = _pair(name, x)
    _check_final(name, JR.scan_accumulate(ja, jnp.asarray(x)),
                 TR.scan_accumulate(ta, torch.from_numpy(x)))
    chunks = np.array_split(x, 5)

    def states(acc, arrs, conv):
        out = []
        for c in arrs:
            s = acc.init(conv(c[0]))
            for row in c:
                s = acc.push(s, conv(row))
            out.append(s)
        return out

    jt = JR.merge_tree(ja, states(ja, chunks, jnp.asarray))
    tt = TR.merge_tree(ta, states(ta, chunks, torch.from_numpy))
    if name != "KahanAccumulator":
        _check_state(name, jt, tt)
    _check_final(name, ja.finalize(jt), ta.finalize(tt))
    scan = TR.scan_accumulate(ta, torch.from_numpy(x))
    if name in ("LimbAccumulator", "BinAccumulator"):
        _same(ta.finalize(tt), scan)
    elif name == "CascadeAccumulator":
        bound = CASCADE_RTOL * (TR.cascade_weights(len(x), 3).double()
                                @ torch.from_numpy(x).abs().double())
        assert bool(((ta.finalize(tt).double() - scan.double()).abs()
                     <= bound).all())


def test_kahan_on_a_tree_of_tensors():
    """A dict of tensors (one bf16) pushed, merged and finalized; the
    bits of every state match the reference's."""
    rng = np.random.RandomState(2)
    xs = [{"a": rng.randn(5).astype(np.float32),
           "b": (rng.randn(2, 3) * 1e3).astype(np.float32)}
          for _ in range(9)]
    ja, ta = JR.KahanAccumulator(), TR.KahanAccumulator()

    def run(acc, items, conv):
        s = acc.init({k: conv(v) for k, v in items[0].items()})
        for it in items:
            s = acc.push(s, {k: conv(v) for k, v in it.items()})
        return s

    js = ja.merge(run(ja, xs[:4], jnp.asarray), run(ja, xs[4:], jnp.asarray))
    ts = ta.merge(run(ta, xs[:4], torch.from_numpy),
                  run(ta, xs[4:], torch.from_numpy))
    for part in (0, 1):
        for k in ("a", "b"):
            _same(js[part][k], ts[part][k])
    jf, tf = ja.finalize(js), ta.finalize(ts)
    for k in ("a", "b"):
        _close(jf[k], tf[k], KAHAN_RTOL)
        _same(jf[k], tf[k])
    xb = torch.from_numpy(xs[0]["a"]).to(torch.bfloat16)
    st = ta.push(ta.init(xb), xb)
    assert st[0].dtype == torch.float32
    _same(ta.finalize(st), xb.to(torch.float32))


def test_limb_accumulators_at_the_int32_edge():
    """Negative quanta, quanta at +-(2^31 - 128) and -2^31, +-0: Limb and
    Limb3 states bitwise, Limb3's ``ovf`` counting a wrapped hi limb."""
    scale = 2.0 ** 10
    top = np.float32((2.0 ** 31 - 128) / scale)
    x = np.array([[top, -top, -2.0 ** 21, 0.0, -0.0, -1.5 / scale,
                   2.5 / scale]] * 3, np.float32)
    for name in ("LimbAccumulator", "Limb3Accumulator"):
        ja, ta = getattr(JR, name)(scale), getattr(TR, name)(scale)
        js, ts = ja.init(jnp.asarray(x[0])), ta.init(torch.from_numpy(x[0]))
        for row in x:
            js, ts = ja.push(js, jnp.asarray(row)), \
                ta.push(ts, torch.from_numpy(row))
        for _ in range(15):              # hi of 3 * 2^16 doubled: wraps
            js, ts = ja.merge(js, js), ta.merge(ts, ts)
        _check_state(name, js, ts)
        _same(ja.finalize(js), ta.finalize(ts))
    assert int(ts.ovf.max()) > 0


def test_cascade_doctest_values_merge_and_poly():
    """The reference doctest's [111.0, 123.0], one-shot and merged; the
    stages combined by ``cascade_poly_coeffs`` against the port's
    ``op="poly"`` (exact2, blocked) and the float64 oracle, as the
    reference's tests hold its own; merge of a prefix and a suffix within
    CASCADE_RTOL of the one-shot stream at depths 1-4."""
    acc = TR.CascadeAccumulator(2)
    st = acc.init(torch.zeros(()))
    for v in (1.0, 10.0, 100.0):
        st = acc.push(st, torch.tensor(v))
    assert acc.finalize(st).tolist() == [111.0, 123.0]
    a = acc.push(acc.init(torch.zeros(())), torch.tensor(1.0))
    b = acc.init(torch.zeros(()))
    for v in (10.0, 100.0):
        b = acc.push(b, torch.tensor(v))
    assert acc.finalize(acc.merge(a, b)).tolist() == [111.0, 123.0]
    n = 48
    for seed, coeffs in ((0, (1.0,)), (1, (0.0, 1.0)), (0, (2.0, -1.0, 0.5))):
        x = np.random.RandomState(seed).randn(n).astype(np.float32)
        acc = TR.CascadeAccumulator(len(coeffs))
        st = acc.init(torch.zeros(()))
        for v in x:
            st = acc.push(st, torch.tensor(v))
        stages = acc.finalize(st).numpy().astype(np.float64)
        alpha = TR.cascade_poly_coeffs(coeffs, n)
        cascaded = float(sum(al * s for al, s in zip(alpha, stages)))
        direct = float(TR.reduce(torch.from_numpy(x), op="poly",
                                 coeffs=coeffs, policy="exact2",
                                 backend="blocked", device="cpu"))
        i = np.arange(n, dtype=np.float64)
        oracle = float(np.sum(x.astype(np.float64)
                              * sum(c * i ** p for p, c in enumerate(coeffs))))
        tol = 1e-4 * max(1.0, abs(oracle))
        assert abs(direct - oracle) <= tol and abs(cascaded - oracle) <= tol
        assert alpha == JR.cascade_poly_coeffs(coeffs, n)
    x = np.random.RandomState(3).randn(32).astype(np.float32)
    for depth in (1, 2, 3, 4):
        ja, ta = JR.CascadeAccumulator(depth), TR.CascadeAccumulator(depth)

        def run(acc, xs, conv):
            s = acc.init(conv(np.float32(0)))
            for v in xs:
                s = acc.push(s, conv(v))
            return s

        conv_t = lambda v: torch.tensor(v)  # noqa: E731
        whole = ta.finalize(run(ta, x, conv_t))
        merged = ta.merge(run(ta, x[:13], conv_t), run(ta, x[13:], conv_t))
        _close(ta.finalize(merged), whole, CASCADE_RTOL)
        jm = ja.merge(run(ja, x[:13], jnp.asarray), run(ja, x[13:], jnp.asarray))
        _check_final("CascadeAccumulator", ja.finalize(jm),
                     ta.finalize(merged))
        w = TR.cascade_weights(32, depth).numpy().astype(np.float64)
        np.testing.assert_allclose(whole.numpy(), w @ x.astype(np.float64),
                                   rtol=1e-4)


def test_exports_under_the_reference_names():
    """The accumulators from ``repro_torch.reduce`` (callable module
    attributes and ``__all__``) and the limb numerics and ``segment_mean``
    from ``repro_torch.core``, under the reference's names; each is an
    ``Accumulator``."""
    for name in NAMES:
        assert name in TR.__all__ and name in JR.__all__
        x = _stream(4)
        assert isinstance(_pair(name, x)[1], TR.Accumulator)
    for name in ("intac_sum", "limb3_finalize", "limb3_init", "limb_add",
                 "limb_add3", "limb_finalize", "limb_init", "limb_merge",
                 "limb_merge3", "limb_split3", "limbs_canonical",
                 "limbs_resolve3", "segment_mean", "segment_sum_ref",
                 "segments_from_lengths", "juggler_push",
                 "pairwise_tree_sum"):
        assert callable(getattr(TC, name)), name
    assert TR.BinAccumulator.merge_is_add
    assert TI.BIN_MAX_TERMS == 1 << 22
