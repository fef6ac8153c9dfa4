"""The limb numerics of repro_torch.core.intac and ``segment_mean`` held
bitwise against repro.core.

The same numpy inputs go through both packages: ``intac_sum``, the
two-limb state (``limb_init``/``limb_add``/``limb_merge``/
``limb_finalize``, ``limbs_resolve``) and the three-limb state
(``limb_split3``, ``limb_add3``, ``limb_merge3``, ``limbs_resolve3``,
``limb3_finalize``), with negative quanta, quanta at the edge of the
int32 contract (|x * scale| near 2^31), wrapping limbs and +-0.  Every
scale is a power of two the two packages agree on (the F1 inputs of
``choose_scale`` are pinned in ``test_torch_intac.py``), and no value or
residual falls below 2^-126 (F2, ditto).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import intac as J  # noqa: E402
from repro.core import segmented as JS  # noqa: E402
from repro_torch.core import intac as T  # noqa: E402
from repro_torch.core import segmented as TS  # noqa: E402


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
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), \
        (a[a != b][:5], b[a != b][:5])
    if a.dtype.kind == "f":             # +0 and -0 apart
        assert np.array_equal(np.signbit(a), np.signbit(b))


def _same_state(js, ts):
    assert type(js).__name__ == type(ts).__name__
    for f in js._fields:
        a, b = getattr(js, f), getattr(ts, f)
        assert (a is None) == (b is None), f
        if a is not None:
            _same(a, b)


def _stream(seed, n, d, scale, edge=False):
    """(n, d) f32 rows: both signs, many magnitudes below 2^31 / scale,
    exact zeros of both signs; ``edge`` puts quanta at +-(2^31 - 2^7)
    and values on the grid's ties."""
    rng = np.random.RandomState(seed)
    mag = rng.randint(-12, 6, (n, d)).astype(np.float32)
    x = (rng.randn(n, d) * np.exp2(mag)).astype(np.float32)
    x[0, :2] = (0.0, -0.0)
    if edge:
        top = np.float32((2.0 ** 31 - 2.0 ** 7) / scale)
        x[1, :4] = (top, -top, np.float32(2.0 ** 31 / scale) * -1, 0.5 / scale)
        x[2, :3] = (1.5 / scale, -2.5 / scale, -0.0)
    return x


def test_intac_sum_bitwise():
    rng = np.random.RandomState(0)
    for shape, axis in (((257, 7), 0), ((5, 300), 1), ((1000,), 0)):
        x = (rng.randn(*shape) * np.exp2(rng.randint(-8, 9, shape))
             ).astype(np.float32)
        x.flat[0] = -0.0
        n = shape[axis]
        m = np.float32(np.abs(x).max())
        assert float(J.choose_scale(jnp.asarray(m), n)) == \
            float(T.choose_scale(torch.tensor(m), n))
        _same(J.intac_sum(jnp.asarray(x), axis=axis),
              T.intac_sum(torch.from_numpy(x), axis=axis))


@pytest.mark.parametrize("edge", [False, True])
def test_limb_state_push_merge_finalize_bitwise(edge):
    """Two streams pushed row by row, merged, finalized: every state and
    the result bitwise.  ``edge`` holds quanta at +-(2^31 - 128) and
    -2^31, whose hi limbs reach +-2^16, and ties of the grid."""
    scale = 2.0 ** 20
    x = _stream(1, 40, 9, scale, edge=edge)
    ja, jb = J.limb_init((9,), scale), J.limb_init((9,), scale)
    ta, tb = T.limb_init((9,), scale), T.limb_init((9,), scale)
    _same_state(ja, ta)
    for i, row in enumerate(x):
        if i % 2:
            ja, ta = J.limb_add(ja, jnp.asarray(row)), \
                T.limb_add(ta, torch.from_numpy(row))
        else:
            jb, tb = J.limb_add(jb, jnp.asarray(row)), \
                T.limb_add(tb, torch.from_numpy(row))
        _same_state(ja, ta)
        _same_state(jb, tb)
    jm, tm = J.limb_merge(ja, jb), T.limb_merge(ta, tb)
    _same_state(jm, tm)
    _same(J.limb_finalize(jm), T.limb_finalize(tm))


def test_limbs_resolve_bitwise_on_raw_limbs():
    """Raw limbs as blocked sums leave them: negative hi, lo far above
    2^15, and both near the int32 edge."""
    rng = np.random.RandomState(2)
    hi = rng.randint(-2 ** 31, 2 ** 31 - 2 ** 16, 500).astype(np.int32)
    lo = rng.randint(0, 2 ** 31 - 1, 500).astype(np.int32)
    hi[:4] = (0, -1, 2 ** 31 - 2 ** 16 - 1, -2 ** 31)
    lo[:4] = (0, 2 ** 15, 2 ** 31 - 1, 0)
    for scale in (2.0 ** -3, 1.0, 2.0 ** 24, 2.0 ** 100):
        _same(J.limbs_resolve(jnp.asarray(hi), jnp.asarray(lo), scale),
              T.limbs_resolve(torch.from_numpy(hi), torch.from_numpy(lo),
                              scale))


@pytest.mark.parametrize("scale_exp", [-4, 8, 24])
def test_limb_split3_bitwise(scale_exp):
    """(hi, lo, residual) of values on and off the grid: negative quanta,
    ties (round half to even), +-0, quanta at the int32 edge."""
    scale = 2.0 ** scale_exp
    x = _stream(3, 64, 16, scale, edge=True)
    x = x[np.abs(x) * scale < 2.0 ** 31 - 2.0 ** 7 + 1]
    assert x.size > 900
    for a, b in zip(J.limb_split3(jnp.asarray(x), scale),
                    T.limb_split3(torch.from_numpy(x), scale)):
        _same(a, b)


def test_limb3_push_merge_finalize_bitwise():
    """Three-limb states over three streams, merged in a fixed order:
    limbs, residual pair, ``ovf`` and the finalize bitwise; one stream
    wraps its hi limb so ``ovf`` counts."""
    scale = 2.0 ** 16
    streams = [_stream(s, 24, 11, scale) for s in (4, 5)]
    big = np.full((6, 11), np.float32(2.0 ** 30 / scale), np.float32)
    streams.append(big)
    js, ts = [], []
    for x in streams:
        j, t = J.limb3_init((11,), scale), T.limb3_init((11,), scale)
        for row in x:
            j = J.limb_add3(j, jnp.asarray(row))
            t = T.limb_add3(t, torch.from_numpy(row))
            _same_state(j, t)
        js.append(j)
        ts.append(t)
    assert int(np.asarray(js[2].ovf).max()) == 0
    jm, tm = J.limb_merge3(J.limb_merge3(js[0], js[1]), js[2]), \
        T.limb_merge3(T.limb_merge3(ts[0], ts[1]), ts[2])
    _same_state(jm, tm)
    _same(J.limb3_finalize(jm), T.limb3_finalize(tm))
    # merges that wrap the hi limbs (6 * 2^15 doubled 14 times passes
    # 2^31) count in ovf, on both sides
    jw, tw = js[2], ts[2]
    for _ in range(14):
        jw, tw = J.limb_merge3(jw, jw), T.limb_merge3(tw, tw)
        _same_state(jw, tw)
    assert int(tw.ovf.max()) > 0
    # a state without the guard rail merges with one that has it
    jn = J.Limb3State(*js[0][:5])
    tn = T.Limb3State(*ts[0][:5])
    _same_state(J.limb_merge3(jn, js[1]), T.limb_merge3(tn, ts[1]))
    _same_state(J.limb_merge3(jn, jn), T.limb_merge3(tn, tn))


def test_limbs_resolve3_bitwise():
    rng = np.random.RandomState(6)
    hi = rng.randint(-2 ** 31, 2 ** 31 - 2 ** 16, 300).astype(np.int32)
    lo = rng.randint(0, 2 ** 31 - 1, 300).astype(np.int32)
    res = (rng.randn(300) * 2.0 ** -30).astype(np.float32)
    comp = (rng.randn(300) * 2.0 ** -56).astype(np.float32)
    res[:2] = (0.0, -0.0)
    for scale in (2.0 ** 8, 2.0 ** 30):
        for c in (None, comp):
            _same(J.limbs_resolve3(jnp.asarray(hi), jnp.asarray(lo),
                                   jnp.asarray(res), scale,
                                   comp=None if c is None
                                   else jnp.asarray(c)),
                  T.limbs_resolve3(torch.from_numpy(hi), torch.from_numpy(lo),
                                   torch.from_numpy(res), scale,
                                   comp=None if c is None
                                   else torch.from_numpy(c)))


def test_segment_mean_bitwise():
    """Integer-valued rows (exact sums in any order), sentinel and
    out-of-range labels, an empty segment, a ``valid`` mask, and a
    custom ``impl``: the means bitwise the reference's."""
    rng = np.random.RandomState(7)
    n, s = 200, 9
    v = rng.randint(-50, 50, (n, 3)).astype(np.float32)
    ids = np.sort(rng.randint(0, s, n)).astype(np.int32)
    ids[ids == 4] = 5                       # segment 4 empty
    ids[:3] = (-1, s, s + 7)
    valid = rng.rand(n) > 0.2
    for kw_j, kw_t in (({}, {}),
                       ({"valid": jnp.asarray(valid)},
                        {"valid": torch.from_numpy(valid)})):
        _same(JS.segment_mean(jnp.asarray(v), jnp.asarray(ids), s, **kw_j),
              TS.segment_mean(torch.from_numpy(v), torch.from_numpy(ids), s,
                              **kw_t))
    # 1-D values and an impl of the same contract
    _same(JS.segment_mean(jnp.asarray(v[:, 0]), jnp.asarray(ids), s,
                          impl=lambda a, i, k: JS.segment_sum_ref(a, i, k) * 2),
          TS.segment_mean(torch.from_numpy(v[:, 0]), torch.from_numpy(ids), s,
                          impl=lambda a, i, k: TS.segment_sum_ref(a, i, k) * 2))


@pytest.mark.parametrize("tier", ["exact2", "procrastinate"])
def test_digit_plane_domains_in_column_slices_bitwise_whole(tier,
                                                            monkeypatch):
    """The digit-plane domains are converted in slices of raw columns
    (a bound on their temporaries at a full-width leaf): the sliced
    conversion, ragged last slice and non-finite values included, is
    bitwise the conversion in one piece."""
    from repro_torch.reduce import policy as P
    pol = P.get_policy(tier)
    x = _stream(11, 5, 23, 2.0 ** 20)
    x[3, :3] = (np.nan, np.inf, -np.inf)
    v = torch.from_numpy(x)
    dom, ctx = pol.prepare(v, 5, shared_max=torch.tensor(40.0))
    for elems in (5, 17, 5 * 23 - 1):
        monkeypatch.setattr(P, "_DOMAIN_ELEMS", elems)
        _same(dom, pol.to_domain(v, ctx))
