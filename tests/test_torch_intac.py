"""repro_torch.core.intac against repro.core.intac, elementwise and bitwise.

Inputs come from numpy and go through both packages.  Two deviations are
pinned, not hidden:

* F1 — the reference computes ``choose_scale``'s exponent with f32 logs,
  which are inexact near powers of two; the port computes it exactly.
  Where the two disagree, the reference's scale is either 2x the exact
  one, which breaks its own ``n * max * scale <= 2^qbits`` bound, or half
  of it, which is merely conservative.
* F2 — JAX on the CPU flushes subnormals to zero; the port keeps them.
"""

import math
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import intac as J  # noqa: E402
from repro_torch.core import intac as T  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f"), \
        (a[a != b][:5], b[a != b][:5])


def _same_f2(ref, port, exact):
    """Bitwise where the exact (float64) result is normal or zero; below
    the normal range the reference flushed it to zero while the port
    rounds it as IEEE does (F2)."""
    ref, port = _np(ref), _np(port)
    tiny = (exact != 0) & (np.abs(exact) < 2.0 ** -126)
    assert tiny.sum() < tiny.size
    assert np.array_equal(ref[~tiny], port[~tiny], equal_nan=True)
    assert (ref[tiny] == 0).all()
    assert np.array_equal(port[tiny], exact[tiny].astype(np.float32))


def edge_values(seed=0, lo=-120, hi=120):
    """Powers of two and their f32 neighbours across the normal range,
    halfway ties, zeros and random magnitudes, both signs."""
    rng = np.random.RandomState(seed)
    vals = []
    for k in range(lo, hi):
        p = np.float32(2.0 ** k)
        vals += [p, np.nextafter(p, np.float32(0)),
                 np.nextafter(p, np.float32(np.inf)), p * np.float32(1.5)]
    vals += [0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 0.0, 1.0, 1 / 3]
    vals += list(rng.randn(500) * 10.0 ** rng.randint(-8, 8, 500))
    v = np.asarray(vals, np.float32)
    return np.concatenate([v, -v])


def test_two_sum_bitwise():
    rng = np.random.RandomState(1)
    a = edge_values(1, -60, 60)
    b = (rng.permutation(a) * np.float32(0.75)).astype(np.float32)
    for x, y in zip(J.two_sum(jnp.asarray(a), jnp.asarray(b)),
                    T.two_sum(torch.tensor(a), torch.tensor(b))):
        _same(x, y)


@pytest.mark.parametrize("e_lo,e_hi", [(-100, 100), (-126, 127)])
def test_ldexp2_bitwise_where_results_are_normal(e_lo, e_hi):
    x = edge_values(2, -40, 40)
    rng = np.random.RandomState(3)
    e = rng.randint(e_lo, e_hi, x.size).astype(np.int32)
    want = np.asarray(J._ldexp2(jnp.asarray(x), jnp.asarray(e)))
    got = T._ldexp2(torch.tensor(x), torch.tensor(e)).numpy()
    exact = np.ldexp(x.astype(np.float64), e)
    normal = (np.abs(exact) >= 2.0 ** -126) | (exact == 0)
    assert normal.sum() > x.size // 2
    assert np.array_equal(want[normal], got[normal])
    # below the normal range the port keeps the IEEE subnormal (F2)
    sub = ~normal & (np.abs(exact) >= 2.0 ** -149)
    assert np.array_equal(got[sub], np.ldexp(x[sub], e[sub]))


def test_round_half_even_and_quantize_bitwise():
    x = edge_values(4, -30, 30)
    for scale in (np.float32(1.0), np.float32(2.0 ** 10),
                  np.float32(2.0 ** -3)):
        _same(J.quantize(jnp.asarray(x), scale),
              T.quantize(torch.tensor(x), torch.tensor(scale)))
    ties = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5], np.float32)
    _same(J.quantize(jnp.asarray(ties), np.float32(1.0)),
          T.quantize(torch.tensor(ties), torch.tensor(np.float32(1.0))))


def test_float_to_int32_cast_saturates_like_xla():
    x = np.asarray([np.nan, 3e9, -3e9, np.inf, -np.inf, 2.0 ** 31,
                    -(2.0 ** 31), 12.0], np.float32)
    _same(jnp.asarray(x).astype(jnp.int32), T.to_i32(torch.tensor(x)))


def _exact_exponent(m, n, qbits):
    """floor(qbits - log2(n * max(m, 2^-126))) in exact arithmetic (not
    yet clamped to the f32 exponent range)."""
    t = Fraction(n) * Fraction(float(max(m, np.float32(2.0 ** -126))))
    e = qbits - math.floor(math.log2(n) + math.log2(float(t / n)))
    while _pow2(qbits - e) < t:
        e -= 1
    while _pow2(qbits - e - 1) >= t:
        e += 1
    return e


def _pow2(k):
    return Fraction(2) ** k


@pytest.mark.parametrize("qbits", [21, 30])
def test_choose_scale_f1_pinned(qbits):
    ms = []
    for k in range(-126, 128):
        p = np.float32(2.0 ** k)
        v = p
        for _ in range(3):
            v = np.nextafter(v, np.float32(0))
            ms.append(v)
        v = p
        for _ in range(3):
            ms.append(v)
            v = np.nextafter(v, np.float32(np.inf))
    ms.append(np.float32(16384.0059))
    ms += list(np.random.RandomState(5).uniform(0, 1e6, 100))
    ms = np.unique(np.asarray(ms, np.float32))
    ms = ms[(ms >= 2.0 ** -126) & np.isfinite(ms)]        # normals only
    ns = (1, 3, 512, 1000, 1 << 20, (1 << 20) + 1, 1 << 24)
    matched = high = low = 0
    for n in ns:
        ref = np.asarray(J.choose_scale(jnp.asarray(ms), n, qbits=qbits))
        got = T.choose_scale(torch.tensor(ms), n, qbits=qbits).numpy()
        e_ref = np.frexp(ref)[1] - 1
        e_got = np.frexp(got)[1] - 1
        for m, er, eg in zip(ms, e_ref, e_got):
            raw = _exact_exponent(m, n, qbits)
            ex = int(np.clip(raw, -126, 127))
            assert eg == ex, (m, n)                  # the port is exact
            over = (Fraction(n) * Fraction(float(m)) * _pow2(int(er))
                    > _pow2(qbits)) and -126 <= raw <= 127
            if er == eg:
                matched += 1
                assert not over
            elif er == eg + 1:
                high += 1
                assert over, (m, n)    # 2x the exact scale: bound broken
            else:
                low += 1
                assert er == eg - 1, (m, n, er, eg)
                assert not over        # half the exact scale: conservative
            # and every input where the reference breaks its bound is a
            # mismatch: the set of 2x cases IS the set of violations
            assert over == (er == eg + 1)
    assert high > 0 and matched > high
    # the issue's example: N=1, max_abs=16384.0059 -> 2^16 vs exact 2^15
    m = np.float32(16384.0059)
    assert float(J.choose_scale(jnp.asarray(m), 1)) == 2.0 ** 16
    assert float(T.choose_scale(torch.tensor(m), 1)) == 2.0 ** 15


def test_choose_scale_degenerate_inputs_match():
    for m in (0.0, np.nan, np.inf, 1.0, 3.0):
        x = np.float32(m)
        for n in (1, 7):
            _same(np.asarray(J.choose_scale(jnp.asarray(x), n)),
                  T.choose_scale(torch.tensor(x), n).numpy())


def test_wrap_add_bitwise_with_predicate():
    rng = np.random.RandomState(6)
    edge = np.asarray([2 ** 31 - 1, -2 ** 31, 0, 1, -1, 2 ** 30, -2 ** 30],
                      np.int64)
    a = np.concatenate([edge, rng.randint(-2 ** 31, 2 ** 31 - 1, 300)])
    b = np.concatenate([edge[::-1], rng.randint(-2 ** 31, 2 ** 31 - 1, 300)])
    a, b = a.astype(np.int32), b.astype(np.int32)
    for x, y in zip(J.wrap_add(jnp.asarray(a), jnp.asarray(b)),
                    T.wrap_add(torch.tensor(a), torch.tensor(b))):
        _same(x, y)


def test_descale_and_dequantize_bitwise():
    x = edge_values(7, -20, 20)
    q = np.random.RandomState(8).randint(-2 ** 30, 2 ** 30, 400) \
        .astype(np.int32)
    for e in (-126, -64, -3, 0, 5, 64, 127):
        s = np.float32(2.0 ** e)
        _same_f2(J.descale(jnp.asarray(x), s),
                 T.descale(torch.tensor(x), torch.tensor(s)),
                 np.ldexp(x.astype(np.float64), -e))
        _same_f2(J.dequantize(jnp.asarray(q), s),
                 T.dequantize(torch.tensor(q), torch.tensor(s)),
                 np.ldexp(q.astype(np.float32).astype(np.float64), -e))
    s = np.float32(3.0)                       # not a power of two: divide
    _same(J.descale(jnp.asarray(x), s),
          T.descale(torch.tensor(x), torch.tensor(s)))


def test_limb_split_and_canonical_bitwise():
    rng = np.random.RandomState(9)
    q = np.concatenate([np.asarray([-1, -32768, -32769, 32767, 32768,
                                    2 ** 31 - 1, -2 ** 31], np.int64),
                        rng.randint(-2 ** 31, 2 ** 31 - 1, 400)]) \
        .astype(np.int32)
    for x, y in zip(J.limb_split(jnp.asarray(q)),
                    T.limb_split(torch.tensor(q))):
        _same(x, y)
    lo = rng.randint(-2 ** 20, 2 ** 20, q.size).astype(np.int32)
    hi = (q >> 4).astype(np.int32)
    for x, y in zip(J.limbs_canonical(jnp.asarray(hi), jnp.asarray(lo)),
                    T.limbs_canonical(torch.tensor(hi), torch.tensor(lo))):
        _same(x, y)


def test_bin_ref_exponent_and_split_bitwise():
    x = edge_values(10, -60, 60)
    m = np.abs(x)
    _same(J.bin_ref_exponent(jnp.asarray(m)),
          T.bin_ref_exponent(torch.tensor(m)))
    e_ref = np.int32(int(np.frexp(np.abs(x).max())[1]))
    _same(J.bin_split(jnp.asarray(x), e_ref),
          T.bin_split(torch.tensor(x), torch.tensor(e_ref)))
    r = (np.random.RandomState(11).uniform(-0.5, 0.5, 500)) \
        .astype(np.float32)
    _same(J.bin_split(jnp.asarray(r), 0, bits=J.RES_BIN_BITS,
                      num=J.RES_NUM_BINS),
          T.bin_split(torch.tensor(r), 0, bits=T.RES_BIN_BITS,
                      num=T.RES_NUM_BINS))


def test_bin_carry_resolve_and_combine_bitwise():
    rng = np.random.RandomState(12)
    bins = rng.randint(-2 ** 24, 2 ** 24, (6, 300)).astype(np.int32)
    for x, y in zip(J._bin_carry_resolve(jnp.asarray(bins), 8),
                    T._bin_carry_resolve(torch.tensor(bins), 8)):
        _same(x, y)
    for e in (-100, 0, 7, 120):
        _same(J.bin_combine(jnp.asarray(bins), e),
              T.bin_combine(torch.tensor(bins), e))


def test_limbs_resolve3_binned_bitwise():
    rng = np.random.RandomState(13)
    hi = rng.randint(-2 ** 28, 2 ** 28, 300).astype(np.int32)
    lo = rng.randint(0, 2 ** 24, 300).astype(np.int32)
    rb = rng.randint(-2 ** 20, 2 ** 20, (7, 300)).astype(np.int32)
    for e in (-20, 0, 21, 100):
        s = np.float32(2.0 ** e)
        _same(J.limbs_resolve3_binned(jnp.asarray(hi), jnp.asarray(lo),
                                      jnp.asarray(rb), s),
              T.limbs_resolve3_binned(torch.tensor(hi), torch.tensor(lo),
                                      torch.tensor(rb), torch.tensor(s)))


def test_constants_match():
    for name in ("LIMB_SHIFT", "BIN_BITS", "NUM_BINS", "BIN_MAX_TERMS",
                 "RES_BIN_BITS", "RES_NUM_BINS"):
        assert getattr(J, name) == getattr(T, name), name


@pytest.mark.parametrize("policy", ["exact2", "procrastinate"])
def test_subnormal_stream_f2_pinned(policy):
    """F2, either way pinned: the reference flushes a stream of subnormal
    values to an exact 0; the port keeps them and lands within 1 ulp of
    the float64 sum."""
    rng = np.random.RandomState(14)
    x = (rng.uniform(0.1, 1.0, 256) * 2.0 ** -130).astype(np.float32)
    assert (np.abs(x) < 2.0 ** -126).all() and (x != 0).all()
    want = float(repro.reduce(jnp.asarray(x), policy=policy,
                              backend="blocked"))
    got = float(repro_torch.reduce(torch.tensor(x), policy=policy,
                                   device="cpu"))
    truth = float(np.sum(x.astype(np.float64)))
    assert want == 0.0                               # flushed
    ulp = float(np.spacing(np.float32(truth)))
    assert got != 0.0 and abs(got - truth) <= ulp     # kept
