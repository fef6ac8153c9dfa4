"""Kept NaN and +-Inf rows: the port against the reference.

* Integer tiers (exact, exact2, procrastinate): bitwise on ``ref`` and
  ``blocked``, with equal ``saturated`` and ``nonfinite`` flags.  The
  reference casts every digit plane to int32 (NaN -> 0, saturating), so
  a kept NaN row adds nothing to its segment; exact2's residual planes
  take the same cast in the port.
* ``intac_accum``'s plain version against the Pallas kernel in
  interpret mode on +-Inf and NaN: each limb saturates (NaN -> 0), and
  the int32 column sum wraps.
* Float tiers (fast, compensated): a pinned deviation.  The reference's
  one-hot ``dot`` form multiplies 0 by the NaN, so one nonfinite row
  spreads over every segment of its column; its ``contrib="lanes"`` form
  keeps it in its own segment, and so does the port in both forms.  The
  port's nonfinite cells equal the reference's lane-form cells.
* Decode attention (F5, a pinned deviation): K2 and its plain version
  skip a split of ``SPLIT_ROWS`` rows whose every row is masked, so a
  +-Inf in a masked V row there never meets its zero weight; the
  reference multiplies every row by its weight (0 * Inf = NaN).  In a
  live split the masked row is read, and both give NaN.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.kernels import ops as R  # noqa: E402
from repro.kernels.intac_accum import intac_accum_pallas  # noqa: E402
from repro_torch.kernels import ops as T  # noqa: E402
from repro_torch.kernels.intac_accum import intac_accum_torch  # noqa: E402

INT_POLICIES = ("exact", "exact2", "procrastinate")


def _bits(x):
    """f32 bit patterns, every NaN mapped to one pattern (the payload is
    not part of either package's contract)."""
    x = np.asarray(x, np.float32)
    return np.where(np.isnan(x), np.float32(np.nan), x).view(np.uint32)


def _pair(vals, ids, s, policy, backend, **kw):
    got, st = repro_torch.reduce(torch.tensor(vals),
                                 segment_ids=torch.tensor(ids),
                                 num_segments=s, policy=policy,
                                 backend=backend, with_status=True,
                                 device="cpu", **kw)
    want, jst = repro.reduce(jnp.asarray(vals), segment_ids=jnp.asarray(ids),
                             num_segments=s, policy=policy, backend=backend,
                             with_status=True, **kw)
    return got.numpy(), st, np.asarray(want), jst


@pytest.mark.parametrize("backend", ("ref", "blocked"))
@pytest.mark.parametrize("policy", INT_POLICIES)
def test_kept_nan_row_two_segments(policy, backend):
    """Values [1, NaN | 2, 3] in two segments give [1, 5], not saturated,
    nonfinite, on both packages (exact2 gave -1.6647159e7 before its
    residual planes were cast)."""
    vals = np.asarray([[1.0], [np.nan], [2.0], [3.0]], np.float32)
    ids = np.asarray([0, 0, 1, 1], np.int32)
    got, st, want, jst = _pair(vals, ids, 2, policy, backend)
    assert got.ravel().tolist() == [1.0, 5.0]
    assert np.array_equal(_bits(got), _bits(want))
    assert not bool(st.saturated) and not bool(jst.saturated)
    assert bool(st.nonfinite) and bool(jst.nonfinite)


@pytest.mark.parametrize("backend", ("ref", "blocked"))
@pytest.mark.parametrize("policy", INT_POLICIES)
@pytest.mark.parametrize("bad", ("nan", "+inf", "-inf", "mixed"))
def test_kept_nonfinite_rows_bitwise_reference(policy, backend, bad):
    rng = np.random.RandomState(31)
    n, d, s = 300, 4, 5
    vals = rng.randn(n, d).astype(np.float32)
    ids = rng.randint(-1, s, n).astype(np.int32)
    kept = np.flatnonzero(ids >= 0)
    fill = {"nan": [np.nan], "+inf": [np.inf], "-inf": [-np.inf],
            "mixed": [np.nan, np.inf, -np.inf]}[bad]
    for i, (row, col) in enumerate(((kept[3], 1), (kept[40], 2),
                                    (kept[41], 0))):
        vals[row, col] = fill[i % len(fill)]
    got, st, want, jst = _pair(vals, ids, s, policy, backend)
    assert np.array_equal(_bits(got), _bits(want)), (policy, backend, bad)
    assert bool(st.saturated) == bool(jst.saturated)
    assert bool(st.nonfinite) == bool(jst.nonfinite) is True


@pytest.mark.parametrize("scale", (2.0 ** 10, 2.0 ** 20))
def test_intac_accum_plain_saturates_like_the_reference(scale):
    """+Inf adds INT32_MAX to the hi limb and -Inf INT32_MIN, NaN and
    both lo limbs (Inf - Inf) add 0; the column sums wrap in int32."""
    rng = np.random.RandomState(5)
    x = rng.randn(256, 8).astype(np.float32)
    x[:3, 0] = np.inf
    x[5:7, 1] = -np.inf
    x[9, 2] = np.nan
    x[10, 3], x[11, 3] = np.inf, -np.inf
    want = np.asarray(intac_accum_pallas(jnp.asarray(x), jnp.float32(scale),
                                         interpret=True))
    got = intac_accum_torch(torch.tensor(x), scale)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(
        T.intac_accum(torch.tensor(x), scale, device="cpu").numpy(), want)


@pytest.mark.parametrize("contrib", ("dot", "lanes"))
@pytest.mark.parametrize("policy", ("fast", "compensated"))
def test_float_tier_nonfinite_cells_pin_the_lane_form(policy, contrib):
    """F4: the port keeps a NaN or Inf row in its own segment in both
    forms; that is the reference's lane form, not its dot form, where
    0 * NaN = NaN spreads the value over the whole column."""
    rng = np.random.RandomState(3)
    n, d, s = 5000, 3, 11
    vals = rng.randn(n, d).astype(np.float32)
    ids = np.sort(rng.randint(0, s, n)).astype(np.int32)
    vals[7, 1] = np.nan
    vals[600, 2] = np.inf
    got = repro_torch.reduce(torch.tensor(vals),
                             segment_ids=torch.tensor(ids), num_segments=s,
                             policy=policy, contrib=contrib,
                             device="cpu").numpy()
    lanes = np.asarray(repro.reduce(
        jnp.asarray(vals), segment_ids=jnp.asarray(ids), num_segments=s,
        policy=policy, backend="blocked", contrib="lanes"))
    dot = np.asarray(repro.reduce(
        jnp.asarray(vals), segment_ids=jnp.asarray(ids), num_segments=s,
        policy=policy, backend="blocked", contrib="dot"))
    bad = ~np.isfinite(got)
    assert np.array_equal(bad, ~np.isfinite(lanes))
    assert bad.sum() == 2 and bad[ids[7], 1] and bad[ids[600], 2]
    assert (~np.isfinite(dot)).sum() > bad.sum()       # the spread
    assert np.array_equal(np.isnan(got), np.isnan(lanes))


@pytest.mark.parametrize("bad", [np.inf, -np.inf])
@pytest.mark.parametrize("where", ["dead split", "live split"])
def test_decode_masked_nonfinite_v_row_f5_pinned(where, bad):
    """B=1, H=2, K=1, d=8, S=4,096, kv_len=100: splits of 1,024 rows, only
    the first live.  A nonfinite V row past kv_len in a dead split (rows
    3,000 on): the reference gives NaN, the port the finite attention of
    the live rows, equal to the same input without the bad rows.  In the
    live split (row 500): both give NaN."""
    from repro_torch.kernels.flash_decode import SPLIT_ROWS
    assert SPLIT_ROWS == 1024
    rng = np.random.default_rng(12)
    q = rng.standard_normal((1, 2, 8)).astype(np.float32)
    k = rng.standard_normal((1, 4096, 1, 8)).astype(np.float32)
    v = rng.standard_normal((1, 4096, 1, 8)).astype(np.float32)
    clean = v.copy()
    rows = slice(3000, None) if where == "dead split" else slice(500, 501)
    v[:, rows] = bad
    kv_len = np.array([100], np.int32)
    want = np.asarray(R.flash_decode(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_len),
        sm_scale=8 ** -0.5, interpret=True))
    got = T.flash_decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                         torch.tensor(kv_len), sm_scale=8 ** -0.5,
                         device="cpu").numpy()
    assert np.isnan(want).all()
    if where == "dead split":
        assert np.isfinite(got).all()
        assert np.array_equal(got, T.flash_decode(
            torch.tensor(q), torch.tensor(k), torch.tensor(clean),
            torch.tensor(kv_len), sm_scale=8 ** -0.5, device="cpu").numpy())
    else:
        assert np.isnan(got).all()
