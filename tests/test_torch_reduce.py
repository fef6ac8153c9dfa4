"""The whole slice: ``repro_torch.reduce(..., device="cpu")`` against
``repro.reduce(...)`` on the same numpy inputs.

* integer tiers (exact, exact2, procrastinate): bitwise, across the
  op x policy matrix of ``tests/test_algebra_matrix.py``;
* float tiers (fast, compensated): within the sum of the two schedules'
  error bounds, (B + nb + log2(B) + lanes + 2) * 2^-24 * sum|x| per cell
  of every summed statistic, carried through the op's ``post``;
* the port's ``ref`` and ``blocked`` executors: bitwise, every tier;
* exact2's <= 1 ulp bound on the adversarial streams of
  ``tests/test_exact_residual.py``, at a CPU-sized N;
* status flags, ``on_overflow="degrade"``, sentinel rows carrying NaN;
* carries moved between the packages through ``interop``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.reduce import interop  # noqa: E402

POLICIES = ("fast", "compensated", "exact", "exact2", "procrastinate")
INT_POLICIES = ("exact", "exact2", "procrastinate")
OPS = ("sum", "mean", "weighted_sum", "sumsq", "moments", "poly")
U = 2.0 ** -24


def _data(n=420, d=6, s=5, seed=0):
    rng = np.random.RandomState(seed)
    vals = rng.randn(n, d).astype(np.float32)
    ids = rng.randint(-1, s, n)
    w = rng.uniform(-2, 2, n).astype(np.float32)
    return vals, ids, w


def _kwargs(op, w, conv):
    if op == "weighted_sum":
        return {"weights": conv(w)}
    if op == "poly":
        return {"coeffs": (1.0, 0.5, -0.25)}
    return {}


def _both(vals, ids, s, **kw):
    """The same reduction through both packages, as numpy arrays."""
    w = kw.pop("w", None)
    op = kw.get("op", "sum")
    jkw = dict(kw, **_kwargs(op, w, jnp.asarray))
    tkw = dict(kw, **_kwargs(op, w, torch.tensor))
    jseg = {} if ids is None else {"segment_ids": jnp.asarray(ids),
                                   "num_segments": s}
    tseg = {} if ids is None else {"segment_ids": torch.tensor(ids),
                                   "num_segments": s}
    tb = tkw.pop("backend", None)
    want = np.asarray(repro.reduce(jnp.asarray(vals), backend="blocked",
                                   **jseg, **jkw))
    got = repro_torch.reduce(torch.tensor(vals), device="cpu", backend=tb,
                             **tseg, **tkw).numpy()
    return want, got


def _float_tolerance(op, vals, ids, w, s, block):
    """Per-cell bound on |port - reference| for the float tiers."""
    v = vals.astype(np.float64)
    n = len(v)
    if op == "weighted_sum":
        v = v * w.astype(np.float64)[:, None]
    elif op == "sumsq":
        v = v * v
    elif op == "poly":
        t = np.arange(n, dtype=np.float64)
        v = v * (1.0 + 0.5 * t - 0.25 * t * t)[:, None]
    if op == "moments":
        v = np.concatenate([v, v * v], 1)
    keep = (ids >= 0) & (ids < s)
    absum = np.zeros((s, v.shape[1]))
    np.add.at(absum, ids[keep], np.abs(v[keep]))
    cnt = np.maximum(np.bincount(ids[keep], minlength=s), 1)[:, None]
    nb = -(-n // block)
    tol = (block + nb + np.log2(block) + 4 + 2) * U * absum \
        + 4 * U * absum                 # + rounding of op-transformed rows
    if op == "mean":
        return tol / cnt + U * absum / cnt
    if op == "moments":
        d = vals.shape[1]
        e1, e2 = tol[:, :d] / cnt, tol[:, d:] / cnt
        m1 = absum[:, :d] / cnt
        ev = e2 + 2 * m1 * e1 + e1 * e1 + 4 * U * (absum[:, d:] / cnt)
        return np.stack([e1 + U * m1, ev], 1)
    return tol


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("op", OPS)
def test_op_policy_matrix_against_reference(op, policy):
    vals, ids, w = _data()
    want, got = _both(vals, ids, 5, op=op, policy=policy, block_size=64, w=w)
    assert want.shape == got.shape and got.dtype == np.float32
    if policy in INT_POLICIES:
        assert np.array_equal(want, got), (op, policy)
    else:
        tol = _float_tolerance(op, vals, ids, w, 5, 64)
        assert (np.abs(want.astype(np.float64) - got) <= tol).all()


@pytest.mark.parametrize("policy", POLICIES)
def test_ref_and_blocked_bitwise(policy):
    vals, ids, w = _data(n=700, d=3, s=40, seed=1)
    for contrib in ("dot", "lanes"):
        outs = [repro_torch.reduce(torch.tensor(vals),
                                   segment_ids=torch.tensor(ids),
                                   num_segments=40, policy=policy,
                                   backend=b, block_size=128,
                                   contrib=contrib, device="cpu")
                for b in ("ref", "blocked")]
        assert torch.equal(outs[0], outs[1]), (policy, contrib)


@pytest.mark.parametrize("policy", INT_POLICIES)
def test_integer_tiers_bitwise_across_block_sizes(policy):
    vals, ids, w = _data(n=900, d=4, s=40, seed=2)
    outs = [repro_torch.reduce(torch.tensor(vals),
                               segment_ids=torch.tensor(ids),
                               num_segments=40, policy=policy,
                               block_size=bs, device="cpu")
            for bs in (32, 128, 512)]
    for o in outs[1:]:
        assert torch.equal(outs[0], o)


def test_whole_stream_and_1d_shapes_match():
    vals, _, _ = _data(n=300, d=3)
    for policy in POLICIES:
        want, got = _both(vals[:, 0], None, None, policy=policy)
        assert got.shape == () and want.shape == ()
        want, got = _both(vals, None, None, policy=policy, op="moments")
        assert got.shape == (2, 3) and want.shape == (2, 3)
        if policy in INT_POLICIES:
            assert np.array_equal(want, got)


N_ADV = 1 << 14


def third_stream(n=N_ADV):
    rng = np.random.RandomState(7)
    return (1 / 3 + rng.randn(n) * 1e-9).astype(np.float32)


def cancellation_stream(n=N_ADV):
    rng = np.random.RandomState(11)
    big = rng.uniform(100.0, 1000.0, n // 2).astype(np.float32)
    x = np.empty(n, np.float32)
    x[0::4] = big[0::2]
    x[1::4] = -big[0::2]
    x[2::4] = big[1::2] + np.float32(1 / 3)
    x[3::4] = -big[1::2]
    return x


@pytest.mark.parametrize("stream", [third_stream, cancellation_stream])
def test_exact2_within_one_ulp_on_adversarial_streams(stream):
    x = stream()
    truth = float(np.sum(x.astype(np.float64)))
    ulp = float(np.spacing(np.abs(np.float32(truth))))
    got = [float(repro_torch.reduce(torch.tensor(x), policy="exact2",
                                    block_size=bs, device="cpu"))
           for bs in (128, 512)]
    want = float(repro.reduce(jnp.asarray(x), policy="exact2",
                              backend="blocked"))
    assert got[0] == got[1] == want
    assert abs(got[0] - truth) <= ulp


def test_status_flags_and_nan_in_sentinel_rows():
    vals, ids, _ = _data(n=500, d=3, s=4, seed=3)
    dirty = vals.copy()
    dirty[ids == -1] = np.nan
    for policy in POLICIES:
        clean = repro_torch.reduce(torch.tensor(vals),
                                   segment_ids=torch.tensor(ids),
                                   num_segments=4, policy=policy,
                                   device="cpu")
        out, st = repro_torch.reduce(torch.tensor(dirty),
                                     segment_ids=torch.tensor(ids),
                                     num_segments=4, policy=policy,
                                     with_status=True, device="cpu")
        _, jst = repro.reduce(jnp.asarray(dirty),
                              segment_ids=jnp.asarray(ids),
                              num_segments=4, policy=policy,
                              backend="blocked", with_status=True)
        assert torch.equal(out, clean)
        assert not bool(st.nonfinite) and not bool(st.saturated)
        assert not bool(st.degraded)
        assert int(st.kept_rows) == int(jst.kept_rows) == (ids >= 0).sum()
        kept_nan = vals.copy()
        kept_nan[np.argmax(ids >= 0), 0] = np.nan
        _, st = repro_torch.reduce(torch.tensor(kept_nan),
                                   segment_ids=torch.tensor(ids),
                                   num_segments=4, policy=policy,
                                   with_status=True, device="cpu")
        _, jst = repro.reduce(jnp.asarray(kept_nan),
                              segment_ids=jnp.asarray(ids),
                              num_segments=4, policy=policy,
                              backend="blocked", with_status=True)
        assert bool(st.nonfinite) and bool(jst.nonfinite)


def test_degrade_chunks_over_bound_streams_like_the_reference():
    """exact2 at block_size=2 admits 2^15 blocks = 65,536 rows: a longer
    stream raises by default and is chunked under "degrade"."""
    rng = np.random.RandomState(4)
    n = (1 << 16) + 300
    vals = rng.randn(n, 2).astype(np.float32)
    ids = rng.randint(-1, 3, n)
    kw = dict(segment_ids=torch.tensor(ids), num_segments=3,
              policy="exact2", block_size=2, device="cpu")
    with pytest.raises(ValueError, match="schedule blocks"):
        repro_torch.reduce(torch.tensor(vals), **kw)
    out, st = repro_torch.reduce(torch.tensor(vals), with_status=True,
                                 on_overflow="degrade", **kw)
    want, jst = repro.reduce(jnp.asarray(vals), segment_ids=jnp.asarray(ids),
                             num_segments=3, policy="exact2", block_size=2,
                             backend="blocked", with_status=True,
                             on_overflow="degrade")
    assert bool(st.degraded) and bool(jst.degraded)
    assert not bool(st.saturated)
    assert int(st.kept_rows) == int(jst.kept_rows)
    assert np.array_equal(np.asarray(want), out.numpy())


@pytest.mark.parametrize("policy", POLICIES)
def test_interop_round_trip_stage_by_stage(policy):
    """A carry folded by one package finalizes in the other, and a
    reference carry of the first half of the stream keeps folding in the
    port: integer tiers to the bit."""
    from repro.reduce import get_backend as j_backend
    from repro.reduce import get_policy as j_policy
    from repro_torch.reduce import get_backend as t_backend
    from repro_torch.reduce import get_policy as t_policy
    vals, ids, _ = _data(n=512, d=3, s=4, seed=5)
    jp, tp = j_policy(policy), t_policy(policy)
    dom, ctx = jp.prepare(jnp.asarray(vals), 512)
    jcarry = j_backend("blocked").run(dom, jnp.asarray(ids), 4, policy=jp,
                                      block_size=64)
    carry, tctx = interop.carry_from_reference(
        policy, [np.asarray(c) for c in jcarry],
        None if ctx is None else np.asarray(ctx))
    assert np.array_equal(np.asarray(jp.finalize(jcarry, ctx)),
                          tp.finalize(carry, tctx).numpy())
    # the port's own carry finalizes in the reference
    tdom = torch.tensor(np.asarray(dom))
    tcarry = t_backend("blocked").run(tdom, torch.tensor(ids), 4, policy=tp,
                                      block_size=64)
    back, bctx = interop.carry_to_numpy(tcarry, tctx)
    fin = np.asarray(jp.finalize(tuple(jnp.asarray(c) for c in back),
                                 None if bctx is None else jnp.asarray(bctx)))
    assert np.array_equal(fin, tp.finalize(tcarry, tctx).numpy())
    if policy in INT_POLICIES:
        for a, b in zip(jcarry, tcarry):
            assert np.array_equal(np.asarray(a), b.numpy())
        # half in the reference, the rest in the port
        half = j_backend("blocked").run(dom[:256], jnp.asarray(ids[:256]), 4,
                                        policy=jp, block_size=64)
        rest = t_backend("blocked").run(tdom[256:], torch.tensor(ids[256:]),
                                        4, policy=tp, block_size=64)
        c0, _ = interop.carry_from_reference(
            policy, [np.asarray(c) for c in half])
        # every integer carry component merges by int32 addition
        for a, b in zip((x + y for x, y in zip(c0, rest)), tcarry):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="carries"):
        interop.carry_from_reference(policy, [np.zeros((4, 3), np.int32)] * 5)


def test_front_door_validation():
    x = torch.ones(4)
    with pytest.raises(ValueError, match="weighted_sum"):
        repro_torch.reduce(x, op="median", device="cpu")
    with pytest.raises(ValueError, match="weights"):
        repro_torch.reduce(x, op="weighted_sum", device="cpu")
    with pytest.raises(ValueError, match="coeffs"):
        repro_torch.reduce(x, op="poly", device="cpu")
    with pytest.raises(ValueError, match="num_segments"):
        repro_torch.reduce(x, segment_ids=torch.zeros(4, dtype=torch.int32),
                           device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        repro_torch.reduce(x, backend="cuda", device="cpu")
    with pytest.raises(ValueError, match="block"):
        repro_torch.reduce(x, policy="exact2", block_size=1024,
                           device="cpu")
    assert repro_torch.reduce.get_backend("blocked").supports(
        repro_torch.reduce.get_policy("exact2"))
