"""The port's collectives across the ranks of a gloo process group, held
against the reference's named-axis functions.

Groups of 1, 2 and 4 ranks run ``tests/torch_dist_workers.py`` (fresh
interpreters, one torch thread each, a ``file://`` store under the test's
temporary directory), each rank on its share of inputs drawn from a seed
with numpy.  The reference runs in this process under
``jax.vmap(fn, axis_name="data")`` over the same per-rank inputs, where
its ``psum``/``pmax``/``all_gather`` act across the mapped axis as
across devices: no ``shard_map``.  Bitwise: ``comm``, the INTAC
collectives, the integer tiers of every collective mean, compensated's
mean and residual (its payload is an integer psum), the integer carries
and the sharded ``reduce`` of the integer tiers.  The fast tier folds the
ranks in a pinned pairwise tree where the reference takes a float psum:
within ``FAST_RTOL`` of the summed magnitudes.
"""

import concurrent.futures
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.reduce as JR  # noqa: E402
from repro.core import intac as RI  # noqa: E402
from repro.reduce import collective as RCOL  # noqa: E402

import repro_torch  # noqa: E402
from repro_torch.distributed import comm, spawn  # noqa: E402
from repro_torch.reduce import get_policy  # noqa: E402

import torch_dist_workers as WK  # noqa: E402

TESTS = str(Path(__file__).resolve().parent)
WORLDS = (1, 2, 4)
TIERS = WK.TIERS
INT_TIERS = ("exact", "exact2", "procrastinate")
BITWISE = INT_TIERS + ("compensated",)
#: fast: the ranks' float32 sum in another order than the reference's
#: psum, each partial rounding at most 2^-24 of the running magnitude
FAST_RTOL = 2.0 ** -21
#: fast and compensated ``reduce``: K1's pinned block trees against the
#: reference's one-hot dots and a rank-order carry merge
FLOAT_REDUCE_RTOL = 2.0 ** -18
KAHAN_RTOL = 2.0 ** -22
NSEG, BLOCK, N, D = 7, 128, 3000, 4
SCALE = 2.0 ** 20


def _inputs():
    rng = np.random.default_rng(20)
    w = max(WORLDS)
    ids = rng.integers(0, NSEG, N).astype(np.int32)
    ids[rng.random(N) < 0.05] = -1
    return dict(
        x=(rng.standard_normal((w, 6, 5))
           * np.exp2(rng.integers(-8, 8, (w, 6, 5)))).astype(np.float32),
        res=(rng.standard_normal((w, 6, 5)) * 1e-3).astype(np.float32),
        ints=rng.integers(-2 ** 31, 2 ** 31 - 1, (w, 3)).astype(np.int32),
        w=rng.random((w, 6, 5)).astype(np.float32),
        stream=(rng.standard_normal((N, D))
                * np.exp2(rng.integers(-6, 6, (N, 1)))).astype(np.float32),
        ids=ids, nseg=NSEG, block=BLOCK,
        items=rng.standard_normal((8, 3, 4)).astype(np.float32),
        acc_x=rng.standard_normal((w, 5, 6)).astype(np.float32))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{W: [rank outputs]} for W = 1, 2, 4, the three groups at once."""
    kw = _inputs()
    root = tmp_path_factory.mktemp("collective")
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        futs = {w: pool.submit(spawn.run_ranks,
                               "torch_dist_workers:collectives", w,
                               workdir=root / f"w{w}", kwargs=kw,
                               paths=[TESTS], threads=1, timeout=240)
                for w in WORLDS}
        return kw, {w: f.result() for w, f in futs.items()}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a, b, equal_nan=True), (a, b)


def _close(a, b, atol):
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    assert a.shape == b.shape
    assert np.all(np.abs(a - b) <= atol), float(np.max(np.abs(a - b) - atol))


def _vmap(fn, *args, jit=False):
    """The reference's ``fn`` run as W devices of a 'data' axis -> its
    first device's result (the others' are checked equal); ``jit``
    compiles the mapped function whole (one compile in place of many
    eager dispatches, where XLA's fusion keeps the bits)."""
    mapped = jax.vmap(fn, axis_name="data")
    out = (jax.jit(mapped) if jit else mapped)(
        *(jnp.asarray(a) for a in args))
    leaves = jax.tree.leaves(out)
    for leaf in leaves:
        assert all(np.array_equal(np.asarray(leaf[0]), np.asarray(leaf[k]),
                                  equal_nan=True)
                   for k in range(leaf.shape[0]))
    return jax.tree.map(lambda v: np.asarray(v[0]), out)


def _replicated(outs, key, part=None):
    """Every rank returned the same ``key`` (its element ``part``, where a
    rank also returns a state of its own); -> rank 0's."""
    def pick(o):
        return o[key] if part is None else o[key][part]
    first = pick(outs[0])
    for o in outs[1:]:
        for a, b in zip(jax.tree.leaves(first), jax.tree.leaves(pick(o))):
            _same(a, b)
    return first


@pytest.mark.parametrize("w", WORLDS)
def test_comm_matches_the_named_axis_collectives(runs, w):
    """psum (int32, wrapping), pmax, all_gather in rank order, a NaN
    through pmax, rank and size; every rank holds the same result."""
    kw, all_outs = runs
    outs = all_outs[w]
    assert [o["rank"] for o in outs] == list(range(w))
    assert all(o["world"] == w for o in outs)
    x, ints = kw["x"][:w], kw["ints"][:w]
    _same(_replicated(outs, "psum"),
          _vmap(lambda a: jax.lax.psum(a, "data"), ints))
    _same(_replicated(outs, "pmax"),
          _vmap(lambda a: jax.lax.pmax(jnp.max(jnp.abs(a)), "data"), x))
    _same(_replicated(outs, "all_gather"),
          _vmap(lambda a: jax.lax.all_gather(a, "data"), x))
    assert np.isnan(float(_replicated(outs, "pmax_nan")))


@pytest.mark.parametrize("w", WORLDS)
def test_intac_collectives_bitwise(runs, w):
    """intac_psum, intac_psum2, intac_psum3, bin_psum, limb3_merge_across
    and compressed_psum_mean's mean and residual, bitwise."""
    kw, all_outs = runs
    outs = all_outs[w]
    x, res = kw["x"][:w], kw["res"][:w]
    for name, fn in (("intac_psum", RI.intac_psum),
                     ("intac_psum2", RI.intac_psum2),
                     ("intac_psum3", RI.intac_psum3),
                     ("bin_psum", RI.bin_psum)):
        _same(_replicated(outs, name),
              _vmap(lambda a: fn(a, ("data",)), x, jit=True))
    mean = _vmap(lambda a, r: RI.compressed_psum_mean(
        a, r, ("data",), bits=8)[0], x, res)
    _same(_replicated(outs, "compressed", 0), mean)
    resid = jax.vmap(lambda a, r: RI.compressed_psum_mean(
        a, r, ("data",), bits=8)[1], axis_name="data")(jnp.asarray(x),
                                                    jnp.asarray(res))
    for k, o in enumerate(outs):                # each rank's own residual
        _same(o["compressed"][1], np.asarray(resid[k]))

    def merge(a, r):
        hi, lo, r3 = RI.limb_split3(a, SCALE)
        return RI.limb3_merge_across(hi, lo, r3, r * 2.0 ** -30, ("data",))
    want = _vmap(merge, x, res)
    for got, ref in zip(_replicated(outs, "limb3_merge"), want):
        _same(got, ref)


@pytest.mark.parametrize("w", WORLDS)
def test_collective_means_of_every_tier(runs, w):
    """collective_mean, collective_weighted_mean, collective_moments and
    collective_mean_tree under the five tiers: bitwise for the integer
    tiers and compensated, within FAST_RTOL of the magnitudes for fast."""
    kw, all_outs = runs
    outs = all_outs[w]
    x, res, wt = kw["x"][:w], kw["res"][:w], kw["w"][:w]
    mag = np.abs(x).sum(0).astype(np.float64)
    for p in TIERS:
        def mean(a, r):
            return RCOL.collective_mean(
                a, ("data",), policy=p,
                residual=r if p == "compensated" else None)[0]
        refs = {
            "mean": _vmap(mean, x, res),
            "wmean": _vmap(lambda a, b: RCOL.collective_weighted_mean(
                a, b, ("data",), policy=p), x, wt),
            "moments": _vmap(lambda a: RCOL.collective_moments(
                a, ("data",), policy=p), x),
            "tree": _vmap(lambda a, r: RCOL.collective_mean_tree(
                {"a": a, "b": a[:2] * 3.0},
                {"a": r, "b": r[:2]} if p == "compensated" else None,
                ("data",), policy=p)[0], x, res)}
        got = {"mean": _replicated(outs, f"mean/{p}", 0),
               "wmean": _replicated(outs, f"wmean/{p}"),
               "moments": _replicated(outs, f"moments/{p}"),
               "tree": _replicated(outs, f"tree/{p}", 0)}
        for key in refs:
            g, r = jax.tree.leaves(got[key]), jax.tree.leaves(refs[key])
            assert len(g) == len(r)
            for a, b in zip(g, r):
                if p in BITWISE:
                    _same(a, b)
                elif key == "mean":
                    _close(a, b, FAST_RTOL * mag / w)
                else:                      # fast's other faces: relative
                    _close(a, b, FAST_RTOL * 64 * (np.abs(_np(b)) + 1e-6))


def test_elastic_reduce_mean_is_bitwise_across_world_sizes(runs):
    """elastic_reduce_mean of one 8-item stack split over 1, 2 and 4
    ranks: the integer tiers bitwise the reference's and each other;
    the float tiers within tolerance of the reference."""
    kw, all_outs = runs
    items = kw["items"]
    for p in TIERS:
        first = None
        for w in WORLDS:
            got = _replicated(all_outs[w], f"elastic/{p}")
            ref = _vmap(lambda s: RCOL.elastic_reduce_mean(
                s, ("data",), policy=p, block_size=2),
                items.reshape((w, -1) + items.shape[1:]), jit=True)
            if p in INT_TIERS:
                _same(got, ref)
                if first is not None:
                    _same(got, first)
                first = got
            else:
                _close(got, ref, FAST_RTOL * 16 * np.abs(items).sum(0) / 8)


@pytest.mark.parametrize("w", (2, 4))
def test_sharded_reduce_against_the_whole_stream(runs, w):
    """reduce(backend="shard_map", group=) over each rank's slice of the
    reference's split: bitwise the reference's ``blocked`` whole-stream
    result for the integer tiers, within FLOAT_REDUCE_RTOL of its
    magnitudes for the float tiers; op="mean" over the group's counts;
    the status's kept rows are the group's."""
    kw, all_outs = runs
    outs = all_outs[w]
    v, ids = jnp.asarray(kw["stream"]), jnp.asarray(kw["ids"])
    absum = np.zeros((NSEG, D))
    keep = kw["ids"] >= 0
    np.add.at(absum, kw["ids"][keep], np.abs(kw["stream"][keep]))
    for p in TIERS:
        ref = np.asarray(JR.reduce(v, segment_ids=ids, num_segments=NSEG,
                                   policy=p, backend="blocked",
                                   block_size=BLOCK))
        got = _replicated(outs, f"reduce/{p}")
        if p in INT_TIERS:
            _same(got, ref)
        else:
            _close(got, ref, FLOAT_REDUCE_RTOL * absum + 1e-30)
    _same(_replicated(outs, "reduce_mean"),
          np.asarray(JR.reduce(v, segment_ids=ids, num_segments=NSEG,
                               op="mean", policy="exact2",
                               backend="blocked", block_size=BLOCK)))
    st = _replicated(outs, "reduce_status")
    assert int(st.kept_rows) == int(keep.sum())
    assert not bool(st.nonfinite) and not bool(st.saturated)


def test_policy_merge_across(runs):
    """Policy.merge_across at 1, 2 and 4 ranks: the integer tiers' merged
    carry is bitwise the reference's merge of the same carries and the
    one-process carry of the whole stream; the float tiers' is bitwise
    the port's own rank-order fold of the ranks' carries with ``merge``
    and within tolerance of the reference's psum / device-order fold."""
    kw, all_outs = runs
    for w in WORLDS:
        outs = all_outs[w]
        for p in TIERS:
            pol = get_policy(p)
            rpol = JR.get_policy(p)
            carries = [o[f"carry/{p}"] for o in outs]
            merged = _replicated(outs, f"merged/{p}")
            stacked = [np.stack([_np(c[i]) for c in carries])
                       for i in range(len(carries[0]))]
            ref = _vmap(lambda *c: rpol.merge_across(tuple(c), ("data",)),
                        *stacked)
            if pol.integer:
                for a, b in zip(merged, ref):
                    _same(a, b)
            else:
                fold = tuple(carries[0])
                for c in carries[1:]:
                    fold = pol.merge(fold, tuple(c))
                for a, b, c in zip(merged, fold, ref):
                    _same(a, b)
                    _close(a, c, FAST_RTOL * 64 * (np.abs(_np(c)) + 1e-3))
        # the integer carries merged at W equal the merge at W = 1
        for p in INT_TIERS:
            for a, b in zip(_replicated(outs, f"merged/{p}"),
                            all_outs[1][0][f"merged/{p}"]):
                _same(a, b)


def test_drop_shard_carry_is_the_surviving_rows(runs):
    """Zeroing the last rank's carry before the merge gives bitwise the
    one-process reduction of the other ranks' rows (same domain and
    context) for the integer tiers, as the reference's fault test holds
    for its shards."""
    kw, all_outs = runs
    from repro_torch.reduce import get_backend, mask_out_of_range
    for w in (2, 4):
        outs = all_outs[w]
        lo, _ = WK.shard_bounds(N, w, w - 1, BLOCK)
        for p in INT_TIERS:
            pol = get_policy(p)
            mids = mask_out_of_range(torch.from_numpy(kw["ids"]), NSEG)
            mvals = torch.where((mids >= 0)[:, None],
                                torch.from_numpy(kw["stream"]),
                                torch.zeros(()))
            dom, ctx = pol.prepare(mvals, N)
            survive = get_backend("blocked").run(
                dom[:lo], mids[:lo], NSEG, policy=pol, block_size=BLOCK)
            dropped = _replicated(outs, f"dropped/{p}")
            _same(pol.finalize(dropped, ctx), pol.finalize(survive, ctx))


def test_accumulators_merge_across(runs):
    """merge_across of Limb3 (its own three-limb merge), Bin (one fused
    integer psum), Limb and Kahan (gather, rank-order fold) against the
    reference's under vmap at 2 and 4 ranks: the finalized sums bitwise,
    Kahan's within KAHAN_RTOL."""
    kw, all_outs = runs
    x = kw["acc_x"]
    scale = jnp.float32(SCALE)
    make = {"limb3": lambda: JR.Limb3Accumulator(scale),
            "limb": lambda: JR.LimbAccumulator(scale),
            "bin": lambda: JR.BinAccumulator(jnp.float32(4.0)),
            "kahan": lambda: JR.KahanAccumulator()}
    for w in (2, 4):
        outs = all_outs[w]
        for name, mk in make.items():
            acc = mk()

            def run(rows):
                st = acc.init(rows[0])
                for i in range(rows.shape[0]):
                    st = acc.push(st, rows[i])
                return acc.finalize(JR.merge_across(acc, st, ("data",)))
            ref = _vmap(run, x[:w], jit=True)
            got = _replicated(outs, f"acc/{name}", 1)
            if name == "kahan":
                _close(got, ref, KAHAN_RTOL * (np.abs(ref) + 1))
            else:
                _same(got, ref)


def test_one_rank_group_in_this_process():
    """A one-rank group (``comm.init_group`` with no environment): the
    auto-selected ``reduce`` runs the local executor and gives its bits,
    ``shard_map`` gives them too; a single-device backend given a group,
    and ``shard_map`` without one, raise, as the reference's rules for a
    mesh."""
    g = comm.init_group("gloo")
    assert comm.axis_size(g) == 1 and comm.axis_index(g) == 0
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal((700, 3)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, 5, 700).astype(np.int32))
    kw = dict(segment_ids=ids, num_segments=5, policy="exact2",
              device="cpu")
    local = repro_torch.reduce(v, **kw)
    _same(repro_torch.reduce(v, group=g, **kw), local)
    _same(repro_torch.reduce(v, group=g, backend="shard_map", **kw), local)
    with pytest.raises(ValueError, match="single-device"):
        repro_torch.reduce(v, group=g, backend="blocked", **kw)
    with pytest.raises(ValueError, match="group="):
        repro_torch.reduce(v, backend="shard_map", **kw)
    with pytest.raises(TypeError, match="integer"):
        comm.psum(torch.ones(2), g)

