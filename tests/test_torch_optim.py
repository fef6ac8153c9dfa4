"""The port's gradient and norm reductions and AdamW against the
reference, on the CPU.

Given the same gradients (numpy draws from fixed seeds), the integer
tiers (``exact``, ``exact2``, ``procrastinate``) of
``reduce_microbatch_grads`` and ``global_norm`` are held bitwise to the
reference and across the port's ``ref`` and ``blocked`` executors: each
result is a pure function of int32 totals and one power-of-two scale.
``global_norm(policy=None)``, the AdamW update and the schedule are held
to float32 tolerances stated per test (the packages sum and round
transcendental functions in their own ways).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import adamw as RA  # noqa: E402
from repro.reduce import accumulator as RACC  # noqa: E402
from repro_torch import reduce as treduce  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.reduce import accumulator as TACC  # noqa: E402

CPU = "cpu"
INT_TIERS = ("exact", "exact2", "procrastinate")
#: leaves of one gradient tree: a 2-D leaf past one 1,024-wide row, a
#: stacked 3-D leaf, a leaf under one row and a scalar-sized one
SHAPES = {"a": (3, 40, 19), "b": (2, 1500), "c": (300,), "d": (1,)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale_spread=10):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s)
                * np.exp2(rng.uniform(-scale_spread, scale_spread, s)))
            .astype(np.float32) for k, s in SHAPES.items()}


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("policy", INT_TIERS)
def test_global_norm_integer_tiers_bitwise_reference(policy):
    """Both stages through the front door (each leaf's (n/1024, 1024)
    ``op="sumsq"`` stream and its partials, then across the leaves): the
    same bits as the reference, on ``ref`` and ``blocked`` alike."""
    tree = _tree(seed=1)
    ref = np.asarray(RA.global_norm({k: jnp.asarray(v) for k, v in
                                     tree.items()}, policy=policy))
    port = {k: torch.from_numpy(v) for k, v in tree.items()}
    for backend in ("blocked", "ref"):
        got = TA.global_norm(port, policy=policy, backend=backend)
        assert np.array_equal(_bits(ref), _bits(got.numpy())), \
            (backend, float(ref), float(got))


def test_global_norm_without_policy_within_tolerance():
    """``policy=None``: float32 per-leaf sums of squares in the two
    packages' own orders, combined by the same pairing tree.  Bound: 4
    float32 ulps of the norm, relative (measured: 1.32)."""
    tree = _tree(seed=2, scale_spread=4)
    ref = float(RA.global_norm({k: jnp.asarray(v) for k, v in
                                tree.items()}))
    got = float(TA.global_norm({k: torch.from_numpy(v) for k, v in
                                tree.items()}))
    assert abs(got - ref) <= 4 * 2.0 ** -23 * ref


@pytest.mark.parametrize("policy", INT_TIERS)
def test_reduce_microbatch_grads_bitwise_reference(policy):
    """The same m = 3 stacked per-microbatch gradients: the mean of each
    (m, |leaf|) stream bitwise the reference's, on ``ref`` and
    ``blocked`` alike, in each leaf's dtype."""
    m = 3
    trees = [_tree(seed=10 + i) for i in range(m)]
    stacked = {k: np.stack([t[k] for t in trees]) for k in SHAPES}

    def ref_fn(p, mb):
        return mb, mb["a"].sum()

    rg, _ = RACC.reduce_microbatch_grads(
        ref_fn, None, {k: jnp.asarray(v) for k, v in stacked.items()},
        num_microbatches=m, policy=policy)
    got = {}
    for backend in ("blocked", "ref"):
        tg, aux = TACC.reduce_microbatch_grads(
            lambda p, mb: (mb, mb["a"].sum()), None,
            {k: torch.from_numpy(v) for k, v in stacked.items()},
            num_microbatches=m, policy=policy, backend=backend)
        assert list(tg) == list(SHAPES) and aux.shape == (m,)
        for k in SHAPES:
            assert tg[k].shape == SHAPES[k] and tg[k].dtype == torch.float32
            assert np.array_equal(_bits(rg[k]), _bits(tg[k].numpy())), \
                (backend, k)
        got[backend] = tg
    for k in SHAPES:
        assert torch.equal(got["ref"][k], got["blocked"][k])


def test_cosine_schedule_values():
    """Warm-up, cosine and floor: within 2 float32 ulps of the
    reference's values (jnp.cos against torch.cos; measured: equal)."""
    for base, warm, total in ((1e-3, 1, 5), (3e-4, 20, 100), (1.0, 0, 10)):
        rf, tf = RA.cosine_schedule(base, warm, total), \
            TA.cosine_schedule(base, warm, total)
        for step in (0, 1, 2, 5, 19, 20, 21, 50, 100, 150):
            r = float(rf(jnp.int32(step)))
            t = float(tf(torch.tensor(step, dtype=torch.int32)))
            assert t == pytest.approx(r, rel=2 * 2.0 ** -23, abs=1e-12), \
                (base, warm, total, step)
            assert float(tf(step)) == t


def test_adamw_update_within_tolerance_of_reference():
    """Two AdamW steps on the same parameters and gradients, with the
    clip's norm under ``exact``: the norm bitwise, the moments within
    1e-6 relative of their leaf's largest value (measured: equal) and the
    parameters within 1e-6 absolute (values about 1; measured: 4.7e-10,
    one rounding of the float32 update)."""
    params = _tree(seed=20, scale_spread=1)
    grads = [_tree(seed=21 + i, scale_spread=3) for i in range(2)]
    rp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    rs, ts = RA.init(rp), TA.init(tp)
    for step, g in enumerate(grads, start=1):
        rp, rs, rn = RA.update({k: jnp.asarray(v) for k, v in g.items()},
                               rs, rp, lr=jnp.float32(1e-3),
                               norm_policy="exact")
        tp, ts, tn = TA.update({k: torch.from_numpy(v) for k, v in
                                g.items()}, ts, tp,
                               lr=torch.tensor(1e-3), norm_policy="exact")
        assert np.array_equal(_bits(rn), _bits(tn.numpy()))
        assert int(ts.count) == int(rs.count) == step
        for k in SHAPES:
            for r, t in ((rs.mu[k], ts.mu[k]), (rs.nu[k], ts.nu[k])):
                r = np.asarray(r)
                assert np.abs(r - t.numpy()).max() <= \
                    1e-6 * np.abs(r).max()
            assert np.abs(np.asarray(rp[k]) - tp[k].numpy()).max() <= 1e-6


@pytest.mark.parametrize("clip", (1.0, None))
def test_adamw_update_in_place_bitwise_functional(clip):
    """``update_`` (the train step's: parameters and moments overwritten,
    the norm taken by the caller) gives bitwise the AdamW formula written
    out functionally, bf16 parameters included; ``update`` returns the
    same bits and leaves its inputs as they were; without a clip both
    report a norm of 0."""
    b1, b2, eps, wd, lr = 0.9, 0.95, 1e-8, 0.1, torch.tensor(1e-2)
    params = {k: torch.from_numpy(v).to(torch.bfloat16)
              for k, v in _tree(seed=30, scale_spread=1).items()}
    grads = [{k: torch.from_numpy(v) for k, v in
              _tree(seed=31 + i, scale_spread=3).items()} for i in range(2)]
    fp, fs = dict(params), TA.init(params)
    ip = {k: v.clone() for k, v in params.items()}
    ist = TA.init(ip)
    wp = {k: v.clone() for k, v in params.items()}
    wm = {k: torch.zeros(v.shape) for k, v in params.items()}
    wv = {k: torch.zeros(v.shape) for k, v in params.items()}
    for step, g in enumerate(grads, start=1):
        given = (fp, fs.mu, fs.nu)
        kept = [{k: v.clone() for k, v in d.items()} for d in given]
        fp, fs, fn = TA.update(g, fs, fp, lr=lr, clip_norm=clip,
                               norm_policy="exact")
        assert all(torch.equal(d[k], c[k]) for d, c in zip(given, kept)
                   for k in SHAPES)
        gn = None if clip is None else TA.global_norm(g, policy="exact")
        mu = ist.mu
        ist = TA.update_(g, ist, ip, lr=lr, gnorm=gn, clip_norm=clip)
        assert ist.mu is mu and int(ist.count) == int(fs.count) == step
        assert float(fn) == (0.0 if gn is None else float(gn))
        # the formula, written out
        c1 = 1.0 - torch.pow(torch.tensor(b1), torch.tensor(float(step)))
        c2 = 1.0 - torch.pow(torch.tensor(b2), torch.tensor(float(step)))
        for k in SHAPES:
            x = g[k] if gn is None else g[k] * torch.clamp(
                clip / torch.clamp(gn, min=1e-9), max=1.0)
            wm[k] = b1 * wm[k] + (1 - b1) * x
            wv[k] = b2 * wv[k] + (1 - b2) * x * x
            pf = wp[k].to(torch.float32)
            upd = (wm[k] / c1) / (torch.sqrt(wv[k] / c2) + eps) + wd * pf
            wp[k] = (pf - lr * upd).to(torch.bfloat16)
            for got in ((ip[k], ist.mu[k], ist.nu[k]),
                        (fp[k], fs.mu[k], fs.nu[k])):
                assert torch.equal(got[0], wp[k])
                assert torch.equal(got[1], wm[k])
                assert torch.equal(got[2], wv[k])


def test_reduce_cuda_backend_raises_for_values_that_require_grad():
    """K1 runs under autograd (``backends.run_with_carry_grad``): a
    single-device ``reduce(..., backend="cuda")`` on a tensor that
    requires grad no longer refuses it, and reaches the device check as
    the same values detached do; ``blocked`` on the CPU differentiates."""
    x = torch.ones(8, 4, requires_grad=True)
    for v in (x, x.detach()):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            treduce.reduce(v, policy="exact", backend="cuda", device=CPU)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        treduce.reduce(x, policy="fast", backend="cuda", device=CPU)
    y = treduce.reduce(x, policy="fast", backend="blocked", device=CPU)
    assert y.shape == (4,)
    g, = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.ones_like(x))


def test_multi_device_knobs_raise():
    """The multi-device knob of ``reduce_microbatch_grads`` is a process
    group (the reference's mesh): over a one-rank group (this process,
    ``comm.init_group``) the auto-selected mean is bitwise the one
    without a group, and the reference's rules for a mesh hold: a
    single-device backend given a group raises, and so does the
    ``shard_map`` executor without one."""
    from repro_torch.distributed import comm
    group = comm.init_group("gloo")
    rng = np.random.default_rng(7)
    tree = {"a": torch.from_numpy(rng.standard_normal((2, 3))
                                  .astype(np.float32))}

    def run(**kw):
        return TACC.reduce_microbatch_grads(
            lambda p, mb: (mb, torch.zeros(())), None, tree,
            num_microbatches=2,
            policy="exact", **kw)[0]["a"]
    assert torch.equal(run(group=group), run())
    assert torch.equal(run(group=group, backend="shard_map"), run())
    with pytest.raises(ValueError, match="single-device"):
        run(group=group, backend="blocked")
    with pytest.raises(ValueError, match="group="):
        run(backend="shard_map")


@pytest.mark.parametrize("tier", ("fast", "exact2", "procrastinate"))
def test_plain_k1_column_slices_bitwise(tier, monkeypatch):
    """K1's plain version cuts a stream too wide for one block's
    contribution into slices of raw columns (every plane of each): the
    same carry bits as in one piece, both gather forms."""
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.reduce import get_policy, plan_program
    pol = get_policy(tier)
    rng = np.random.default_rng(30)
    n, d, s = 256, 37, 3
    vals = torch.from_numpy((rng.standard_normal((n, d))
                             * np.exp2(rng.integers(-8, 8, (n, d))))
                            .astype(np.float32))
    ids = torch.from_numpy(rng.integers(-1, s, n).astype(np.int32))
    dom, _ = pol.prepare(vals, n)
    for contrib in ("dot", "lanes"):
        prog = plan_program(pol, num_segments=s, domain_width=dom.shape[1],
                            block_size=64, contrib=contrib)
        whole = K.segsum_policy_torch(dom, ids, s, policy=pol, program=prog,
                                      block_rows=64)
        monkeypatch.setattr(K, "_CONTRIB_ELEMS", s * pol.parts * 5)
        sliced = K.segsum_policy_torch(dom, ids, s, policy=pol,
                                       program=prog, block_rows=64)
        monkeypatch.undo()
        assert all(torch.equal(a, b) for a, b in zip(whole, sliced))
