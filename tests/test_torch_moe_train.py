"""The port's training of models with experts against the reference, on the
CPU.

``repro_torch.models.moe`` under autograd, and ``make_train_step`` on
mixtral-8x22b's and deepseek-v2-lite-16b's SMOKE configurations (float32;
jamba-v0.1-52b's in ``tests/test_torch_jamba_train.py``), against ``jax.grad`` / ``jax.value_and_grad`` of
``repro.models.moe`` and ``repro.models.model`` and the reference's jitted
train step.  The module tests load the reference's ``moe_init`` leaves; the
whole-model tests carry the reference's ``init_params`` tree across with
``convert.params_from_numpy``.  Inputs are numpy draws from fixed seeds.
The two packages sum in different orders, so float results are held to
the float32 tolerances of ``tests/test_torch_train.py``, restated below;
before any gradient is compared, the port's and the reference's top-k
choices are held equal in every MoE layer, so a flipped near tie shows as
such and not as a gradient error.  What the port does alone (``remat``,
the ordered dispatch backward) is held bitwise.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models.config import MoECfg  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

CPU = "cpu"
KEY = jax.random.PRNGKey(0)
MIXTRAL, DEEPSEEK = "mixtral-8x22b", "deepseek-v2-lite-16b"
#: as tests/test_torch_train.py: the loss (float32 xent of about 6.8, an
#: ulp 4.8e-7; measured here 1.9e-6 at most)
LOSS_ATOL = 8e-6
#: every gradient leaf and AdamW moment: max |ref - port| over the leaf's
#: largest |value| (measured here: 1.8e-6 at most)
GRAD_REL = 1e-5
#: as tests/test_torch_train.py: a parameter's first AdamW step against
#: the reference's, a share of lr everywhere and where |mu| >= 1e-7
PARAM_LR_SHARE = 0.25
PARAM_LR_SHARE_LIVE = 1e-4
LR = 1e-2
#: the Switch aux loss's weight in the loss, the reference's default
AUX_WEIGHT = 0.01

#: the reference's forwards' top-k choices, once a configuration and
#: batch
R_CHOICES = {}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These are small CPU computations: one intra-op thread each, so the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    """arch -> (reference config, its init_params tree, the same as
    numpy), drawn once."""
    out = {}
    init = jax.jit(RM.init_params, static_argnums=1)
    for arch in (MIXTRAL, DEEPSEEK):
        cfg = RC.get_smoke_config(arch)
        params = init(KEY, cfg)
        out[arch] = (cfg, params, jax.tree.map(np.asarray, params))
    return out


def _model(arch, tree):
    return convert.params_from_numpy(TC.get_smoke_config(arch), tree,
                                     device=CPU)


def _tokens(seed, shape=(4, 16), vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _path(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _close(ref, got, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max())
    assert err <= rel * float(np.abs(ref).max()), \
        f"{what}: max |ref - port| = {err:g}, largest |ref| " \
        f"{float(np.abs(ref).max()):g}"


# ---------------------------------------------------------------------------
# top-k choices of both packages
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _reference_choices():
    """Inside ``with``: every ``router_topk`` the reference runs sends its
    expert ids to the host (in execution order: layer order through the
    scan over periods)."""
    seen, real = [], RMoE.router_topk

    def recorded(router_w, x, m):
        w, idx, aux = real(router_w, x, m)
        jax.debug.callback(lambda i: seen.append(np.asarray(i)), idx,
                           ordered=True)
        return w, idx, aux
    RMoE.router_topk = recorded
    try:
        yield seen
    finally:
        RMoE.router_topk = real


def _port_choices(model, tokens):
    """The port's expert ids in every MoE layer of a forward, in layer
    order."""
    seen, hooks = [], []
    for blk in model.blocks:
        if isinstance(blk.mlp, TMoE.MoE):
            def hook(mod, args, _out):
                x = args[0]
                seen.append(TMoE.router_topk(
                    mod.router, x.reshape(-1, x.shape[-1]),
                    mod.cfg.moe)[1].numpy())
            hooks.append(blk.mlp.register_forward_hook(hook))
    try:
        with torch.no_grad():
            TM.forward(model, tokens=torch.from_numpy(tokens))
    finally:
        for h in hooks:
            h.remove()
    return seen


def _assert_same_choices(cfg, params, model, tokens, ref=None):
    """Both packages' top-k choices equal in every MoE layer of a forward
    over ``tokens``.  ``ref``: the reference's, recorded already; else its
    forward runs with the recording router (a function of its own, so no
    trace cached without the recording is reused), once a configuration
    and batch (the SMOKE weights are drawn once)."""
    if ref is None:
        key = (cfg.name, tokens.tobytes())
        if key not in R_CHOICES:
            with _reference_choices() as R_CHOICES[key]:
                jax.block_until_ready(jax.jit(
                    lambda p, t: RM.forward(p, cfg, tokens=t))(
                        params, jnp.asarray(tokens)))
        ref = R_CHOICES[key]
    got = _port_choices(model, tokens)
    n_moe = sum(sp.mlp == "moe" for sp in cfg.period) * cfg.n_periods
    assert len(ref) == len(got) == n_moe, (len(ref), len(got), n_moe)
    for i, (r, t) in enumerate(zip(ref, got)):
        assert np.array_equal(r, t), f"MoE layer {i}: top-k choices differ"


# ---------------------------------------------------------------------------
# one MoE layer under autograd
# ---------------------------------------------------------------------------


def _layer(arch, v=1):
    """(reference cfg, its moe_init leaves, port cfg, the port's MoE
    holding the same leaves, with gradients on)."""
    rcfg = RC.get_smoke_config(arch).scaled(moe_virtual_split=v)
    tcfg = TC.get_smoke_config(arch).scaled(moe_virtual_split=v)
    p = RMoE.moe_init(KEY, rcfg, jnp.float32)
    mod = TMoE.MoE(tcfg, torch.float32, CPU)
    flat = {_path(path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]}
    mod.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(a))
                         for k, a in flat.items()}, strict=True)
    return rcfg, p, tcfg, mod.requires_grad_(True)


def _layer_grads(arch, v, impl, seed, *, capacity=None, aux_only=False):
    """One MoE layer's loss, sum(y * ct) + AUX_WEIGHT * aux (or aux
    alone), and its gradients for x and every weight leaf, in both
    packages, after holding their top-k choices equal.  Returns (ref
    grads, port grads) as {name: array / tensor}, and the port's
    routing."""
    rcfg, p, tcfg, mod = _layer(arch, v)
    x = _x(seed, (4, 24, rcfg.d_model))
    ct = _x(seed + 1, x.shape)
    _, ridx, _ = RMoE.router_topk(p["router"], jnp.asarray(
        x.reshape(-1, rcfg.d_model)), rcfg.moe)
    _, tidx, _ = TMoE.router_topk(mod.router, torch.from_numpy(
        x.reshape(-1, tcfg.d_model)), tcfg.moe)
    assert np.array_equal(np.asarray(ridx), tidx.numpy()), "top-k differ"

    if impl == "capacity":
        def fwd(pp, xx):
            return RMoE.moe_apply_capacity(pp, xx, rcfg, capacity=capacity)
    else:
        def fwd(pp, xx):
            return RMoE.moe_apply_dense(pp, xx, rcfg)

    def loss(pp, xx, cc):
        y, aux = fwd(pp, xx)
        return aux if aux_only else jnp.sum(y * cc) + AUX_WEIGHT * aux

    rgp, rgx = jax.jit(jax.grad(loss, argnums=(0, 1)))(
        p, jnp.asarray(x), jnp.asarray(ct))
    ref = {_path(path): leaf for path, leaf in
           jax.tree_util.tree_flatten_with_path(rgp)[0]}
    ref["x"] = rgx

    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = TMoE.moe_apply(mod, xt, tcfg, impl=impl, capacity=capacity)
    tloss = aux if aux_only else (torch.sum(y * torch.from_numpy(ct))
                                  + AUX_WEIGHT * aux)
    named = dict(mod.named_parameters())
    gs = torch.autograd.grad(tloss, [xt] + list(named.values()),
                             allow_unused=aux_only)
    port = {"x": gs[0]}
    port.update({n.replace(".", "/"): g for n, g in zip(named, gs[1:])})
    route = TMoE.capacity_route(mod.router, torch.from_numpy(
        x.reshape(-1, tcfg.d_model)), tcfg, capacity=capacity)
    return ref, port, route


CAPACITY_CASES = {"mixtral-v1": (MIXTRAL, 1, None),
                  "mixtral-v2": (MIXTRAL, 2, None),
                  "deepseek-v1": (DEEPSEEK, 1, None),
                  "mixtral-drops": (MIXTRAL, 1, 13)}


@pytest.mark.parametrize("case", sorted(CAPACITY_CASES))
def test_capacity_grads_within_tolerance_of_reference(case):
    """``moe_apply_capacity``'s gradients for x, ``router``, ``wi``,
    ``wg``, ``wo`` (and deepseek's ``shared``) against ``jax.grad`` of the
    reference's, through the combine weights (softmax, top-k,
    ``router_norm_topk``), the aux term, both gathers, the experts and the
    shared SwiGLU: mixtral at ``moe_virtual_split`` 1 and 2, deepseek,
    and mixtral with ``capacity=13`` of 96 tokens' 192 choices, where
    choices drop (asserted)."""
    arch, v, capacity = CAPACITY_CASES[case]
    ref, port, route = _layer_grads(arch, v, "capacity", seed=3,
                                    capacity=capacity)
    dropped = int((~route.keep).sum())
    if capacity is not None:
        assert dropped > 0, "no choice dropped"
    want = {"x", "router", "wi", "wg", "wo"}
    if arch == DEEPSEEK:
        want |= {"shared/wi", "shared/wg", "shared/wo"}
    assert set(port) == set(ref) == want
    for name in sorted(want):
        _close(ref[name], port[name], GRAD_REL,
               f"{case} ({dropped} dropped) {name}")


def test_dense_grads_within_tolerance_of_reference():
    """``moe_apply_dense``'s gradients, every expert on every token and
    the top-k gates combining them: mixtral at ``moe_virtual_split`` 2
    (the virtual shards summed back) and deepseek (shared experts,
    ``router_norm_topk``)."""
    for arch, v in ((MIXTRAL, 2), (DEEPSEEK, 1)):
        ref, port, _ = _layer_grads(arch, v, "dense", seed=5)
        assert set(port) == set(ref)
        for name in sorted(ref):
            _close(ref[name], port[name], GRAD_REL, f"{arch} dense {name}")


def test_router_grad_from_aux_alone():
    """The Switch aux term alone: its gradient reaches the router and x
    through the mean router probability ``me``; the top-1 one-hot ``ce``
    carries none, and the experts get none (``allow_unused``: None)."""
    ref, port, _ = _layer_grads(DEEPSEEK, 1, "capacity", seed=7,
                                aux_only=True)
    for name in ("router", "x"):
        assert float(np.abs(np.asarray(ref[name])).max()) > 0
        _close(ref[name], port[name], GRAD_REL, f"aux {name}")
    for name in ("wi", "wg", "wo", "shared/wi"):
        assert not np.asarray(ref[name]).any()
        assert port[name] is None, name


def test_dispatch_backward_is_the_ordered_sum_and_repeats():
    """The dispatch gather's backward (``_DispatchGather``, under 768
    tokens in two groups with choices dropped): a token's gradient is
    bitwise 0 + its kept choices' slot gradients in choice order, summed
    in float32 and rounded once (float32 and bf16), a dropped choice and
    an empty slot adding nothing; two runs give the same bits."""
    tcfg = TC.get_smoke_config(DEEPSEEK).scaled(
        moe=MoECfg(num_experts=8, top_k=3, d_ff_expert=64, num_shared=1,
                   d_ff_shared=64, router_norm_topk=True))
    d = tcfg.d_model
    router = torch.from_numpy(_x(11, (d, 8)))
    xt = torch.from_numpy(_x(12, (768, d)))
    r = TMoE.capacity_route(router, xt, tcfg, capacity=140,
                            group_size=384)
    ng, g, k = r.w.shape
    assert (ng, g, k) == (2, 384, 3)
    assert 0 < int((~r.keep).sum()) and int((r.slots == g).sum()) > 0
    for dt in (torch.float32, torch.bfloat16):
        xg = xt.reshape(ng, g, d).to(dt).requires_grad_(True)
        xe = TMoE._DispatchGather.apply(xg, r.slots, r.src, k)
        # the forward: each filled slot holds its token's row
        filled = r.slots < g
        rows = torch.gather(xg.detach(), 1, torch.where(
            filled, r.slots, 0)[..., None].expand(-1, -1, d))
        assert torch.equal(xe.detach()[filled], rows[filled])
        assert not xe.detach()[~filled].any()
        gy = torch.from_numpy(_x(13, tuple(xe.shape))).to(dt)
        (g1,) = torch.autograd.grad(xe, xg, gy)
        xe = TMoE._DispatchGather.apply(xg, r.slots, r.src, k)
        (g2,) = torch.autograd.grad(xe, xg, gy)
        assert torch.equal(g1, g2)
        want = torch.zeros((ng, g, d), dtype=torch.float32)
        for n in range(ng):
            for i in range(g):
                acc = torch.zeros(d, dtype=torch.float32)
                for j in range(k):
                    if r.keep[n, i * k + j]:
                        acc = acc + gy[n, r.src[n, i * k + j]].float()
                want[n, i] = acc
        assert g1.dtype == dt and torch.equal(g1, want.to(dt)), dt


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


def _port_grads(model, batch, *, moe_impl="capacity", remat=False):
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = TM.loss_fn(model, batch, moe_impl=moe_impl, remat=remat)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), metrics, convert.to_reference(
        model.cfg, dict(zip(named, grads)))


def check_loss_and_grads(arch, impl, cfg, params, tree, rel_of):
    """``loss_fn`` (xent + 0.01 aux) and every gradient leaf, in the
    reference's layout, against ``jax.value_and_grad`` of the reference's,
    after holding the top-k choices of every MoE layer equal (recorded as
    the reference computes the loss).  Under ``capacity`` the tokens drop
    choices in some layer (asserted).  ``rel_of(path)``: a leaf's
    tolerance."""
    toks = _tokens(seed=1)
    model = _model(arch, tree)
    if impl == "capacity":
        assert _dropped_choices(model, toks) > 0, "no choice dropped"

    def ref_loss(p):
        return RM.loss_fn(p, cfg, {"tokens": jnp.asarray(toks)},
                          moe_impl=impl)

    with _reference_choices() as choices:
        (rl, rmet), rg = jax.jit(jax.value_and_grad(ref_loss,
                                                    has_aux=True))(params)
        jax.block_until_ready(rg)
    _assert_same_choices(cfg, params, model, toks, ref=choices)
    tl, tmet, tg = _port_grads(model, {"tokens": torch.from_numpy(toks)},
                               moe_impl=impl)
    assert abs(float(rl) - float(tl)) <= LOSS_ATOL
    assert float(tmet["tokens"]) == float(rmet["tokens"])
    assert float(rmet["aux"]) > 0
    assert abs(float(tmet["aux"].detach()) - float(rmet["aux"])) <= LOSS_ATOL
    assert list(tg) == [_path(path) for path, _ in
                        jax.tree_util.tree_leaves_with_path(rg)]
    for (path, got), ref in zip(tg.items(), jax.tree.leaves(rg)):
        _close(ref, got, rel_of(path), f"{arch} {impl} {path}")


LOSS_CASES = {"mixtral-capacity": (MIXTRAL, "capacity"),
              "mixtral-dense": (MIXTRAL, "dense"),
              "deepseek-capacity": (DEEPSEEK, "capacity")}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_grads_within_tolerance_of_reference(trees, case):
    """``check_loss_and_grads``: mixtral (GQA on a sliding window) under
    both dispatches, deepseek (MLA, shared experts,
    ``router_norm_topk``)."""
    arch, impl = LOSS_CASES[case]
    check_loss_and_grads(arch, impl, *trees[arch],
                         rel_of=lambda path: GRAD_REL)


def _dropped_choices(model, tokens):
    """The (token, choice) pairs the capacity dispatch drops over every
    MoE layer of a forward over ``tokens``."""
    dropped, hooks = [], []
    for blk in model.blocks:
        if isinstance(blk.mlp, TMoE.MoE):
            def hook(mod, args, _out):
                x = args[0]
                r = TMoE.capacity_route(mod.router,
                                        x.reshape(-1, x.shape[-1]), mod.cfg)
                dropped.append(int((~r.keep).sum()))
            hooks.append(blk.mlp.register_forward_hook(hook))
    try:
        with torch.no_grad():
            TM.forward(model, tokens=torch.from_numpy(tokens))
    finally:
        for h in hooks:
            h.remove()
    return sum(dropped)


def check_train_step(arch, kw, cfg, params, tree,
                     rel_of=lambda path: GRAD_REL):
    """One ``make_train_step`` step (remat on, as the reference's default)
    from the same weights and batch, after holding the top-k choices of
    every MoE layer equal: the parameters, the AdamW moments (a leaf's
    within ``rel_of(path)``), the grad norm, the loss, aux and lr against
    the reference's jitted step."""
    toks = _tokens(seed=3)
    model = _model(arch, tree)
    _assert_same_choices(cfg, params, model, toks)
    if kw.get("moe_impl", "capacity") == "capacity":
        assert _dropped_choices(model, toks) > 0, "no choice dropped"
    ref_step = jax.jit(RS.make_train_step(
        cfg, lr_fn=RA.cosine_schedule(LR, 1, 5), **kw))
    rp, rs, rmet = ref_step(params, RA.init(params),
                            {"tokens": jnp.asarray(toks)})
    step = TS.make_train_step(model.cfg, lr_fn=TA.cosine_schedule(LR, 1, 5),
                              device=CPU, **kw)
    model, ts, tmet = step(model, TS.init_state(model), {"tokens": toks})
    assert int(ts.count) == int(rs.count) == 1
    assert float(tmet["lr"]) == float(rmet["lr"])
    assert abs(float(tmet["loss"]) - float(rmet["loss"])) <= LOSS_ATOL
    assert abs(float(tmet["aux"]) - float(rmet["aux"])) <= LOSS_ATOL
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(rmet["grad_norm"]), rel=1e-6)
    for name, ref, got in (("mu", rs.mu, ts.mu), ("nu", rs.nu, ts.nu)):
        for (path, g), r in zip(got.items(), jax.tree.leaves(ref)):
            _close(r, g, rel_of(path), f"{arch} {name} {path}")
    for (path, got), ref, mu in zip(convert.stacked_leaves(model).items(),
                                    jax.tree.leaves(rp),
                                    jax.tree.leaves(rs.mu)):
        err = np.abs(np.asarray(ref) - got.numpy())
        live = np.abs(np.asarray(mu)) >= 1e-7
        assert float(err.max()) <= PARAM_LR_SHARE * LR, path
        assert float(err[live].max(initial=0.0)) <= \
            PARAM_LR_SHARE_LIVE * LR, path


STEPS = {"mixtral-m1": (MIXTRAL, {"num_microbatches": 1}),
         "mixtral-juggler_m2-dense": (MIXTRAL, {"num_microbatches": 2,
                                                "moe_impl": "dense"}),
         "mixtral-exact_m2": (MIXTRAL, {"num_microbatches": 2,
                                        "grad_reduce": "exact",
                                        "norm_policy": "exact"}),
         "deepseek-m1": (DEEPSEEK, {"num_microbatches": 1})}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_within_tolerance_of_reference(trees, case):
    """``check_train_step`` on mixtral at one microbatch, through the
    juggler at two (under the ``dense`` dispatch) and with ``exact``
    ``grad_reduce`` and ``norm_policy`` at two, and on deepseek at one;
    ``capacity`` elsewhere, where these tokens drop choices."""
    arch, kw = STEPS[case]
    check_train_step(arch, kw, *trees[arch])


def test_remat_bitwise_no_remat(trees):
    """``remat`` recomputes each block in the backward, the capacity
    dispatch and its ordered backward included: the loss and every
    gradient of mixtral's SMOKE model are bitwise the same as without
    it."""
    _, _, tree = trees[MIXTRAL]
    batch = {"tokens": torch.from_numpy(_tokens(seed=4))}
    l0, _, g0 = _port_grads(_model(MIXTRAL, tree), batch, remat=False)
    l1, _, g1 = _port_grads(_model(MIXTRAL, tree), batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_launch_train_trains_experts_on_the_cpu():
    """``python -m repro_torch.launch.train --arch mixtral-8x22b --smoke
    --device cpu``, and deepseek's, under either ``--moe-impl``: three
    logged steps, each with a finite loss."""
    for arch in (MIXTRAL, DEEPSEEK):
        for impl in ("dense", "capacity"):
            out = io.StringIO()
            argv = ["--arch", arch, "--smoke", "--device", "cpu",
                    "--steps", "3", "--batch", "4", "--seq", "16",
                    "--log-every", "1", "--moe-impl", impl]
            with contextlib.redirect_stdout(out):
                loss = TL.main(argv)
            lines = out.getvalue().splitlines()
            losses = [float(ln.split()[3]) for ln in lines
                      if ln.startswith("step")]
            assert len(losses) == 3 and np.isfinite(losses).all(), lines
            assert lines[-1].startswith("done: 3 steps"), lines
            assert np.isfinite(loss)
