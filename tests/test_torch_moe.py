"""The port's mixture-of-experts against the reference, on the CPU.

``repro_torch.models.moe`` against ``repro.models.moe`` on two SMOKE
configurations (float32): mixtral-8x22b's (4 experts, top-2) and
deepseek-v2-lite-16b's (8 experts, top-2, a shared expert,
``router_norm_topk``), each at ``moe_virtual_split`` v = 1 and v = 2.  The
module tests load the reference's ``moe_init`` leaves; the whole-model
tests carry the reference's ``init_params`` tree across with
``convert.params_from_numpy``.  Inputs are drawn with numpy from fixed
seeds.  The two packages sum in different orders (XLA's dot against
PyTorch's matmul), so float results are held to the float32 tolerances
stated below; the expert choices are held equal, with the reference's
smallest top-k margin asserted to exceed ten times the router's tolerance
so that a near tie cannot flip a choice silently.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro import reduce as RR  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.models import moe as RMoE  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import moe as TMoE  # noqa: E402

CPU = "cpu"
KEY = jax.random.PRNGKey(0)
#: router probabilities and top-k weights (values in (0, 1)): a few
#: float32 ulps of the softmax
W_TOL = 1e-6
#: the Switch aux loss (about 1 to 2): a few ulps
AUX_TOL = 4e-6
#: an MoE layer's output (values of about 1): float32 products of width
#: 128 and 256 summed in another order
Y_TOL = 1e-5
#: logits through two layers (about N(0, 1)), as tests/test_torch_models.py
LOGITS_TOL = 2e-5
#: combine_segsum's fast tier: the port's pinned pairwise tree against
#: the reference's, for sums of at most 4 rows of about 1
SEGSUM_TOL = 1e-6

#: the reference's functions, jitted once a configuration (eager JAX
#: compiles every primitive on its own, which is slower on the CPU)
R_ROUTER = jax.jit(RMoE.router_topk, static_argnums=2)
R_DENSE = jax.jit(RMoE.moe_apply_dense, static_argnums=2)
R_CAPACITY = jax.jit(RMoE.moe_apply_capacity, static_argnums=2,
                     static_argnames=("capacity", "group_size"))
R_FORWARD = jax.jit(RM.forward, static_argnums=1,
                    static_argnames=("mode", "moe_impl"))
R_LOSS = jax.jit(RM.loss_fn, static_argnums=1, static_argnames="moe_impl")
R_INIT = jax.jit(RM.init_params, static_argnums=1)

CASES = [(arch, v) for arch in ("mixtral-8x22b", "deepseek-v2-lite-16b")
         for v in (1, 2)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These are small CPU computations: one intra-op thread each, so the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, v=1, **kw):
    return (RC.get_smoke_config(arch).scaled(moe_virtual_split=v, **kw),
            TC.get_smoke_config(arch).scaled(moe_virtual_split=v, **kw))


def _layer(arch, v, **kw):
    """(reference cfg, its moe_init leaves, port cfg, the port's MoE
    holding the same leaves)."""
    rcfg, tcfg = _cfgs(arch, v, **kw)
    p = RMoE.moe_init(KEY, rcfg, jnp.float32)
    mod = TMoE.MoE(tcfg, torch.float32, CPU)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(p)[0]}
    mod.load_state_dict({k.replace("/", "."): torch.from_numpy(np.array(a))
                         for k, a in flat.items()}, strict=True)
    return rcfg, p, tcfg, mod


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _err(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max()) if ref.size else 0.0


@pytest.mark.parametrize("arch,v", CASES)
def test_router_topk_matches_reference(arch, v):
    """Expert ids equal; weights and aux within W_TOL / AUX_TOL.  The
    reference's smallest gap between the k-th and the (k+1)-th router
    probability over these tokens is reported and must exceed 10 x
    W_TOL."""
    rcfg, p, tcfg, mod = _layer(arch, v)
    x = _x(1, (96, rcfg.d_model))
    rw, ridx, raux = R_ROUTER(p["router"], jnp.asarray(x), rcfg.moe)
    tw, tidx, taux = TMoE.router_topk(mod.router, torch.from_numpy(x),
                                      tcfg.moe)
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ p["router"], -1))
    top = -np.sort(-probs, axis=-1)
    k = rcfg.moe.top_k
    margin = float((top[:, k - 1] - top[:, k]).min())
    assert margin > 10 * W_TOL, f"smallest top-{k} margin {margin:g}"
    assert np.array_equal(np.asarray(ridx), tidx.numpy())
    assert _err(rw, tw) <= W_TOL
    assert abs(float(raux) - float(taux)) <= AUX_TOL


@pytest.mark.parametrize("policy", ("exact", "exact2"))
def test_router_norm_policy_bitwise_given_the_same_topk(policy):
    """deepseek's router with ``router_norm_policy``: the port's
    normalized weights are bitwise the reference's normalization
    (``repro.reduce`` over w.T, then the division) of the port's own
    top-k weights, through the port's ``blocked`` and ``ref``
    executors."""
    m = TC.get_smoke_config("deepseek-v2-lite-16b").moe
    _, p, tcfg, mod = _layer("deepseek-v2-lite-16b", 1)
    x = torch.from_numpy(_x(2, (77, tcfg.d_model)))
    raw, idx, _ = TMoE.router_topk(
        mod.router, x, dataclasses.replace(m, router_norm_topk=False))
    w = jnp.asarray(raw.numpy())
    den = RR.reduce(w.T, policy=policy)
    want = np.asarray(w / jnp.maximum(den[:, None], 1e-9))
    pm = dataclasses.replace(m, router_norm_policy=policy)
    for backend in ("blocked", "ref"):
        got, gidx, _ = TMoE.router_topk(mod.router, x, pm, backend=backend)
        assert torch.equal(gidx, idx)
        assert np.array_equal(got.numpy(), want), backend
    plain = TMoE.router_topk(mod.router, x, m)[0].numpy()
    assert np.abs(plain - want).max() <= W_TOL


@pytest.mark.parametrize("arch,v", CASES)
def test_moe_apply_dense_and_capacity_match_reference(arch, v):
    """``moe_apply_dense`` and ``moe_apply_capacity`` within Y_TOL of the
    reference, aux within AUX_TOL: capacity at its default, at
    ``capacity=1`` (most choices dropped) and at a group of 16 over 50
    tokens (the last group padded)."""
    rcfg, p, tcfg, mod = _layer(arch, v)
    x = _x(3, (2, 25, rcfg.d_model))
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    ry, raux = R_DENSE(p, jx, rcfg)
    ty, taux = TMoE.moe_apply_dense(mod, tx, tcfg)
    assert _err(ry, ty) <= Y_TOL
    assert abs(float(raux) - float(taux)) <= AUX_TOL
    for kw in ({}, {"capacity": 1}, {"group_size": 16},
               {"group_size": 16, "capacity": 2}):
        rc, _ = R_CAPACITY(p, jx, rcfg, **kw)
        tc, taux_c = TMoE.moe_apply_capacity(mod, tx, tcfg, **kw)
        assert _err(rc, tc) <= Y_TOL, kw
        assert abs(float(raux) - float(taux_c)) <= AUX_TOL
        if kw.get("capacity") == 1:        # the drops are real
            assert float(np.abs(np.asarray(rc) - np.asarray(ry)).max()) \
                > 100 * Y_TOL
    y2, _ = mod(tx, impl="dense")
    assert torch.equal(y2, ty)


def test_combine_segsum_matches_reference():
    """Gate-weighted rows of 40 (token, choice) pairs over 16 tokens (some
    tokens with no row, one row with the out-of-range label): within
    SEGSUM_TOL of the reference's, and the port's executors bitwise each
    other."""
    rows = _x(4, (40, 32))
    ids = np.random.default_rng(5).integers(0, 16, 40).astype(np.int32)
    ids[7] = -1
    ref = RMoE.combine_segsum(jnp.asarray(rows), jnp.asarray(ids), 16)
    got = TMoE.combine_segsum(torch.from_numpy(rows), torch.from_numpy(ids),
                              16)
    assert got.shape == (16, 32)
    assert _err(ref, got) <= SEGSUM_TOL
    plain = TMoE.combine_segsum(torch.from_numpy(rows),
                                torch.from_numpy(ids), 16, backend="ref")
    assert torch.equal(plain, got)


def test_init_params_expert_scales():
    """``init_params`` draws the expert leaves at the reference's scales
    (``moe_init``): wi and wg N(0, 1/d), wo N(0, 1/(f v)), the router
    N(0, 1/d) in float32 (at v = 1 and v = 2; a bf16 model keeps the
    router float32).  The two packages draw from different generators,
    so each leaf's standard deviation is held to the reference's within
    3% (tens of thousands of draws a leaf)."""
    for v in (1, 2):
        rcfg, tcfg = _cfgs("mixtral-8x22b", v, dtype="bfloat16")
        ref = RMoE.moe_init(KEY, rcfg, jnp.bfloat16)
        gen = torch.Generator()
        gen.manual_seed(0)
        model = TM.init_params(tcfg, generator=gen, device=CPU)
        mlp = model.blocks[0].mlp
        assert mlp.router.dtype == torch.float32
        assert mlp.wi.dtype == torch.bfloat16
        for leaf in ("router", "wi", "wg", "wo"):
            want = float(np.asarray(ref[leaf], np.float32).std())
            got = float(getattr(mlp, leaf).float().std())
            assert abs(got / want - 1) < 0.03, (v, leaf, got, want)
        assert abs(float(mlp.wo.float().std())
                   * (tcfg.moe.d_ff_expert ** 0.5) - 1) < 0.03


def test_params_from_numpy_keeps_the_router_float32():
    """A bf16 mixtral SMOKE tree carried across: the router float32 and
    bitwise the tree's, the expert leaves bf16; ``to_reference`` names
    every leaf as the reference's tree does, in its order."""
    rcfg, tcfg = _cfgs("mixtral-8x22b", 1, dtype="bfloat16")
    params = R_INIT(KEY, rcfg)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), params)
    model = convert.params_from_numpy(tcfg, tree, device=CPU)
    sd = model.state_dict()
    assert sd["blocks.1.mlp.router"].dtype == torch.float32
    assert np.array_equal(sd["blocks.1.mlp.router"].numpy(),
                          tree["blocks"][0]["mlp"]["router"][1])
    assert sd["blocks.1.mlp.wo"].dtype == torch.bfloat16
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    leaves = convert.to_reference(tcfg, dict(model.named_parameters()))
    assert list(leaves) == want
    assert leaves["blocks/0/mlp/router"].dtype == torch.float32


@pytest.fixture(scope="module")
def mixtral():
    rcfg, tcfg = _cfgs("mixtral-8x22b")
    params = R_INIT(KEY, rcfg)
    model = convert.params_from_numpy(tcfg, jax.tree.map(np.asarray,
                                                         params), device=CPU)
    return rcfg, params, tcfg, model


@pytest.mark.parametrize("impl", ("dense", "capacity"))
def test_forward_logits_and_aux_match_reference(mixtral, impl):
    """The whole model (2 layers, window 16, 40 tokens: the window mask
    bites) in train and prefill mode: logits within LOGITS_TOL, aux (the
    two layers' sum) within AUX_TOL."""
    rcfg, params, tcfg, model = mixtral
    toks = np.random.default_rng(6).integers(0, rcfg.vocab, (2, 40))
    for mode in ("train", "prefill"):
        rl, _, raux = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks),
                                mode=mode, moe_impl=impl)
        tl, _, taux = TM.forward(model, tokens=torch.from_numpy(toks),
                                 mode=mode, moe_impl=impl)
        assert _err(rl, tl) <= LOGITS_TOL, mode
        assert abs(float(raux) - float(taux)) <= 2 * AUX_TOL
        assert float(taux) > 0


def test_loss_fn_matches_reference(mixtral):
    """``loss_fn``'s value and metrics (forward only) with both MoE
    dispatches, the aux term weighted in."""
    rcfg, params, tcfg, model = mixtral
    toks = np.random.default_rng(7).integers(0, rcfg.vocab, (2, 33))
    for impl in ("capacity", "dense"):
        rl, rm = R_LOSS(params, rcfg, {"tokens": jnp.asarray(toks)},
                        moe_impl=impl)
        with torch.no_grad():
            tl, tm = TM.loss_fn(model, {"tokens": torch.from_numpy(toks)},
                                moe_impl=impl)
        assert abs(float(rl) - float(tl)) <= LOGITS_TOL, impl
        assert abs(float(rm["aux"]) - float(tm["aux"])) <= 2 * AUX_TOL
        assert float(rm["tokens"]) == float(tm["tokens"])


def test_moe_apply_rejects_what_the_reference_rejects():
    _, _, tcfg, mod = _layer("mixtral-8x22b", 1)
    x = torch.zeros(1, 3, tcfg.d_model)
    with pytest.raises(ValueError):
        TMoE.moe_apply(mod, x, tcfg, impl="sparse")
    with pytest.raises(ValueError, match="non-MoE"):
        TMoE.moe_apply(mod, x, TC.get_smoke_config("stablelm-1.6b"))
    with pytest.raises(ValueError, match="moe_virtual_split"):
        TMoE.MoE(tcfg.scaled(moe_virtual_split=3), torch.float32, CPU)
