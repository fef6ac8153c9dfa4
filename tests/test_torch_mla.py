"""The port's multi-head latent attention (MLA) and deepseek-v2-lite-16b's
serving path against the reference, on the CPU.

deepseek-v2-lite-16b's SMOKE configuration (2 layers, d_model 128, 4
heads, latent rank r = 32, nd = 16, rd = 8, vd = 16, 8 experts top-2 and a
shared one, float32), the reference's ``init_params`` tree carried across
with ``convert.params_from_numpy``, inputs drawn with numpy from fixed
seeds.  Each comparison is against the reference's own mode (unabsorbed
train and prefill, absorbed decode and extend), so both sides compute the
same function in the same order up to the summation order of their
products: float32 results are held to the tolerances stated below.
Greedy tokens are held equal, with the reference's top-2 logit gap
asserted at every compared position to exceed ten times the logits'
tolerance.
"""

import contextlib
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

ARCH = "deepseek-v2-lite-16b"
CPU = "cpu"
#: one MLA layer's output and latent cache (values of about 1): float32
#: products of width 128 or less, summed in another order
ATTN_TOL = 1e-5
#: logits through two layers (about N(0, 1)), as tests/test_torch_models.py
LOGITS_TOL = 2e-5
#: mean_logprob of the two packages, both ``compensated``
LOGPROB_TOL = 1e-4

R_FORWARD = jax.jit(RM.forward, static_argnums=1,
                    static_argnames=("mode", "moe_impl"))
R_DECODE = jax.jit(RM.decode_step, static_argnums=1,
                   static_argnames="moe_impl")
R_MLA = jax.jit(RA.mla_apply, static_argnums=2, static_argnames="mode")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These are small CPU computations: one intra-op thread each, so the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    rcfg = RC.get_smoke_config(ARCH)
    params = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    cfg = TC.get_smoke_config(ARCH)
    tree = jax.tree.map(np.asarray, params)
    model = convert.params_from_numpy(cfg, tree, device=CPU)
    return rcfg, params, cfg, model, tree


def _close(ref, got, tol, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max())
    assert err <= tol, f"{what}: max |ref - port| = {err:g} > {tol:g}"


def _toks(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, shape)


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n in lengths]


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _layer(setup, **kw):
    """Layer 0's reference leaves and MLA module, and both packages'
    configurations with the fields ``kw`` changed."""
    rcfg, params, cfg, model, _ = setup
    rcore = jax.tree.map(lambda a: a[0], params["blocks"][0]["core"])
    return rcfg.scaled(**kw), rcore, cfg.scaled(**kw), model.blocks[0].core


@pytest.mark.parametrize("mode", ("train", "prefill"))
@pytest.mark.parametrize("s,qchunk", ((12, 1024), (24, 8)))
def test_mla_train_and_prefill_match_reference(setup, mode, s, qchunk):
    """``mla_apply`` unabsorbed, below ``attn_qchunk`` and above it (s =
    24 in three 8-query chunks): the output within ATTN_TOL, and
    prefill's ``MLACache`` (c_kv (B, s, r), k_rope (B, s, rd), length s)
    too."""
    rcfg, rcore, cfg, core = _layer(setup, attn_qchunk=qchunk)
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    rout, rc = R_MLA(rcore, jnp.asarray(x), rcfg, positions=jnp.asarray(pos),
                     mode=mode)
    tout, tc = TA.mla_apply(core, torch.from_numpy(x), cfg,
                            positions=torch.from_numpy(pos.copy()),
                            mode=mode)
    _close(rout, tout, ATTN_TOL, f"{mode} out")
    if mode == "train":
        assert tc is None
        return
    assert isinstance(tc, TA.MLACache)
    assert tc.c_kv.shape == (2, s, cfg.kv_lora_rank)
    assert tc.k_rope.shape == (2, s, cfg.qk_rope_dim)
    _close(rc.c_kv, tc.c_kv, ATTN_TOL, "c_kv")
    _close(rc.k_rope, tc.k_rope, ATTN_TOL, "k_rope")
    assert tc.length.tolist() == [s, s]


@pytest.mark.parametrize("s", (1, 4))
def test_mla_decode_and_extend_match_reference(setup, s):
    """Absorbed decode (s = 1) and a 4-token extend on three rows at
    lengths 5, 9 and 3 of a 16-row latent cache holding random values:
    the active rows' output, c_kv, k_rope and length within ATTN_TOL of
    the reference's; the inactive row's cache and length unchanged."""
    rcfg, rcore, cfg, core = _layer(setup)
    rng = np.random.default_rng(40 + s)
    b, t = 3, 16
    c_kv = rng.standard_normal((b, t, cfg.kv_lora_rank)).astype(np.float32)
    k_rope = rng.standard_normal((b, t, cfg.qk_rope_dim)).astype(np.float32)
    length = np.asarray([5, 9, 3], np.int32)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    pos = length[:, None] + np.arange(s, dtype=np.int32)[None, :]
    rout, rc = R_MLA(rcore, jnp.asarray(x), rcfg, positions=jnp.asarray(pos),
                     mode="decode", cache=RA.MLACache(
                         jnp.asarray(c_kv), jnp.asarray(k_rope),
                         jnp.asarray(length)))
    cache = TA.MLACache(torch.from_numpy(c_kv.copy()),
                        torch.from_numpy(k_rope.copy()),
                        torch.from_numpy(length.copy()))
    active = torch.tensor([True, False, True])
    tout, tc = TA.mla_apply(core, torch.from_numpy(x), cfg,
                            positions=torch.from_numpy(pos), mode="decode",
                            cache=cache, active=active)
    for row in (0, 2):
        _close(np.asarray(rout)[row], tout[row], ATTN_TOL, f"row {row} out")
        _close(np.asarray(rc.c_kv)[row], tc.c_kv[row], ATTN_TOL, "c_kv")
        _close(np.asarray(rc.k_rope)[row], tc.k_rope[row], ATTN_TOL,
               "k_rope")
    assert tc.length.tolist() == [5 + s, 9, 3 + s]
    assert np.array_equal(tc.c_kv[1].numpy(), c_kv[1])
    assert np.array_equal(tc.k_rope[1].numpy(), k_rope[1])


@pytest.mark.parametrize("impl", ("capacity", "dense"))
def test_forward_logits_match_reference(setup, impl):
    """The whole model's train-mode logits and aux, both MoE dispatches:
    within LOGITS_TOL."""
    rcfg, params, cfg, model, _ = setup
    toks = _toks(7, (2, 20))
    rl, _, raux = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks),
                            moe_impl=impl)
    tl, _, taux = TM.forward(model, tokens=torch.from_numpy(toks),
                             moe_impl=impl)
    _close(rl, tl, LOGITS_TOL, "logits")
    _close(raux, taux, 1e-5, "aux")


def test_decode_steps_after_prefill_and_pad_match_reference(setup):
    """Prefill 10 tokens, ``pad_caches_to`` 24 rows (the latent cache
    grows with zero rows), then an extend of 4 tokens and 6 single-token
    decode steps: each step's logits within LOGITS_TOL of the
    reference's ``decode_step``, the caches' lengths in step."""
    rcfg, params, cfg, model, _ = setup
    toks = _toks(8, (2, 20))
    _, rc, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks[:, :10]),
                         mode="prefill", moe_impl="dense")
    _, tc, _ = TM.forward(model, tokens=torch.from_numpy(toks[:, :10]),
                          mode="prefill", moe_impl="dense")
    rc = RM.pad_caches_to(rcfg, rc, 24)
    tc = TM.pad_caches_to(cfg, tc, 24)
    core = tc[0]["core"]
    assert isinstance(core, TA.MLACache)
    assert core.c_kv.shape == (cfg.n_periods, 2, 24, cfg.kv_lora_rank)
    assert core.k_rope.shape == (cfg.n_periods, 2, 24, cfg.qk_rope_dim)
    assert not core.c_kv[:, :, 10:].any()
    _close(rc[0]["core"].c_kv, core.c_kv, ATTN_TOL, "padded c_kv")
    for lo, hi in ((10, 14),) + tuple((i, i + 1) for i in range(14, 20)):
        rl, rc = R_DECODE(params, rcfg, jnp.asarray(toks[:, lo:hi]), rc,
                          jnp.asarray(lo), moe_impl="dense")
        tl, tc = TM.decode_step(model, torch.from_numpy(toks[:, lo:hi]), tc,
                                lo, moe_impl="dense")
        _close(rl, tl, LOGITS_TOL, f"step {lo}:{hi}")
    assert tc[0]["core"].length.tolist() == [[20, 20]] * cfg.n_periods


def test_latent_rmsnorm_policy_matches_reference(setup):
    """With ``norm_reduce_policy="exact"`` every rmsnorm, the latent's
    included, goes through the front door (``blocked`` on the CPU): the
    model's logits within LOGITS_TOL of the reference's."""
    rcfg, params, cfg, _, tree = setup
    rcfg = rcfg.scaled(norm_reduce_policy="exact")
    cfg = cfg.scaled(norm_reduce_policy="exact")
    model = convert.params_from_numpy(cfg, tree, device=CPU)
    toks = _toks(9, (1, 12))
    rl = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks),
                   moe_impl="dense")[0]
    tl = TM.forward(model, tokens=torch.from_numpy(toks),
                    moe_impl="dense")[0]
    _close(rl, tl, LOGITS_TOL, "logits under exact norms")


def test_engine_greedy_tokens_match_reference(setup):
    """The port's Engine against the reference Engine: the chunked
    extend prefill (prompts of one, two and three 32-token chunks), 12
    greedy tokens each: tokens equal, mean_logprob within LOGPROB_TOL."""
    rcfg, params, cfg, model, _ = setup
    prompts = _prompts(0, (5, 32, 45, 70))
    ref = RE.Engine(rcfg, params, max_len=96).generate(
        [RE.Request(prompt=p, max_new_tokens=12) for p in prompts])
    eng = Engine(cfg, model, max_len=96, device=CPU)
    assert eng._extend_ok
    got = eng.generate([Request(prompt=p, max_new_tokens=12)
                        for p in prompts])
    for r, g in zip(ref, got):
        seq = jnp.asarray([r.tokens[:-1]])
        logits = np.asarray(R_FORWARD(params, rcfg, tokens=seq,
                                      moe_impl="dense")[0])[0]
        gaps = _top2_gap(logits[r.prompt_len - 1:, :rcfg.vocab])
        assert gaps.min() > 10 * LOGITS_TOL, gaps.min()
        assert g.tokens == r.tokens
        assert (g.prompt_len, g.rid, g.finish_reason) \
            == (r.prompt_len, r.rid, r.finish_reason)
        assert abs(g.mean_logprob - r.mean_logprob) <= LOGPROB_TOL


def test_engine_greedy_single_vs_batched_bitwise(setup):
    _, _, cfg, model, _ = setup
    eng = Engine(cfg, model, max_len=64, device=CPU)
    reqs = [Request(prompt=p, max_new_tokens=10)
            for p in _prompts(2, (3, 33, 20))]
    batched = eng.generate(reqs)
    for req, res in zip(reqs, batched):
        assert eng.generate([req])[0].tokens == res.tokens


def test_init_params_fills_c_norm_with_ones_and_names_round_trip(setup):
    """``init_params`` draws every projection and fills each norm with
    ones, MLA's latent ``c_norm`` included; the model's parameter names
    map onto the reference tree's leaves (``reference_leaves``) and
    ``to_reference`` gives back the reference's own values."""
    rcfg, params, cfg, model, _ = setup
    gen = torch.Generator().manual_seed(0)
    fresh = TM.init_params(cfg, generator=gen, device=CPU)
    for blk in fresh.blocks:
        assert torch.equal(blk.core.c_norm, torch.ones(cfg.kv_lora_rank))
        assert float(blk.core.wuk.std()) > 0.1
    leaves = dict(convert.reference_leaves(cfg))
    core = {p for p in leaves if p.startswith("blocks/0/core/")}
    assert core == {f"blocks/0/core/{n}" for n in
                    ("wq", "wdkv", "wkr", "wuk", "wuv", "wo", "c_norm")}
    got = convert.to_reference(cfg, dict(model.named_parameters()))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    assert set(got) == set(flat)
    for path, leaf in flat.items():
        assert np.array_equal(got[path].numpy(), leaf), path


def test_init_caches_shapes_dtype_and_cache_bytes(setup):
    """An MLA model's cache is an ``MLACache``: c_kv (n, B, T, r) and
    k_rope (n, B, T, rd), float32 by default (or the dtype asked for),
    zeroed, and ``cache_bytes`` counts its three tensors."""
    _, _, cfg, _, _ = setup
    caches = TM.init_caches(cfg, 3, 40, device=CPU)
    core = caches[0]["core"]
    n = cfg.n_periods
    assert isinstance(core, TA.MLACache)
    assert core.c_kv.shape == (n, 3, 40, cfg.kv_lora_rank)
    assert core.k_rope.shape == (n, 3, 40, cfg.qk_rope_dim)
    assert core.length.shape == (n, 3) and core.length.dtype == torch.int32
    assert core.c_kv.dtype == core.k_rope.dtype == torch.float32
    assert not core.c_kv.any() and not core.k_rope.any()
    assert TM.cache_bytes(caches) \
        == n * 3 * (40 * (cfg.kv_lora_rank + cfg.qk_rope_dim) * 4 + 4)
    half = TM.init_caches(cfg, 3, 40, device=CPU, dtype=torch.bfloat16)
    assert half[0]["core"].c_kv.dtype == torch.bfloat16


def test_serve_launcher_runs_deepseek_smoke_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch deepseek-v2-lite-16b
    --smoke --device cpu`` serves its requests."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", CPU,
                           "--requests", "3", "--new-tokens", "8",
                           "--max-len", "64"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["req0", "req1", "req2"]
    assert all("+8 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("24 tokens in") and "on cpu" in lines[-1]
