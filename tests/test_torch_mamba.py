"""The port's Mamba block (``models/ssm.py``) and jamba-v0.1-52b's serving
path against the reference, on the CPU.

jamba-v0.1-52b's SMOKE configuration (one period of 8 layers: Mamba at
every position but 4, GQA attention there; d_model 128, di 256, d_state 4,
d_conv 4; 4 experts top-2 at the odd positions; float32), and the same at
16 layers (two periods) where a wrong period index would show.  The
reference's ``init_params`` tree (drawn once at 16 layers; its first
period is the SMOKE model) is carried across with
``convert.params_from_numpy``; inputs are drawn with numpy from fixed
seeds.  The two packages scan a chunk in different trees (the reference's
``lax.associative_scan`` against the port's doubling scan) and sum their
products in other orders, so float32 results are held to the tolerances
stated below; greedy tokens are held equal, with the reference's top-2
logit gap asserted at every compared position to exceed ten times the
logits' tolerance.
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
from repro.models import ssm as RS  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

ARCH = "jamba-v0.1-52b"
CPU = "cpu"
#: one Mamba layer's output and state (values of about 1): the two scans'
#: trees are at most log2(Q) = 7 combines deep (ulp 6e-8 each, two
#: roundings a combine), and in_proj's 128-wide float32 products are
#: summed in another order (an ulp or two of each x row, seen in the conv
#: state); measured 4e-7 at most
LAYER_TOL = 5e-6
#: the port against itself: another chunk size gives another tree over
#: the same rows, as the reference's test_ssm_chunk_invariance holds its
#: own; prefill plus decode steps against one train pass likewise
SELF_TOL = 5e-6
#: logits through 8 or 16 layers (about N(0, 1)), as tests/
#: test_torch_models.py; measured 1e-5
LOGITS_TOL = 3e-5
#: mean_logprob of the two packages, both ``compensated``
LOGPROB_TOL = 1e-4

#: the token width of every SMOKE forward here (one compiled shape)
FORWARD_LEN = 30

R_FORWARD = jax.jit(RM.forward, static_argnums=1,
                    static_argnames=("mode", "moe_impl"))
R_DECODE = jax.jit(RM.decode_step, static_argnums=1,
                   static_argnames="moe_impl")
R_MAMBA = jax.jit(RS.mamba_apply, static_argnums=2,
                  static_argnames=("mode", "chunk"))


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
    """(reference config, params, port config, model) at SMOKE (8 layers)
    and at 16 layers, from one reference draw at 16 layers."""
    rcfg16 = RC.get_smoke_config(ARCH).scaled(n_layers=16)
    cfg16 = TC.get_smoke_config(ARCH).scaled(n_layers=16)
    params16 = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg16)
    params8 = dict(params16, blocks=[jax.tree.map(lambda a: a[:1], b)
                                     for b in params16["blocks"]])
    rcfg, cfg = RC.get_smoke_config(ARCH), TC.get_smoke_config(ARCH)
    return {n: (r, p, c, convert.params_from_numpy(
                c, jax.tree.map(np.asarray, p), device=CPU))
            for n, r, p, c in ((8, rcfg, params8, cfg),
                               (16, rcfg16, params16, cfg16))}


def _close(ref, got, tol, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max())
    assert err <= tol, f"{what}: max |ref - port| = {err:g} > {tol:g}"


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n in lengths]


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _layer(setup):
    """Layer 0's reference leaves and Mamba module, and the configs."""
    rcfg, params, cfg, model = setup[8]
    rcore = jax.tree.map(lambda a: a[0], params["blocks"][0]["core"])
    return rcfg, rcore, cfg, model.blocks[0].core


def _x(seed, b, s, d=128):
    return np.random.default_rng(seed).standard_normal(
        (b, s, d)).astype(np.float32)


def _state(st):
    """A port ``MambaState`` holding a copy of the reference's state."""
    return TS.MambaState(torch.from_numpy(np.array(st.h)),
                         torch.from_numpy(np.array(st.conv)))


@pytest.mark.parametrize("s", (1, 2, 7, 40, 130))
def test_mamba_train_and_prefill_match_reference(setup, s):
    """``mamba_apply`` in train and prefill mode at chunks of 8 and 64
    rows (S = 130 ends in a ragged chunk at both; S = 1 and 2 are shorter
    than d_conv - 1, so the conv tail holds padding): y, the final h and
    the conv tail within LAYER_TOL of the reference's, train's y equal to
    prefill's."""
    rcfg, rcore, cfg, core = _layer(setup)
    x = _x(s, 2, s)
    for chunk in (8, 64):
        ry, rst = R_MAMBA(rcore, jnp.asarray(x), rcfg.mamba, mode="prefill",
                          chunk=chunk)
        ty, tst = TS.mamba_apply(core, torch.from_numpy(x), cfg.mamba,
                                 mode="prefill", chunk=chunk)
        _close(ry, ty, LAYER_TOL, f"S={s} chunk={chunk} y")
        assert isinstance(tst, TS.MambaState)
        assert tst.h.shape == (2, 256, 4) and tst.h.dtype == torch.float32
        assert tst.conv.shape == (2, 3, 256)
        _close(rst.h, tst.h, LAYER_TOL, f"S={s} chunk={chunk} h")
        _close(rst.conv, tst.conv, LAYER_TOL, f"S={s} chunk={chunk} conv")
        if s < 3:
            assert not tst.conv[:, :3 - s].any()
        train_y, none = TS.mamba_apply(core, torch.from_numpy(x), cfg.mamba,
                                       mode="train", chunk=chunk)
        assert none is None and torch.equal(train_y, ty)


def test_mamba_decode_steps_match_reference(setup):
    """From the reference's prefill state of 7 rows, five decode steps of
    three rows: each step's y and the state (h, conv) within LAYER_TOL of
    the reference's decode; the port's state is written in place and
    returned; more than one token a row raises."""
    rcfg, rcore, cfg, core = _layer(setup)
    x = _x(11, 3, 12)
    _, rst = R_MAMBA(rcore, jnp.asarray(x[:, :7]), rcfg.mamba,
                     mode="prefill")
    st = _state(rst)
    for i in range(7, 12):
        ry, rst = R_MAMBA(rcore, jnp.asarray(x[:, i:i + 1]), rcfg.mamba,
                          mode="decode", state=rst)
        h_buf = st.h
        ty, st = TS.mamba_apply(core, torch.from_numpy(x[:, i:i + 1]),
                                cfg.mamba, mode="decode", state=st)
        assert st.h is h_buf
        _close(ry, ty, LAYER_TOL, f"step {i} y")
        _close(rst.h, st.h, LAYER_TOL, f"step {i} h")
        _close(rst.conv, st.conv, LAYER_TOL, f"step {i} conv")
    with pytest.raises(ValueError, match="one token"):
        TS.mamba_apply(core, torch.from_numpy(x[:, :2]), cfg.mamba,
                       mode="decode", state=st)


def test_chunk_invariance_and_prefill_then_decode_match_train(setup):
    """The port against itself: chunks of 4, 8 and 512 rows over 33 rows
    give y and h within SELF_TOL; prefill of 20 rows plus 13 decode steps
    gives the same outputs and final state as one train pass over the 33
    rows, within SELF_TOL."""
    _, _, cfg, core = _layer(setup)
    x = torch.from_numpy(_x(33, 2, 33))
    y512, st512 = TS.mamba_apply(core, x, cfg.mamba, mode="prefill",
                                 chunk=512)
    for chunk in (4, 8):
        y, st = TS.mamba_apply(core, x, cfg.mamba, mode="prefill",
                               chunk=chunk)
        _close(y512, y, SELF_TOL, f"chunk {chunk} y")
        _close(st512.h, st.h, SELF_TOL, f"chunk {chunk} h")
    y, st = TS.mamba_apply(core, x[:, :20], cfg.mamba, mode="prefill",
                           chunk=8)
    outs = [y]
    for i in range(20, 33):
        yi, st = TS.mamba_apply(core, x[:, i:i + 1], cfg.mamba,
                                mode="decode", state=st)
        outs.append(yi)
    _close(y512, torch.cat(outs, dim=1), SELF_TOL, "prefill + decode y")
    _close(st512.h, st.h, SELF_TOL, "prefill + decode h")
    _close(st512.conv, st.conv, SELF_TOL, "prefill + decode conv")


def test_decode_active_mask_keeps_inactive_rows_bitwise(setup):
    """``active`` [True, False, True, False]: the inactive rows' h and
    conv stay bitwise as they were; the active rows' outputs and state
    equal an unmasked step's bitwise."""
    _, _, cfg, core = _layer(setup)
    x = torch.from_numpy(_x(5, 4, 9))
    _, st = TS.mamba_apply(core, x[:, :8], cfg.mamba, mode="prefill")
    free = TS.MambaState(st.h.clone(), st.conv.clone())
    masked = TS.MambaState(st.h.clone(), st.conv.clone())
    active = torch.tensor([True, False, True, False])
    y_free, _ = TS.mamba_apply(core, x[:, 8:], cfg.mamba, mode="decode",
                               state=free)
    y_mask, _ = TS.mamba_apply(core, x[:, 8:], cfg.mamba, mode="decode",
                               state=masked, active=active)
    for r in range(4):
        if active[r]:
            assert torch.equal(y_mask[r], y_free[r])
            assert torch.equal(masked.h[r], free.h[r])
            assert torch.equal(masked.conv[r], free.conv[r])
            assert not torch.equal(masked.h[r], st.h[r])
        else:
            assert torch.equal(masked.h[r], st.h[r])
            assert torch.equal(masked.conv[r], st.conv[r])


def test_init_params_fills_mamba_leaves_and_names_round_trip(setup):
    """``init_params`` sets a_log to log(1..d_state) on every channel,
    d_skip to ones, dt_bias and conv_b to zeros, with a_log, d_skip and
    dt_bias float32 in a bf16 model; conv_w is drawn at 1/d_conv; the
    model's parameter names map onto the reference tree's leaves and
    ``to_reference`` gives back the reference's own values, the float32
    leaves bitwise."""
    rcfg, params, cfg, model = setup[8]
    gen = torch.Generator().manual_seed(0)
    fresh = TM.init_params(cfg.scaled(dtype="bfloat16"), generator=gen,
                           device=CPU)
    core = fresh.blocks[0].core
    want = np.log(np.arange(1, 5, dtype=np.float32))
    assert core.a_log.shape == (256, 4)
    np.testing.assert_allclose(core.a_log.numpy(),
                               np.broadcast_to(want, (256, 4)), rtol=2e-7)
    assert torch.equal(core.a_log, core.a_log[:1].expand(256, 4))
    assert torch.equal(core.d_skip, torch.ones(256))
    assert not core.dt_bias.any() and not core.conv_b.any()
    assert {core.a_log.dtype, core.d_skip.dtype, core.dt_bias.dtype} \
        == {torch.float32}
    assert core.in_proj.dtype == core.conv_b.dtype == torch.bfloat16
    assert abs(float(core.conv_w.float().std()) - 0.25) < 0.02
    assert abs(float(core.in_proj.float().std()) - 128 ** -0.5) < 0.005
    leaves = dict(convert.reference_leaves(cfg))
    got_core = {p for p in leaves if p.startswith("blocks/0/core/")}
    assert got_core == {f"blocks/0/core/{n}" for n in (
        "in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias",
        "a_log", "d_skip", "out_proj")}
    got = convert.to_reference(cfg, dict(model.named_parameters()))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    assert set(got) == set(flat)
    for path, leaf in flat.items():
        assert np.array_equal(got[path].numpy(), leaf), path


@pytest.mark.parametrize("impl", ("capacity", "dense"))
def test_forward_logits_match_reference(setup, impl):
    """The whole SMOKE model's train-mode logits and aux, both MoE
    dispatches: within LOGITS_TOL."""
    rcfg, params, cfg, model = setup[8]
    toks = np.random.default_rng(7).integers(1, 512, (2, FORWARD_LEN))
    rl, _, raux = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks),
                            moe_impl=impl)
    tl, _, taux = TM.forward(model, tokens=torch.from_numpy(toks),
                             moe_impl=impl)
    _close(rl, tl, LOGITS_TOL, "logits")
    _close(raux, taux, 1e-5, "aux")


def test_decode_step_after_pad_matches_reference_two_periods(setup):
    """At 16 layers (two periods, so a wrong period index shows): prefill
    10 tokens, ``pad_caches_to`` 24 rows (the attention cache grows, each
    ``MambaState`` stays the object it was), then 8 decode steps: each
    step's logits within LOGITS_TOL of the reference's ``decode_step``,
    the Mamba states (inputs through up to 15 layers) within LOGITS_TOL,
    the attention lengths in step."""
    rcfg, params, cfg, model = setup[16]
    toks = np.random.default_rng(8).integers(1, 512, (2, 18))
    _, rc, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks[:, :10]),
                         mode="prefill", moe_impl="dense")
    _, tc, _ = TM.forward(model, tokens=torch.from_numpy(toks[:, :10]),
                          mode="prefill", moe_impl="dense")
    rc = RM.pad_caches_to(rcfg, rc, 24)
    padded = TM.pad_caches_to(cfg, tc, 24)
    for j, (a, b) in enumerate(zip(tc, padded)):
        if isinstance(a["core"], TS.MambaState):
            assert b["core"] is a["core"], j
    tc = padded
    assert tc[4]["core"].k.shape == (2, 2, 24, 2, 32)
    for i in range(10, 18):
        rl, rc = R_DECODE(params, rcfg, jnp.asarray(toks[:, i:i + 1]), rc,
                          jnp.asarray(i), moe_impl="dense")
        tl, tc = TM.decode_step(model, torch.from_numpy(toks[:, i:i + 1]),
                                tc, i, moe_impl="dense")
        _close(rl, tl, LOGITS_TOL, f"step {i}")
    for j in (0, 3, 7):
        _close(rc[j]["core"].h, tc[j]["core"].h, LOGITS_TOL, f"h {j}")
        _close(rc[j]["core"].conv, tc[j]["core"].conv, LOGITS_TOL,
               f"conv {j}")
    assert tc[4]["core"].length.tolist() == [[18, 18]] * 2


def test_init_caches_shapes_dtypes_and_cache_bytes(setup):
    """``init_caches`` builds a ``MambaState`` at each Mamba position (h
    float32 whatever ``dtype`` is, conv in ``dtype``) and a ``KVCache``
    at position 4, shaped as the reference's; ``cache_bytes`` counts
    them."""
    rcfg, _, cfg, _ = setup[16]
    ref = RM.init_caches(rcfg, 3, 40)
    got = TM.init_caches(cfg, 3, 40, device=CPU)
    n = cfg.n_periods
    for j, (r, g) in enumerate(zip(ref, got)):
        assert type(g["core"]).__name__ == type(r["core"]).__name__, j
        assert [tuple(t.shape) for t in g["core"]] \
            == [tuple(t.shape) for t in r["core"]], j
        assert not any(t.any() for t in g["core"])
    mamba = got[0]["core"]
    assert mamba.h.shape == (n, 3, 256, 4) and mamba.conv.shape == (n, 3, 3,
                                                                    256)
    half = TM.init_caches(cfg, 3, 40, device=CPU, dtype=torch.bfloat16)
    assert half[0]["core"].h.dtype == torch.float32
    assert half[0]["core"].conv.dtype == torch.bfloat16
    assert isinstance(got[4]["core"], TA.KVCache)
    assert TM.cache_bytes(got) == n * 3 * (
        7 * (256 * 4 + 3 * 256) * 4 + (2 * 40 * 2 * 32 * 4 + 4))


def test_engine_greedy_tokens_match_reference(setup):
    """The port's Engine against the reference Engine on SMOKE: the
    whole-prompt prefill (no extend path for a Mamba model), 10 greedy
    tokens for prompts of 2 (shorter than the conv's tail) and 21 tokens:
    tokens equal, mean_logprob within LOGPROB_TOL."""
    rcfg, params, cfg, model = setup[8]
    prompts = _prompts(0, (2, 21))
    ref = RE.Engine(rcfg, params, max_len=40).generate(
        [RE.Request(prompt=p, max_new_tokens=10) for p in prompts])
    eng = Engine(cfg, model, max_len=40, device=CPU)
    assert not eng._extend_ok
    got = eng.generate([Request(prompt=p, max_new_tokens=10)
                        for p in prompts])
    # the reference's logits over each result, in one causal forward
    # (each row padded at its end, which no earlier position sees)
    seqs = [r.tokens[:-1] for r in ref]
    logits = np.asarray(R_FORWARD(params, rcfg, tokens=jnp.asarray(
        [q + [0] * (FORWARD_LEN - len(q)) for q in seqs]),
        moe_impl="dense")[0])
    for i, (r, g) in enumerate(zip(ref, got)):
        gaps = _top2_gap(logits[i, r.prompt_len - 1:len(seqs[i]),
                                :rcfg.vocab])
        assert gaps.min() > 10 * LOGITS_TOL, gaps.min()
        assert g.tokens == r.tokens
        assert (g.prompt_len, g.rid, g.finish_reason) \
            == (r.prompt_len, r.rid, r.finish_reason)
        assert abs(g.mean_logprob - r.mean_logprob) <= LOGPROB_TOL


def test_engine_greedy_single_vs_batched_bitwise(setup):
    """Each request alone in the engine gives bitwise its batched tokens
    (its slot's state never sees its batchmates')."""
    _, _, cfg, model = setup[8]
    eng = Engine(cfg, model, max_len=48, device=CPU)
    reqs = [Request(prompt=p, max_new_tokens=10)
            for p in _prompts(2, (3, 30, 17))]
    batched = eng.generate(reqs)
    for req, res in zip(reqs, batched):
        assert eng.generate([req])[0].tokens == res.tokens


def test_serve_launcher_runs_jamba_smoke_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch jamba-v0.1-52b --smoke
    --device cpu`` serves its requests."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", CPU,
                           "--requests", "3", "--new-tokens", "8",
                           "--max-len", "64"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["req0", "req1", "req2"]
    assert all("+8 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("24 tokens in") and "on cpu" in lines[-1]
