"""The port's M-RoPE, its embedding-input forward and qwen2-vl-7b's serving
path against the reference, on the CPU.

qwen2-vl-7b's SMOKE configuration (2 layers, d_model 128, 4 heads on 2 KV
heads, hd 32, M-RoPE sections (4, 6, 6), float32), the reference's
``init_params`` tree carried across with ``convert.params_from_numpy``,
inputs drawn with numpy from fixed seeds.  Both packages compute each
function in the same order up to the summation order of their products
and their float32 cos and sin, so results are held to the tolerances
stated below; greedy tokens are held equal, with the reference's top-2
logit gap asserted at every compared position to exceed ten times the
logits' tolerance.  Within the port, M-RoPE with three equal streams is
bitwise RoPE.
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.kernels import ops as JK  # noqa: E402
from repro.launch import serve as ref_launch_serve  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ARCH = "qwen2-vl-7b"
CPU = "cpu"
#: one rotation of values of about 1: the same float32 angle in both
#: packages, their cos and sin within an ulp or two, a product and a sum
#: (measured: 3.0e-7)
ROPE_TOL = 1e-5
#: logits through two layers (about N(0, 1)), as tests/test_torch_models.py
#: (measured on embeds with a patch grid: 2.0e-6)
LOGITS_TOL = 2e-5
#: the loss (float32 xent of about 6.2, an ulp 4.8e-7) and every gradient
#: leaf, max |ref - port| over its largest |value|, as
#: tests/test_torch_train.py holds stablelm's
LOSS_ATOL = 8e-6
GRAD_REL = 1e-5
#: mean_logprob of the two packages, both ``compensated``
LOGPROB_TOL = 1e-4
#: K2's plain version against the reference's Pallas kernel in interpret
#: mode, as tests/test_torch_flash_decode.py holds them: float32 sums of
#: up to 1,024 terms in two orders
FD_RTOL, FD_ATOL = 1e-5, 1e-6

R_FORWARD = jax.jit(RM.forward, static_argnums=1,
                    static_argnames=("mode", "moe_impl"))
R_DECODE = jax.jit(RM.decode_step, static_argnums=1,
                   static_argnames="moe_impl")


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


def _rel_close(ref, got, rel, what=""):
    """max |ref - port| within ``rel`` of the largest |ref| (0 if ref is
    all zeros)."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max())
    assert err <= rel * float(np.abs(ref).max()), \
        f"{what}: max |ref - port| = {err:g} > {rel:g} of the largest"


def _toks(seed, shape, vocab=512):
    return np.random.default_rng(seed).integers(1, vocab, shape)


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n in lengths]


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def patch_grid_positions(n_before, grid, n_after):
    """(S, 3) int32 M-RoPE positions of one prompt: ``n_before`` text
    tokens (the three streams equal), a ``grid`` x ``grid`` patch grid at
    t = n_before holding (t, t + row, t + col), then ``n_after`` text
    tokens resuming at the largest position so far + 1."""
    text = np.repeat(np.arange(n_before)[:, None], 3, axis=1)
    t = n_before
    row, col = np.divmod(np.arange(grid * grid), grid)
    patches = np.stack([np.full_like(row, t), t + row, t + col], axis=1)
    start = t + grid
    after = np.repeat(np.arange(start, start + n_after)[:, None], 3, axis=1)
    return np.concatenate([text, patches, after]).astype(np.int32)


@pytest.mark.parametrize("hd", (32, 128))
def test_apply_mrope_matches_reference(hd):
    """``apply_mrope`` on random distinct (B, S, 3) positions at hd = 32
    (the SMOKE head) and 128 (qwen2-vl-7b's): within ROPE_TOL of the
    reference's; the section split is the reference's
    ``_rope_or_mrope``'s, (4, 6, 6) and (16, 24, 24)."""
    half = hd // 2
    s0 = max(1, round(half * 16 / 64))
    s1 = (half - s0) // 2
    want = (s0, s1, half - s0 - s1)
    assert TA.mrope_sections(hd) == want
    assert want == {32: (4, 6, 6), 128: (16, 24, 24)}[hd]
    rng = np.random.default_rng(hd)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (2, 12, 3)).astype(np.int32)
    ref = RL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, want)
    got = TL.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         want)
    _close(ref, got, ROPE_TOL, f"mrope hd={hd}")
    # the reference's attention picks the same split from the head
    ref_attn = RA._rope_or_mrope(jnp.asarray(x), jnp.asarray(pos),
                                 RC.get_smoke_config(ARCH))
    _close(ref_attn, got, ROPE_TOL, f"_rope_or_mrope hd={hd}")


def test_mrope_with_equal_streams_is_rope_bitwise():
    """Three equal streams: the M-RoPE tables and rotation are bitwise
    RoPE's, for hd = 32 and 128."""
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(rng.integers(0, 10 ** 5, (2, 40)).astype(
        np.int32))
    pos3 = pos[..., None].expand(2, 40, 3)
    for hd in (32, 128):
        x = torch.from_numpy(rng.standard_normal((2, 40, 4, hd)).astype(
            np.float32))
        secs = TA.mrope_sections(hd)
        for a, b in zip(TL.rope_tables(pos3, hd, 1e6, secs),
                        TL.rope_tables(pos, hd, 1e6)):
            assert torch.equal(a, b)
        assert torch.equal(TL.apply_mrope(x, pos3, 1e6, secs),
                           TL.apply_rope(x, pos, 1e6))


@pytest.mark.parametrize("offset", (5, (0, 7, 31)), ids=("scalar", "per-row"))
def test_default_positions_match_reference(setup, offset):
    """``_default_positions`` of an M-RoPE config: (B, S, 3) int32, equal
    to the reference's at a scalar offset and at a (B,) offset."""
    rcfg, _, cfg, _, _ = setup
    ref = np.asarray(RM._default_positions(rcfg, 3, 6,
                                           jnp.asarray(offset, jnp.int32)))
    got = TM._default_positions(cfg, 3, 6, torch.tensor(offset))
    assert got.shape == ref.shape == (3, 6, 3) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), ref)
    plain = TM._default_positions(TC.get_smoke_config("stablelm-1.6b"), 3,
                                  6, torch.tensor(offset))
    assert torch.equal(got, plain[..., None].expand(3, 6, 3))


def test_forward_logits_on_tokens_match_reference(setup):
    """The whole model's train-mode and prefill logits on tokens (default
    (B, S, 3) positions): within LOGITS_TOL; prefill's caches too."""
    rcfg, params, cfg, model, _ = setup
    toks = _toks(7, (2, 20))
    rl = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks))[0]
    tl = TM.forward(model, tokens=torch.from_numpy(toks))[0]
    _close(rl, tl, LOGITS_TOL, "train logits")
    rl, rc, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks),
                          mode="prefill")
    tl, tc, _ = TM.forward(model, tokens=torch.from_numpy(toks),
                           mode="prefill")
    _close(rl, tl, LOGITS_TOL, "prefill logits")
    _close(rc[0]["core"].k, tc[0]["core"].k, LOGITS_TOL, "prefill k cache")


def test_forward_on_embeds_with_a_patch_grid_matches_reference(setup):
    """``forward(embeds=, positions=)`` on random embeddings with a
    prompt's M-RoPE positions (5 text tokens, a 4 x 4 patch grid, 7 text
    tokens; distinct streams in the grid): within LOGITS_TOL of the
    reference's, in train and prefill mode; ``make_prefill_step`` on the
    same batch gives the last position's logits.  On the default
    positions, ``embeds = embed_lookup(tokens)`` is bitwise the token
    forward."""
    rcfg, params, cfg, model, _ = setup
    pos1 = patch_grid_positions(5, 4, 7)
    assert pos1.shape == (28, 3) and pos1[21:, 0].tolist() == list(
        range(9, 16))
    assert (pos1[5:21, 1] != pos1[5:21, 2]).any()
    pos = np.broadcast_to(pos1, (2, 28, 3)).copy()
    emb = np.random.default_rng(11).standard_normal(
        (2, 28, cfg.d_model)).astype(np.float32)
    for mode in ("train", "prefill"):
        rl = R_FORWARD(params, rcfg, embeds=jnp.asarray(emb),
                       positions=jnp.asarray(pos), mode=mode)[0]
        tl = TM.forward(model, embeds=torch.from_numpy(emb),
                        positions=torch.from_numpy(pos), mode=mode)[0]
        _close(rl, tl, LOGITS_TOL, f"{mode} logits on embeds")
    last, _ = TS.make_prefill_step(cfg, device=CPU)(
        model, {"embeds": emb, "positions": pos})
    _close(np.asarray(rl)[:, -1:], last, LOGITS_TOL, "prefill_step")
    toks = torch.from_numpy(_toks(12, (2, 28)))
    on_toks = TM.forward(model, tokens=toks)[0]
    on_emb = TM.forward(model, embeds=TL.embed_lookup(model.embed, toks),
                        positions=TM._default_positions(cfg, 2, 28))[0]
    assert torch.equal(on_toks, on_emb)


def test_loss_and_grads_on_an_embeds_batch_match_reference(setup):
    """``loss_fn`` on the reference's training batch (``embeds`` (B, S,
    D), ``labels`` (B, S), ``positions`` (B, S, 3) with a patch grid) and
    every gradient leaf against ``jax.value_and_grad``: the loss within
    LOSS_ATOL, each leaf within GRAD_REL of its largest value, in the
    reference's leaf order.  ``enc_embeds``, which a decoder-only model
    ignores as the reference does, leaves the loss bitwise the same."""
    rcfg, params, cfg, _, tree = setup
    rng = np.random.default_rng(13)
    pos = np.stack([patch_grid_positions(3, 3, 4),
                    patch_grid_positions(6, 3, 1)])
    batch = {"embeds": rng.standard_normal((2, 16, cfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32),
             "positions": pos}

    def ref_loss(p):
        return RM.loss_fn(p, rcfg, {k: jnp.asarray(v)
                                    for k, v in batch.items()})

    (rl, _), rg = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        params)
    model = convert.params_from_numpy(cfg, tree, device=CPU) \
        .requires_grad_(True)
    named = dict(model.named_parameters())
    tl, metrics = TM.loss_fn(model, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    grads = convert.to_reference(cfg, dict(zip(named, torch.autograd.grad(
        tl, list(named.values()), materialize_grads=True))))
    assert abs(float(rl) - float(tl.detach())) <= LOSS_ATOL
    assert float(metrics["tokens"]) == 32
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert list(grads) == ["/".join(str(getattr(k, "key", getattr(
        k, "idx", k))) for k in path) for path, _ in flat]
    for (path, ref), got in zip(flat, grads.values()):
        _rel_close(ref, got, GRAD_REL, f"grad {path}")
    assert not grads["embed"].any()         # the embeddings come as input
    with torch.no_grad():
        plain, _ = TM.loss_fn(model, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        with_enc, _ = TM.loss_fn(model, dict(
            {k: torch.from_numpy(v) for k, v in batch.items()},
            enc_embeds=torch.ones(2, 16, 128)))
    assert torch.equal(plain, with_enc)
    assert torch.equal(plain, tl.detach())


def test_train_step_on_an_embeds_batch_matches_reference(setup):
    """One ``make_train_step`` step in two juggler microbatches (remat
    on) on an ``embeds``, ``labels``, (B, S, 3) ``positions`` batch
    against the reference's jitted step: the loss within LOSS_ATOL, the
    grad norm to 1e-6, every AdamW moment leaf within GRAD_REL of its
    largest value; the embedding's moments zero in both."""
    rcfg, params, cfg, _, tree = setup
    rng = np.random.default_rng(14)
    batch = {"embeds": rng.standard_normal((4, 12, cfg.d_model)).astype(
                 np.float32),
             "labels": rng.integers(0, cfg.vocab, (4, 12)).astype(np.int32),
             "positions": np.stack([patch_grid_positions(n, 2, 8 - n)
                                    for n in (0, 1, 3, 8)])}
    ref_step = jax.jit(RS.make_train_step(
        rcfg, lr_fn=RO.cosine_schedule(1e-2, 1, 5), num_microbatches=2))
    _, rs, rmet = ref_step(params, RO.init(params),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.params_from_numpy(cfg, tree, device=CPU)
    step = TS.make_train_step(cfg, lr_fn=TO.cosine_schedule(1e-2, 1, 5),
                              num_microbatches=2, device=CPU)
    _, ts, tmet = step(model, TS.init_state(model), batch)
    assert abs(float(tmet["loss"]) - float(rmet["loss"])) <= LOSS_ATOL
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(rmet["grad_norm"]), rel=1e-6)
    for name in ("mu", "nu"):
        refs = jax.tree.leaves(getattr(rs, name))
        gots = list(getattr(ts, name).values())
        assert len(refs) == len(gots)
        for r, g in zip(refs, gots):
            _rel_close(r, g, GRAD_REL, name)
    assert not np.asarray(rs.mu["embed"]).any()
    assert not ts.mu["embed"].any()


def test_decode_steps_after_prefill_and_pad_match_reference(setup):
    """Prefill 10 tokens, ``pad_caches_to`` 24 rows, then an extend of 4
    tokens and 6 single-token decode steps (positions from the scalar
    offset, the streams equal), then one step at per-row (B,) offsets:
    each step's logits within LOGITS_TOL of the reference's
    ``decode_step``, the caches' lengths in step."""
    rcfg, params, cfg, model, _ = setup
    toks = _toks(8, (2, 21))
    _, rc, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks[:, :10]),
                         mode="prefill")
    _, tc, _ = TM.forward(model, tokens=torch.from_numpy(toks[:, :10]),
                          mode="prefill")
    rc = RM.pad_caches_to(rcfg, rc, 24)
    tc = TM.pad_caches_to(cfg, tc, 24)
    assert tc[0]["core"].k.shape == (cfg.n_periods, 2, 24, cfg.n_kv_heads,
                                     cfg.hdim)
    for lo, hi in ((10, 14),) + tuple((i, i + 1) for i in range(14, 20)):
        rl, rc = R_DECODE(params, rcfg, jnp.asarray(toks[:, lo:hi]), rc,
                          jnp.asarray(lo))
        tl, tc = TM.decode_step(model, torch.from_numpy(toks[:, lo:hi]),
                                tc, lo)
        _close(rl, tl, LOGITS_TOL, f"step {lo}:{hi}")
    at = np.array([20, 20], np.int32)
    rl, rc = R_DECODE(params, rcfg, jnp.asarray(toks[:, 20:]), rc,
                      jnp.asarray(at))
    tl, tc = TM.decode_step(model, torch.from_numpy(toks[:, 20:]), tc,
                            torch.from_numpy(at))
    _close(rl, tl, LOGITS_TOL, "step at (B,) offsets")
    assert tc[0]["core"].length.tolist() == [[21, 21]] * cfg.n_periods


def test_engine_greedy_tokens_match_reference(setup):
    """The port's Engine against the reference Engine on tokens: the
    chunked extend prefill (prompts of one, two and three 32-token
    chunks), 12 greedy tokens each: tokens equal, mean_logprob within
    LOGPROB_TOL."""
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
        logits = np.asarray(R_FORWARD(params, rcfg, tokens=seq)[0])[0]
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


def test_k2_plain_version_at_seven_query_heads_per_kv_head():
    """K2's plain version at G = 7 (H = 14, K = 2, d = 128; qwen2-vl-7b's
    group) against the reference's ``flash_decode`` in interpret mode,
    with a request of kv_len 0 and a window: within FD_RTOL / FD_ATOL;
    the CUDA kernel's grouping takes one group of the 7 rows."""
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    assert fd.group_rows(7) == 7
    rng = np.random.RandomState(17)
    b, h, kh, s, d = 3, 14, 2, 1000, 128
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, s, kh, d).astype(np.float32)
    v = rng.randn(b, s, kh, d).astype(np.float32)
    kv_len = np.array([0, 517, 1000], np.int32)
    for window in (None, 200):
        want = JK.flash_decode(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(kv_len),
                               sm_scale=d ** -0.5, window=window,
                               block_kv=256)
        got = TK.flash_decode(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), torch.tensor(kv_len),
                              sm_scale=d ** -0.5, window=window,
                              block_kv=256, device=CPU)
        assert got.shape == (b, h, d)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FD_RTOL, atol=FD_ATOL)


def test_params_from_numpy_round_trips_the_qwen2vl_tree(setup):
    """The reference's qwen2-vl ``init_params`` tree has no leaf beyond
    GQA and SwiGLU: ``params_from_numpy`` loads every leaf and
    ``to_reference`` gives back the reference's own values; the model
    holds ``param_counts()`` plus its norms, at SMOKE and (on the meta
    device) at full width."""
    rcfg, params, cfg, model, _ = setup
    got = convert.to_reference(cfg, dict(model.named_parameters()))
    flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}
    assert set(got) == set(flat)
    for path, leaf in flat.items():
        assert np.array_equal(got[path].numpy(), leaf), path
    for c, m in ((cfg, model),
                 (TC.get_config(ARCH), TM.init_params(TC.get_config(ARCH),
                                                      device="meta"))):
        norms = (2 * c.n_layers + 1) * c.d_model
        assert sum(p.numel() for p in m.parameters()) \
            == c.param_counts()["total"] + norms
    assert TC.get_config(ARCH).param_counts()["total"] == 7_615_283_200


def test_serve_launcher_refuses_as_the_reference_does(capsys):
    """``python -m repro_torch.launch.serve --arch qwen2-vl-7b --smoke
    --device cpu`` exits with the reference launcher's message (its
    demo serves token language models), before drawing any weight."""
    argv = ["--arch", ARCH, "--smoke"]
    with pytest.raises(SystemExit) as ref:
        ref_launch_serve.main(argv)
    with pytest.raises(SystemExit) as got:
        launch_serve.main(argv + ["--device", CPU])
    assert str(got.value) == str(ref.value) \
        == "qwen2-vl-7b: serve demo targets token-LM archs"
    assert capsys.readouterr().out == ""
