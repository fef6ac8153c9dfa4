"""The port's encoder-decoder (seamless-m4t-large-v2) against the
reference, on the CPU: the non-causal encoder, the decoder's
cross-attention in train, prefill and decode mode, ``enc_embeds`` in the
prefill step, the loss and a train step.

seamless-m4t-large-v2's SMOKE configuration (2 encoder and 2 decoder
layers, d_model 128, 4 heads on 4 KV heads, hd 32, d_ff 256, float32), the
reference's ``init_params`` tree carried across with
``convert.params_from_numpy``, inputs drawn with numpy from fixed seeds.
The encoder memory stands for the stub speech frontend's output: random
(B, T, D) ``enc_embeds``.  Both packages compute each function in the
same order up to the summation order of their products; a decode step's
cross-attention runs through K2's plain version here (its split and merge
order), where the reference runs a materialized softmax, so results are
held to the tolerances stated below.  Greedy tokens are held equal, with
the reference's top-2 logit gap asserted at every compared position to
exceed ten times the logits' tolerance.
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
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RO  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.kernels import ops as TK  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TO  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ARCH = "seamless-m4t-large-v2"
CPU = "cpu"
#: the encoder memory (two non-causal layers and a final rmsnorm, values
#: of about 1) and the logits through two decoder layers with
#: cross-attention (about N(0, 1)), as tests/test_torch_qwen2vl.py holds
#: its logits (measured: 1.4e-6 the memory, 2.5e-6 the logits)
LOGITS_TOL = 2e-5
#: the loss (float32 xent of about 6.2, an ulp 4.8e-7) and every gradient
#: leaf, the encoder's included, max |ref - port| over its largest
#: |value|, as tests/test_torch_train.py holds stablelm's
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
R_ENCODE = jax.jit(RM.encode, static_argnums=1, static_argnames="remat")


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


def _memory(seed, b, t, d=128):
    """Random ``enc_embeds`` (B, T, D) float32: the stub frontend's
    output."""
    return np.random.default_rng(seed).standard_normal((b, t, d)).astype(
        np.float32)


def _paths(tree):
    return ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _grads(model, batch, remat):
    """The port's loss and every gradient leaf in the reference's
    layout."""
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = TM.loss_fn(model, {k: torch.from_numpy(v)
                                       for k, v in batch.items()},
                               remat=remat)
    grads = convert.to_reference(model.cfg, dict(zip(named, torch.autograd
                                                     .grad(loss, list(
                                                         named.values())))))
    model.requires_grad_(False)
    return loss.detach(), metrics, grads


def test_leaf_paths_order_and_round_trip(setup):
    """The reference tree's 25 leaves, the encoder's (stacked on a leading
    ``encoder_layers`` axis) and the decoder's cross-attention and
    ``norm_x`` among them: ``reference_leaves`` lists them in
    ``jax.tree.leaves`` order, ``to_reference`` gives back the reference's
    own values, ``nest`` its nesting (the encoder's ``blocks`` a dict) and
    ``params_from_numpy`` refuses a wrong encoder depth."""
    rcfg, params, cfg, model, tree = setup
    want = _paths(params)
    assert [p for p, _ in convert.reference_leaves(cfg)] == want
    assert {"blocks/0/cross/wk", "blocks/0/norm_x", "encoder/final_norm",
            "encoder/blocks/core/wq", "encoder/blocks/mlp/wi"} <= set(want)
    got = convert.to_reference(cfg, dict(model.named_parameters()))
    assert list(got) == want
    for path, leaf in zip(want, jax.tree.leaves(params)):
        assert np.array_equal(got[path].numpy(), np.asarray(leaf)), path
    assert got["encoder/blocks/core/wq"].shape == (2, 128, 128)
    nested = convert.nest(got)
    assert isinstance(nested["encoder"]["blocks"], dict)
    assert isinstance(nested["blocks"], list)
    bad = dict(tree, encoder=dict(tree["encoder"], blocks=jax.tree.map(
        lambda a: a[:1], tree["encoder"]["blocks"])))
    with pytest.raises(ValueError, match="encoder/blocks"):
        convert.params_from_numpy(cfg, bad, device=CPU)


@pytest.mark.parametrize("t,qchunk", ((16, None), (32, 8)),
                         ids=("plain", "chunked"))
def test_encode_matches_reference(setup, t, qchunk):
    """``encode`` on random ``enc_embeds`` against the reference's: at T =
    16 (one non-causal zero mask) and at T = 32 with ``attn_qchunk`` = 8,
    which takes the chunked non-causal path on both sides; within
    LOGITS_TOL, in float32 and of shape (B, T, D)."""
    rcfg, params, cfg, model, tree = setup
    if qchunk is not None:
        rcfg, cfg = rcfg.scaled(attn_qchunk=qchunk), \
            cfg.scaled(attn_qchunk=qchunk)
        model = convert.params_from_numpy(cfg, tree, device=CPU)
    emb = _memory(t, 2, t)
    ref = R_ENCODE(params, rcfg, jnp.asarray(emb))
    got = TM.encode(model, torch.from_numpy(emb))
    assert got.shape == (2, t, cfg.d_model) and got.dtype == torch.float32
    _close(ref, got, LOGITS_TOL, f"encode T={t}")


def test_forward_with_enc_out_matches_reference(setup):
    """The whole decoder's train-mode and prefill logits with the
    cross-attention reading the memory (``forward(enc_out=)``), and
    prefill's self-attention caches: within LOGITS_TOL of the reference's.
    Without ``enc_out`` the decoder runs alone on both sides (the
    cross-attention skipped), and another memory moves the logits."""
    rcfg, params, cfg, model, _ = setup
    emb = _memory(1, 2, 24)
    rmem = R_ENCODE(params, rcfg, jnp.asarray(emb))
    tmem = TM.encode(model, torch.from_numpy(emb))
    toks = _toks(7, (2, 20))
    for mode in ("train", "prefill"):
        rl, rc, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks),
                              mode=mode, enc_out=rmem)
        tl, tc, _ = TM.forward(model, tokens=torch.from_numpy(toks),
                               mode=mode, enc_out=tmem)
        _close(rl, tl, LOGITS_TOL, f"{mode} logits")
    _close(rc[0]["core"].k, tc[0]["core"].k, LOGITS_TOL, "prefill k cache")
    _close(rc[0]["core"].v, tc[0]["core"].v, LOGITS_TOL, "prefill v cache")
    alone = TM.forward(model, tokens=torch.from_numpy(toks))[0]
    _close(R_FORWARD(params, rcfg, tokens=jnp.asarray(toks))[0], alone,
           LOGITS_TOL, "decoder alone")
    swapped = TM.forward(model, tokens=torch.from_numpy(toks),
                         enc_out=tmem.flip(0))[0]
    assert float((swapped - tl).abs().max()) > 1e-2


def test_prefill_step_encodes_enc_embeds_as_the_reference(setup):
    """``make_prefill_step`` on a batch with ``tokens`` and
    ``enc_embeds``: the last position's logits and the caches within
    LOGITS_TOL of the reference's prefill step."""
    rcfg, params, cfg, model, _ = setup
    batch = {"tokens": _toks(3, (3, 10)), "enc_embeds": _memory(3, 3, 20)}
    rl, rc = jax.jit(RS.make_prefill_step(rcfg))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    tl, tc = TS.make_prefill_step(cfg, device=CPU)(model, batch)
    assert tl.shape == (3, 1, cfg.padded_vocab)
    _close(rl, tl, LOGITS_TOL, "prefill_step logits")
    for j, (r, t) in enumerate(zip(rc, tc)):
        for name in ("k", "v", "length"):
            _close(getattr(r["core"], name), getattr(t["core"], name),
                   LOGITS_TOL, f"cache {j} {name}")


def test_decode_steps_with_enc_out_match_reference(setup):
    """Prefill 10 tokens against a 40-row memory, ``pad_caches_to`` 24
    rows, then an extend of 4 tokens (the cross-attention in train mode on
    both sides) and 6 single-token steps (the port's cross-attention
    through ``DecodeAttention``, K2's plain version here), then a step at
    per-row (B,) offsets, all through ``make_decode_step(enc_out=)``: each
    step's logits within LOGITS_TOL of the reference's ``decode_step``,
    the caches' lengths in step."""
    rcfg, params, cfg, model, _ = setup
    toks = _toks(8, (2, 21))
    emb = _memory(8, 2, 40)
    rmem = R_ENCODE(params, rcfg, jnp.asarray(emb))
    tmem = TM.encode(model, torch.from_numpy(emb))
    _, rc, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks[:, :10]),
                         mode="prefill", enc_out=rmem)
    _, tc, _ = TM.forward(model, tokens=torch.from_numpy(toks[:, :10]),
                          mode="prefill", enc_out=tmem)
    rc = RM.pad_caches_to(rcfg, rc, 24)
    tc = TM.pad_caches_to(cfg, tc, 24)
    dstep = TS.make_decode_step(cfg, device=CPU)
    for lo, hi in ((10, 14),) + tuple((i, i + 1) for i in range(14, 20)):
        rl, rc = R_DECODE(params, rcfg, jnp.asarray(toks[:, lo:hi]), rc,
                          jnp.asarray(lo), enc_out=rmem)
        tl, tc = dstep(model, toks[:, lo:hi], tc, lo, enc_out=tmem)
        _close(rl, tl, LOGITS_TOL, f"step {lo}:{hi}")
    at = np.array([20, 20], np.int32)
    rl, rc = R_DECODE(params, rcfg, jnp.asarray(toks[:, 20:]), rc,
                      jnp.asarray(at), enc_out=rmem)
    tl, tc = dstep(model, toks[:, 20:], tc, torch.from_numpy(at),
                   enc_out=tmem)
    _close(rl, tl, LOGITS_TOL, "step at (B,) offsets")
    assert tc[0]["core"].length.tolist() == [[21, 21]] * cfg.n_periods


def test_cross_decode_step_runs_decode_attention_on_the_whole_memory(
        setup):
    """A decode step at s = 1 sends each layer's cross-attention through
    its ``DecodeAttention`` (the module K2 runs under on a CUDA device):
    q (B, H, hd), the memory's keys and values (B, T, K, hd) contiguous
    float32, ``kv_len`` T on every row; its output is K2's plain version
    on those inputs bitwise, and within LOGITS_TOL of the reference's
    materialized softmax over the same query and memory.  An extend (s >
    1) does not call it."""
    rcfg, params, cfg, model, _ = setup
    seen = []

    def tap(mod, args, out):
        seen.append((args, out))

    hooks = [b.cross.decode_attn.register_forward_hook(tap)
             for b in model.blocks]
    mem = TM.encode(model, torch.from_numpy(_memory(9, 2, 30)))
    _, caches, _ = TM.forward(model, tokens=torch.from_numpy(
        _toks(9, (2, 6))), mode="prefill", enc_out=mem)
    caches = TM.pad_caches_to(cfg, caches, 12)
    TM.decode_step(model, torch.from_numpy(_toks(10, (2, 3))), caches, 6,
                   enc_out=mem)
    assert not seen
    TM.decode_step(model, torch.from_numpy(_toks(11, (2, 1))), caches, 9,
                   enc_out=mem)
    for hk in hooks:
        hk.remove()
    assert len(seen) == cfg.n_layers
    (q, k, v, kv_len, sc), out = seen[-1]
    assert q.shape == (2, cfg.n_heads, cfg.hdim)
    assert k.shape == v.shape == (2, 30, cfg.n_kv_heads, cfg.hdim)
    assert k.dtype == v.dtype == torch.float32
    assert k.is_contiguous() and v.is_contiguous()
    assert kv_len.tolist() == [30, 30] and sc == cfg.hdim ** -0.5
    assert torch.equal(out, TK.flash_decode(q, k, v, kv_len, sm_scale=sc,
                                            device=CPU))
    g = cfg.n_heads // cfg.n_kv_heads
    qn, kn, vn = (t.numpy().astype(np.float64) for t in (q, k, v))
    s = np.einsum("bkgd,btkd->bkgt", qn.reshape(2, -1, g, cfg.hdim),
                  kn) * sc
    p = np.exp(s - s.max(-1, keepdims=True))
    want = np.einsum("bkgt,btkd->bkgd", p / p.sum(-1, keepdims=True), vn)
    _close(want.reshape(out.shape), out, LOGITS_TOL, "cross K2 vs softmax")


def test_k2_plain_version_over_a_memory_of_several_splits():
    """K2's plain version at the cross-attention's shape, every row live
    (``kv_len`` = T on every row; T = 2,100 spans three splits of 1,024
    rows, the last ragged; 4 heads on 4 KV heads, G = 1, hd 64) against
    the reference's ``flash_decode`` in interpret mode: within FD_RTOL /
    FD_ATOL."""
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    assert fd.SPLIT_ROWS == 1024
    rng = np.random.RandomState(23)
    b, h, kh, t, d = 2, 4, 4, 2100, 64
    q = rng.randn(b, h, d).astype(np.float32)
    k = rng.randn(b, t, kh, d).astype(np.float32)
    v = rng.randn(b, t, kh, d).astype(np.float32)
    kv_len = np.full((b,), t, np.int32)
    want = JK.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(kv_len), sm_scale=d ** -0.5,
                           block_kv=512)
    got = TK.flash_decode(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                          torch.tensor(kv_len), sm_scale=d ** -0.5,
                          block_kv=512, device=CPU)
    assert got.shape == (b, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FD_RTOL,
                               atol=FD_ATOL)


def test_chunked_cross_attention_where_the_memory_is_longer():
    """The port's chunked train-mode path gives the decoder's
    cross-attention a (qchunk, T) zero mask, so a decoder of 16 tokens
    (two query chunks of 8) reads a 32-row memory: its logits within
    LOGITS_TOL of the unchunked path's.  (The reference's chunked path
    builds a (qchunk, S) mask and raises where S != T; the ROADMAP lists
    it among the reference's quirks.)"""
    cfg = TC.get_smoke_config(ARCH)
    whole, chunked = (TM.init_params(
        c, generator=torch.Generator().manual_seed(4), device=CPU)
        for c in (cfg, cfg.scaled(attn_qchunk=8)))
    mem = TM.encode(whole, torch.from_numpy(_memory(4, 2, 32)))
    toks = torch.from_numpy(_toks(4, (2, 16)))
    _close(TM.forward(whole, tokens=toks, enc_out=mem)[0],
           TM.forward(chunked, tokens=toks, enc_out=mem)[0], LOGITS_TOL,
           "chunked cross-attention")


def test_engine_serves_the_decoder_alone_as_the_reference(setup):
    """The port's Engine against the reference Engine (which passes no
    encoder memory, so the cross-attention is skipped on both sides): the
    chunked extend prefill (prompts of one, two and three 32-token
    chunks), 12 greedy tokens each: tokens equal, mean_logprob within
    LOGPROB_TOL."""
    rcfg, params, cfg, model, _ = setup
    rng = np.random.default_rng(0)
    prompts = [[int(x) for x in rng.integers(1, 512, size=n)]
               for n in (5, 32, 45, 70)]
    ref = RE.Engine(rcfg, params, max_len=96).generate(
        [RE.Request(prompt=p, max_new_tokens=12) for p in prompts])
    got = Engine(cfg, model, max_len=96, device=CPU).generate(
        [Request(prompt=p, max_new_tokens=12) for p in prompts])
    for r, g in zip(ref, got):
        logits = np.asarray(R_FORWARD(params, rcfg, tokens=jnp.asarray(
            [r.tokens[:-1]]))[0])[0]
        top = np.sort(logits[r.prompt_len - 1:, :rcfg.vocab], axis=-1)
        assert (top[:, -1] - top[:, -2]).min() > 10 * LOGITS_TOL
        assert g.tokens == r.tokens
        assert (g.prompt_len, g.rid, g.finish_reason) \
            == (r.prompt_len, r.rid, r.finish_reason)
        assert abs(g.mean_logprob - r.mean_logprob) <= LOGPROB_TOL


@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_loss_and_grads_with_enc_embeds_match_reference(setup, remat):
    """``loss_fn`` on a batch of ``tokens`` and ``enc_embeds`` (the
    reference's enc-dec training batch) and every gradient leaf, the
    encoder's and the cross-attention's included, against
    ``jax.value_and_grad``: the loss within LOSS_ATOL, each leaf within
    GRAD_REL of its largest value, in the reference's leaf order, with
    ``remat`` off and on (on: each block, the encoder's too, recomputed in
    the backward; the result bitwise the same); ``make_eval_step`` gives
    the same loss."""
    rcfg, params, cfg, _, tree = setup
    batch = {"tokens": _toks(13, (2, 17)), "enc_embeds": _memory(13, 2, 24)}

    def ref_loss(p):
        return RM.loss_fn(p, rcfg, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                          remat=remat)

    (rl, _), rg = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        params)
    model = convert.params_from_numpy(cfg, tree, device=CPU)
    tl, metrics, grads = _grads(model, batch, remat)
    assert abs(float(rl) - float(tl)) <= LOSS_ATOL
    assert float(metrics["tokens"]) == 32
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert list(grads) == _paths(rg)
    for (path, ref), got in zip(flat, grads.values()):
        _rel_close(ref, got, GRAD_REL, f"grad {path}")
    assert all(grads[p].abs().max() > 0 for p in grads
               if p.startswith("encoder/"))
    if remat:
        _, _, plain = _grads(model, batch, False)
        assert all(torch.equal(plain[p], grads[p]) for p in grads)
    ev = TS.make_eval_step(cfg, device=CPU)(model, batch)
    assert float(ev["loss"]) == float(tl)


def test_train_step_with_enc_embeds_matches_reference(setup):
    """One ``make_train_step`` step in two juggler microbatches (remat on)
    on a ``tokens`` and ``enc_embeds`` batch against the reference's
    jitted step: the loss within LOSS_ATOL, the grad norm to 1e-6, every
    AdamW moment leaf, the encoder's included, within GRAD_REL of its
    largest value."""
    rcfg, params, cfg, _, tree = setup
    batch = {"tokens": _toks(14, (4, 12)), "enc_embeds": _memory(14, 4, 16)}
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
        gots = getattr(ts, name)
        assert list(gots) == _paths(getattr(rs, name))
        for r, g in zip(refs, gots.values()):
            _rel_close(r, g, GRAD_REL, name)


def test_param_counts_and_the_serve_launcher(capsys):
    """The model holds ``param_counts()`` corrected for its two errors
    (the encoder's GELU MLP counted as 3 d d_ff where the tree holds two
    matrices; no norm counted), at SMOKE and (on the meta device) at full
    width: 1,632,233,472 parameters, 3.264 GB in bf16.  ``python -m
    repro_torch.launch.serve --arch seamless-m4t-large-v2 --smoke --device
    cpu`` exits with the reference launcher's message."""
    for cfg in (TC.get_smoke_config(ARCH), TC.get_config(ARCH)):
        model = TM.init_params(cfg, device="meta")
        d = cfg.d_model
        norms = (2 * cfg.n_layers + 1) * d + cfg.n_layers * d \
            + (2 * cfg.encoder_layers + 1) * d
        assert sum(p.numel() for p in model.parameters()) \
            == cfg.param_counts()["total"] + norms \
            - cfg.encoder_layers * d * cfg.d_ff
    assert sum(p.numel() for p in model.parameters()) == 1_632_233_472
    assert TM.param_bytes(model) == 3_264_466_944
    argv = ["--arch", ARCH, "--smoke"]
    with pytest.raises(SystemExit) as ref:
        ref_launch_serve.main(argv)
    with pytest.raises(SystemExit) as got:
        launch_serve.main(argv + ["--device", CPU])
    assert str(got.value) == str(ref.value) \
        == f"{ARCH}: serve demo targets token-LM archs"
    assert capsys.readouterr().out == ""
