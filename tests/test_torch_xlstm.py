"""The port's mLSTM and sLSTM blocks (``models/ssm.py``) and xlstm-125m's
serving and training paths against the reference, on the CPU.

xlstm-125m's SMOKE configuration at 8 layers (two periods of mLSTM,
mLSTM, mLSTM, sLSTM; d_model 64, mLSTM di 128 in 2 heads of 64, conv
kernel 4, sLSTM FFN of 85; vocab 256; float32), its ``scan_chunk`` cut
from 512 to 16 so that prompts of a few dozen tokens carry the mLSTM
state across chunks.  The reference's ``init_params`` tree is drawn once
and carried across with ``convert.params_from_numpy``; inputs are drawn
with numpy from fixed seeds.  The two packages sum the gates' prefix
(XLA's ``cumsum`` against the port's doubling order), the chunk's
contractions and the projections in other orders, so float32 results
are held to the tolerances stated below; greedy tokens are held equal,
with the reference's top-2 logit gap asserted at every compared position
to exceed ten times the logits' tolerance.  One test draws the same
configuration in bf16 (one period) to hold the roundings the reference
makes in that dtype: the gates, the sLSTM's recurrent h.
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
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.serve import Engine, Request  # noqa: E402

ARCH = "xlstm-125m"
CPU = "cpu"
#: the test configuration: SMOKE at two periods, 16-row scan chunks
LAYERS, CHUNK = 8, 16
#: one layer's output and state, max |ref - port| over the largest
#: |value| of the compared tensor (outputs of about 1; c of up to about
#: 10): the gate prefix sums of a 16-row chunk in two orders (a few ulps
#: of F, which grows to about 0.8 a chunk, inside exp), the chunk's
#: 64-wide contractions and in_proj's 64-wide products in other orders;
#: measured 6.7e-7 at most
LAYER_REL = 5e-6
#: the model's states after 18 tokens, their inputs through up to 7
#: layers of such differences (measured 1.7e-5, the sLSTM's n)
STATE_REL = 1e-4
#: the port against itself: another chunk size gives other prefix sums
#: and contractions over the same rows; prefill plus decode steps
#: against one prefill pass likewise (measured 5.2e-7)
SELF_REL = 5e-6
#: logits through 8 layers (about 0.2 std, largest about 0.7), absolute;
#: measured 4.4e-6
LOGITS_TOL = 2e-5
#: mean_logprob of the two packages, both ``compensated``
LOGPROB_TOL = 1e-4
#: bf16 at one period: both packages round the same float32 values to
#: bf16 at every projection, the gates and the sLSTM's h, so they agree
#: but for the rare value that lies within a float32 error of a bf16
#: rounding boundary; such a flip moves its element by one bf16 ulp
#: (2^-8 relative) and what it feeds by less.  Max |ref - port| over the
#: largest |value|: 2 bf16 ulps of it (measured 2.1e-7: no flip in
#: this draw, the outputs bitwise equal)
BF16_REL = 2.0 ** -7
#: the loss (float32 xent of about 5.5, an ulp 4.8e-7) and every gradient
#: leaf, max |ref - port| over its largest |value| (measured: the loss
#: equal, the gradients 2.0e-5: sums through the sLSTM's 24-step
#: recurrence and the chunk's exponentials)
LOSS_ATOL = 1e-5
GRAD_REL = 1e-4

#: the token width of every SMOKE forward here (one compiled shape)
FORWARD_LEN = 48

R_FORWARD = jax.jit(RM.forward, static_argnums=1,
                    static_argnames=("mode", "moe_impl"))
R_DECODE = jax.jit(RM.decode_step, static_argnums=1,
                   static_argnames="moe_impl")
R_MLSTM = jax.jit(RS.mlstm_apply, static_argnums=2,
                  static_argnames=("mode", "chunk"))
R_SLSTM = jax.jit(RS.slstm_apply, static_argnums=2, static_argnames="mode")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These are small CPU computations: one intra-op thread each, so the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(dtype="float32", n_layers=LAYERS):
    kw = dict(n_layers=n_layers, scan_chunk=CHUNK, dtype=dtype)
    return (RC.get_smoke_config(ARCH).scaled(**kw),
            TC.get_smoke_config(ARCH).scaled(**kw))


@pytest.fixture(scope="module")
def setup():
    """(reference config, params, port config, model) at 8 layers."""
    rcfg, cfg = _configs()
    params = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(0), rcfg)
    return rcfg, params, cfg, convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, params), device=CPU)


def _rel(ref, got):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    return float(np.abs(ref - got).max()) / max(float(np.abs(ref).max()),
                                                1e-30)


def _close(ref, got, rel, what=""):
    err = _rel(ref, got)
    assert err <= rel, f"{what}: max |ref - port| / max |ref| = {err:g} " \
                       f"> {rel:g}"


def _prompts(seed, lengths, vocab=256):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n in lengths]


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def _layers(rcfg, params, model):
    """{kind: (the reference's leaves, the port's module)} of layer 0
    (mLSTM) and layer 3 (sLSTM)."""
    return {kind: (jax.tree.map(lambda a: a[0], params["blocks"][j]["core"]),
                   model.blocks[j].core)
            for kind, j in (("mlstm", 0), ("slstm", 3))}


def _x(seed, b, s, d=64, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal((b, s, d)) \
        .astype(dtype)


def _apply(kind, core, cfg, x, **kw):
    fn = TS.mlstm_apply if kind == "mlstm" else TS.slstm_apply
    return fn(core, x, cfg.xlstm, **kw)


def _ref_apply(kind, rcore, rcfg, x, **kw):
    fn = R_MLSTM if kind == "mlstm" else R_SLSTM
    return fn(rcore, x, rcfg.xlstm, **kw)


def _port_state(kind, st):
    """A port state holding a copy of the reference's."""
    cls = TS.MLSTMState if kind == "mlstm" else TS.SLSTMState
    return cls(*(torch.from_numpy(np.array(t, np.float32)) for t in st))


def _clone(st):
    return type(st)(*(t.clone() for t in st))


@pytest.mark.parametrize("s", (1, 2, 7, 40, 130))
def test_train_and_prefill_match_reference(setup, s):
    """``mlstm_apply`` at chunks of 8 and 16 rows (S = 40 is five whole
    chunks of 8, S = 130 ends ragged at both, S = 1, 2 and 7 lie inside
    one chunk and S = 1, 2 inside the conv's tail) and ``slstm_apply``:
    the output and every field of the prefill state within LAYER_REL of
    the reference's, the conv tail's padding zero; train mode's output
    bitwise prefill's."""
    rcfg, params, cfg, model = setup
    x = _x(s, 2, s)
    for kind, (rcore, core) in _layers(rcfg, params, model).items():
        for chunk in ((8, 16) if kind == "mlstm" else (None,)):
            kw = {} if chunk is None else {"chunk": chunk}
            ry, rst = _ref_apply(kind, rcore, rcfg, jnp.asarray(x),
                                 mode="prefill", **kw)
            ty, tst = _apply(kind, core, cfg, torch.from_numpy(x),
                             mode="prefill", **kw)
            what = f"{kind} S={s} chunk={chunk}"
            _close(ry, ty, LAYER_REL, f"{what} y")
            assert type(tst).__name__ == type(rst).__name__
            for f in tst._fields:
                _close(getattr(rst, f), getattr(tst, f), LAYER_REL,
                       f"{what} {f}")
            if kind == "mlstm":
                assert tst.c.shape == (2, 2, 64, 64) \
                    and tst.c.dtype == torch.float32
                if s < 3:
                    assert not tst.conv[:, :3 - s].any()
            train_y, none = _apply(kind, core, cfg, torch.from_numpy(x),
                                   mode="train", **kw)
            assert none is None and torch.equal(train_y, ty)


def test_decode_steps_match_reference(setup):
    """From the reference's prefill state of 7 rows, five decode steps of
    three rows through each block: each step's output and the state
    within LAYER_REL of the reference's decode; the port's state is
    written in place and returned; more than one token a row raises."""
    rcfg, params, cfg, model = setup
    x = _x(11, 3, 12)
    for kind, (rcore, core) in _layers(rcfg, params, model).items():
        _, rst = _ref_apply(kind, rcore, rcfg, jnp.asarray(x[:, :7]),
                            mode="prefill")
        st = _port_state(kind, rst)
        for i in range(7, 12):
            ry, rst = _ref_apply(kind, rcore, rcfg,
                                 jnp.asarray(x[:, i:i + 1]), mode="decode",
                                 state=rst)
            buf = st.c
            ty, st = _apply(kind, core, cfg, torch.from_numpy(x[:, i:i + 1]),
                            mode="decode", state=st)
            assert st.c is buf
            _close(ry, ty, LAYER_REL, f"{kind} step {i} y")
            for f in st._fields:
                _close(getattr(rst, f), getattr(st, f), LAYER_REL,
                       f"{kind} step {i} {f}")
        with pytest.raises(ValueError, match="one token"):
            _apply(kind, core, cfg, torch.from_numpy(x[:, :2]),
                   mode="decode", state=st)


def test_chunk_invariance_and_prefill_then_decode_match_train(setup):
    """The port against itself: the mLSTM over 33 rows in chunks of 4, 8
    and 512 gives y and the state within SELF_REL; for both blocks,
    prefill of 20 rows plus 13 decode steps gives the outputs and final
    state of one prefill pass over the 33 rows within SELF_REL (the
    sLSTM's cell is the same code in both; its input projection is one
    product of 20 rows against 13 of one)."""
    rcfg, params, cfg, model = setup
    x = torch.from_numpy(_x(33, 2, 33))
    for kind, (_, core) in _layers(rcfg, params, model).items():
        kw = {"chunk": 512} if kind == "mlstm" else {}
        y_all, st_all = _apply(kind, core, cfg, x, mode="prefill", **kw)
        if kind == "mlstm":
            for chunk in (4, 8):
                y, st = _apply(kind, core, cfg, x, mode="prefill",
                               chunk=chunk)
                _close(y_all, y, SELF_REL, f"chunk {chunk} y")
                for f in st._fields:
                    _close(getattr(st_all, f), getattr(st, f), SELF_REL,
                           f"chunk {chunk} {f}")
            kw = {"chunk": 8}
        y, st = _apply(kind, core, cfg, x[:, :20], mode="prefill", **kw)
        outs = [y]
        for i in range(20, 33):
            yi, st = _apply(kind, core, cfg, x[:, i:i + 1], mode="decode",
                            state=st)
            outs.append(yi)
        _close(y_all, torch.cat(outs, dim=1), SELF_REL,
               f"{kind} prefill + decode y")
        for f in st._fields:
            _close(getattr(st_all, f), getattr(st, f), SELF_REL,
                   f"{kind} prefill + decode {f}")


def test_decode_active_mask_keeps_inactive_rows_bitwise(setup):
    """``active`` [True, False, True, False]: for both blocks the inactive
    rows' state fields stay bitwise as they were; the active rows'
    outputs and state equal an unmasked step's bitwise and moved."""
    rcfg, params, cfg, model = setup
    x = torch.from_numpy(_x(5, 4, 9))
    active = torch.tensor([True, False, True, False])
    for kind, (_, core) in _layers(rcfg, params, model).items():
        _, st = _apply(kind, core, cfg, x[:, :8], mode="prefill")
        free, masked = _clone(st), _clone(st)
        y_free, _ = _apply(kind, core, cfg, x[:, 8:], mode="decode",
                           state=free)
        y_mask, _ = _apply(kind, core, cfg, x[:, 8:], mode="decode",
                           state=masked, active=active)
        for r in range(4):
            for f in st._fields:
                old, new = getattr(st, f)[r], getattr(masked, f)[r]
                if active[r]:
                    assert torch.equal(new, getattr(free, f)[r]), (kind, f)
                else:
                    assert torch.equal(new, old), (kind, f, r)
            if active[r]:
                assert torch.equal(y_mask[r], y_free[r])
                assert not torch.equal(masked.c[r], st.c[r])


def test_init_params_fills_xlstm_leaves_and_names_round_trip(setup):
    """``init_params`` sets the mLSTM's b_f to 3.0, b_i and conv_b to
    zeros, out_norm to ones and the sLSTM's bias to zeros, with w_if,
    b_i, b_f and bias float32 in a bf16 model; conv_w is drawn at
    1/kernel; the model's parameter names map onto the reference tree's
    leaves (the mLSTM's at period positions 0-2, the sLSTM's at 3), and
    ``to_reference`` gives back the reference's own values bitwise, from
    a float32 tree and from a bf16 one (its float32 leaves kept)."""
    rcfg, params, cfg, model = setup
    gen = torch.Generator().manual_seed(0)
    fresh = TM.init_params(cfg.scaled(dtype="bfloat16"), generator=gen,
                           device=CPU)
    m, s = fresh.blocks[0].core, fresh.blocks[3].core
    assert torch.equal(m.b_f, torch.full((2,), 3.0))
    assert not m.b_i.any() and not m.conv_b.any() and not s.bias.any()
    assert torch.equal(m.out_norm, torch.ones(128, dtype=torch.bfloat16))
    assert {m.w_if.dtype, m.b_i.dtype, m.b_f.dtype, s.bias.dtype} \
        == {torch.float32}
    assert {m.in_proj.dtype, m.wv.dtype, s.w_h.dtype, s.ff_wo.dtype} \
        == {torch.bfloat16}
    assert abs(float(m.conv_w.float().std()) - 0.25) < 0.03
    assert abs(float(s.w_x.float().std()) - 64 ** -0.5) < 0.005
    leaves = dict(convert.reference_leaves(cfg))
    for j in range(3):
        assert {p for p in leaves if p.startswith(f"blocks/{j}/core/")} \
            == {f"blocks/{j}/core/{n}" for n in (
                "in_proj", "conv_w", "conv_b", "wq", "wk", "wv", "w_if",
                "b_i", "b_f", "out_norm", "out_proj")}
    assert {p for p in leaves if p.startswith("blocks/3/")} \
        == {f"blocks/3/core/{n}" for n in ("w_x", "w_h", "bias", "ff_wi",
                                            "ff_wo")} | {"blocks/3/norm1"}
    rcfg16, cfg16 = _configs("bfloat16", n_layers=4)
    params16 = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), rcfg16)
    for c, p in ((cfg, params), (cfg16, params16)):
        port = model if c is cfg else convert.params_from_numpy(
            c, jax.tree.map(np.asarray, p), device=CPU)
        got = convert.to_reference(c, dict(port.named_parameters()))
        flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    p)[0]}
        assert list(got) == list(flat)
        for path, leaf in flat.items():
            assert str(got[path].dtype).split(".")[-1] == str(leaf.dtype), \
                path
            assert np.array_equal(got[path].float().numpy(),
                                  np.asarray(leaf, np.float32)), path


def test_bf16_layers_round_as_the_reference(setup):
    """In bf16 (one period, the reference's bf16 tree): each block's
    prefill of 40 rows and three decode steps, the outputs and states
    within BF16_REL of the reference's; the sLSTM's h, cached in a
    float32 state, holds bf16 values (what the reference's bf16 h
    holds), and the mLSTM's gates round to bf16 before they widen."""
    rcfg, cfg = _configs("bfloat16", n_layers=4)
    params = jax.jit(RM.init_params, static_argnums=1)(
        jax.random.PRNGKey(2), rcfg)
    model = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device=CPU)
    x = _x(21, 2, 43).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x, np.float32)).bfloat16()
    for kind, (rcore, core) in _layers(rcfg, params, model).items():
        ry, rst = _ref_apply(kind, rcore, rcfg, jnp.asarray(x[:, :40]),
                             mode="prefill")
        ty, st = _apply(kind, core, cfg, tx[:, :40], mode="prefill")
        assert ty.dtype == torch.bfloat16
        _close(ry, ty, BF16_REL, f"bf16 {kind} prefill y")
        st = _port_state(kind, tuple(t.float() for t in st))
        for i in range(40, 43):
            ry, rst = _ref_apply(kind, rcore, rcfg, jnp.asarray(
                x[:, i:i + 1]), mode="decode", state=rst)
            ty, st = _apply(kind, core, cfg, tx[:, i:i + 1], mode="decode",
                            state=st)
            _close(ry, ty, BF16_REL, f"bf16 {kind} step {i} y")
            for f in st._fields:
                _close(getattr(rst, f), getattr(st, f), BF16_REL,
                       f"bf16 {kind} step {i} {f}")
        if kind == "slstm":
            assert st.h.dtype == torch.float32
            assert torch.equal(st.h, st.h.bfloat16().float())
    # the gates: w_if's float32 product rounded to bf16, then widened
    core = model.blocks[0].core
    xi = tx[:, :, :].repeat(1, 1, 2)                     # (2, 43, 128) bf16
    _, _, _, logi, _ = TS.mlstm_gates(core, xi, xi, 2)
    exact = xi.float() @ core.w_if
    assert torch.equal(logi, exact[..., :2].bfloat16().float()
                       .transpose(1, 2) + core.b_i[:, None])
    assert not torch.equal(logi, exact[..., :2].transpose(1, 2)
                           + core.b_i[:, None])


def test_forward_logits_match_reference(setup):
    """The whole 8-layer model's train-mode logits (48 tokens: three
    scan chunks) within LOGITS_TOL of the reference's."""
    rcfg, params, cfg, model = setup
    toks = np.random.default_rng(7).integers(1, 256, (2, FORWARD_LEN))
    rl, _, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks))
    tl, _, aux = TM.forward(model, tokens=torch.from_numpy(toks))
    assert float(aux) == 0.0
    err = float(np.abs(np.asarray(rl) - tl.numpy()).max())
    assert err <= LOGITS_TOL, err


def test_decode_step_after_pad_matches_reference_two_periods(setup):
    """Prefill 10 tokens, ``pad_caches_to`` 24 rows (every recurrent state
    stays the object it was), then 8 decode steps through both periods:
    each step's logits within LOGITS_TOL of the reference's
    ``decode_step``, every state field within STATE_REL of the
    reference's at the end."""
    rcfg, params, cfg, model = setup
    toks = np.random.default_rng(8).integers(1, 256, (2, 18))
    _, rc, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks[:, :10]),
                         mode="prefill")
    _, tc, _ = TM.forward(model, tokens=torch.from_numpy(toks[:, :10]),
                          mode="prefill")
    rc = RM.pad_caches_to(rcfg, rc, 24)
    padded = TM.pad_caches_to(cfg, tc, 24)
    assert all(b["core"] is a["core"] for a, b in zip(tc, padded))
    tc = padded
    for i in range(10, 18):
        rl, rc = R_DECODE(params, rcfg, jnp.asarray(toks[:, i:i + 1]), rc,
                          jnp.asarray(i))
        tl, tc = TM.decode_step(model, torch.from_numpy(toks[:, i:i + 1]),
                                tc, i)
        err = float(np.abs(np.asarray(rl) - tl.numpy()).max())
        assert err <= LOGITS_TOL, f"step {i}: {err:g}"
    for j in range(4):
        for f in tc[j]["core"]._fields:
            _close(getattr(rc[j]["core"], f), getattr(tc[j]["core"], f),
                   STATE_REL, f"position {j} {f}")


def test_init_caches_shapes_dtypes_and_cache_bytes(setup):
    """``init_caches`` builds an ``MLSTMState`` at positions 0-2 and an
    ``SLSTMState`` at 3, shaped as the reference's: c, n, m float32
    whatever ``dtype`` is, conv and the sLSTM's h in ``dtype``; zeros
    but the sLSTM's n, which starts at ones; ``cache_bytes`` counts
    them."""
    rcfg, _, cfg, _ = setup
    ref = RM.init_caches(rcfg, 3, 40)
    got = TM.init_caches(cfg, 3, 40, device=CPU)
    for j, (r, g) in enumerate(zip(ref, got)):
        assert type(g["core"]).__name__ == type(r["core"]).__name__, j
        assert g["core"]._fields == r["core"]._fields
        for f in g["core"]._fields:
            a, b = getattr(r["core"], f), getattr(g["core"], f)
            assert tuple(b.shape) == a.shape, (j, f)
            assert np.array_equal(np.asarray(a, np.float32), b.numpy())
    slstm = got[3]["core"]
    assert torch.equal(slstm.n, torch.ones(2, 3, 64))
    half = TM.init_caches(cfg, 3, 40, device=CPU, dtype=torch.bfloat16)
    assert {half[0]["core"].c.dtype, half[0]["core"].m.dtype,
            half[3]["core"].n.dtype} == {torch.float32}
    assert half[0]["core"].conv.dtype == half[3]["core"].h.dtype \
        == torch.bfloat16
    n, b = cfg.n_periods, 3
    assert TM.cache_bytes(got) == n * b * 4 * (
        3 * (2 * 64 * 64 + 2 * 64 + 2 + 3 * 128) + 4 * 64)


def test_engine_greedy_tokens_match_reference(setup):
    """The port's Engine against the reference Engine: the whole-prompt
    prefill (no extend path for a recurrent model), 10 greedy tokens for
    prompts of 2 (inside the conv's tail), 21 and 37 tokens (three scan
    chunks): tokens equal, mean_logprob within LOGPROB_TOL."""
    rcfg, params, cfg, model = setup
    prompts = _prompts(0, (2, 21, 37))
    ref = RE.Engine(rcfg, params, max_len=64).generate(
        [RE.Request(prompt=p, max_new_tokens=10) for p in prompts])
    eng = Engine(cfg, model, max_len=64, device=CPU)
    assert not eng._extend_ok
    got = eng.generate([Request(prompt=p, max_new_tokens=10)
                        for p in prompts])
    # the reference's logits over each result in one forward (each row
    # padded at its end, which no earlier position sees)
    seqs = [r.tokens[:-1] for r in ref]
    logits = np.asarray(R_FORWARD(params, rcfg, tokens=jnp.asarray(
        [q + [0] * (FORWARD_LEN - len(q)) for q in seqs]))[0])
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
    (its slot's states never see its batchmates')."""
    _, _, cfg, model = setup
    eng = Engine(cfg, model, max_len=48, device=CPU)
    reqs = [Request(prompt=p, max_new_tokens=10)
            for p in _prompts(2, (3, 30, 17))]
    batched = eng.generate(reqs)
    for req, res in zip(reqs, batched):
        assert eng.generate([req])[0].tokens == res.tokens


def test_serve_launcher_runs_xlstm_smoke_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch xlstm-125m --smoke
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


def test_loss_and_grads_match_reference(setup):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's, on 2 x 24 tokens (two scan chunks): the loss
    within LOSS_ATOL, each leaf within GRAD_REL of its largest value, in
    the reference's leaf order."""
    rcfg, params, cfg, _ = setup
    toks = np.random.default_rng(9).integers(0, 256, (2, 24)) \
        .astype(np.int32)

    def ref_loss(p):
        return RM.loss_fn(p, rcfg, {"tokens": jnp.asarray(toks)})

    (rl, _), rg = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        params)
    model = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device=CPU).requires_grad_(True)
    named = dict(model.named_parameters())
    tl, _ = TM.loss_fn(model, {"tokens": torch.from_numpy(toks)})
    grads = convert.to_reference(cfg, dict(zip(named, torch.autograd.grad(
        tl, list(named.values())))))
    assert abs(float(rl) - float(tl.detach())) <= LOSS_ATOL
    flat = jax.tree_util.tree_flatten_with_path(rg)[0]
    assert list(grads) == ["/".join(str(getattr(k, "key", getattr(
        k, "idx", k))) for k in path) for path, _ in flat]
    for (path, ref), got in zip(flat, grads.values()):
        assert np.isfinite(got.numpy()).all()
        _close(ref, got, GRAD_REL, f"grad {path}")
