"""The port's ring (sliding-window) caches and the window model's serving
path against the reference, on the CPU.

mixtral-8x22b's SMOKE configuration (2 layers, window W = 16, 4 experts,
float32), the reference's ``init_params`` tree carried across with
``convert.params_from_numpy``, inputs drawn with numpy from fixed seeds.
The ring's slot-to-position map is held exactly; attention, logits and
``mean_logprob`` to the float32 tolerances below.  Decode at s = 1 reads
a wrapped ring in slot order (K2's plain version on the CPU), the
reference in position order, so no bit is promised across the packages;
greedy tokens are held equal, with the reference's top-2 logit gap
asserted at every compared position to exceed ten times the logits'
tolerance.
"""

import io
import contextlib

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

ARCH = "mixtral-8x22b"
CPU = "cpu"
#: keys, values and attention outputs (about 1) of one layer
KV_TOL = 1e-5
#: logits through two layers (about N(0, 1)), as tests/test_torch_models.py
LOGITS_TOL = 2e-5
#: mean_logprob of the two packages, both ``compensated``
LOGPROB_TOL = 1e-4

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
    model = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device=CPU)
    return rcfg, params, cfg, model


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


@pytest.mark.parametrize("s", (10, 16, 37))
def test_ring_prefill_slot_map(setup, s):
    """Prefill of s < W, s = W and s > W tokens: slot j holds the latest
    position p <= s - 1 with p % W == j (position 0 where there is none),
    and layer 0's ring keys and values are the reference's within
    KV_TOL."""
    rcfg, params, cfg, model = setup
    w = cfg.window
    want = [max([p for p in range(s) if p % w == j], default=0)
            for j in range(w)]
    assert TA.ring_positions(s, w).tolist() == want
    x = np.random.default_rng(s).standard_normal(
        (2, s, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s))
    core = jax.tree.map(lambda a: a[0], params["blocks"][0]["core"])
    _, rc = RA.gqa_apply(core, jnp.asarray(x), rcfg,
                         positions=jnp.asarray(pos), mode="prefill")
    _, tc = model.blocks[0].core(torch.from_numpy(x),
                                 positions=torch.from_numpy(pos.copy()),
                                 mode="prefill")
    assert tc.k.shape == (2, w, cfg.n_kv_heads, cfg.hdim)
    _close(rc.k, tc.k, KV_TOL, "ring k")
    _close(rc.v, tc.v, KV_TOL, "ring v")
    assert tc.length.tolist() == [s, s]


@pytest.mark.parametrize("prompt", (5, 16, 21))
def test_ring_decode_across_the_wrap_matches_reference(setup, prompt):
    """Prefill ``prompt`` tokens, then 14 single-token decode steps (the
    ring wraps during them, or already has): each step's logits within
    LOGITS_TOL of the reference's ``decode_step``, with the dense MoE as
    the engines run it and the capacity MoE at the first step."""
    rcfg, params, cfg, model = setup
    toks = _toks(prompt, (2, prompt + 14))
    _, rcaches, _ = R_FORWARD(params, rcfg,
                              tokens=jnp.asarray(toks[:, :prompt]),
                              mode="prefill", moe_impl="dense")
    tl, tcaches, _ = TM.forward(model, tokens=torch.from_numpy(
        toks[:, :prompt]), mode="prefill", moe_impl="dense")
    assert tcaches[0]["core"].k.shape[2] == cfg.window
    for i in range(prompt, prompt + 14):
        tok = toks[:, i:i + 1]
        impl = "capacity" if i == prompt else "dense"
        rl, rcaches = R_DECODE(params, rcfg, jnp.asarray(tok), rcaches,
                               jnp.asarray(i), moe_impl=impl)
        tl, tcaches = TM.decode_step(model, torch.from_numpy(tok), tcaches,
                                     i, moe_impl=impl)
        _close(rl, tl, LOGITS_TOL, f"position {i}")
    assert tcaches[0]["core"].length.tolist() == [[prompt + 14] * 2] * 2


def test_ring_extend_chunk_matches_reference(setup):
    """A 5-token extend (s > 1 through ``_sdpa`` with the ring's mask) on
    a ring of 14 tokens: the chunk's writes wrap the ring; logits within
    LOGITS_TOL of the reference's, and the next single-token step too."""
    rcfg, params, cfg, model = setup
    toks = _toks(3, (2, 20))
    _, rc, _ = R_FORWARD(params, rcfg, tokens=jnp.asarray(toks[:, :14]),
                         mode="prefill", moe_impl="dense")
    _, tc, _ = TM.forward(model, tokens=torch.from_numpy(toks[:, :14]),
                          mode="prefill", moe_impl="dense")
    for lo, hi in ((14, 19), (19, 20)):
        rl, rc = R_DECODE(params, rcfg, jnp.asarray(toks[:, lo:hi]), rc,
                          jnp.asarray(lo), moe_impl="dense")
        tl, tc = TM.decode_step(model, torch.from_numpy(toks[:, lo:hi]), tc,
                                lo, moe_impl="dense")
        _close(rl, tl, LOGITS_TOL, f"extend {lo}:{hi}")


def test_ring_decode_leaves_inactive_rows_alone(setup):
    """``active`` on a ring: the inactive row's slots and length stay as
    they were, the active row's logits are bitwise those of a step with
    every row active."""
    _, _, cfg, model = setup
    toks = torch.from_numpy(_toks(4, (2, 19)))
    _, caches, _ = TM.forward(model, tokens=toks[:, :18], mode="prefill",
                              moe_impl="dense")
    twin = [{"core": TA.KVCache(*(t.clone() for t in c["core"]))}
            for c in caches]
    before = [t.clone() for t in caches[0]["core"]]
    act = torch.tensor([True, False])
    lg, caches = TM.decode_step(model, toks[:, 18:], caches, 18, active=act,
                                moe_impl="dense")
    full, twin = TM.decode_step(model, toks[:, 18:], twin, 18,
                                moe_impl="dense")
    after = caches[0]["core"]
    assert torch.equal(after.k[:, 1], before[0][:, 1])
    assert torch.equal(after.v[:, 1], before[1][:, 1])
    assert after.length[:, 1].tolist() == [18, 18]
    assert after.length[:, 0].tolist() == [19, 19]
    assert torch.equal(after.k[:, 0], twin[0]["core"].k[:, 0])
    assert torch.equal(lg[0], full[0])


def test_engine_greedy_tokens_match_reference(setup):
    """The port's Engine against the reference Engine: prompts shorter
    than, equal to and longer than the window (so rings wrap in the
    prefill packing and during decode), 12 greedy tokens each: tokens
    equal, mean_logprob within LOGPROB_TOL."""
    rcfg, params, cfg, model = setup
    prompts = _prompts(0, (5, 16, 23, 40))
    ref = RE.Engine(rcfg, params, max_len=64).generate(
        [RE.Request(prompt=p, max_new_tokens=12) for p in prompts])
    eng = Engine(cfg, model, max_len=64, device=CPU)
    assert not eng._extend_ok
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
    _, _, cfg, model = setup
    eng = Engine(cfg, model, max_len=64, device=CPU)
    reqs = [Request(prompt=p, max_new_tokens=10)
            for p in _prompts(2, (3, 16, 30))]
    batched = eng.generate(reqs)
    for req, res in zip(reqs, batched):
        assert eng.generate([req])[0].tokens == res.tokens


def test_engine_splices_the_ring_for_each_prompt_length(setup):
    """The whole-prompt prefill splices a ring into its slot for a prompt
    shorter than, equal to and longer than W: the slot's keys, values and
    length are bitwise the prefill's, the other slots untouched."""
    _, _, cfg, model = setup
    eng = Engine(cfg, model, max_len=64, max_batch=3, device=CPU)
    for slot, s in enumerate((7, 16, 29)):
        toks = torch.from_numpy(_toks(s, (1, s)))
        others = [t.clone() for t in eng._caches[0]["core"]]
        eng._classic_prefill(slot, toks)
        _, want, _ = TM.forward(model, tokens=toks, mode="prefill",
                                moe_impl="dense")
        got = eng._caches[0]["core"]
        for f in ("k", "v", "length"):
            assert torch.equal(getattr(got, f)[:, slot],
                               getattr(want[0]["core"], f)[:, 0]), (s, f)
            for o in range(3):
                if o != slot:
                    assert torch.equal(getattr(got, f)[:, o],
                                       getattr(TA.KVCache(*others), f)[:, o])


def test_init_caches_ring_sized_and_pad_leaves_rings_alone(setup):
    """A window model's caches are ``cfg.window`` slots whatever
    ``max_len`` is (float32 by default); ``pad_caches_to`` returns them
    as they are."""
    _, _, cfg, _ = setup
    caches = TM.init_caches(cfg, 3, 100, device=CPU)
    core = caches[0]["core"]
    assert core.k.shape == (cfg.n_periods, 3, cfg.window, cfg.n_kv_heads,
                            cfg.hdim)
    assert core.k.dtype == torch.float32
    padded = TM.pad_caches_to(cfg, caches, 100)
    assert padded[0]["core"].k is core.k
    assert TM.unsupported(TC.get_config(ARCH)) == []


def test_serve_launcher_runs_mixtral_smoke_on_the_cpu():
    """``python -m repro_torch.launch.serve --arch mixtral-8x22b --smoke
    --device cpu`` serves its requests."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        launch_serve.main(["--arch", ARCH, "--smoke", "--device", CPU,
                           "--requests", "3", "--new-tokens", "20",
                           "--max-len", "64"])
    lines = out.getvalue().splitlines()
    assert [ln.split(":")[0] for ln in lines[:3]] == ["req0", "req1", "req2"]
    assert all("+20 tokens" in ln for ln in lines[:3])
    assert lines[-1].startswith("60 tokens in") and "on cpu" in lines[-1]
