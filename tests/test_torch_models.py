"""The port's model against the reference, on the CPU.

The same inputs, drawn with numpy from fixed seeds, go through
``repro.models`` (JAX) and ``repro_torch.models`` with the reference's
parameters carried across by ``convert.params_from_numpy``.  Everything
runs at stablelm-1.6b's SMOKE configuration (2 layers, d_model 128, vocab
512, float32).  Tolerances are float32 ones, stated per test: the two
packages sum in different orders (XLA's dot against PyTorch's matmul, and
the decode step's K2 order against one softmax), so no bit is promised
across them; the port's own integer-tier paths are held bitwise.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402

ARCH = "stablelm-1.6b"
CPU = "cpu"
#: float32 results of the two packages: a few ulps of values near 1
#: through two layers (logits are about N(0, 1))
ATOL = 2e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These are small CPU computations: one intra-op thread each, so the
    parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    cfg = RC.get_smoke_config(ARCH)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    tcfg = TC.get_smoke_config(ARCH)
    return cfg, params, tcfg, convert.params_from_numpy(tcfg, tree,
                                                        device=CPU)


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _close(ref, got, atol=ATOL, what=""):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    assert err <= atol, f"{what}: max |ref - port| = {err:g} > {atol:g}"


def test_params_from_numpy_carries_every_leaf(smoke):
    cfg, params, tcfg, model = smoke
    sd = model.state_dict()
    assert np.array_equal(sd["embed"].numpy(), np.asarray(params["embed"]))
    for layer in range(cfg.n_layers):
        got = sd[f"blocks.{layer}.core.wq"].numpy()
        assert np.array_equal(
            got, np.asarray(params["blocks"][0]["core"]["wq"][layer]))
    assert not any(p.requires_grad for p in model.parameters())


def test_init_params_is_reproducible_from_the_generator():
    cfg = TC.get_smoke_config(ARCH)

    def draw(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return TM.init_params(cfg, generator=g, device=CPU).state_dict()

    a, b, c = draw(3), draw(3), draw(4)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed"], c["embed"])
    assert torch.equal(a["blocks.1.norm2"], torch.ones(cfg.d_model))
    assert abs(float(a["embed"].std()) - 0.02) < 0.002
    with pytest.raises(ValueError, match="Generator"):
        TM.init_params(cfg, device=CPU)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", [None, "compensated", "exact2"])
def test_rmsnorm_matches_reference(policy):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 128)) * 3).astype(np.float32)
    g = rng.standard_normal(128).astype(np.float32)
    ref = RL.rmsnorm(jnp.asarray(g), jnp.asarray(x), 1e-5, policy=policy)
    got = TL.rmsnorm(_t(g), _t(x), 1e-5, policy=policy)
    _close(ref, got, atol=1e-5, what=f"rmsnorm policy={policy}")


def test_rmsnorm_exact2_bitwise_across_batch_compositions():
    """Under an integer tier each token's norm is bitwise its own, alone
    or among other tokens."""
    rng = np.random.default_rng(2)
    x = _t((rng.standard_normal((6, 128)) * 7).astype(np.float32))
    g = _t(rng.standard_normal(128).astype(np.float32))
    whole = TL.rmsnorm(g, x, policy="exact2")
    for rows in ([0], [2, 5], [5, 1, 3]):
        part = TL.rmsnorm(g, x[rows], policy="exact2")
        assert torch.equal(part, whole[rows])


def test_rope_and_swiglu_match_reference(smoke):
    cfg, params, _, model = smoke
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 4, 32)).astype(np.float32)
    pos = rng.integers(0, 90, (2, 7)).astype(np.int32)
    _close(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos)),
           TL.apply_rope(_t(x), _t(pos)), atol=1e-5, what="apply_rope")
    h = rng.standard_normal((2, 7, 128)).astype(np.float32)
    mlp = jax.tree.map(lambda a: a[1], params["blocks"][0]["mlp"])
    _close(RL.swiglu(mlp, jnp.asarray(h)), model.blocks[1].mlp(_t(h)),
           what="swiglu")
    _close(RL.causal_mask(5, 9, offset=3, window=4),
           TL.causal_mask(5, 9, offset=3, window=4), atol=0.0,
           what="causal_mask")


# ---------------------------------------------------------------------------
# GQA attention: prefill, decode (s = 1, K2's plain version), extend
# ---------------------------------------------------------------------------


def _layer0(params):
    return jax.tree.map(lambda a: a[0], params["blocks"][0]["core"])


def _caches_pair(rng, b, t, kvh, hd, lengths):
    k = rng.standard_normal((b, t, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, t, kvh, hd)).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    ref = RA.KVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    got = TA.KVCache(_t(k), _t(v), _t(lengths))
    return ref, got


def test_gqa_prefill_matches_reference(smoke):
    cfg, params, tcfg, model = smoke
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    ref, rc = RA.gqa_apply(_layer0(params), jnp.asarray(x), cfg,
                           positions=jnp.asarray(pos), mode="prefill")
    got, gc = model.blocks[0].core(_t(x), positions=_t(pos), mode="prefill")
    _close(ref, got, what="prefill out")
    _close(rc.k, gc.k, what="prefill k")
    _close(rc.v, gc.v, what="prefill v")
    assert np.array_equal(np.asarray(rc.length), gc.length.numpy())


@pytest.mark.parametrize("s", [1, 4])
def test_gqa_decode_and_extend_match_reference(smoke, s):
    """Rows at their own lengths (continuous batching); with s = 4 the
    last row's writes run past the cache's end and are dropped."""
    cfg, params, tcfg, model = smoke
    rng = np.random.default_rng(5 + s)
    b, t = 4, 24
    lengths = [0, 5, 17, t - 2]
    rc, gc = _caches_pair(rng, b, t, cfg.n_kv_heads, cfg.hdim, lengths)
    x = rng.standard_normal((b, s, 128)).astype(np.float32)
    pos = (np.asarray(lengths)[:, None] + np.arange(s)).astype(np.int32)
    ref, rn = RA.gqa_apply(_layer0(params), jnp.asarray(x), cfg,
                           positions=jnp.asarray(pos), mode="decode",
                           cache=rc)
    got, gn = model.blocks[0].core(_t(x), positions=_t(pos), mode="decode",
                                   cache=gc)
    _close(ref, got, what=f"decode s={s} out")
    _close(rn.k, gn.k, what="cache k")
    _close(rn.v, gn.v, what="cache v")
    assert np.array_equal(np.asarray(rn.length), gn.length.numpy())


def test_gqa_decode_inactive_rows_keep_their_cache(smoke):
    _, _, tcfg, model = smoke
    rng = np.random.default_rng(8)
    _, gc = _caches_pair(rng, 3, 16, tcfg.n_kv_heads, tcfg.hdim, [2, 7, 15])
    before = (gc.k.clone(), gc.v.clone())
    x = _t(rng.standard_normal((3, 1, 128)).astype(np.float32))
    pos = gc.length[:, None].clone()
    active = torch.tensor([True, False, True])
    _, new = model.blocks[0].core(x, positions=pos, mode="decode",
                                  cache=gc, active=active)
    assert new.length.tolist() == [3, 7, 16]
    assert torch.equal(gc.k[1], before[0][1])
    assert torch.equal(gc.v[1], before[1][1])
    assert not torch.equal(gc.k[0], before[0][0])


# ---------------------------------------------------------------------------
# the model: forward and a chain of decode steps
# ---------------------------------------------------------------------------


def test_forward_logits_match_reference(smoke):
    cfg, params, tcfg, model = smoke
    rng = np.random.default_rng(9)
    toks = rng.integers(0, cfg.vocab, (2, 13)).astype(np.int32)
    for mode in ("train", "prefill"):
        ref, rcache, _ = RM.forward(params, cfg, tokens=jnp.asarray(toks),
                                    mode=mode)
        got, gcache, aux = TM.forward(model, tokens=_t(toks, torch.long),
                                      mode=mode)
        assert got.dtype == torch.float32 and float(aux) == 0.0
        _close(ref, got, what=f"forward {mode}")
    ref_pad = RM.pad_caches_to(cfg, rcache, 32)
    got_pad = TM.pad_caches_to(tcfg, gcache, 32)
    _close(ref_pad[0]["core"].k, got_pad[0]["core"].k, what="padded k")
    assert got_pad[0]["core"].k.shape == (cfg.n_periods, 2, 32, 4, 32)


def test_forward_hidden_and_chunked_queries(smoke):
    """``forward_hidden`` against the reference, and the query-block path
    (``_sdpa_chunked``) against one block."""
    cfg, params, tcfg, model = smoke
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab, (1, 16)).astype(np.int32)
    ref, _, _ = RM.forward_hidden(params, cfg, tokens=jnp.asarray(toks))
    got, _, _ = TM.forward_hidden(model, tokens=_t(toks, torch.long))
    _close(ref, got, what="forward_hidden")
    chunked = dataclasses.replace(tcfg, attn_qchunk=4)
    q, k, v = (torch.randn(1, 16, 4, 32, generator=torch.Generator()
                           .manual_seed(i)) for i in range(3))
    whole = TA._sdpa(q, k, v, TL.causal_mask(16, 16), 0.25)
    _close(whole, TA._sdpa_chunked(q, k, v, chunked, 0.25, qchunk=4),
           atol=1e-6, what="chunked queries")


def test_decode_chain_matches_reference(smoke):
    """init_caches, one chunked-prefill extend of the prompts at per-row
    lengths, then five s = 1 decode steps (K2's plain version), the
    reference's greedy tokens fed to both: logits at every step."""
    cfg, params, tcfg, model = smoke
    rng = np.random.default_rng(11)
    b, t, plen = 3, 40, 7
    rc = RM.init_caches(cfg, b, t)
    gc = TM.init_caches(tcfg, b, t, device=CPU)
    assert gc[0]["core"].k.dtype == torch.float32
    prompt = rng.integers(0, cfg.vocab, (b, plen)).astype(np.int32)
    ref, rc = RM.decode_step(params, cfg, jnp.asarray(prompt), rc, 0)
    got, gc = TM.decode_step(model, _t(prompt, torch.long), gc, 0)
    _close(ref, got, what="extend")
    tok = np.asarray(jnp.argmax(ref[:, -1:, :cfg.vocab], -1), np.int32)
    for step in range(5):
        pos = np.full(b, plen + step, np.int32)
        ref, rc = RM.decode_step(params, cfg, jnp.asarray(tok), rc,
                                 jnp.asarray(pos))
        got, gc = TM.decode_step(model, _t(tok, torch.long), gc, _t(pos))
        _close(ref, got, what=f"decode step {step}")
        assert np.array_equal(np.asarray(rc[0]["core"].length),
                              gc[0]["core"].length.numpy())
        tok = np.asarray(jnp.argmax(ref[:, :, :cfg.vocab], -1), np.int32)
    _close(rc[0]["core"].k, gc[0]["core"].k, what="cache k after the chain")


@pytest.mark.parametrize("s", [1, 3, 9])
def test_cache_writes_match_a_plain_loop(s):
    """``_write_rows`` against a loop over rows and positions: rows at
    length 0, mid-cache, at the end and past it; an inactive row; with
    s = 9 > T = 8 every position from T on is dropped."""
    rng = np.random.default_rng(13)
    t = 8
    lengths = torch.tensor([0, 3, t - 1, t, t + 2])
    active = torch.tensor([True, True, True, False, True])
    buf = torch.tensor(rng.standard_normal((5, t, 2, 3)).astype(np.float32))
    vals = torch.tensor(rng.standard_normal((5, s, 2, 3)).astype(np.float32))
    pos = lengths[:, None] + torch.arange(s)[None, :]
    want = buf.clone()
    for b in range(5):
        for i in range(s):
            if active[b] and pos[b, i] < t:
                want[b, pos[b, i]] = vals[b, i]
    TA._write_rows(buf, pos, vals, active)
    assert torch.equal(buf, want)
