"""The port's serving engine, on the CPU: against the reference's Engine,
and its own contract.

stablelm-1.6b's SMOKE configuration (float32), the reference's parameters
carried across by ``convert.params_from_numpy``, prompts drawn with numpy
from fixed seeds.  Greedy tokens are compared exactly, with the
reference's top-2 logit gap asserted at every compared step to exceed ten
times the logits' tolerance, so a near-tie cannot flip a token silently.
The sampling streams differ by design (README: the sampling contract), so
sampling is held only to the port's own reproducibility.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as ref_smoke  # noqa: E402
from repro.models import forward as ref_forward  # noqa: E402
from repro.models import init_params as ref_init  # noqa: E402
from repro.serve import engine as RE  # noqa: E402
from repro.serve.scheduler import Scheduler as RefScheduler  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.serve import (Engine, PagedKVPool, Request,  # noqa: E402
                               Scheduler)

ARCH = "stablelm-1.6b"
CPU = "cpu"
#: the two packages' logits agree to this (float32, two layers; the
#: model tests measure about 4e-6)
LOGITS_TOL = 2e-5
#: mean_logprob of the two packages, both `compensated`: the same
#: per-token log-probabilities within the logits' tolerance
LOGPROB_TOL = 1e-4


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
    rcfg = ref_smoke(ARCH)
    params = ref_init(jax.random.PRNGKey(0), rcfg)
    cfg = get_smoke_config(ARCH)
    model = convert.params_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                      device=CPU)
    return rcfg, params, cfg, model


def _engine(setup, **kw):
    _, _, cfg, model = setup
    kw.setdefault("max_len", 96)
    return Engine(cfg, model, device=CPU, **kw)


def _prompts(seed, lengths, vocab=512):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, size=n)]
            for n in lengths]


def _top2_gap(logits):
    top = np.sort(logits, axis=-1)[..., -2:]
    return top[..., 1] - top[..., 0]


def test_greedy_tokens_and_mean_logprob_match_reference(setup):
    rcfg, params, _, _ = setup
    prompts = _prompts(0, (5, 17, 33, 40))
    ref = RE.Engine(rcfg, params, max_len=96).generate(
        [RE.Request(prompt=p, max_new_tokens=8) for p in prompts])
    got = _engine(setup).generate(
        [Request(prompt=p, max_new_tokens=8) for p in prompts])
    for r, g in zip(ref, got):
        # the reference's logits over the whole sequence: the gap between
        # its top two at every generated position
        seq = jnp.asarray([r.tokens[:-1]])
        logits = np.asarray(ref_forward(params, rcfg, tokens=seq)[0])[0]
        gaps = _top2_gap(logits[r.prompt_len - 1:, :rcfg.vocab])
        assert gaps.min() > 10 * LOGITS_TOL, gaps.min()
        assert g.tokens == r.tokens
        assert (g.prompt_len, g.rid, g.finish_reason) \
            == (r.prompt_len, r.rid, r.finish_reason)
        assert abs(g.mean_logprob - r.mean_logprob) <= LOGPROB_TOL


def test_classic_prefill_matches_reference(setup):
    """The whole-prompt prefill path (the reference's for SSM and window
    models), driven on the dense model in both packages."""
    rcfg, params, _, _ = setup
    prompts = _prompts(1, (9, 30))
    reng = RE.Engine(rcfg, params, max_len=64)
    reng._extend_ok = False
    ref = reng.generate([RE.Request(prompt=p, max_new_tokens=5)
                         for p in prompts])
    eng = _engine(setup, max_len=64)
    eng._extend_ok = False
    got = eng.generate([Request(prompt=p, max_new_tokens=5)
                        for p in prompts])
    for r, g in zip(ref, got):
        seq = jnp.asarray([r.tokens[:-1]])
        logits = np.asarray(ref_forward(params, rcfg, tokens=seq)[0])[0]
        assert _top2_gap(logits[r.prompt_len - 1:, :rcfg.vocab]).min() \
            > 10 * LOGITS_TOL
        assert g.tokens == r.tokens
        assert abs(g.mean_logprob - r.mean_logprob) <= LOGPROB_TOL


def test_greedy_single_vs_batched_bitwise(setup):
    eng = _engine(setup)
    prompts = _prompts(2, (6, 2, 25, 11))
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    batched = eng.generate(reqs)
    for req, res in zip(reqs, batched):
        assert eng.generate([req])[0].tokens == res.tokens


def test_arrival_trace_in_order_and_alone_bitwise(setup):
    """Staggered arrivals admit into freed slots mid-stream; results come
    back in submission order, each request's tokens bitwise its tokens
    alone."""
    eng = _engine(setup, max_batch=3)
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=p, max_new_tokens=int(rng.integers(1, 7)))
            for p in _prompts(3, rng.integers(1, 20, size=7))]
    rids = [eng.submit(r, arrival=float(a))
            for r, a in zip(reqs, rng.uniform(0, 10, size=len(reqs)))]
    results = eng.run()
    assert [r.rid for r in results] == rids
    for req, res in zip(reqs, results):
        alone = eng.generate([req])[0]
        assert (res.tokens, res.finish_reason) \
            == (alone.tokens, alone.finish_reason)


def test_exact2_mean_logprob_bitwise_across_compositions(setup):
    eng = _engine(setup, logprob_policy="exact2")
    targets = [Request(prompt=p, max_new_tokens=n)
               for p, n in zip(_prompts(4, (4, 1, 2)), (5, 8, 3))]
    fillers = [Request(prompt=p, max_new_tokens=n)
               for p, n in zip(_prompts(5, (3, 2)), (6, 2))]
    alone = [eng.generate([t])[0].mean_logprob for t in targets]
    batch = [r.mean_logprob for r in eng.generate(targets)]
    order = [(targets[0], 0.0), (fillers[0], 1.0), (targets[1], 2.0),
             (fillers[1], 4.0), (targets[2], 7.0)]
    rids = {id(req): eng.submit(req, arrival=a) for req, a in order}
    by_rid = {r.rid: r for r in eng.run()}
    staggered = [by_rid[rids[id(t)]].mean_logprob for t in targets]
    for a, b, c in zip(alone, batch, staggered):
        assert np.float32(a).tobytes() == np.float32(b).tobytes() \
            == np.float32(c).tobytes()


def test_chunk_size_invariance(setup):
    """A prompt streamed in 3-token chunks decodes the same greedy tokens
    as one streamed in a single chunk; the mean log-probability agrees to
    float32 rounding."""
    req = Request(prompt=_prompts(6, (11,))[0], max_new_tokens=5)
    a = _engine(setup, prefill_chunk=3).generate([req])[0]
    b = _engine(setup, prefill_chunk=64).generate([req])[0]
    assert a.tokens == b.tokens
    assert abs(a.mean_logprob - b.mean_logprob) <= 1e-5


def test_pool_exhaustion_queues_and_completes(setup):
    eng = _engine(setup, max_batch=4, page_size=16, num_pages=5)
    reqs = [Request(prompt=[(i + j) % 512 for j in range(30)],
                    max_new_tokens=4) for i in range(3)]
    rids = [eng.submit(r) for r in reqs]       # 3 of 5 pages each
    peak = {"live": 0}

    def probe(engine, step):
        peak["live"] = max(peak["live"], engine.pool.live_requests)

    results = eng.run(on_step=probe)
    assert [r.rid for r in results] == rids
    assert peak["live"] == 1
    assert eng.pool.free_pages == 5
    for req, res in zip(reqs, results):
        assert res.tokens == eng.generate([req])[0].tokens
    with pytest.raises(ValueError, match="raise num_pages"):
        eng.submit(Request(prompt=[1] * 40, max_new_tokens=60))


def test_generate_validation_and_truncation(setup):
    eng = _engine(setup, max_len=32)
    with pytest.raises(ValueError, match="empty batch"):
        eng.generate([])
    with pytest.raises(ValueError, match="request 1 has an empty prompt"):
        eng.generate([Request(prompt=[1]), Request(prompt=[])])
    long = list(range(1, 41))
    with pytest.raises(ValueError, match="truncate_prompts=True"):
        eng.generate([Request(prompt=long, max_new_tokens=2)])
    res = eng.generate([Request(prompt=long, max_new_tokens=2)],
                       truncate_prompts=True)[0]
    assert res.prompt_len == 31 and res.tokens[:31] == long[-31:]
    assert len(res.tokens) == 32 and res.finish_reason == "length"
    with pytest.raises(ValueError, match="policy"):
        _engine(setup, logprob_policy="no-such-tier")
    with pytest.raises(ValueError, match="parameters are on"):
        Engine(setup[2], setup[3], device="meta")


def test_max_new_tokens_one_and_eos(setup):
    eng = _engine(setup)
    prompt = _prompts(7, (3,))[0]
    one = eng.generate([Request(prompt=prompt, max_new_tokens=1)])[0]
    assert len(one.tokens) == 4 and one.mean_logprob is not None
    eos = one.tokens[-1]
    res = eng.generate([Request(prompt=prompt, max_new_tokens=10,
                                eos_id=eos)])[0]
    assert res.tokens == one.tokens and res.finish_reason == "stop"


def test_request_seed_reproducible_sampling(setup):
    eng = _engine(setup)
    seeded = Request(prompt=[5, 6, 7], max_new_tokens=6, temperature=0.9,
                     seed=123)
    other = Request(prompt=[40, 41], max_new_tokens=4)
    alone = eng.generate([seeded])[0].tokens
    batched = eng.generate([other, seeded])[1].tokens
    again = _engine(setup).generate([seeded])[0].tokens
    assert alone == batched == again
    twins = eng.generate([dataclasses.replace(seeded, seed=7),
                          dataclasses.replace(seeded, seed=7)])
    assert twins[0].tokens == twins[1].tokens
    greedy = eng.generate([dataclasses.replace(seeded, temperature=0.0)])
    draws = {tuple(eng.generate([dataclasses.replace(seeded, seed=s)])[0]
                   .tokens) for s in range(4)}
    assert len(draws | {tuple(greedy[0].tokens)}) > 1   # it does sample
    other_seed = _engine(setup, seed=1).generate([seeded])[0].tokens
    assert other_seed != alone


def test_cancel_frees_the_slot_and_isolates_the_rest(setup):
    eng = _engine(setup, max_batch=2)
    reqs = [Request(prompt=p, max_new_tokens=8)
            for p in _prompts(8, (6, 9, 4))]
    rids = [eng.submit(r) for r in reqs]
    done = {}

    def probe(engine, step):
        if step == 3 and not done:
            done["first"] = engine.cancel(rids[0])
            done["again"] = engine.cancel(rids[0])

    results = eng.run(on_step=probe)
    assert done == {"first": True, "again": False}
    assert [r.rid for r in results] == rids
    assert results[0].finish_reason == "cancelled"
    assert len(results[0].tokens) < len(reqs[0].prompt) + 8
    assert eng.pool.free_pages == eng.pool.num_pages
    for req, res in zip(reqs[1:], results[1:]):
        assert res.tokens == eng.generate([req])[0].tokens


def test_scheduler_delivery_order_matches_reference():
    """An arrival trace with a small pool: admission, slot order and the
    reorder buffer's deliveries step for step equal the reference
    Scheduler's (the copy is plain Python)."""
    rng = np.random.default_rng(9)
    trace = [(float(a), int(n), int(life)) for a, n, life in zip(
        rng.uniform(0, 12, 12), rng.integers(1, 60, 12),
        rng.integers(1, 6, 12))]
    logs = []
    for sched in (Scheduler(3, PagedKVPool(8, 16)),
                  RefScheduler(3, PagedKVPool(8, 16))):
        rids = [sched.submit(i, arrival=a, need_tokens=n)
                for i, (a, n, _) in enumerate(trace)]
        left = {rid: life for rid, (_, _, life) in zip(rids, trace)}
        log = []
        for now in range(200):
            sched.advance(now)
            adm = [tr.rid for tr in sched.admit()]
            for rid in list(sched.slots):
                if rid is None:
                    continue
                left[rid] -= 1
                if left[rid] == 0:
                    sched.finish(sched.tracked(rid), rid)
            log.append((adm, list(sched.slots), sched.pop_ready()))
            if not sched.has_work():
                break
        logs.append(log)
    assert logs[0] == logs[1] and len(logs[0]) > 12
    assert [r for _, _, out in logs[0] for r in out] == list(range(12))


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                "--new-tokens", "3", "--max-len", "64"])
    out = capsys.readouterr().out
    assert "req1: prompt[" in out and "6 tokens in" in out
