"""The port's training path against the reference, on the CPU.

stablelm-1.6b's SMOKE configuration (2 layers, d_model 128, vocab 512,
float32) with the reference's ``init_params`` weights carried across by
``convert.params_from_numpy``; tokens are numpy draws from fixed seeds.
The loss, every gradient leaf (in the reference's layout,
``convert.to_reference``) and one whole train step are held to float32
tolerances stated per test: the packages sum in different orders (XLA's
dot against PyTorch's matmul), so no bit is promised across them.  What
the port does alone (``remat``, the data pipeline's copy) is held
bitwise.  The reference's train step comes from ``repro.train.steps``.
"""

import dataclasses
import io
import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as RC  # noqa: E402
from repro.data import pipeline as RP  # noqa: E402
from repro.models import model as RM  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.train import steps as RS  # noqa: E402
from repro_torch import configs as TC  # noqa: E402
from repro_torch.data import pipeline as TP  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.train import steps as TS  # noqa: E402

ARCH = "stablelm-1.6b"
CPU = "cpu"
#: the loss of the two packages: float32 xent of about 6.7, where one ulp
#: is 4.8e-7 (measured: 1.9e-6)
LOSS_ATOL = 8e-6
#: every gradient leaf and AdamW moment: max |ref - port| over the leaf's
#: largest |value| (measured: 1.41e-6 the gradients, 1.69e-6 the moments)
GRAD_REL = 1e-5
#: the first AdamW step of an element is g / (|g| + 1e-8), which moves by
#: up to |dg| / 1e-8 for a gradient error dg: gradients within ~1e-8 of
#: zero, which both packages reach by cancelling sums in their own
#: orders (dg about 1e-9), move their step by a share of one step
#: (measured: 0.079 of lr); where |g| >= 1e-6 (|mu| >= 1e-7) the step is
#: about sign(g) and the parameters agree tightly (measured: 1.4e-5 of
#: lr)
PARAM_LR_SHARE = 0.25
PARAM_LR_SHARE_LIVE = 1e-4
LR = 1e-2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def smoke():
    cfg = RC.get_smoke_config(ARCH)
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    return cfg, params, jax.tree.map(np.asarray, params)


def _model(tree, tcfg=None):
    tcfg = tcfg or TC.get_smoke_config(ARCH)
    return convert.params_from_numpy(tcfg, tree, device=CPU)


def _tokens(seed=0, shape=(4, 16), vocab=512):
    return np.random.default_rng(seed).integers(
        0, vocab, size=shape).astype(np.int32)


def _port_grads(model, batch, remat=False):
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = TM.loss_fn(model, batch, remat=remat)
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss.detach(), metrics, convert.to_reference(
        model.cfg, dict(zip(named, grads)))


def _leaf_close(ref_leaves, port, rel, what):
    for (path, got), ref in zip(port.items(), ref_leaves):
        ref = np.asarray(ref, np.float32)
        got = got.detach().numpy()
        assert ref.shape == got.shape, (what, path)
        err = float(np.abs(ref - got).max())
        assert err <= rel * float(np.abs(ref).max()), \
            f"{what} {path}: max |ref - port| = {err:g}"


@pytest.mark.parametrize("case", ("next_token", "chunked_masked"))
def test_loss_and_grads_within_tolerance_of_reference(smoke, case):
    """``loss_fn`` and every gradient leaf against ``jax.value_and_grad``
    of the reference's: next-token labels in one chunk, and given labels
    with a loss mask over two sequence chunks (``loss_chunk`` = 8)."""
    cfg, params, tree = smoke
    tcfg = TC.get_smoke_config(ARCH)
    toks = _tokens(seed=1)
    batch = {"tokens": toks}
    if case == "chunked_masked":
        cfg = dataclasses.replace(cfg, loss_chunk=8)
        tcfg = dataclasses.replace(tcfg, loss_chunk=8)
        rng = np.random.default_rng(2)
        batch["labels"] = rng.integers(0, cfg.vocab, toks.shape).astype(
            np.int32)
        batch["loss_mask"] = (rng.random(toks.shape) < 0.7).astype(
            np.float32)

    def ref_loss(p):
        return RM.loss_fn(p, cfg, {k: jnp.asarray(v)
                                   for k, v in batch.items()})

    (rl, rmet), rg = jax.jit(jax.value_and_grad(ref_loss, has_aux=True))(
        params)
    tl, tmet, tg = _port_grads(
        _model(tree, tcfg), {k: torch.from_numpy(v)
                             for k, v in batch.items()})
    assert abs(float(rl) - float(tl)) <= LOSS_ATOL
    assert float(tmet["tokens"]) == float(rmet["tokens"])
    assert float(tmet["aux"]) == float(rmet["aux"]) == 0.0
    assert list(tg) == ["/".join(str(getattr(k, "key", getattr(k, "idx",
                                                                 k)))
                                 for k in path)
                        for path, _ in jax.tree_util.tree_leaves_with_path(
                            rg)]
    _leaf_close(jax.tree.leaves(rg), tg, GRAD_REL, case)


STEPS = {"m1": {"num_microbatches": 1},
         "juggler_m2": {"num_microbatches": 2},
         "exact_m2": {"num_microbatches": 2, "grad_reduce": "exact",
                      "norm_policy": "exact"}}


@pytest.mark.parametrize("case", sorted(STEPS))
def test_train_step_within_tolerance_of_reference(smoke, case):
    """One ``make_train_step`` step (remat on, as the reference's default)
    from the same weights and batch: the parameters, the AdamW moments,
    the grad norm, the loss and lr against the reference's jitted step."""
    cfg, params, tree = smoke
    kw = STEPS[case]
    toks = _tokens(seed=3)
    ref_step = jax.jit(RS.make_train_step(
        cfg, lr_fn=RA.cosine_schedule(LR, 1, 5), **kw))
    rp, rs, rmet = ref_step(params, RA.init(params),
                            {"tokens": jnp.asarray(toks)})
    model = _model(tree)
    step = TS.make_train_step(model.cfg, lr_fn=TA.cosine_schedule(LR, 1, 5),
                              device=CPU, **kw)
    model, ts, tmet = step(model, TS.init_state(model), {"tokens": toks})
    assert int(ts.count) == int(rs.count) == 1
    assert float(tmet["lr"]) == float(rmet["lr"])
    assert abs(float(tmet["loss"]) - float(rmet["loss"])) <= LOSS_ATOL
    assert float(tmet["grad_norm"]) == pytest.approx(
        float(rmet["grad_norm"]), rel=1e-6)
    _leaf_close(jax.tree.leaves(rs.mu), ts.mu, GRAD_REL, "mu")
    _leaf_close(jax.tree.leaves(rs.nu), ts.nu, GRAD_REL, "nu")
    for (path, got), ref, mu in zip(convert.stacked_leaves(model).items(),
                                    jax.tree.leaves(rp),
                                    jax.tree.leaves(rs.mu)):
        err = np.abs(np.asarray(ref) - got.numpy())
        live = np.abs(np.asarray(mu)) >= 1e-7
        assert float(err.max()) <= PARAM_LR_SHARE * LR, path
        assert float(err[live].max(initial=0.0)) <= \
            PARAM_LR_SHARE_LIVE * LR, path


def test_remat_bitwise_no_remat(smoke):
    """``remat`` recomputes each block in the backward: the loss and every
    gradient are bitwise the same as without it."""
    _, _, tree = smoke
    batch = {"tokens": torch.from_numpy(_tokens(seed=4))}
    l0, _, g0 = _port_grads(_model(tree), batch, remat=False)
    l1, _, g1 = _port_grads(_model(tree), batch, remat=True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)


def test_data_pipeline_batches_bitwise_reference(tmp_path):
    """``SyntheticLM.batch(step)`` (host-sharded, with the motif rows) and
    ``PackedFile`` give the reference's tokens bit for bit."""
    for kw in ({"vocab": 512, "seq_len": 64, "global_batch": 8, "seed": 3},
               {"vocab": 100352, "seq_len": 32, "global_batch": 4,
                "seed": 0, "num_hosts": 2, "host_id": 1}):
        rs, ts = RP.SyntheticLM(RP.DataCfg(**kw)), \
            TP.SyntheticLM(TP.DataCfg(**kw))
        for step in (0, 1, 7):
            r, t = rs.batch(step)["tokens"], ts.batch(step)["tokens"]
            assert r.dtype == t.dtype == np.int32
            assert np.array_equal(r, t)
    path = tmp_path / "tokens.bin"
    np.arange(5000, dtype=np.uint16).tofile(path)
    kw = {"vocab": 512, "seq_len": 48, "global_batch": 4, "seed": 0}
    rf = RP.make_source(RP.DataCfg(**kw), str(path))
    tf = TP.make_source(TP.DataCfg(**kw), str(path))
    assert isinstance(tf, TP.PackedFile) and tf.rows == rf.rows
    for step in (0, 5, 40):
        assert np.array_equal(rf.batch(step)["tokens"],
                              tf.batch(step)["tokens"])


def test_reference_layout_round_trip(smoke):
    """``to_reference`` of a model from ``params_from_numpy`` is the
    reference tree, leaf by leaf in ``jax.tree.leaves`` order, bitwise,
    and names every parameter once."""
    _, params, tree = smoke
    model = _model(tree)
    leaves = convert.to_reference(model.cfg, dict(model.named_parameters()))
    assert len(leaves) == len(jax.tree.leaves(params)) == 12
    for got, ref in zip(leaves.values(), jax.tree.leaves(tree)):
        assert np.array_equal(got.numpy(), ref)
    names = [n for _, ns in convert.reference_leaves(model.cfg) for n in ns]
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())


def test_stacked_leaves_share_the_parameters_storage(smoke):
    """``stacked_leaves`` (the train step's layout) is the reference tree
    bitwise, leaves the model's function bitwise as it was, and shares
    storage with the parameters: a write to a leaf shows in the model; a
    second call returns the same leaves, and a parameter given new
    storage is stacked anew."""
    _, params, tree = smoke
    model = _model(tree)
    toks = torch.from_numpy(_tokens(seed=8))
    with torch.no_grad():
        before = TM.forward(model, tokens=toks)[0]
        leaves = convert.stacked_leaves(model)
        after = TM.forward(model, tokens=toks)[0]
    assert torch.equal(before, after)
    for got, ref in zip(leaves.values(), jax.tree.leaves(tree)):
        assert np.array_equal(got.numpy(), ref)
    assert convert.stacked_leaves(model) is leaves
    named = dict(model.named_parameters())
    path, names = next((p, n) for p, n in convert.reference_leaves(model.cfg)
                       if p.startswith("blocks/"))
    with torch.no_grad():
        leaves[path][-1].add_(1.0)
    assert torch.equal(named[names[-1]], leaves[path][-1])
    named[names[0]].data = named[names[0]].data.clone()
    again = convert.stacked_leaves(model)
    assert again is not leaves and torch.equal(again[path], leaves[path])
    assert named[names[0]].data_ptr() == again[path][0].data_ptr()


def test_params_from_numpy_model_trains(smoke):
    """A model from ``params_from_numpy`` holds its parameters without
    gradients (serving's); the train step switches them on, and two
    steps on one batch take every leaf off its start and lower the
    loss."""
    _, _, tree = smoke
    model = _model(tree)
    assert not any(p.requires_grad for p in model.parameters())
    before = {k: v.clone() for k, v in convert.to_reference(
        model.cfg, dict(model.named_parameters())).items()}
    step = TS.make_train_step(model.cfg, lr_fn=TA.cosine_schedule(LR, 1, 5),
                              device=CPU, remat=False)
    state = TS.init_state(model)
    batch = {"tokens": _tokens(seed=5)}
    losses = []
    for _ in range(2):
        model, state, met = step(model, state, batch)
        losses.append(float(met["loss"]))
    assert all(p.requires_grad for p in model.parameters())
    # the moments are the reference's leaves; the parameters view the
    # stacked leaves the update wrote in place
    assert list(state.mu) == list(before) and int(state.count) == 2
    after = convert.stacked_leaves(model)
    assert all(torch.equal(after[k], v) for k, v in convert.to_reference(
        model.cfg, dict(model.named_parameters())).items())
    assert all(not torch.equal(before[k], after[k]) for k in before)
    assert np.isfinite(losses).all() and losses[1] < losses[0]


def test_eval_and_prefill_steps_within_tolerance_of_reference(smoke):
    """``make_eval_step``'s loss and ``make_prefill_step``'s last-position
    logits against the reference's (logits about N(0, 1): 2e-5, as the
    model tests hold them)."""
    cfg, params, tree = smoke
    model = _model(tree)
    toks = _tokens(seed=6)
    rev = RS.make_eval_step(cfg)(params, {"tokens": jnp.asarray(toks)})
    tev = TS.make_eval_step(model.cfg, device=CPU)(model, {"tokens": toks})
    assert abs(float(rev["loss"]) - float(tev["loss"])) <= LOSS_ATOL
    rlog, _ = RS.make_prefill_step(cfg)(params,
                                        {"tokens": jnp.asarray(toks)})
    tlog, caches = TS.make_prefill_step(model.cfg, device=CPU)(
        model, {"tokens": toks})
    assert tlog.shape == rlog.shape == (4, 1, cfg.padded_vocab)
    assert float(np.abs(np.asarray(rlog) - tlog.numpy()).max()) <= 2e-5
    dstep = TS.make_decode_step(model.cfg, device=CPU)
    caches = TM.pad_caches_to(model.cfg, caches, toks.shape[1] + 1)
    logits, _ = dstep(model, tlog.argmax(-1), caches, toks.shape[1])
    assert logits.shape == (4, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())


def test_knobs_the_port_lacks_raise(smoke):
    """No fallback: every knob this slice does not port raises
    ``NotImplementedError`` naming its ROADMAP item (``logits_pspec``:
    item 6, ``distributed/sharding.py``), ``grad_reduce_mesh`` is a
    process group whose misuse raises ``ValueError`` (a group without
    ``grad_reduce``; an object that is no group), a model with experts
    builds a step, and a train step without a device asks for CUDA.  A
    decoder-only model ignores an encoder-decoder's inputs, as the
    reference does: ``enc_embeds`` in the loss's batch leaves the loss
    bitwise the same, and ``make_decode_step(...)(enc_out=)`` gives the
    logits of the step without it."""
    _, _, tree = smoke
    tcfg = TC.get_smoke_config(ARCH)
    lr = TA.cosine_schedule(LR, 1, 5)
    for kw, item in (({"logits_pspec": object()}, "item 6"),):
        with pytest.raises(NotImplementedError, match=item):
            TS.make_train_step(tcfg, lr_fn=lr, device=CPU, **kw)
    with pytest.raises(NotImplementedError, match="distributed/sharding"):
        TM.loss_fn(_model(tree),
                   {"tokens": torch.ones(1, 4, dtype=torch.int32)},
                   logits_pspec=object())
    from repro_torch.distributed import comm
    with pytest.raises(ValueError, match="grad_reduce"):
        TS.make_train_step(tcfg, lr_fn=lr, device=CPU, num_microbatches=2,
                           grad_reduce_mesh=comm.init_group("gloo"))
    with pytest.raises((TypeError, ValueError, RuntimeError, AttributeError)):
        TS.make_train_step(tcfg, lr_fn=lr, device=CPU, num_microbatches=2,
                           grad_reduce="exact", grad_reduce_mesh=object())
    # a model with experts trains (tests/test_torch_moe_train.py)
    assert callable(TS.make_train_step(TC.get_smoke_config("mixtral-8x22b"),
                                       lr_fn=lr, device=CPU))
    model = _model(tree)
    toks = torch.from_numpy(_tokens(seed=9, shape=(1, 4)))
    plain, _ = TM.loss_fn(model, {"tokens": toks})
    with_enc, _ = TM.loss_fn(model, {"tokens": toks,
                                     "enc_embeds": torch.ones(1, 4, 128)})
    assert torch.equal(plain, with_enc)
    dstep = TS.make_decode_step(tcfg, device=CPU)
    outs = []
    for enc_out in (None, torch.ones(1, 4, 128)):
        caches = TM.init_caches(tcfg, 1, 8, device=CPU)
        outs.append(dstep(model, [[1]], caches, 0, enc_out=enc_out)[0])
    assert torch.equal(outs[0], outs[1])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.make_train_step(tcfg, lr_fn=lr)


def test_launch_train_smoke_on_the_cpu_and_flags_that_raise(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu``: two
    logged steps with a finite loss; with ``--ckpt-dir`` and
    ``--ckpt-every 1`` it saves step 1 and a second run resumes past it;
    the compression and microbatch flags run the data-parallel step over
    the environment's group (here one rank: this process), with finite
    losses, and a world size other than the environment's raises;
    without ``--device`` it asks for CUDA."""
    out = io.StringIO()
    argv = ["--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
            "--seq", "16", "--log-every", "1"]
    with contextlib.redirect_stdout(out):
        loss = TL.main(argv)
    lines = out.getvalue().splitlines()
    assert [ln.split()[:2] for ln in lines[:2]] == [["step", "0"],
                                                    ["step", "1"]]
    assert lines[-1].startswith("done: 2 steps") and np.isfinite(loss)
    ckpt = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "1"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert TL.main(argv + ckpt) == loss
        assert TL.main(argv + ckpt) is None
    lines = out.getvalue().splitlines()
    assert "[ckpt] saved step 1" in lines
    assert lines[-2:] == ["[restore] resumed from step 1 -> next 2",
                          "done: 0 steps"]
    for flags in (["--compress-bits", "8"], ["--microbatches", "2"]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            dp = TL.main(["--smoke", "--device", "cpu", "--steps", "2",
                          "--batch", "4", "--seq", "16", "--log-every",
                          "1"] + flags)
        lines = out.getvalue().splitlines()
        assert [ln.split()[:2] for ln in lines[:2]] == [["step", "0"],
                                                        ["step", "1"]]
        assert np.isfinite(dp)
    with pytest.raises(ValueError, match="world-size"):
        TL.main(["--smoke", "--device", "cpu", "--steps", "1",
                 "--microbatches", "2", "--world-size", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TL.main(["--smoke", "--steps", "1"])
