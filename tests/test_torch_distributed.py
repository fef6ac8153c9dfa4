"""Training across the ranks of a gloo process group: the elastic step,
the data-parallel step, the train step's ``grad_reduce_mesh`` group, the
launcher's data-parallel path and the checkpoint of a train state with
residuals, on xlstm-125m's SMOKE config on the CPU.

Groups of 2 and 4 ranks run ``tests/torch_dist_workers.py`` (fresh
interpreters, one torch thread each, ``file://`` stores under the test's
temporary directory); this process, at one thread, holds a one-rank
group.  The reference's elastic step is composed here as its
``make_elastic_train_step`` composes it, with no ``shard_map``: the
jitted ``loss_fn`` gradients of each one-row microbatch, each leaf's
``elastic_reduce_mean`` under ``jax.vmap(axis_name="data")`` over the 2
ranks' stacks, and ``adamw.update``.  The port's step is held to it
within the train tests' tolerances (``tests/test_torch_train.py``,
``tests/test_torch_xlstm.py``); the port's resume from 2 ranks onto 4
and onto 1 is held to its uninterrupted run bit for bit.
"""

import concurrent.futures
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as r_smoke  # noqa: E402
from repro.models import init_params as r_init  # noqa: E402
from repro.models import loss_fn as r_loss  # noqa: E402
from repro.optim import adamw as RA  # noqa: E402
from repro.reduce.collective import (  # noqa: E402
    elastic_reduce_mean as r_elastic)

from repro_torch.ckpt import checkpoint as TCK  # noqa: E402
from repro_torch.distributed import comm, spawn  # noqa: E402
from repro_torch.distributed.collectives import init_residuals  # noqa: E402
from repro_torch.launch import mesh as TMESH  # noqa: E402
from repro_torch.models import convert  # noqa: E402
from repro_torch.train import checkpoint_state, make_train_step  # noqa: E402

import torch_dist_workers as WK  # noqa: E402

TESTS = str(Path(__file__).resolve().parent)
CPU = "cpu"
#: the loss (about 5.57, float32) of one elastic step: the 8 microbatch
#: losses differ from the reference's by a few ulps each
#: (``tests/test_torch_xlstm.py``: LOSS_ATOL)
LOSS_ATOL = 1e-5
#: every AdamW moment against the reference's, over the leaf's largest
#: value: the gradients agree to GRAD_REL (``tests/test_torch_xlstm.py``)
GRAD_REL = 1e-4
#: the parameters after one step, in shares of the step's lr: the first
#: AdamW step of an element is g / (|g| + 1e-8), so a gradient within
#: ~1e-8 of zero may move by a share of a step; elsewhere (|mu| >= 1e-7)
#: it is about sign(g) and agrees tightly (``tests/test_torch_train.py``;
#: measured here: 0.039 of lr, and 9.3e-5 of lr where |mu| >= 1e-7, the
#: xlstm gradients being 10x looser than stablelm's)
PARAM_LR_SHARE = 0.25
PARAM_LR_SHARE_LIVE = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The ranks run one thread each; this process's one-rank group must
    compute the same microbatch gradients bit for bit, so it does too."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference_step(cfg, params):
    """The reference's elastic step at 2 devices, composed: (new params,
    AdamW state, grad norm, loss, lr)."""
    toks = WK.token_batch(0, cfg.vocab)["tokens"]
    grad = jax.jit(jax.value_and_grad(lambda p, t: r_loss(
        p, cfg, {"tokens": t}, moe_impl="dense")[0]))
    losses, grads = [], []
    for i in range(toks.shape[0]):
        loss, g = grad(params, jnp.asarray(toks[i:i + 1]))
        losses.append(loss)
        grads.append(g)
    # each leaf's stack of 8, split over the 2 devices of a "data" axis;
    # one jitted reduction per leaf shape
    elastic = jax.jit(jax.vmap(lambda s: r_elastic(
        s, ("data",), block_size=WK.ELASTIC_BLOCK), axis_name="data"))
    means = jax.tree.map(lambda *g: elastic(jnp.stack(g).reshape(
        (2, 4) + g[0].shape))[0], *grads)
    loss = elastic(jnp.stack(losses).reshape(2, 4))[0]
    opt0 = RA.init(params)
    lr = RA.cosine_schedule(*WK.LR_ARGS)(opt0.count + 1)
    rp, rs, gnorm = RA.update(means, opt0, params, lr=lr, clip_norm=1.0)
    return rp, rs, gnorm, loss, lr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference tree and step, the 2-rank battery (its elastic run
    saved after 2 of 4 steps) and the 4-rank resume from that snapshot;
    the ranks run while this process composes the reference's step."""
    cfg = r_smoke(WK.ARCH)
    params = r_init(jax.random.PRNGKey(0), cfg)
    tree = jax.tree.map(np.asarray, params)
    root = tmp_path_factory.mktemp("distributed")
    ck = str(root / "ck")

    def groups():
        w2 = spawn.run_ranks("torch_dist_workers:train_battery", 2,
                             workdir=root / "w2",
                             kwargs={"tree": tree, "ckpt_dir": ck,
                                     "launch_dir": str(root / "launch")},
                             paths=[TESTS], threads=1, timeout=300)
        w4 = spawn.run_ranks("torch_dist_workers:elastic_run", 4,
                             workdir=root / "w4",
                             kwargs={"tree": tree, "steps": 2,
                                     "ckpt_dir": ck, "restore": True},
                             paths=[TESTS], threads=1, timeout=300)
        return w2, w4
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(groups)
        ref = _reference_step(cfg, params)
        w2, w4 = ranks.result()
    return {"cfg": cfg, "params": params, "tree": tree, "ckpt": ck,
            "ref": ref, "w2": w2, "w4": w4}


def _same_leaves(a, b):
    assert list(a) == list(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _replicated(outs, pick):
    first = pick(outs[0])
    for o in outs[1:]:
        other = pick(o)
        if isinstance(first, dict):
            _same_leaves(first, other)
        else:
            assert torch.equal(first, other)
    return first


def test_elastic_step_at_two_ranks_matches_the_reference_step(runs):
    """One elastic step (exact2, one-row microbatches, the global batch of
    8 split over 2 ranks) against the reference's step composed here:
    the loss, the AdamW moments and the parameters within the train
    tests' tolerances; both ranks hold the same bits."""
    rp, rs, gnorm, loss, lr = runs["ref"]
    outs = runs["w2"]
    got = _replicated(outs, lambda o: o["elastic"]["first"])
    met = outs[0]["elastic"]["first_metrics"]
    assert abs(float(met["loss"]) - float(loss)) <= LOSS_ATOL
    assert float(met["lr"]) == float(lr)
    assert float(met["grad_norm"]) == pytest.approx(float(gnorm), rel=1e-4)
    for (path, got_mu), mu in zip(outs[0]["elastic"]["first_mu"].items(),
                                  jax.tree.leaves(rs.mu)):
        mu = np.asarray(mu)
        err = float(np.abs(mu - got_mu.numpy()).max())
        assert err <= GRAD_REL * float(np.abs(mu).max()), path
    for (path, p), ref, mu in zip(got.items(), jax.tree.leaves(rp),
                                  jax.tree.leaves(rs.mu)):
        err = np.abs(np.asarray(ref) - p.numpy())
        live = np.abs(np.asarray(mu)) >= 1e-7
        assert float(err.max()) <= PARAM_LR_SHARE * float(lr), path
        assert float(err[live].max(initial=0.0)) <= \
            PARAM_LR_SHARE_LIVE * float(lr), path


def test_elastic_resume_from_two_ranks_onto_four_and_one_is_bitwise(runs):
    """The acceptance test of the reference (``tests/test_faults.py``,
    2 devices onto 8) on the port: 4 steps on 2 ranks; the snapshot after
    step 2, restored on 4 ranks and on 1 (this process), trains steps 3
    and 4: every loss and every parameter bit for bit the uninterrupted
    run's."""
    whole = runs["w2"][0]["elastic"]
    _replicated(runs["w2"], lambda o: o["elastic"]["last"])
    four = runs["w4"]
    assert all(o["start"] == 2 and o["count"] == 4 for o in four)
    _same_leaves(_replicated(four, lambda o: o["last"]), whole["last"])
    for a, b in zip(four[0]["losses"], whole["losses"][2:]):
        assert torch.equal(a, b)
    one = WK.elastic_run(comm.init_group("gloo"), tree=runs["tree"],
                         steps=2, ckpt_dir=runs["ckpt"], restore=True)
    assert one["start"] == 2 and one["count"] == 4
    _same_leaves(one["last"], whole["last"])
    for a, b in zip(one["losses"], whole["losses"][2:]):
        assert torch.equal(a, b)
    assert len({float(v) for v in whole["losses"]}) == 4


def test_data_parallel_step_fast_is_the_one_process_juggler_step(runs):
    """The data-parallel step at 2 ranks, 2 microbatches each, fast tier:
    each rank's juggler mean, then the ranks' pinned tree mean (halvings
    are exact), is bitwise the one-process step's juggler mean over the 4
    microbatches: the same parameters after 3 steps, the losses within
    LOSS_ATOL (a mean in another order)."""
    outs = runs["w2"]
    got = _replicated(outs, lambda o: o["dp/fast"]["last"])
    _, model, opt, lr_fn = WK._train_setup(runs["tree"])
    step = make_train_step(model.cfg, lr_fn=lr_fn, num_microbatches=4,
                           moe_impl="dense", remat=False, device=CPU)
    for s, loss in enumerate(outs[0]["dp/fast"]["losses"]):
        model, opt, m = step(model, opt, WK.token_batch(s, model.cfg.vocab))
        assert abs(float(m["loss"]) - float(loss)) <= LOSS_ATOL
    _same_leaves(got, WK._leaves(model))


def test_data_parallel_step_compensated_keeps_each_ranks_residual(runs):
    """The compressed (8-bit, error-feedback) step at 2 ranks: the
    parameters replicated bit for bit, each rank's residual its own
    (nonzero, different across ranks, below half a quantum of the
    step's largest gradient), the losses finite and near the fast tier's."""
    outs = runs["w2"]
    _replicated(outs, lambda o: o["dp/compensated"]["last"])
    r0, r1 = (o["dp/compensated"]["residuals"] for o in outs)
    assert any(bool(v.ne(0).any()) for v in r0.values())
    assert any(not torch.equal(r0[k], r1[k]) for k in r0)
    comp = [float(v) for v in outs[0]["dp/compensated"]["losses"]]
    fast = [float(v) for v in outs[0]["dp/fast"]["losses"]]
    assert np.all(np.isfinite(comp))
    assert abs(comp[0] - fast[0]) <= LOSS_ATOL
    assert max(abs(a - b) for a, b in zip(comp, fast)) < 0.05


def test_train_step_with_a_group_is_the_one_process_step(runs):
    """``make_train_step(grad_reduce="exact", num_microbatches=4,
    grad_reduce_mesh=group)`` at 2 ranks (2 microbatches each, each
    leaf's mean through the ``shard_map`` executor): bitwise the
    parameters and moments of the one-process step, the loss equal."""
    outs = runs["w2"]
    got = _replicated(outs, lambda o: o["mesh_step"]["last"])
    _, model, opt, lr_fn = WK._train_setup(runs["tree"])
    step = make_train_step(model.cfg, lr_fn=lr_fn, num_microbatches=4,
                           grad_reduce="exact", device=CPU)
    model, opt, m = step(model, opt, WK.token_batch(0, model.cfg.vocab))
    _same_leaves(got, WK._leaves(model))
    _same_leaves(outs[0]["mesh_step"]["mu"], opt.mu)
    assert torch.equal(outs[0]["mesh_step"]["loss"], m["loss"])
    with pytest.raises(ValueError, match="grad_reduce"):
        make_train_step(model.cfg, lr_fn=lr_fn, num_microbatches=4,
                        grad_reduce_mesh=comm.init_group("gloo"), device=CPU)


def test_launcher_data_parallel_on_two_ranks(runs):
    """``launch.train --compress-bits 8 --microbatches 2`` in each of 2
    ranks: rank 0 alone logs 4 steps with finite losses, saves step 2
    with the ranks' residuals, and a second run resumes past it."""
    outs = runs["w2"]
    log = outs[0]["launch"]["log"].splitlines()
    steps = [ln for ln in log if ln.startswith("step")]
    assert [ln.split()[1] for ln in steps] == ["0", "1", "2", "3", "3"]
    assert all(np.isfinite(float(ln.split()[3])) for ln in steps)
    assert "[ckpt] saved step 2" in log
    assert "[restore] resumed from step 2 -> next 3" in log
    assert outs[0]["launch"]["loss"] == outs[0]["launch"]["again"]
    assert outs[1]["launch"]["log"] == ""           # rank 1 prints nothing
    assert outs[1]["launch"]["loss"] == outs[0]["launch"]["loss"]


def test_checkpoint_state_with_residuals_round_trip(runs, tmp_path):
    """``checkpoint_state(model, opt, residuals)`` nests the residuals
    under "residuals" by the reference's leaf paths; a snapshot restores
    into a fresh state bit for bit, on the device of the template."""
    _, model, opt, _ = WK._train_setup(runs["tree"])
    res = init_residuals(model)
    for i, v in enumerate(res.values()):
        v.fill_(0.5 ** (i + 3))
    state = checkpoint_state(model, opt, res)
    assert set(state) == {"params", "opt", "residuals"}
    assert list(TCK.flatten(state["residuals"])) == \
        list(TCK.flatten(state["params"]))
    TCK.save(tmp_path, 1, state, extra={"next_step": 2})
    _, m2, o2, _ = WK._train_setup(runs["tree"])
    r2 = init_residuals(m2)
    TCK.restore(tmp_path, 1, checkpoint_state(m2, o2, r2), inplace=True)
    _same_leaves(r2, res)
    _same_leaves(convert.stacked_leaves(m2), convert.stacked_leaves(model))


def test_launch_mesh_is_the_process_group():
    """``launch/mesh.py``: the reference's ``make_mesh`` is the port's
    ``init_group`` (one data-parallel axis, the world)."""
    g = TMESH.make_mesh("gloo")
    assert g is comm.init_group("gloo")
    assert TMESH.axis_size(g) == 1



def test_a_failed_or_late_rank_fails_the_group(tmp_path):
    """``spawn.run_ranks``: a rank that raises stops its group and raises
    ``RankFailure`` with the rank's own error; a group past its timeout
    is stopped and raises too; no partial result comes back."""
    with pytest.raises(spawn.RankFailure, match="fails on purpose"):
        spawn.run_ranks("torch_dist_workers:fail_on_rank", 2,
                        workdir=tmp_path / "fail", kwargs={"rank": 1},
                        paths=[TESTS], threads=1, timeout=120)
    with pytest.raises(spawn.RankFailure, match="timeout"):
        spawn.run_ranks("torch_dist_workers:fail_on_rank", 2,
                        workdir=tmp_path / "late",
                        kwargs={"rank": 5, "sleep": 60.0}, paths=[TESTS],
                        threads=1, timeout=8)
