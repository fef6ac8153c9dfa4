"""Rank programs of the port's multi-process tests (no JAX import).

``tests/test_torch_collective.py`` and ``tests/test_torch_distributed.py``
start these through ``repro_torch.distributed.spawn.run_ranks``: each
rank gets the whole global input (small, drawn from a seed by the test),
takes its own share by its rank, runs the port's collectives and returns
its results as host tensors.  The tests hold them against the reference
run in the test's own process under ``jax.vmap(axis_name="data")``.
"""

from __future__ import annotations

import numpy as np
import torch

import repro_torch
from repro_torch.core import intac as TI
from repro_torch.distributed import comm
from repro_torch.reduce import collective as TCOL
from repro_torch.reduce import accumulator as TACC
from repro_torch.reduce import get_backend, get_policy, mask_out_of_range
from repro_torch.testing.faults import drop_shard_carry

TIERS = ("fast", "compensated", "exact", "exact2", "procrastinate")
CPU = torch.device("cpu")


def shard_bounds(n: int, world: int, rank: int, block: int):
    """The reference's shard_map split of an N-row stream: N padded to a
    multiple of world * block, each rank a contiguous equal share of the
    padded rows (its real rows clipped at N)."""
    padded = n + (-n) % (world * block)
    per = padded // world
    return min(rank * per, n), min((rank + 1) * per, n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def collectives(group, *, x, res, ints, w, stream, ids, nseg, block,
                items, acc_x):
    """Every collective of the port on this rank's share of the inputs."""
    r, world = comm.axis_index(group), comm.axis_size(group)
    out = {"rank": r, "world": world}
    xr, rr = _t(x[r]), _t(res[r])
    out["psum"] = comm.psum(_t(ints[r]), group)
    out["pmax"] = comm.pmax(xr.abs().max(), group)
    out["all_gather"] = comm.all_gather(xr, group)
    nan = torch.tensor(float("nan") if r == world - 1 else float(r))
    out["pmax_nan"] = comm.pmax(nan, group)
    out["intac_psum"] = TI.intac_psum(xr, group)
    out["intac_psum2"] = TI.intac_psum2(xr, group)
    out["intac_psum3"] = TI.intac_psum3(xr, group)
    out["bin_psum"] = TI.bin_psum(xr, group)
    out["compressed"] = TI.compressed_psum_mean(xr, rr, group, bits=8)
    hi, lo, r3 = TI.limb_split3(xr, torch.tensor(2.0 ** 20))
    out["limb3_merge"] = TI.limb3_merge_across(hi, lo, r3, rr * 2.0 ** -30,
                                               group)
    for p in TIERS:
        out[f"mean/{p}"] = TCOL.collective_mean(
            xr, group, policy=p, residual=rr if p == "compensated" else None)
        out[f"wmean/{p}"] = TCOL.collective_weighted_mean(
            xr, _t(w[r]), group, policy=p)
        out[f"moments/{p}"] = TCOL.collective_moments(xr, group, policy=p)
        tree = {"a": xr, "b": xr[:2] * 3.0}
        rtree = {"a": rr, "b": rr[:2]} if p == "compensated" else None
        out[f"tree/{p}"] = TCOL.collective_mean_tree(tree, rtree, group,
                                                     policy=p)
    m = items.shape[0] // world
    mine = _t(items[r * m:(r + 1) * m])
    for p in TIERS:
        out[f"elastic/{p}"] = TCOL.elastic_reduce_mean(mine, group, policy=p,
                                                       block_size=2)
    # the sharded reduce: this rank's slice of the reference's split
    lo_, hi_ = shard_bounds(len(ids), world, r, block)
    sv, si = _t(stream[lo_:hi_]), _t(ids[lo_:hi_])
    for p in TIERS:
        out[f"reduce/{p}"] = repro_torch.reduce(
            sv, segment_ids=si, num_segments=nseg, policy=p,
            backend="shard_map", block_size=block, group=group, device=CPU)
    out["reduce_mean"] = repro_torch.reduce(
        sv, segment_ids=si, num_segments=nseg, op="mean", policy="exact2",
        block_size=block, group=group, device=CPU)
    out["reduce_status"] = repro_torch.reduce(
        sv, segment_ids=si, num_segments=nseg, policy="exact",
        block_size=block, group=group, device=CPU, with_status=True)[1]
    # each tier's carry merge, and a dropped rank: the policy's prepare on
    # the whole masked stream, this rank's domain rows, one merge
    for p in TIERS:
        pol = get_policy(p)
        mids = mask_out_of_range(_t(ids), nseg)
        mvals = torch.where((mids >= 0)[:, None], _t(stream),
                            torch.zeros(()))
        dom, _ = pol.prepare(mvals, len(ids))
        carry = get_backend("blocked").run(dom[lo_:hi_], mids[lo_:hi_], nseg,
                                           policy=pol, block_size=block)
        out[f"carry/{p}"] = carry
        out[f"merged/{p}"] = TCOL.merge_carry_across(pol, carry, group)
        out[f"dropped/{p}"] = TCOL.merge_carry_across(
            pol, drop_shard_carry(carry, group, world - 1), group)
    # the accumulators: this rank's pushes, one merge across the ranks
    mine = _t(acc_x[r])
    scale = torch.tensor(2.0 ** 20)
    accs = {"limb3": TACC.Limb3Accumulator(scale),
            "limb": TACC.LimbAccumulator(scale),
            "bin": TACC.BinAccumulator(torch.tensor(4.0)),
            "kahan": TACC.KahanAccumulator()}
    for name, acc in accs.items():
        st = acc.init(mine[0])
        for row in mine:
            st = acc.push(st, row)
        merged = TACC.merge_across(acc, st, group)
        out[f"acc/{name}"] = (merged, acc.finalize(merged))
    out["stats"] = comm.read_stats()
    return out


# ---------------------------------------------------------------------------
# training across ranks (xlstm-125m's SMOKE config, float32, on the CPU)
# ---------------------------------------------------------------------------

ARCH = "xlstm-125m"
LR_ARGS = (1e-3, 2, 20)          # cosine_schedule(base, warmup, total)
#: the elastic reductions' schedule block: the global stack's 8 rows (the
#: integer tiers' bits do not depend on it; the CPU's plain executor
#: would pad each leaf's stream to 512 rows)
ELASTIC_BLOCK = 8


def token_batch(step: int, vocab: int, rows: int = 8, seq: int = 16):
    """The global batch of ``step``: (rows, seq) tokens from a seed."""
    rng = np.random.default_rng(100 + step)
    return {"tokens": rng.integers(0, vocab, (rows, seq)).astype(np.int32)}


def _train_setup(tree, device=CPU):
    """(config, model, AdamW state, lr schedule): the model holds the
    reference's tree, or (``tree`` None) the port's draw from seed 0."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import convert, init_params
    from repro_torch.optim import adamw
    from repro_torch.train import init_state
    cfg = get_smoke_config(ARCH)
    if tree is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        model = init_params(cfg, generator=gen, device=device)
    else:
        model = convert.params_from_numpy(cfg, tree, device=device)
    return cfg, model, init_state(model), adamw.cosine_schedule(*LR_ARGS)


def _leaves(model):
    from repro_torch.models import convert
    return {k: v.detach().to(CPU, copy=True)
            for k, v in convert.stacked_leaves(model).items()}


def elastic_run(group, *, tree, steps, start=0, ckpt_dir=None, save_at=None,
                restore=False, device=CPU):
    """The elastic (exact2) step over ``steps`` global batches from
    ``start``: optionally restored from ``ckpt_dir`` first, and rank 0
    saving the state after ``save_at`` steps.  -> losses, and the leaves
    after the first step and at the end."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.distributed.collectives import make_elastic_train_step
    from repro_torch.train import checkpoint_state
    cfg, model, opt, lr_fn = _train_setup(tree, device)
    if restore:
        _, manifest, _ = ckpt.restore_latest_valid(
            ckpt_dir, checkpoint_state(model, opt), inplace=True)
        start = manifest["extra"]["next_step"]
    step_fn = make_elastic_train_step(cfg, group, lr_fn=lr_fn,
                                      microbatch_size=1,
                                      block_size=ELASTIC_BLOCK,
                                      device=device)
    out = {"losses": [], "start": start}
    for s in range(start, start + steps):
        model, opt, m = step_fn(model, opt, token_batch(s, cfg.vocab))
        out["losses"].append(m["loss"].cpu())
        if s == start:
            out["first"] = _leaves(model)
            out["first_metrics"] = {k: torch.as_tensor(v).cpu()
                                    for k, v in m.items()}
            out["first_mu"] = {k: v.to(CPU, copy=True)
                               for k, v in opt.mu.items()}
        if save_at == s + 1:
            if comm.axis_index(group) == 0:
                ckpt.save(ckpt_dir, s + 1, checkpoint_state(model, opt),
                          extra={"next_step": s + 1})
            comm.barrier(group)
    out["last"] = _leaves(model)
    out["count"] = int(opt.count)
    return out


def train_battery(group, *, tree, ckpt_dir, launch_dir):
    """At W ranks: the elastic run (4 steps, saved after 2), the
    data-parallel step (compensated, 8 bits, 2 microbatches a rank; and
    fast), ``make_train_step(grad_reduce_mesh=group)``, and the launcher's
    data-parallel path with a snapshot and a resume."""
    import contextlib
    import io

    from repro_torch.distributed.collectives import (
        init_residuals, make_shardmap_train_step)
    from repro_torch.launch import train as TL
    from repro_torch.train import make_train_step
    out = {"elastic": elastic_run(group, tree=tree, steps=4,
                                  ckpt_dir=ckpt_dir, save_at=2)}
    for policy, bits in (("compensated", 8), ("fast", None)):
        cfg, model, opt, lr_fn = _train_setup(tree)
        res = init_residuals(model) if bits else None
        step_fn = make_shardmap_train_step(
            cfg, group, lr_fn=lr_fn, num_microbatches=2, compress_bits=bits,
            device=CPU)
        losses = []
        for s in range(3):
            model, opt, res, m = step_fn(model, opt, res,
                                         token_batch(s, cfg.vocab))
            losses.append(m["loss"])
        out[f"dp/{policy}"] = {"losses": losses, "last": _leaves(model),
                               "residuals": res}
    cfg, model, opt, lr_fn = _train_setup(tree)
    step_fn = make_train_step(cfg, lr_fn=lr_fn, num_microbatches=4,
                              grad_reduce="exact", grad_reduce_mesh=group,
                              device=CPU)
    model, opt, m = step_fn(model, opt, token_batch(0, cfg.vocab))
    out["mesh_step"] = {"last": _leaves(model), "loss": m["loss"],
                        "mu": {k: v.clone() for k, v in opt.mu.items()}}
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "4",
            "--batch", "8", "--seq", "16", "--log-every", "1",
            "--compress-bits", "8", "--microbatches", "2",
            "--ckpt-dir", launch_dir, "--ckpt-every", "2"]
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        first = TL.main(argv)
        again = TL.main(argv)           # resumes past its last step
    out["launch"] = {"loss": first, "again": again, "log": text.getvalue()}
    return out


def sharded_reduce(group, *, stream, ids, nseg, block, device):
    """Every tier's ``reduce(backend="shard_map")`` of this rank's slice of
    the reference's split, on ``device`` (K1 on a CUDA device)."""
    r, world = comm.axis_index(group), comm.axis_size(group)
    lo, hi = shard_bounds(len(ids), world, r, block)
    sv = _t(stream[lo:hi]).to(device)
    si = _t(ids[lo:hi]).to(device)
    return {p: repro_torch.reduce(sv, segment_ids=si, num_segments=nseg,
                                  policy=p, backend="shard_map",
                                  block_size=block, group=group,
                                  device=device).cpu()
            for p in TIERS}


def fail_on_rank(group, *, rank, sleep=0.0):
    """Raise on ``rank`` (after ``sleep`` seconds on the others): a rank
    failing mid-group."""
    import time
    if comm.axis_index(group) == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    time.sleep(sleep)
    return comm.axis_index(group)
