"""Data-parallel train steps across the ranks of a process group, as the
reference's ``repro.distributed.collectives``.

One process per rank; every rank holds the whole model (the parameters
replicated, pure data parallelism) and calls the step with the same
global batch, of which it takes its own contiguous rows, as the
reference's ``shard_map`` splits a batch over the ``data`` axis.  Only
gradients, losses and integer payloads cross between ranks, and only
through ``repro_torch.reduce``'s collective means:

  * ``make_shardmap_train_step`` — the gradient mean is
    ``collective_mean_tree`` under one accuracy policy (``compensated``
    with ``compress_bits``: the INTAC compressed mean with error
    feedback, the residuals carried from step to step); the microbatch
    gradients of a rank accumulate through the JugglePAC pairing tree,
    or with ``microbatch_reduce`` through ``repro_torch.reduce`` (K1 on a
    CUDA device);
  * ``make_elastic_train_step`` — the topology-elastic step: the
    microbatch grid is pinned to the global batch (``microbatch_size``
    rows each, whichever rank computes them), and every gradient leaf and
    the loss are ``elastic_reduce_mean``s over the global microbatch
    stack under a bitwise policy.  The same parameters and batch give
    bitwise the same new parameters and loss at any rank count: train
    on 2 ranks, checkpoint, resume on 4 or on 1, and the run goes on bit
    for bit.

Each rank's gradients are those of ``train.make_grad_fn`` (``loss_fn``
and autograd, the reference's layout) and the update is ``adamw``'s, in
place on the model's stacked leaves, as ``train.make_train_step`` runs
them.  A microbatch's gradients must be the same bits on whichever rank
computes them: the same shapes (so the same library kernels) and no
atomics in any backward.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import resolve_device
from ..models import convert
from ..models.config import ModelConfig
from ..models.model import check_supported
from ..reduce.accumulator import (accumulate_microbatch_grads,
                                  reduce_microbatch_grads)
from ..reduce.collective import (collective_mean, collective_mean_tree,
                                 elastic_reduce_mean)
from ..train.steps import _to_device, apply_update, make_grad_fn
from . import comm


def rank_rows(batch, group):
    """This rank's contiguous share of a global batch (a dict of (B, ...)
    tensors): rows [r * B / W, (r + 1) * B / W)."""
    w, r = comm.axis_size(group), comm.axis_index(group)
    rows = next(iter(batch.values())).shape[0]
    if rows % w:
        raise ValueError(f"a global batch of {rows} rows does not split "
                         f"over {w} ranks")
    per = rows // w
    return {k: v[r * per:(r + 1) * per] for k, v in batch.items()}


def make_shardmap_train_step(cfg: ModelConfig, group, *, lr_fn: Callable,
                             num_microbatches: int = 1,
                             compress_bits: Optional[int] = 8,
                             reduce_policy: Optional[str] = None,
                             microbatch_reduce: Optional[str] = None,
                             moe_impl: str = "dense", remat: bool = False,
                             clip_norm: float = 1.0, device=None):
    """-> ``step(model, opt_state, residuals, batch) -> (model, opt_state,
    residuals, metrics)``; params replicated on every rank.

    ``batch`` is the global batch; its rows divide by W *
    ``num_microbatches``.  ``reduce_policy`` is the collective tier;
    None derives it from ``compress_bits`` (bits set: "compensated",
    else "fast").  ``residuals`` is ``init_residuals(model)`` (each
    rank's own; only "compensated" changes them) or None.
    ``microbatch_reduce`` (a policy name) takes a rank's microbatch mean
    through ``repro_torch.reduce`` on the rank's own device instead of
    the pairing tree.  The loss is the ranks' mean by the fixed pairwise
    tree (a logged metric; the gradients take the policy)."""
    check_supported(cfg)
    dev = resolve_device(device)
    policy = reduce_policy or ("compensated" if compress_bits is not None
                               else "fast")
    bits = compress_bits if compress_bits is not None else 8
    m = num_microbatches
    grad_fn = make_grad_fn(cfg, moe_impl=moe_impl, remat=remat)

    def step(model, opt_state, residuals, batch):
        model.requires_grad_(True)
        local = rank_rows(_to_device(batch, dev), group)
        if m > 1:
            mbs = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])
                   for k, v in local.items()}
            if microbatch_reduce is not None:
                grads, (losses, _) = reduce_microbatch_grads(
                    grad_fn, model, mbs, num_microbatches=m,
                    policy=microbatch_reduce)
            else:
                grads, (losses, _) = accumulate_microbatch_grads(
                    grad_fn, model, mbs, num_microbatches=m)
            # detlint: ok[DET001] m microbatch loss scalars, a logging metric;
            # the gradients take the front door above (reference
            # distributed/collectives.py:122)
            loss = losses.mean()
        else:
            grads, (loss, _) = grad_fn(model, local)
        grads, residuals = collective_mean_tree(grads, residuals, group,
                                                policy=policy, bits=bits)
        opt_state, gnorm, lr = apply_update(model, opt_state, grads, lr_fn,
                                            clip_norm=clip_norm)
        loss, _ = collective_mean(loss, group, policy="fast")
        return model, opt_state, residuals, {"loss": loss,
                                             "grad_norm": gnorm, "lr": lr}
    return step


def make_elastic_train_step(cfg: ModelConfig, group, *, lr_fn: Callable,
                            microbatch_size: int = 1,
                            moe_impl: str = "dense", remat: bool = False,
                            clip_norm: float = 1.0, policy: str = "exact2",
                            block_size: int = 512, device=None):
    """-> ``step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the same parameters and global batch give bitwise the
    same new parameters and loss at any rank count.

    Each rank takes its contiguous rows of ``batch`` and runs them in
    slices of ``microbatch_size`` rows, so the set of microbatches is the
    global batch's whatever W is; only their placement changes.  Each
    gradient leaf is stacked over the rank's microbatches and reduced by
    ``elastic_reduce_mean`` (K1 on a CUDA device) under ``policy``, the
    loss likewise; then the clip and AdamW.  A rank's row count must
    divide by ``microbatch_size``."""
    check_supported(cfg)
    dev = resolve_device(device)
    grad_fn = make_grad_fn(cfg, moe_impl=moe_impl, remat=remat)

    def step(model, opt_state, batch):
        model.requires_grad_(True)
        local = rank_rows(_to_device(batch, dev), group)
        rows = next(iter(local.values())).shape[0]
        if rows % microbatch_size:
            raise ValueError(
                f"elastic step: a rank's {rows} rows are not a multiple of "
                f"microbatch_size={microbatch_size}; the global microbatch "
                f"grid must tile every rank")
        grads, losses = [], []
        for i in range(0, rows, microbatch_size):
            g, (loss, _) = grad_fn(model, {k: v[i:i + microbatch_size]
                                           for k, v in local.items()})
            grads.append(g)
            losses.append(loss)
        means = {}
        for k in list(grads[0]):
            stack = torch.stack([g.pop(k) for g in grads])
            means[k] = elastic_reduce_mean(stack, group, policy=policy,
                                           block_size=block_size)
            del stack
        loss = elastic_reduce_mean(torch.stack(losses), group, policy=policy,
                                   block_size=block_size)
        opt_state, gnorm, lr = apply_update(model, opt_state, means, lr_fn,
                                            clip_norm=clip_norm)
        return model, opt_state, {"loss": loss, "grad_norm": gnorm,
                                  "lr": lr}
    return step


def init_residuals(model) -> dict:
    """Zero float32 error-feedback residuals, one per leaf of the
    reference's layout (``convert.stacked_leaves``), on its device."""
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in convert.stacked_leaves(model).items()}


__all__ = ["rank_rows", "make_shardmap_train_step",
           "make_elastic_train_step", "init_residuals"]
