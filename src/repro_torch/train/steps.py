"""Train / eval / prefill / decode step factories, as the reference's
``repro.train.steps``.

``make_train_step`` builds one training step: forward and backward
through torch autograd (``models.loss_fn``, ``remat`` recomputing each
block), the microbatch gradients (the JugglePAC pairing tree, or the
``repro_torch.reduce`` front door with ``grad_reduce``), the global-norm
clip and AdamW.  The step runs in the reference's layout: the model's
parameters are views of its 12 stacked leaves for a dense model
(``models.convert.stacked_leaves``), each microbatch's gradients are
stacked the same way (``convert.to_reference``), and AdamW updates the
leaves and the moments (``init_state``) in place.  So ``grad_reduce``
and ``norm_policy`` reduce the reference's streams, bit for bit under
the integer tiers, and the update touches 12 tensors, not 219.

On a CUDA device ``grad_reduce`` runs K1 once per leaf and ``norm_policy``
twice per leaf and once across the leaves (37 launches a step for a dense
model with both set); with both unset a step launches none of the port's
kernels.  What this port lacks raises ``NotImplementedError`` naming the
``ROADMAP.md`` item that brings it: ``grad_reduce_mesh`` and
``logits_pspec`` (queue 1, item 5, multi-device), models with experts or
other families (item 4).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import resolve_device
from ..models import convert
from ..models.config import ModelConfig
from ..models.model import (check_supported, decode_step, forward,
                            loss_fn)
from ..optim import adamw
from ..reduce.accumulator import (accumulate_microbatch_grads,
                                  reduce_microbatch_grads)

_ITEM5 = "ROADMAP.md queue 1, item 5 (multi-device) brings it"


def _to_device(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def init_state(model) -> adamw.AdamWState:
    """The optimizer state ``make_train_step``'s steps take: float32 AdamW
    moments of the reference's leaves.  The model's parameters become
    views of those leaves (``convert.stacked_leaves``)."""
    return adamw.init(convert.stacked_leaves(model))


def checkpoint_state(model, opt_state: adamw.AdamWState) -> dict:
    """The train state as the reference launcher checkpoints it,
    ``{"params": ..., "opt": AdamWState}``, nested as the reference's
    tree (``convert.nest``), so a snapshot's leaf keys are the
    reference's.  It holds the live tensors: the parameters' stacked
    leaves (of which the model's parameters are views) and the moments,
    so ``ckpt.restore(..., inplace=True)`` into it sets the model and the
    optimizer state."""
    return {"params": convert.nest(convert.stacked_leaves(model)),
            "opt": adamw.AdamWState(mu=convert.nest(opt_state.mu),
                                    nu=convert.nest(opt_state.nu),
                                    count=opt_state.count)}


def make_train_step(cfg: ModelConfig, *, lr_fn: Callable,
                    moe_impl: str = "capacity", remat: bool = True,
                    clip_norm: float = 1.0, weight_decay: float = 0.1,
                    logits_pspec=None, num_microbatches: int = 1,
                    grad_reduce: Optional[str] = None,
                    grad_reduce_mesh=None,
                    norm_policy: Optional[str] = None, device=None):
    """-> ``train_step(model, opt_state, batch) -> (model, opt_state,
    metrics)``, updating the model's parameters and ``opt_state``'s
    moments in place.

    ``opt_state`` is ``init_state(model)``; ``batch`` holds ``tokens``
    (B, S) (arrays or tensors), moved to ``device`` (None means CUDA).
    ``num_microbatches`` = m > 1 splits the batch along dim 0; the m
    gradients accumulate through the JugglePAC binary-counter tree
    (``accumulate_microbatch_grads``: O(log m) live copies, a fixed
    pairing), or with ``grad_reduce`` (a policy name) their mean goes
    through ``repro_torch.reduce`` (``reduce_microbatch_grads``: m live
    copies, bitwise independent of m and of the executor under the
    integer tiers).  ``norm_policy`` routes the clip's global norm
    through ``repro_torch.reduce`` (``adamw.global_norm``).  The loss is
    the mean of the microbatch losses; ``lr`` is ``lr_fn(count + 1)``.
    ``moe_impl`` is accepted and ignored (a model with experts raises
    here).  The step switches gradients on for every parameter of the
    model it trains."""
    check_supported(cfg)
    if grad_reduce_mesh is not None:
        raise NotImplementedError(f"make_train_step(grad_reduce_mesh=): "
                                  f"{_ITEM5}")
    if logits_pspec is not None:
        raise NotImplementedError(f"make_train_step(logits_pspec=): "
                                  f"{_ITEM5}")
    dev = resolve_device(device)
    m = num_microbatches

    def grad_fn(model, batch):
        named = dict(model.named_parameters())
        loss, metrics = loss_fn(model, batch, moe_impl=moe_impl,
                                remat=remat)
        grads = torch.autograd.grad(loss, list(named.values()))
        grads = convert.to_reference(cfg, dict(zip(named, grads)))
        return grads, (loss.detach(),
                       {k: v.detach() for k, v in metrics.items()})

    def train_step(model, opt_state: adamw.AdamWState, batch):
        model.requires_grad_(True)
        batch = _to_device(batch, dev)
        if m > 1:
            mbs = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])
                   for k, v in batch.items()}
            accumulate = (accumulate_microbatch_grads if grad_reduce is None
                          else reduce_microbatch_grads)
            kw = {} if grad_reduce is None else {"policy": grad_reduce}
            grads, (losses, metricses) = accumulate(
                grad_fn, model, mbs, num_microbatches=m, **kw)
            loss = losses.mean()
            metrics = {k: v.mean() for k, v in metricses.items()}
        else:
            grads, (loss, metrics) = grad_fn(model, batch)
        gnorm = torch.zeros((), dtype=torch.float32, device=dev)
        if clip_norm is not None:
            gnorm = adamw.global_norm(grads, policy=norm_policy)
        lr = lr_fn(opt_state.count + 1)          # count is 0-based
        opt_state = adamw.update_(
            grads, opt_state, convert.stacked_leaves(model), lr=lr,
            gnorm=None if clip_norm is None else gnorm, clip_norm=clip_norm,
            weight_decay=weight_decay)
        metrics = dict(metrics, loss=loss, grad_norm=gnorm, lr=lr)
        return model, opt_state, metrics
    return train_step


def make_eval_step(cfg: ModelConfig, *, moe_impl: str = "capacity",
                   device=None):
    """-> ``eval_step(model, batch) -> metrics`` (``loss_fn`` without
    gradients)."""
    check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(model, batch):
        loss, metrics = loss_fn(model, _to_device(batch, dev),
                                moe_impl=moe_impl, remat=False)
        return dict(metrics, loss=loss)
    return eval_step


def make_prefill_step(cfg: ModelConfig, *, moe_impl: str = "capacity",
                      device=None):
    """-> ``prefill_step(model, batch) -> (last-position logits (B, 1, V),
    caches)``."""
    check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(model, batch):
        batch = _to_device(batch, dev)
        logits, caches, _ = forward(model, tokens=batch["tokens"],
                                    positions=batch.get("positions"),
                                    mode="prefill")
        return logits[:, -1:], caches
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, moe_impl: str = "capacity",
                     device=None):
    """-> ``dstep(model, token, caches, position) -> (logits, caches)``
    (``models.decode_step``); ``enc_out`` raises (enc-dec models are
    ROADMAP.md queue 1, item 4)."""
    check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def dstep(model, token, caches, position, enc_out=None):
        if enc_out is not None:
            raise NotImplementedError(
                "decode_step(enc_out=): enc-dec models are ROADMAP.md "
                "queue 1, item 4")
        return decode_step(model, torch.as_tensor(token, device=dev),
                           caches, position)
    return dstep


__all__ = ["init_state", "checkpoint_state", "make_train_step", "make_eval_step", "make_prefill_step",
           "make_decode_step"]
