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
model with both set, 58 for deepseek-v2-lite's 19 leaves); with both
unset a step launches none of the port's kernels.  A model with experts
trains through ``moe_impl``'s dispatch (``models.moe``), its router,
expert and shared leaves stacked as the others, its ``aux`` loss in the
metrics.  An encoder-decoder's batch brings ``enc_embeds``, which the
loss, the eval and the prefill step encode (``models.encode``) for the
decoder's cross-attention; its decode step takes the memory as
``enc_out``.  ``grad_reduce_mesh`` (the reference's mesh) is a process
group here: its ranks split the step's microbatches and each leaf's mean
runs through the ``shard_map`` executor across them.  What this port
lacks raises ``NotImplementedError`` naming the ``ROADMAP.md`` item that
brings it: ``logits_pspec`` (queue 1, item 6, ``distributed/sharding.py``).
The data-parallel and elastic steps across a group's ranks are
``repro_torch.distributed.collectives``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .. import resolve_device
from ..models import convert
from ..models.config import ModelConfig
from ..models.model import (check_supported, decode_step, encode, forward,
                            loss_fn)
from ..optim import adamw
from ..distributed import comm
from ..reduce.accumulator import (accumulate_microbatch_grads,
                                  reduce_microbatch_grads)

_ITEM6 = ("ROADMAP.md queue 1, item 6 (distributed/sharding.py, a sharded "
          "vocabulary) brings it")


def _to_device(batch, dev):
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}


def init_state(model) -> adamw.AdamWState:
    """The optimizer state ``make_train_step``'s steps take: float32 AdamW
    moments of the reference's leaves.  The model's parameters become
    views of those leaves (``convert.stacked_leaves``)."""
    return adamw.init(convert.stacked_leaves(model))


def checkpoint_state(model, opt_state: adamw.AdamWState,
                     residuals=None) -> dict:
    """The train state as the reference launcher checkpoints it,
    ``{"params": ..., "opt": AdamWState}``, nested as the reference's
    tree (``convert.nest``), so a snapshot's leaf keys are the
    reference's.  It holds the live tensors: the parameters' stacked
    leaves (of which the model's parameters are views) and the moments,
    so ``ckpt.restore(..., inplace=True)`` into it sets the model and the
    optimizer state.  ``residuals`` (a dict of tensors keyed as the
    leaves: the data-parallel step's error-feedback state) is nested
    under ``"residuals"`` the same way."""
    state = {"params": convert.nest(convert.stacked_leaves(model)),
             "opt": adamw.AdamWState(mu=convert.nest(opt_state.mu),
                                     nu=convert.nest(opt_state.nu),
                                     count=opt_state.count)}
    if residuals is not None:
        state["residuals"] = convert.nest(residuals)
    return state


def make_grad_fn(cfg: ModelConfig, *, moe_impl: str = "capacity",
                 remat: bool = True):
    """-> ``grad_fn(model, batch) -> (grads, (loss, metrics))``: one
    forward and backward of ``loss_fn``, the gradients in the reference's
    layout (``convert.to_reference``), loss and metrics detached."""
    def grad_fn(model, batch):
        named = dict(model.named_parameters())
        loss, metrics = loss_fn(model, batch, moe_impl=moe_impl,
                                remat=remat)
        # an ``embeds`` batch leaves the embedding unused: its gradient
        # is zeros, as the reference's
        grads = torch.autograd.grad(loss, list(named.values()),
                                    materialize_grads=True)
        grads = convert.to_reference(cfg, dict(zip(named, grads)))
        return grads, (loss.detach(),
                       {k: v.detach() for k, v in metrics.items()})
    return grad_fn


def apply_update(model, opt_state: adamw.AdamWState, grads, lr_fn, *,
                 clip_norm: Optional[float] = 1.0, weight_decay: float = 0.1,
                 norm_policy: Optional[str] = None):
    """The global-norm clip (``norm_policy`` routes its norm through
    ``repro_torch.reduce``) and AdamW, in place on the model's stacked
    leaves -> (opt_state, grad norm, lr); ``lr`` is ``lr_fn(count + 1)``,
    the norm 0 without a clip."""
    gnorm = torch.zeros((), dtype=torch.float32,
                        device=opt_state.count.device)
    if clip_norm is not None:
        gnorm = adamw.global_norm(grads, policy=norm_policy)
    lr = lr_fn(opt_state.count + 1)          # count is 0-based
    opt_state = adamw.update_(
        grads, opt_state, convert.stacked_leaves(model), lr=lr,
        gnorm=None if clip_norm is None else gnorm, clip_norm=clip_norm,
        weight_decay=weight_decay)
    return opt_state, gnorm, lr


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
    (B, S), or ``embeds`` (B, S, D) with ``labels`` (B, S) (and, for an
    M-RoPE model, ``positions`` (B, S, 3); for an encoder-decoder,
    ``enc_embeds`` (B, T, D)), arrays or tensors, moved to ``device``
    (None means CUDA).
    ``num_microbatches`` = m > 1 splits the batch along dim 0; the m
    gradients accumulate through the JugglePAC binary-counter tree
    (``accumulate_microbatch_grads``: O(log m) live copies, a fixed
    pairing), or with ``grad_reduce`` (a policy name) their mean goes
    through ``repro_torch.reduce`` (``reduce_microbatch_grads``: m live
    copies, bitwise independent of m and of the executor under the
    integer tiers).  ``norm_policy`` routes the clip's global norm
    through ``repro_torch.reduce`` (``adamw.global_norm``).  The loss is
    the mean of the microbatch losses; ``lr`` is ``lr_fn(count + 1)``.
    ``moe_impl`` picks a model with experts' dispatch (``capacity``, the
    reference's default, or ``dense``); the metrics carry its ``aux``
    loss.  The step switches gradients on for every parameter of the
    model it trains.

    ``grad_reduce_mesh`` is a process group (``distributed.comm``) of W
    ranks, each calling the step with the same batch: rank r computes the
    r-th contiguous m/W of the microbatches, each leaf's mean over all m
    runs through the ``shard_map`` executor across the ranks, and the
    microbatch losses and metrics are gathered in rank order.  Under an
    integer ``grad_reduce`` every rank gets the bits of one process
    running all m.  It needs ``grad_reduce`` and m divisible by W."""
    check_supported(cfg)
    if logits_pspec is not None:
        raise NotImplementedError(f"make_train_step(logits_pspec=): "
                                  f"{_ITEM6}")
    dev = resolve_device(device)
    m = num_microbatches
    group = grad_reduce_mesh
    m_local = m
    if group is not None:
        w = comm.axis_size(group)
        if grad_reduce is None or m % w:
            raise ValueError(
                f"make_train_step(grad_reduce_mesh=): the group's {w} "
                f"ranks split the microbatches of a grad_reduce mean; got "
                f"grad_reduce={grad_reduce!r}, num_microbatches={m}")
        m_local = m // w
    grad_fn = make_grad_fn(cfg, moe_impl=moe_impl, remat=remat)

    def gathered(x):
        """This rank's (m_local,) values -> the group's (m,), in order."""
        return x if group is None else comm.all_gather(x, group).reshape(-1)

    def train_step(model, opt_state: adamw.AdamWState, batch):
        model.requires_grad_(True)
        batch = _to_device(batch, dev)
        if m > 1:
            mbs = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])
                   for k, v in batch.items()}
            if group is not None:
                r = comm.axis_index(group)
                mbs = {k: v[r * m_local:(r + 1) * m_local]
                       for k, v in mbs.items()}
            accumulate = (accumulate_microbatch_grads if grad_reduce is None
                          else reduce_microbatch_grads)
            kw = {} if grad_reduce is None else {"policy": grad_reduce,
                                                 "group": group}
            grads, (losses, metricses) = accumulate(
                grad_fn, model, mbs, num_microbatches=m_local, **kw)
            # detlint: ok[DET001] m microbatch loss scalars; the gradients take
            # the front door above (reference train/steps.py:92)
            loss = gathered(losses).mean()
            # detlint: ok[DET001] m microbatch metrics, logging only (reference
            # train/steps.py:92)
            metrics = {k: gathered(v).mean() for k, v in metricses.items()}
        else:
            grads, (loss, metrics) = grad_fn(model, batch)
        opt_state, gnorm, lr = apply_update(
            model, opt_state, grads, lr_fn, clip_norm=clip_norm,
            weight_decay=weight_decay, norm_policy=norm_policy)
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
    caches)``; ``batch`` holds ``tokens`` (B, S) or ``embeds`` (B, S, D),
    and optional ``positions``; for an encoder-decoder ``enc_embeds`` (B,
    T, D), encoded for the decoder's cross-attention, as the
    reference's."""
    check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def prefill_step(model, batch):
        batch = _to_device(batch, dev)
        enc_out = (encode(model, batch["enc_embeds"]) if cfg.is_encdec
                   else None)
        logits, caches, _ = forward(model, tokens=batch.get("tokens"),
                                    embeds=batch.get("embeds"),
                                    positions=batch.get("positions"),
                                    mode="prefill", moe_impl=moe_impl,
                                    enc_out=enc_out)
        return logits[:, -1:], caches
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, moe_impl: str = "capacity",
                     device=None):
    """-> ``dstep(model, token, caches, position, enc_out=None) ->
    (logits, caches)`` (``models.decode_step``); ``enc_out`` (B, T, D) is
    an encoder-decoder's memory (``models.encode``), which a decoder-only
    model ignores, as the reference's."""
    check_supported(cfg)
    dev = resolve_device(device)

    @torch.no_grad()
    def dstep(model, token, caches, position, enc_out=None):
        return decode_step(model, torch.as_tensor(token, device=dev),
                           caches, position, moe_impl=moe_impl,
                           enc_out=enc_out)
    return dstep


__all__ = ["init_state", "checkpoint_state", "make_grad_fn", "apply_update",
           "make_train_step", "make_eval_step", "make_prefill_step",
           "make_decode_step"]
