"""AdamW, the global-norm clip and the cosine schedule, as the reference's
``repro.optim.adamw`` builds them (no optimizer library).

Parameters, gradients and moments are dicts of tensors with the same keys
(``AdamWState`` holds the moments in float32 whatever the parameters'
dtype).  The update is elementwise, so it gives the same values in any
layout.  ``global_norm`` does not: it reduces each leaf to one float32
sum of squares before the cross-leaf reduce, and under an integer tier
the scale is chosen from the whole leaf.  So the train step hands it the
gradients in the reference's layout (``models.convert.to_reference``: 12
leaves for a dense model, each period position's leaf stacked over the
periods, in ``jax.tree.leaves`` order), and the norm is the reference's,
bit for bit under the integer tiers; ``update_`` then writes those
leaves of the parameters (``convert.stacked_leaves``) and the moments in
place.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..core.trees import pairwise_tree_sum


def _leaf_sumsq(x: torch.Tensor, policy: str, width: int = 1024,
                backend: Optional[str] = None) -> torch.Tensor:
    """One leaf's sum of squares through the ``repro_torch.reduce`` front
    door: the flat leaf, zero-padded to a multiple of ``width`` (exact:
    0^2 adds nothing in any tier), folds as an (n/width, width)
    ``op="sumsq"`` stream, and its (width,) partials fold once more under
    the same policy — two reductions, K1 twice on a CUDA device."""
    from .. import reduce as _reduce
    xf = x.to(torch.float32).reshape(-1)
    n = xf.shape[0]
    w = max(1, min(n, width))
    pad = (-n) % w
    if pad:
        xf = torch.cat([xf, xf.new_zeros(pad)])
    partial = _reduce.reduce(xf.reshape(-1, w), op="sumsq", policy=policy,
                             backend=backend, device=x.device)
    return _reduce.reduce(partial, policy=policy, backend=backend,
                          device=x.device)


class AdamWState(NamedTuple):
    mu: Dict[str, torch.Tensor]     # float32
    nu: Dict[str, torch.Tensor]     # float32
    count: torch.Tensor             # 0-d int32: updates taken


def init(params: Dict[str, torch.Tensor]) -> AdamWState:
    """Zero float32 moments shaped as ``params``, on their device."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return AdamWState(mu=zeros,
                      nu={k: torch.zeros_like(z) for k, z in zeros.items()},
                      count=torch.zeros((), dtype=torch.int32, device=dev))


def global_norm(tree: Dict[str, torch.Tensor], *,
                policy: Optional[str] = None,
                backend: Optional[str] = None) -> torch.Tensor:
    """The global L2 norm of a dict of tensors, its leaves in dict order.

    ``policy=None``: each leaf's float32 sum of squares, combined by the
    fixed pairing tree (``core.trees.pairwise_tree_sum``).  A policy name
    routes both stages — each leaf's ``op="sumsq"`` (``_leaf_sumsq``) and
    the cross-leaf sum — through ``repro_torch.reduce``: under an integer
    tier the squared norm is bitwise the reference's for the same leaves.
    ``backend`` names the executor of those reductions (None: the
    device's own, K1 on a CUDA device)."""
    leaves = list(tree.values())
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    dev = leaves[0].device
    if policy is None:
        sq = [torch.sum(x.to(torch.float32) ** 2) for x in leaves]
        return torch.sqrt(pairwise_tree_sum(torch.stack(sq), axis=0))
    from .. import reduce as _reduce
    sq = [_leaf_sumsq(x, policy, backend=backend) for x in leaves]
    return torch.sqrt(_reduce.reduce(torch.stack(sq), policy=policy,
                                     backend=backend, device=dev))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float, *,
                        norm_policy: Optional[str] = None):
    """(grads scaled by min(1, max_norm / norm), as float32; the norm)."""
    g = global_norm(grads, policy=norm_policy)
    scale = _clip_scale(g, max_norm)
    return {k: x.to(torch.float32) * scale for k, x in grads.items()}, g


def update(grads, state: AdamWState, params, *, lr, b1: float = 0.9,
           b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1,
           clip_norm: Optional[float] = 1.0,
           norm_policy: Optional[str] = None):
    """One AdamW step: (new params, new state, grad norm); the inputs are
    left as they are.

    ``clip_norm`` scales the gradients by min(1, clip_norm / global norm)
    first (``norm_policy`` routes that norm through ``repro_torch.reduce``;
    without a clip the norm is reported as 0).  The arithmetic is
    ``update_``'s, on copies."""
    if clip_norm is None:
        gnorm = torch.zeros((), dtype=torch.float32,
                            device=state.count.device)
    else:
        gnorm = global_norm(grads, policy=norm_policy)
    params = {k: p.detach().clone() for k, p in params.items()}
    state = AdamWState({k: m.clone() for k, m in state.mu.items()},
                       {k: v.clone() for k, v in state.nu.items()},
                       state.count)
    state = update_(grads, state, params, lr=lr, b1=b1, b2=b2, eps=eps,
                    weight_decay=weight_decay,
                    gnorm=None if clip_norm is None else gnorm,
                    clip_norm=clip_norm)
    return params, state, gnorm


@torch.no_grad()
def update_(grads, state: AdamWState, params, *, lr, gnorm=None,
            clip_norm: Optional[float] = 1.0, b1: float = 0.9,
            b2: float = 0.95, eps: float = 1e-8,
            weight_decay: float = 0.1) -> AdamWState:
    """One AdamW step in place: ``params`` and ``state``'s moments are
    overwritten; returns the state with its count advanced.

    ``gnorm`` is the gradients' global norm, taken by the caller in the
    layout its policy needs (None: no clip); the gradients are scaled by
    min(1, clip_norm / gnorm).  Each leaf is clipped, widened to float32
    and updated in turn, so only one leaf's float32 temporaries are alive
    at a time; the parameters keep their dtype."""
    dev = state.count.device
    scale = None if gnorm is None else _clip_scale(gnorm, clip_norm)
    count = state.count + 1
    cf = count.to(torch.float32)
    c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev),
                         cf)
    c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev),
                         cf)
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        if scale is not None:
            g = g * scale
        # b1 * mu + (1 - b1) * g, and the same for nu, rounded as written
        mu = state.mu[k].mul_(b1).add_((1 - b1) * g)
        nu = state.nu[k].mul_(b2).add_((1 - b2) * g * g)
        step = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        pf = p.to(torch.float32)
        step = step + weight_decay * pf
        p.copy_(pf - lr * step)
        del g, step, pf
    return AdamWState(state.mu, state.nu, count)


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_ratio: float = 0.1) -> Callable:
    """lr(step): linear warm-up over ``warmup`` steps, then a cosine decay
    to ``min_ratio * base_lr`` at ``total``; float32, as the reference
    computes it.  ``step`` is an int or a tensor (then on its device)."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi
                                                                 * prog))
        return base_lr * warm * cos
    return lr


__all__ = ["AdamWState", "init", "global_norm", "clip_by_global_norm",
           "update", "update_", "cosine_schedule"]
