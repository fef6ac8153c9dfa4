"""Mixture-of-Experts: a top-k router and two dispatch strategies.

The PyTorch counterpart of the reference's ``repro.models.moe``, with one
contract for both strategies:

  * ``capacity``: tokens are packed, a group of ``MOE_GROUP`` at a time,
    into a fixed (E, C) buffer by gathers; a (token, choice) past its
    expert's capacity C is dropped to a spare slot that reads zeros.  The
    reference's training default.
  * ``dense``: every expert runs on every token and a gated combine keeps
    the top-k; exact (nothing dropped), O(E) compute.  The reference's
    serving engine runs this one, and so does the port's.

``router_topk`` follows the reference step by step: float32 logits,
softmax, top-k (ties to the lower expert index, as ``lax.top_k``), the
``router_norm_topk`` renormalization and the Switch auxiliary loss.  With
``MoECfg.router_norm_policy`` set, the renormalization's denominator goes
through ``repro_torch.reduce`` (K1 on a CUDA device), the top-k axis as
the stream and the tokens as the width.  ``combine_segsum`` is the top-k
combine as one segmented sum through the same front door.

Both dispatches run under autograd (``train.make_train_step``).  The
capacity dispatch's gather reads a token's row once for every choice it
kept; its backward (``_DispatchGather``) sums those slots' gradients in
choice order, with no float atomics, so a step repeats bitwise.  The
reference's ``shard_hint`` and expert-parallel axes are dropped: the port
runs on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .config import ModelConfig, MoECfg
from .layers import SwiGLU, _param, bmm_f32, matmul_f32, swiglu

#: tokens per capacity group
MOE_GROUP = 4096


class MoE(nn.Module):
    """The weights of one MoE layer, in the reference's layout: ``router``
    (d, E) float32; ``wi``, ``wg`` (E*v, d, f) and ``wo`` (E*v, f, d) in
    the model's dtype, with v = ``cfg.moe_virtual_split`` column shards of
    each expert's d_ff (f = d_ff_expert / v); ``shared``, a SwiGLU of
    ``num_shared * (d_ff_shared or d_ff_expert)`` columns, when the
    configuration has shared experts."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        m, d, v = cfg.moe, cfg.d_model, cfg.moe_virtual_split
        if m.d_ff_expert % v:
            raise ValueError(f"{cfg.name}: d_ff_expert {m.d_ff_expert} is "
                             f"not divisible by moe_virtual_split {v}")
        e, f = m.num_experts * v, m.d_ff_expert // v
        self.router = _param((d, m.num_experts), torch.float32, device)
        self.wi = _param((e, d, f), dtype, device)
        self.wg = _param((e, d, f), dtype, device)
        self.wo = _param((e, f, d), dtype, device)
        if m.num_shared:
            fs = m.d_ff_shared or m.d_ff_expert
            self.shared = SwiGLU(d, m.num_shared * fs, dtype, device)

    def forward(self, x, *, impl: str = "capacity"):
        return moe_apply(self, x, self.cfg, impl=impl)


def router_topk(router_w, x, m: MoECfg, *, backend: Optional[str] = None):
    """x (T, d) -> (weights (T, k) float32, expert ids (T, k) int64, aux
    loss ()).  ``backend`` picks the executor of the ``router_norm_policy``
    denominator (None: ``cuda`` on a CUDA device, ``blocked`` on the
    CPU)."""
    logits = matmul_f32(x.float(), router_w)
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower expert first on a tie
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :m.top_k], idx[:, :m.top_k]
    if m.router_norm_topk:
        if m.router_norm_policy is not None:
            from .. import reduce as _reduce
            den = _reduce.reduce(w.T.contiguous(),
                                 policy=m.router_norm_policy,
                                 backend=backend, device=w.device)   # (T,)
            w = w / torch.clamp(den[:, None], min=1e-9)
        else:
            # detlint: ok[DET001] legacy branch, bits pinned;
            # router_norm_policy is the front door (reference models/moe.py:66)
            w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    # load-balancing auxiliary loss (Switch-style)
    e = m.num_experts
    # detlint: ok[DET001] Switch aux-loss stats over E experts (reference
    # models/moe.py:69)
    me = probs.mean(0)                                   # mean router prob
    # detlint: ok[DET001] top-1 load, E experts (reference models/moe.py:72)
    ce = F.one_hot(idx[:, 0], e).to(torch.float32).mean(0)   # top-1 load
    # detlint: ok[DET001] aux-loss scalar, E experts (reference
    # models/moe.py:73)
    aux = e * torch.sum(me * ce)
    return w, idx, aux


def _expert_ffn(p, xe):
    """xe (E, C, d) -> (E, C, d): a SwiGLU per expert, the products summed
    in float32 and rounded once to xe's dtype."""
    hi = bmm_f32(xe, p.wi)
    hg = bmm_f32(xe, p.wg)
    h = (F.silu(hg) * hi).to(xe.dtype)
    return bmm_f32(h, p.wo).to(xe.dtype)


class CapacityRoute(NamedTuple):
    """The capacity dispatch's routing of T tokens in nG groups of G:
    ``w`` (nG, G, k) float32 combine weights (zero for padding tokens),
    ``keep`` (nG, G*k) whether each (token, choice), token-major, found a
    place in its expert's buffer of ``cg`` (the capacity), ``src`` (nG,
    G*k) its slot there, e*Cg + place, or
    the spare slot E*Cg where it was dropped, ``slots`` (nG, E*Cg) the
    token in each slot, G (the zero row) where a slot is empty, ``aux``
    the router's auxiliary loss."""
    w: torch.Tensor
    keep: torch.Tensor
    cg: int
    src: torch.Tensor
    slots: torch.Tensor
    aux: torch.Tensor


def capacity_route(router_w, xt, cfg: ModelConfig, *,
                   capacity: Optional[int] = None,
                   group_size: int = MOE_GROUP) -> CapacityRoute:
    """Route xt (T, d) as ``moe_apply_capacity`` does: the router's top-k,
    each chosen expert expanded to its v virtual column shards, the tokens
    in groups of ``group_size`` (the last padded with tokens of expert 0
    and zero weight), a per-expert capacity Cg = ``capacity`` or
    max(1, int(capacity_factor * G * k / E)), and each (token, choice),
    token-major, at the next free place of its expert by cumulative
    count; one past Cg is dropped to the spare slot."""
    m = cfg.moe
    t = xt.shape[0]
    v = cfg.moe_virtual_split
    e, k = m.num_experts * v, m.top_k * v
    w, idx, aux = router_topk(router_w, xt, m)            # (T, k)
    if v > 1:
        # each chosen expert expands to its v virtual column shards, whose
        # partial outputs sum in the combine (weights unchanged)
        idx = (idx[:, :, None] * v
               + torch.arange(v, device=xt.device)[None, None, :]
               ).reshape(t, k)
        w = torch.repeat_interleave(w, v, dim=1)
    g = min(group_size, t)
    ng = -(-t // g)
    padt = ng * g - t
    if padt:
        idx = F.pad(idx, (0, 0, 0, padt))                 # expert 0
        w = F.pad(w, (0, 0, 0, padt))                     # zero weight
    cg = capacity or max(1, int(m.capacity_factor * g * k / e))
    idx_g = idx.reshape(ng, g * k)                        # token-major
    onehot = F.one_hot(idx_g, e).to(torch.int32)          # (nG, G*k, E)
    # detlint: ok[DET001] int32 slot-position prefix count: exact, part of the
    # dispatch algorithm (reference models/moe.py:134)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    pos = torch.gather(pos, 2, idx_g[..., None])[..., 0].long()
    keep = pos < cg                                       # (nG, G*k)
    # token ids into expert slots: (nG, E*Cg [+1 overflow]); empty slots
    # hold token g, the zero row
    src = torch.where(keep, idx_g * cg + pos, e * cg)
    tok_in_g = (torch.arange(g * k, device=xt.device) // k).expand(ng, g * k)
    slots = torch.full((ng, e * cg + 1), g, dtype=torch.long,
                       device=xt.device)
    slots.scatter_(1, src, tok_in_g)
    return CapacityRoute(w.reshape(ng, g, k), keep, cg, src,
                         slots[:, :e * cg], aux)          # drop overflow


class _DispatchGather(torch.autograd.Function):
    """The capacity dispatch's gather, xg (nG, G, d) -> (nG, E*Cg, d):
    slot j of group n reads token ``slots[n, j]``'s row, or zeros where
    ``slots`` holds G (an empty slot).

    A token's row is read once for every choice it kept, so autograd's
    backward (a ``scatter_add`` of the slots' gradients, float atomics on
    the card) would sum up to k rows in no fixed order.  This backward
    sums them in one: a token's gradient is 0 + the gradient of the slot
    of its first kept choice + that of its second kept choice ..., in
    choice order and in float32, rounded once to xg's dtype.  The slots
    are read through ``src`` (the combine's index: a kept (token, choice)'s
    slot, a dropped one's the spare slot E*Cg, whose gradient row is
    zeros), so a dropped choice adds +0, which leaves the sum's bits as
    they are; empty slots reach no token.  No float atomics."""

    @staticmethod
    def forward(ctx, xg, slots, src, k):
        ng, g, d = xg.shape
        xg_pad = F.pad(xg, (0, 0, 0, 1))                  # zero row @ G
        ctx.save_for_backward(src)
        ctx.k = k
        return torch.gather(xg_pad, 1,
                            slots[..., None].expand(ng, slots.shape[1], d))

    @staticmethod
    def backward(ctx, gy):
        (src,) = ctx.saved_tensors
        k = ctx.k
        ng, _, d = gy.shape
        g = src.shape[1] // k
        gy_pad = F.pad(gy, (0, 0, 0, 1))                  # spare slot: 0
        rows = torch.gather(gy_pad, 1, src[..., None].expand(ng, g * k, d))
        rows = rows.reshape(ng, g, k, d).float()
        acc = torch.zeros((ng, g, d), dtype=torch.float32, device=gy.device)
        for j in range(k):
            acc = acc + rows[:, :, j]
        return acc.to(gy.dtype), None, None, None


def moe_apply_capacity(p, x, cfg: ModelConfig, *,
                       capacity: Optional[int] = None,
                       group_size: int = MOE_GROUP):
    """x (B, S, d) -> ((B, S, d), aux): grouped gather dispatch.

    ``capacity_route`` places each (token, choice); one past Cg goes to
    the spare slot E*Cg, whose row is zeros, so a dropped choice adds
    nothing.  The expert FFN runs on the (E, Cg) buffers and each (token,
    choice) gathers its slot back and sums its k rows weighted, in
    float32."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    e = m.num_experts * cfg.moe_virtual_split
    xt = x.reshape(t, d)
    r = capacity_route(p.router, xt, cfg, capacity=capacity,
                       group_size=group_size)
    ng, g, k = r.w.shape
    cg, src = r.cg, r.src
    if ng * g > t:
        xt = F.pad(xt, (0, 0, 0, ng * g - t))

    # dispatch gather: (nG, G, d) -> (nG, E*Cg, d)
    xe = _DispatchGather.apply(xt.reshape(ng, g, d), r.slots, src, k)
    # expert FFN, the expert axis leading: (E, nG*Cg, d)
    xe = xe.reshape(ng, e, cg, d).transpose(0, 1).reshape(e, ng * cg, d)
    ye = _expert_ffn(p, xe)
    ye = ye.reshape(e, ng, cg, d).transpose(0, 1).reshape(ng, e * cg, d)

    # combine gather: each (token, choice) reads its slot back.  Its
    # backward (autograd's scatter_add) has one writer a kept slot; the
    # dropped choices all write the spare row, which the pad's backward
    # cuts off, so no sum there depends on an order
    ye_pad = F.pad(ye, (0, 0, 0, 1))                      # zero row
    y_tk = torch.gather(ye_pad, 1, src[..., None].expand(ng, g * k, d))
    y_tk = y_tk.reshape(ng, g, k, d)
    yt = torch.einsum("ngkd,ngk->ngd", y_tk.float(), r.w.float())
    yt = yt.reshape(ng * g, d)[:t].to(x.dtype)

    if m.num_shared:
        yt = yt + swiglu(p.shared, x.reshape(t, d))
    return yt.reshape(b, s, d), r.aux


def moe_apply_dense(p, x, cfg: ModelConfig):
    """x (B, S, d) -> ((B, S, d), aux): every expert sees every token; the
    top-k gates (zeros elsewhere) combine the E outputs in float32."""
    m = cfg.moe
    v = cfg.moe_virtual_split
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    w, idx, aux = router_topk(p.router, xt, m)
    e_eff = m.num_experts * v
    ye = _expert_ffn(p, xt.expand(e_eff, t, d))
    if v > 1:      # sum the virtual shards back into their parent experts
        # detlint: ok[DET001] v virtual shards, fixed axis order; pinned by moe
        # tests (reference models/moe.py:196)
        ye = ye.reshape(m.num_experts, v, t, d).sum(1)
    # detlint: ok[DET003] one add per cell: a token's top-k experts are
    # distinct, so each (token, expert) gate receives one add onto zero
    gates = torch.zeros((t, m.num_experts), dtype=torch.float32,
                        device=x.device).scatter_add_(1, idx, w)
    yt = torch.einsum("etd,te->td", ye.float(), gates)
    if m.num_shared:
        yt = yt + swiglu(p.shared, xt).float()
    return yt.to(x.dtype).reshape(b, s, d), aux


def combine_segsum(expert_rows, row_token_ids, num_tokens: int, *,
                   backend: Optional[str] = None):
    """The top-k combine as one segmented sum: ``expert_rows`` (R, d),
    already gate-weighted, one row per (token, choice) that survived
    capacity; ``row_token_ids`` (R,) the token of each row.  Returns
    (num_tokens, d) float32 through ``repro_torch.reduce`` (the ``fast``
    tier) on the rows' device, so K1 on a CUDA device; ``backend`` picks
    another executor (the reference's ``interpret=`` picks its kernel)."""
    from .. import reduce as _reduce
    return _reduce.reduce(expert_rows, segment_ids=row_token_ids,
                          num_segments=num_tokens, backend=backend,
                          device=expert_rows.device)


def moe_apply(p, x, cfg: ModelConfig, *, impl: str = "capacity",
              capacity: Optional[int] = None):
    if cfg.moe is None:
        raise ValueError("moe_apply on a non-MoE config")
    if impl == "capacity":
        return moe_apply_capacity(p, x, cfg, capacity=capacity)
    if impl == "dense":
        return moe_apply_dense(p, x, cfg)
    raise ValueError(impl)


__all__ = ["MoE", "MOE_GROUP", "router_topk", "CapacityRoute",
           "capacity_route", "moe_apply_capacity",
           "moe_apply_dense", "combine_segsum", "moe_apply"]
