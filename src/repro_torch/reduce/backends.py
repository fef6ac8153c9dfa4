"""Backend registry for ``repro_torch.reduce`` — one schedule, three
executors on one device and one across the ranks of a process group.

Every executor runs the same block schedule: the (N, W) domain stream
pads to whole row blocks with ``OUT_OF_RANGE_LABEL``, each block's
gather stage forms its (S, W) contribution (``program.block_contrib``),
and the contributions fold into the policy carry strictly in block
order.  The results are bitwise equal across executors, per policy:

  * ``ref``     — a Python loop over blocks, one gather per block; the
                  readable oracle of the schedule.
  * ``blocked`` — the plain version of the CUDA kernel
                  (``kernels.jugglepac_segsum.segsum_policy_torch``):
                  gathers in batches of blocks, then the in-order fold.
  * ``cuda``    — the Hopper kernel (the reference's ``pallas``
                  backend); CUDA tensors only, and it raises rather than
                  fall back.  Under autograd ``reduce`` wraps it in
                  ``run_with_carry_grad``: the plain executors' gradient.
  * ``shard_map`` — the reference's multi-device executor, kept under its
                  name so that a spec carries across: each rank of a
                  process group folds its own contiguous slice of rows
                  with the local executor, and the carries merge across
                  the ranks (``collective.merge_carry_across``).

``select_local_backend`` picks ``cuda`` for a CUDA device and
``blocked`` for the CPU, which the caller has to ask for; it raises for a
policy the kernel does not implement rather than run the plain version
on the card.  ``select_backend`` picks ``shard_map`` under a group of
more than one rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Optional

import torch

from ..distributed import comm
from .policy import Policy
from .program import BlockProgram, block_contrib, plan_program  # noqa: F401

#: The padding sentinel: never equal to a label in [0, num_segments).
OUT_OF_RANGE_LABEL: int = -1

BACKENDS: Dict[str, "Backend"] = {}


@dataclasses.dataclass(frozen=True)
class Backend:
    """A registered executor of the block schedule.

    ``run(values, ids, num_segments, policy=..., block_size=...,
    program=...)`` takes domain-prepared (N, W) values and returns the
    policy carry tuple, not yet finalized.
    """

    name: str
    run: Callable
    policies: FrozenSet[str]          # capability: policies it can execute
    description: str = ""
    #: staged executors accept ``program=`` (a planned ``BlockProgram``);
    #: ``reduce`` plans one only for them
    staged: bool = False
    #: distributed executors take ``group=`` (a process group) and run in
    #: every rank of it
    distributed: bool = False
    #: True when ``run`` is plain PyTorch that autograd records; a kernel
    #: launch is not, and ``reduce`` wraps it in ``run_with_carry_grad``
    autograd: bool = True

    def supports(self, policy: Policy) -> bool:
        return "*" in self.policies or policy.name in self.policies


def register_backend(name: str, *, policies, description: str = "",
                     staged: bool = False, distributed: bool = False,
                     autograd: bool = True):
    """Decorator: register ``fn`` as backend ``name`` (``policies``: an
    iterable of policy names, or "*" for schedule-generic executors)."""
    def deco(fn):
        if isinstance(policies, str):
            if policies != "*":
                raise ValueError(
                    f"register_backend({name!r}): policies must be an "
                    f"iterable of policy names or the string '*', got "
                    f"{policies!r}")
            caps = frozenset({"*"})
        else:
            caps = frozenset(policies)
        BACKENDS[name] = Backend(name=name, run=fn, policies=caps,
                                 description=description, staged=staged,
                                 distributed=distributed, autograd=autograd)
        return fn
    return deco


def get_backend(name: str) -> Backend:
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}; registered: "
                         f"{sorted(BACKENDS)}") from None


def select_local_backend(policy: Policy, device) -> Backend:
    """The single-device auto-choice: the CUDA kernel on a CUDA device,
    the plain ``blocked`` executor on the CPU (which the caller has to ask
    for).  A policy the kernel does not implement raises on a CUDA
    device: the plain version never runs there unless named."""
    if torch.device(device).type == "cuda":
        cand = get_backend("cuda")
        if not cand.supports(policy):
            raise ValueError(
                f"the CUDA kernel does not implement policy "
                f"{policy.name!r} (capabilities: {sorted(cand.policies)}); "
                f"pass backend='blocked' to run its plain version on the "
                f"card")
        return cand
    return get_backend("blocked")


def select_backend(policy: Policy, device, group=None) -> Backend:
    """Auto-selection: ``shard_map`` under a process group of more than
    one rank, else the device's local executor."""
    if group is not None and comm.axis_size(group) > 1:
        cand = get_backend("shard_map")
        if cand.supports(policy):
            return cand
    return select_local_backend(policy, device)


# ---------------------------------------------------------------------------
# Shared schedule helpers
# ---------------------------------------------------------------------------


def mask_out_of_range(segment_ids: torch.Tensor,
                      num_segments: int) -> torch.Tensor:
    """Map every label outside [0, num_segments) to OUT_OF_RANGE_LABEL."""
    ids = segment_ids.to(torch.int32)
    ok = (ids >= 0) & (ids < num_segments)
    return torch.where(ok, ids, torch.full_like(ids, OUT_OF_RANGE_LABEL))


def _pad_to_blocks(values, segment_ids, block_size):
    """Pad N to a multiple of block_size; padded rows carry the sentinel.
    Returns (nb, B, W) values, (nb, B) int32 ids and nb."""
    n, d = values.shape
    pad = (-n) % block_size
    ids = segment_ids.to(torch.int32)
    if pad:
        values = torch.cat([values, values.new_zeros((pad, d))], 0)
        ids = torch.cat([ids, ids.new_full((pad,), OUT_OF_RANGE_LABEL)], 0)
    nb = (n + pad) // block_size
    return (values.reshape(nb, block_size, d),
            ids.reshape(nb, block_size), nb)


class _CarryGrad(torch.autograd.Function):
    """An executor's carry with the gradient autograd derives through the
    plain executors: the forward runs the executor as it is, the backward
    gathers the (S, W) gradient of the first carry by label."""

    @staticmethod
    def forward(ctx, domain, ids, run, num_segments, policy, kw):
        carry = run(domain.detach(), ids, num_segments, policy=policy, **kw)
        ctx.save_for_backward(ids)
        return tuple(carry)

    @staticmethod
    def backward(ctx, g, *_):
        ids, = ctx.saved_tensors
        s = g.shape[0]
        keep = (ids >= 0) & (ids < s)
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        rows = g.index_select(0, torch.where(keep, ids, 0).long())
        # autograd through the plain gather adds each row's gradient to
        # the zeros of its masked leaves, which turns -0 into +0: so does
        # the + 0
        rows = torch.where(keep[:, None], rows, zero) + zero
        return rows, None, None, None, None, None


def run_with_carry_grad(run, domain, ids, num_segments, *, policy: Policy,
                        **kw):
    """``run(domain, ids, num_segments, policy=, **kw)`` (any executor's
    ``run``) with the carry in ``domain``'s autograd graph.

    The gradient is the one autograd derives through ``ref`` and
    ``blocked``, as ``jax.grad`` derives the reference's through its
    executors: every schedule add is an IEEE add, so each row whose label
    is in [0, num_segments) receives its set's incoming gradient exactly,
    and a dropped row receives 0.  Under ``compensated`` the TwoSum
    residual carry's derivative is exactly 0 (the rounding error's terms
    cancel), so only the sum carry's gradient reaches the rows.  An
    integer domain is outside the graph already: ``run`` alone."""
    if (policy.integer or not domain.requires_grad
            or not torch.is_grad_enabled()):
        return run(domain, ids, num_segments, policy=policy, **kw)
    return _CarryGrad.apply(domain, ids, run, num_segments, policy, kw)


# ---------------------------------------------------------------------------
# Built-in backends
# ---------------------------------------------------------------------------


@register_backend("ref", policies="*", staged=True,
                  description="Python loop over blocks; the readable "
                              "schedule oracle")
def _run_ref(values, segment_ids, num_segments, *, policy: Policy,
             block_size: int = 512,
             program: Optional[BlockProgram] = None):
    vb, ib, nb = _pad_to_blocks(values, segment_ids, block_size)
    carry = policy.init(num_segments, values.shape[1], device=values.device)
    for b in range(nb):
        contrib = block_contrib(vb[b:b + 1], ib[b:b + 1], num_segments,
                                policy, program)[0]
        carry = policy.update(carry, contrib)
    return carry


@register_backend("blocked", policies="*", staged=True,
                  description="the plain PyTorch version of the CUDA "
                              "kernel: batched gathers, in-order fold")
def _run_blocked(values, segment_ids, num_segments, *, policy: Policy,
                 block_size: int = 512,
                 program: Optional[BlockProgram] = None):
    from ..kernels.jugglepac_segsum import segsum_policy_torch
    vb, ib, _ = _pad_to_blocks(values, segment_ids, block_size)
    return segsum_policy_torch(vb.reshape(-1, values.shape[1]),
                               ib.reshape(-1), num_segments, policy=policy,
                               program=program, block_rows=block_size)


@register_backend("cuda", policies=("fast", "compensated", "exact",
                                    "exact2", "procrastinate"),
                  staged=True, autograd=False,
                  description="hand-written Hopper kernel (sm_90a): one "
                              "CUDA block per (label tile, column tile) "
                              "walks the whole schedule in block order; "
                              "at one label a column-wide ordered fold")
def _run_cuda(values, segment_ids, num_segments, *, policy: Policy,
              block_size: int = 512,
              program: Optional[BlockProgram] = None):
    from ..kernels.jugglepac_segsum import segsum_policy_cuda
    if not values.is_cuda:
        raise ValueError("backend 'cuda' runs on CUDA tensors only; got "
                         f"values on {values.device} — pass device='cuda' "
                         "or pick backend='blocked' for the CPU")
    # no padding copy: the kernel reads the ragged last block's missing
    # rows as sentinel rows, which is what the padding would hold
    return segsum_policy_cuda(values, segment_ids.to(torch.int32),
                              num_segments, policy=policy, program=program,
                              block_rows=block_size)


@register_backend("shard_map", policies="*", distributed=True, staged=True,
                  description="a process group's ranks: each folds its own "
                              "rows with the local executor, the carries "
                              "merge across the ranks")
def _run_shard_map(values, segment_ids, num_segments, *, policy: Policy,
                   block_size: int = 512,
                   program: Optional[BlockProgram] = None, group=None,
                   to_domain=None, ctx=None):
    """Fold this rank's rows, then merge the carries of ``group``'s ranks.

    Every rank of ``group`` calls this with its own contiguous slice of
    the stream, rank 0 holding the first rows.  The slice is padded to
    whole schedule blocks with ``OUT_OF_RANGE_LABEL`` rows, as the
    reference pads each shard (the local executors pad, or read the
    ragged last block as sentinel rows, which is the same).  Where every
    slice but the last holds whole blocks (the reference's split: N
    padded to W * block_size rows, an equal share each), a rank's blocks
    are the whole stream's blocks; the integer tiers' bits do not depend
    on the split at all.  The rank folds them with ``select_local_backend`` (K1 on a CUDA device)
    and the carries merge with the policy's combiner
    (``collective.merge_carry_across``): one integer ``psum`` for the
    integer tiers, whose carry is then bitwise the one-process schedule's
    at any rank count; a rank-order fold for the float tiers.  Every rank
    returns the merged carry; ``finalize`` runs once, after this.

    ``to_domain`` (with ``ctx``, the globally shared quantization scale
    or window anchor) maps the raw rows into the policy domain inside the
    rank, as the reference's staged path does; without it ``values`` are
    already domain rows."""
    from .collective import merge_carry_across
    if group is None:
        raise ValueError("backend 'shard_map' needs group= (a process "
                         "group; repro_torch.distributed.comm.init_group)")
    if values.shape[0] == 0:
        w = (policy.domain_width(values.shape[1]) if to_domain is not None
             else values.shape[1])
        carry = policy.init(num_segments, w, device=values.device)
    else:
        if to_domain is not None:
            values = to_domain(values, ctx)
        inner = select_local_backend(policy, values.device)
        carry = inner.run(values, segment_ids, num_segments, policy=policy,
                          block_size=block_size, program=program)
    return merge_carry_across(policy, carry, group)
