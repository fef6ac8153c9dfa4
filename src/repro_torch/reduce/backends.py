"""Backend registry for ``repro_torch.reduce`` — one schedule, three
executors on one device.

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
                  fall back.

``select_local_backend`` picks ``cuda`` for a CUDA device and
``blocked`` for the CPU, which the caller has to ask for; it raises for a
policy the kernel does not implement rather than run the plain version
on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, FrozenSet, Optional

import torch

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

    def supports(self, policy: Policy) -> bool:
        return "*" in self.policies or policy.name in self.policies


def register_backend(name: str, *, policies, description: str = "",
                     staged: bool = False):
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
                                 description=description, staged=staged)
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


def select_backend(policy: Policy, device) -> Backend:
    """Auto-selection; one device only in this package."""
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
                  staged=True,
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
