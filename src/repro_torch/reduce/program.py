"""The staged block-program: what an executor runs for each schedule block.

Two stages per block, as in the reference's ``reduce/program.py``:

  * **contrib** (the gather) — the (B, W) domain rows and their labels
    become the (S, W) block contribution, in the form the program names:
    ``"dot"`` (one lane) or ``"lanes"`` (PhasedAccu lane slices).  Both
    forms give the same bits for the integer tiers; for the float tiers
    they are two pinned orders (``repro_torch.reduce.policy``).
  * **update** — the contribution folds into the policy carry, strictly
    in block order.

``plan_program`` is the one planner: it picks the contrib form from the
same cost rule as the reference (integer tiers switch to lanes at
``LANE_MIN_SEGMENTS`` labels), so both packages plan identical programs.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from .policy import LANES_DEFAULT, Policy, get_policy

#: contrib-mode crossover: integer tiers plan the lane form from this
#: many labels on
LANE_MIN_SEGMENTS = 32


@dataclasses.dataclass(frozen=True)
class BlockStage:
    """One declared stage: its roofline regime and per-block cost hints."""

    name: str
    bound: str
    bytes: float
    flops: float


@dataclasses.dataclass(frozen=True)
class BlockProgram:
    """A planned, staged execution of the block schedule (frozen)."""

    policy: str
    contrib: str                      # "dot" | "lanes"
    lanes: int
    block_size: int
    num_segments: int
    domain_width: int
    stages: Tuple[BlockStage, ...]
    op: str = "sum"

    def stage(self, name: str) -> BlockStage:
        for s in self.stages:
            if s.name == name:
                return s
        raise KeyError(f"block program has no stage {name!r}; "
                       f"stages: {[s.name for s in self.stages]}")


def plan_program(policy, *, num_segments: int, domain_width: int,
                 block_size: int = 512, contrib: str = "auto",
                 lanes: int = LANES_DEFAULT, op: str = "sum") -> BlockProgram:
    """Plan the staged block-program for one (policy, shape) pair.

    ``contrib="auto"``: integer tiers take the lane form from
    ``LANE_MIN_SEGMENTS`` labels on (bitwise invisible); float tiers
    always take the dot form unless asked for lanes.
    """
    if isinstance(policy, str):
        policy = get_policy(policy)
    if contrib not in ("auto", "dot", "lanes"):
        raise ValueError(f"contrib must be 'auto', 'dot', or 'lanes', "
                         f"got {contrib!r}")
    if contrib == "auto":
        contrib = ("lanes" if policy.integer
                   and num_segments >= LANE_MIN_SEGMENTS else "dot")
    costs = policy.stage_costs(block_size, domain_width, num_segments,
                               contrib=contrib)
    stages = tuple(BlockStage(name=name, bound=c["bound"],
                              bytes=c["bytes"], flops=c["flops"])
                   for name, c in costs.items())
    return BlockProgram(policy=policy.name, contrib=contrib,
                        lanes=int(lanes), block_size=int(block_size),
                        num_segments=int(num_segments),
                        domain_width=int(domain_width), stages=stages,
                        op=str(op))


def block_contrib(vals, ids, num_segments: int, policy: Policy,
                  program: BlockProgram = None, *, seg_offset: int = 0):
    """The gather stage for a batch of blocks: ``vals`` (nb, B, W) and
    ``ids`` (nb, B) -> (nb, S, W), labels taken relative to
    ``seg_offset``.  The one implementation every plain executor runs."""
    local = ids - seg_offset if seg_offset else ids
    if program is not None and program.contrib == "lanes":
        return policy.contrib_lanes(local, vals, num_segments,
                                    lanes=program.lanes)
    return policy.contrib(local, vals, num_segments)
