"""GradientJuggler — streaming pairwise-tree accumulation with bounded slots.

The software twin of JugglePAC's PIS, as in the reference's
``repro.core.juggler``: when microbatch gradients arrive one at a time,
they accumulate through a *binary-counter* pairing tree instead of a
serial ``+=``:

    push 1:  slots = [g1]
    push 2:  slots = [g1+g2]            (carry to level 1)
    push 3:  slots = [g1+g2, g3]
    push 4:  slots = [(g1+g2)+(g3+g4)]  (carry chain)

A gradient here is a list of tensors (one per leaf); the slots hold the
leaves in their own dtype (bf16 slots for bf16 gradients, as in the
reference).  The reference resolves the carry chain on the device with a
``fori_loop`` over an occupancy mask; here the occupancy is a list of
Python bools on the host, so each push runs exactly the adds its carry
chain needs and nothing else.  The schedule is the reference's: the
incoming value merges with the occupied slots below the first free one,
lowest level first (``slot + carry``), and ``juggler_finalize`` folds the
occupied slots low to high, starting from zeros.  An empty slot holds
``None`` instead of the reference's stale (never read) values, so a
state keeps only its occupied slots alive.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch


class JugglerState(NamedTuple):
    slots: List[Optional[List[torch.Tensor]]]  # per level: leaves or None
    occupancy: List[bool]
    count: int                                 # items pushed
    template: List[tuple]                      # (shape, dtype, device) a leaf


def juggler_init(grad_template, num_slots: int) -> JugglerState:
    """``grad_template``: a list of tensors giving each leaf's shape, dtype
    and device.  ``num_slots`` must be >= ceil(log2(num_pushes)) + 1."""
    template = [(tuple(g.shape), g.dtype, g.device) for g in grad_template]
    return JugglerState([None] * num_slots, [False] * num_slots, 0, template)


def juggler_push(state: JugglerState, grad) -> JugglerState:
    """Insert one gradient (a list of leaves) and resolve the carry chain.

    The insertion level is the first free slot; every slot below it is
    occupied (the binary-counter invariant) and merges into the incoming
    value, lowest level first.  With every slot occupied the level is
    ``num_slots``: the merged value is kept nowhere and every slot frees,
    as in the reference (``num_slots_for`` leaves headroom for that)."""
    k = len(state.occupancy)
    lvl = next((i for i, occ in enumerate(state.occupancy) if not occ), k)
    carry = list(grad)
    for i in range(lvl):
        carry = [s + c for s, c in zip(state.slots[i], carry)]
    slots = [None if i < lvl else s for i, s in enumerate(state.slots)]
    occ = [i == lvl or (o and i > lvl) for i, o in enumerate(state.occupancy)]
    if lvl < k:
        slots[lvl] = carry
    return JugglerState(slots, occ, state.count + 1, state.template)


def juggler_finalize(state: JugglerState, *, mean: bool = False):
    """Fold the occupied slots low to high onto zeros; optionally divide by
    the push count (as a value of the leaf's dtype)."""
    total = [torch.zeros(shape, dtype=dtype, device=device)
             for shape, dtype, device in state.template]
    for occ, slot in zip(state.occupancy, state.slots):
        if occ:
            total = [t + s for t, s in zip(total, slot)]
    if mean:
        denom = float(max(state.count, 1))
        total = [t / torch.tensor(denom, dtype=t.dtype, device=t.device)
                 for t in total]
    return total


def num_slots_for(num_microbatches: int) -> int:
    k = 0
    while (1 << k) < max(num_microbatches, 1):
        k += 1
    return max(k, 1) + 1  # +1 headroom for the final carry


__all__ = ["JugglerState", "juggler_init", "juggler_push",
           "juggler_finalize", "num_slots_for"]
