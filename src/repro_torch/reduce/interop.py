"""Carry state across the two packages.

A reduction's state between the executor and ``finalize`` is the policy
carry tuple plus its context (the quantization scale or the window
anchor).  These helpers move that state between this package's tensors
and plain numpy arrays, the form the reference's arrays convert to and
from (``np.asarray`` / ``jnp.asarray``), so a carry folded by one package
can be finalized, or folded further, by the other.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from .policy import get_policy

_DTYPES = {torch.float32: np.float32, torch.int32: np.int32}


def carry_from_reference(policy_name: str, arrays: Sequence, ctx=None, *,
                         device="cpu") -> Tuple[tuple, object]:
    """(carry tuple, ctx) as tensors from the reference's numpy arrays.

    Checks the component count and dtypes against the policy, so a carry
    of the wrong tier fails here instead of finalizing to garbage.
    """
    policy = get_policy(policy_name)
    arrays = tuple(arrays)
    if len(arrays) != policy.carry_len:
        raise ValueError(f"policy {policy_name!r} carries "
                         f"{policy.carry_len} arrays, got {len(arrays)}")
    carry = []
    for a, dt in zip(arrays, policy.carry_dtypes):
        a = np.asarray(a)
        if a.dtype != _DTYPES[dt]:
            raise ValueError(f"policy {policy_name!r} carry component has "
                             f"dtype {a.dtype}, expected {_DTYPES[dt]}")
        carry.append(torch.as_tensor(a.copy(), device=device))
    if ctx is not None:
        ctx = torch.as_tensor(np.asarray(ctx).copy(), device=device)
    return tuple(carry), ctx


def carry_to_numpy(carry, ctx=None) -> Tuple[tuple, object]:
    """(carry tuple, ctx) as numpy arrays, ready for ``jnp.asarray``."""
    out = tuple(c.detach().cpu().numpy() for c in carry)
    if ctx is not None:
        ctx = ctx.detach().cpu().numpy()
    return out, ctx
