"""Fixed pairing-tree reduction schedules.

JugglePAC re-orders additions, so the re-ordering follows a fixed,
shallow tree: level 1 pairs adjacent inputs, higher levels pair partial
results.  The pairing depends only on the element count, so results are
bitwise reproducible across layouts.  An odd remainder at a level passes
through to the next level untouched.

This pass-through tree equals a right fold of the subtrees of the count's
binary decomposition (largest first): for 13 leaves,
``T8 + (T4 + x12)``.  The CUDA kernels of this package build it that way,
with a binary-counter stack of subtrees, and their plain versions call
``pairwise_tree_sum``: both give the same bits.
"""

from __future__ import annotations

from typing import Callable

import torch


def tree_combine(x: torch.Tensor, axis: int,
                 combine: Callable[[torch.Tensor, torch.Tensor],
                                   torch.Tensor]) -> torch.Tensor:
    """Reduce ``axis`` with the fixed balanced pairing tree; an odd
    remainder at each level passes through untouched."""
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    if n == 0:
        raise ValueError("cannot tree-reduce an empty axis")
    while n > 1:
        half = n // 2
        paired = combine(x[0:2 * half:2], x[1:2 * half:2])
        x = torch.cat([paired, x[n - 1:n]], 0) if n % 2 else paired
        n = x.shape[0]
    return x[0]


def pairwise_tree_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Deterministic log-depth pairwise summation over ``axis``."""
    return tree_combine(x, axis, torch.add)


def _tree_add(a, b):
    if isinstance(a, (tuple, list)):
        return type(a)(_tree_add(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return {k: _tree_add(a[k], b[k]) for k in a}
    return a + b


def pairwise_tree_sum_pytree(trees, combine=None):
    """Pairwise-tree reduce a list of nested tuples/lists/dicts of tensors
    (e.g. microbatch gradients), leaf by leaf."""
    combine = combine or _tree_add
    items = list(trees)
    if not items:
        raise ValueError("empty list")
    while len(items) > 1:
        nxt = [combine(items[i], items[i + 1])
               for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]


def tree_depth(n: int) -> int:
    """Depth of the fixed pairing tree for n leaves = ceil(log2 n)."""
    d = 0
    while (1 << d) < n:
        d += 1
    return d
