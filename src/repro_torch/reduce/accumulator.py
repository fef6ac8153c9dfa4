"""The streaming ``Accumulator`` protocol — one contract for every state
machine of the package:

    init(template)      -> state        bounded
    push(state, x)      -> state        consume one stream element
    merge(a, b)         -> state        combine two partial streams
    finalize(state)     -> value        the once-per-set "final addition"

``scan_accumulate`` folds a stacked stream through ``push`` in order;
``merge_tree`` merges a list of states in a fixed pairwise tree.

Instances so far: ``FlashAccumulator``, the online-softmax (m, l, o)
triple that merges the raw partials of the chunked flash-decode kernel.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from ..core.segmented import flash_finalize, flash_partial_combine
from ..core.trees import pairwise_tree_sum_pytree


@runtime_checkable
class Accumulator(Protocol):
    """Structural protocol: anything with init/push/merge/finalize.

    ``merge`` is the declared combiner — what ``merge_tree`` folds with."""

    def init(self, template) -> Any: ...

    def push(self, state, x) -> Any: ...

    def merge(self, a, b) -> Any: ...

    def finalize(self, state) -> Any: ...


class FlashAccumulator:
    """Online-softmax partials: state = (max m, denom l, weighted out o).

    ``push``/``merge`` are the same associative combine (flash partials
    are their own partial-stream type); ``finalize`` returns the
    normalized output ``o / max(l, 1e-30)``.

    >>> import torch
    >>> acc = FlashAccumulator()
    >>> st = acc.init((torch.zeros(1), torch.zeros(1), torch.zeros(1, 2)))
    >>> st = acc.push(st, (torch.zeros(1), torch.ones(1),
    ...                    torch.tensor([[2.0, 4.0]])))
    >>> acc.finalize(st).tolist()
    [[2.0, 4.0]]
    """

    _NEG = -1e30

    def init(self, template):
        m, l, o = template
        return (torch.full(m.shape, self._NEG, dtype=torch.float32,
                           device=m.device),
                torch.zeros(l.shape, dtype=torch.float32, device=l.device),
                torch.zeros(o.shape, dtype=torch.float32, device=o.device))

    def push(self, state, partial):
        return flash_partial_combine(*state, *partial)

    def merge(self, a, b):
        return self.push(a, b)

    def finalize(self, state):
        _, l, o = state
        return flash_finalize(l, o)


def _index(xs, i):
    if isinstance(xs, (tuple, list)):
        return type(xs)(_index(x, i) for x in xs)
    return xs[i]


def _length(xs) -> int:
    return _length(xs[0]) if isinstance(xs, (tuple, list)) else xs.shape[0]


def scan_accumulate(acc: Accumulator, xs, template=None):
    """Fold a stacked stream (leading axis; a tensor or a tuple of them)
    through ``acc`` in order and finalize."""
    if template is None:
        template = _index(xs, 0)
    state = acc.init(template)
    for i in range(_length(xs)):
        state = acc.push(state, _index(xs, i))
    return acc.finalize(state)


def merge_tree(acc: Accumulator, states):
    """Fixed pairwise-tree merge of a list of accumulator states; an odd
    leftover passes through at each level."""
    items = list(states)
    if not items:
        raise ValueError("merge_tree: empty state list")
    return pairwise_tree_sum_pytree(items, combine=acc.merge)
