"""The streaming ``Accumulator`` protocol — one contract for every state
machine of the package:

    init(template)      -> state        bounded
    push(state, x)      -> state        consume one stream element
    merge(a, b)         -> state        combine two partial streams
    finalize(state)     -> value        the once-per-set "final addition"

``scan_accumulate`` folds a stacked stream through ``push`` in order;
``merge_tree`` merges a list of states in a fixed pairwise tree.

Instances so far:
  * ``TreeAccumulator`` — the binary-counter pairwise tree of
    ``core.juggler`` over a list of tensors: O(log n) live copies, a
    pairing that depends only on the push order;
  * ``FlashAccumulator`` — the online-softmax (m, l, o) triple that merges
    the raw partials of the chunked flash-decode kernel.

Microbatch gradients take one of two paths, as in the reference:
``accumulate_microbatch_grads`` pushes each microbatch's gradient through
a ``TreeAccumulator``; ``reduce_microbatch_grads`` stacks them into one
(m, |leaf|) float32 stream per leaf and takes its mean through the
``repro_torch.reduce`` front door (K1 on a CUDA device).  Under an integer
tier the scale is chosen from the whole stream, so the bits depend on
what a leaf is: the train step passes its gradients in the reference's
layout (``models.convert.to_reference``: each period position's leaf
stacked over the periods, the leaves in ``jax.tree.leaves`` order), which
makes each stream the reference's, bit for bit.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import torch

from ..core import juggler
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


class TreeAccumulator:
    """Binary-counter pairwise-tree accumulation of lists of tensors (wraps
    ``core.juggler``): ``num_slots`` >= ceil(log2 pushes) + 1 slots bound
    the live state, and the pairing depends only on the push order.

    >>> import torch
    >>> acc = TreeAccumulator.for_count(3)
    >>> st = acc.init([torch.zeros(2)])
    >>> for v in (1.0, 2.0, 3.0):
    ...     st = acc.push(st, [torch.full((2,), v)])
    >>> acc.finalize(st, mean=True)[0].tolist()
    [2.0, 2.0]
    """

    def __init__(self, num_slots: int):
        self.num_slots = num_slots

    @classmethod
    def for_count(cls, num_pushes: int) -> "TreeAccumulator":
        return cls(juggler.num_slots_for(num_pushes))

    def init(self, template) -> juggler.JugglerState:
        return juggler.juggler_init(template, self.num_slots)

    def push(self, state, x) -> juggler.JugglerState:
        return juggler.juggler_push(state, x)

    def merge(self, a, b) -> juggler.JugglerState:
        """Fold b's slots to one partial and insert it into a's counter —
        a fixed, deterministic (if unbalanced) pairing of the two trees."""
        merged = juggler.juggler_push(a, juggler.juggler_finalize(b))
        return merged._replace(count=a.count + b.count)

    def finalize(self, state, *, mean: bool = False):
        return juggler.juggler_finalize(state, mean=mean)


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
    if isinstance(xs, dict):
        return {k: _index(v, i) for k, v in xs.items()}
    if isinstance(xs, (tuple, list)):
        return type(xs)(_index(x, i) for x in xs)
    return xs[i]


def _length(xs) -> int:
    if isinstance(xs, dict):
        return _length(next(iter(xs.values())))
    return _length(xs[0]) if isinstance(xs, (tuple, list)) else xs.shape[0]


def _stack(trees):
    """A list of equal-structured trees (tensors, or dicts, tuples and
    lists of them) -> one tree of tensors stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(list(trees))


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


_ITEM5 = ("ROADMAP.md queue 1, item 5 (multi-device) brings it; the port "
          "runs on one device")


def _grads_by_microbatch(grad_fn, params, microbatches, m: int):
    """Run ``grad_fn`` on each of the m stacked microbatches in order:
    (list of gradient dicts, stacked aux)."""
    grads, auxes = [], []
    for i in range(m):
        g, aux = grad_fn(params, _index(microbatches, i))
        grads.append(g)
        auxes.append(aux)
    return grads, _stack(auxes)


def reduce_microbatch_grads(grad_fn, params, microbatches, *,
                            num_microbatches: int, policy: str,
                            backend=None, mesh=None):
    """Microbatch gradient mean through the ``repro_torch.reduce`` front
    door.

    ``grad_fn(params, mb) -> (grads, aux)`` with ``grads`` a dict of
    tensors; ``microbatches`` is stacked on a leading axis of
    ``num_microbatches``.  Each leaf's m gradients form one (m, |leaf|)
    float32 stream (one row per microbatch = one schedule block,
    ``block_size=1``) whose ``op="mean"`` is taken under ``policy`` on the
    leaves' device (K1 on a CUDA device; ``backend`` names another
    executor), then cast back to the leaf's dtype: one reduction per
    leaf.  Under an integer tier the mean is bitwise independent of the
    microbatch count and the executor.  Keeps all m gradients alive.
    Returns (mean grads, stacked aux).  ``mesh`` raises: this port runs
    on one device.
    """
    from .api import ReduceSpec, reduce as _reduce
    if mesh is not None:
        raise NotImplementedError(f"reduce_microbatch_grads(mesh=): "
                                  f"{_ITEM5}")
    spec = ReduceSpec(op="mean", policy=policy, backend=backend,
                      block_size=1)
    grads, aux = _grads_by_microbatch(grad_fn, params, microbatches,
                                      num_microbatches)
    per_leaf = {k: [g[k] for g in grads] for k in grads[0]}
    del grads
    out = {}
    for k in list(per_leaf):
        parts = per_leaf.pop(k)          # the leaf's m gradients, in order
        shape, dtype, dev = parts[0].shape, parts[0].dtype, parts[0].device
        stream = torch.empty((num_microbatches, parts[0].numel()),
                             dtype=torch.float32, device=dev)
        for i, g in enumerate(parts):
            stream[i].copy_(g.reshape(-1))
        del parts, g
        out[k] = _reduce(stream, spec=spec, device=dev).reshape(shape) \
            .to(dtype)
        del stream
    return out, aux


def accumulate_microbatch_grads(grad_fn, params, microbatches, *,
                                num_microbatches: int, mean: bool = True):
    """Microbatch gradient accumulation through the Accumulator protocol:
    each microbatch's gradient (a dict of tensors) is pushed, in order,
    into a ``TreeAccumulator`` (O(log m) live copies, a fixed pairing).
    Returns (mean or sum, stacked aux)."""
    acc = TreeAccumulator.for_count(num_microbatches)
    state, keys, auxes = None, None, []
    for i in range(num_microbatches):
        g, aux = grad_fn(params, _index(microbatches, i))
        if state is None:
            keys = list(g)
            state = acc.init([g[k] for k in keys])
        state = acc.push(state, [g[k] for k in keys])
        del g
        auxes.append(aux)
    total = acc.finalize(state, mean=mean)
    return dict(zip(keys, total)), _stack(auxes)
