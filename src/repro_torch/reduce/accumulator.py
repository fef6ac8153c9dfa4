"""The streaming ``Accumulator`` protocol — one contract for every state
machine of the package:

    init(template)      -> state        bounded
    push(state, x)      -> state        consume one stream element
    merge(a, b)         -> state        combine two partial streams
    finalize(state)     -> value        the once-per-set "final addition"

``scan_accumulate`` folds a stacked stream through ``push`` in order;
``merge_tree`` merges a list of states in a fixed pairwise tree.

Instances:
  * ``TreeAccumulator`` — the binary-counter pairwise tree of
    ``core.juggler`` over a list of tensors: O(log n) live copies, a
    pairing that depends only on the push order;
  * ``KahanAccumulator`` — the (sum, compensation) two-sum pair of a
    tensor or a dict, tuple or list of them;
  * ``LimbAccumulator`` — INTAC's two int32 carry-save limbs
    (``core.intac.LimbState``): exact on the scale's grid, order-free;
  * ``Limb3Accumulator`` — the three-limb state: the quantization
    residual rides along as a compensated f32 pair, so any f32 stream
    sums to within 1 ulp of float64;
  * ``BinAccumulator`` — exponent-indexed int32 digit bins anchored at
    an a-priori max |x|: order-free, one rounding at ``finalize``;
  * ``FlashAccumulator`` — the online-softmax (m, l, o) triple that merges
    the raw partials of the chunked flash-decode kernel;
  * ``CascadeAccumulator`` — ``depth`` chained plain accumulators, whose
    stages combine into any polynomial time-index weighting.

The integer states (limbs, bins) are bitwise the reference's for any
push order.  The float states follow the reference's IEEE operations in
the same order.  ``merge_across`` merges the states of a process group's
ranks (the reference merges across mesh axes): an accumulator's own
``merge_across`` (``Limb3Accumulator``: the limbs and the residual's
digits in one integer psum), else an integer ``psum`` of each leaf for
one that declares ``merge_is_add`` (``BinAccumulator``), else a gather
and a strict rank-order fold with ``merge``.

Microbatch gradients take one of two paths, as in the reference:
``accumulate_microbatch_grads`` pushes each microbatch's gradient through
a ``TreeAccumulator``; ``reduce_microbatch_grads`` stacks them into one
(m, |leaf|) float32 stream per leaf and takes its mean through the
``repro_torch.reduce`` front door (K1 on a CUDA device; with ``group=``
each rank stacks its own microbatches and the ``shard_map`` executor
reduces the group's stack).  Under an integer
tier the scale is chosen from the whole stream, so the bits depend on
what a leaf is: the train step passes its gradients in the reference's
layout (``models.convert.to_reference``: each period position's leaf
stacked over the periods, the leaves in ``jax.tree.leaves`` order), which
makes each stream the reference's, bit for bit.
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

import math

import torch

from ..core import intac, juggler
from ..core.segmented import flash_finalize, flash_partial_combine
from ..core.trees import pairwise_tree_sum_pytree
from ..distributed import comm


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


def _map(fn, *trees):
    """``fn`` over the tensors of equal-structured trees (a tensor, or a
    dict, tuple, NamedTuple or list of them); other leaves (``None``, an
    int) pass through from the first tree."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees) if isinstance(first, torch.Tensor) else first


class KahanAccumulator:
    """Compensated (sum, comp) accumulation of a tensor or a tree of them:
    every push is a ``two_sum`` into float32 sums, its error added to the
    compensation; ``finalize`` is sum + comp.

    >>> import torch
    >>> acc = KahanAccumulator()
    >>> st = acc.init(torch.zeros(2))
    >>> st = acc.push(st, torch.tensor([1.0, 2.0]))
    >>> st = acc.push(st, torch.tensor([3.0, 4.0]))
    >>> acc.finalize(st).tolist()
    [4.0, 6.0]
    """

    def init(self, template):
        z = _map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                       device=t.device), template)
        return (z, _map(torch.zeros_like, z))

    def push(self, state, x):
        acc, comp = state
        s = _map(lambda a, b: intac.two_sum(a, b)[0], acc, x)
        e = _map(lambda a, b: intac.two_sum(a, b)[1], acc, x)
        return (s, _map(torch.add, comp, e))

    def merge(self, a, b):
        state = self.push(a, b[0])                    # two-sum the sums
        return (state[0], _map(lambda c, cb: c + cb, state[1], b[1]))

    def finalize(self, state):
        acc, comp = state
        return _map(lambda a, c: a + c, acc, comp)


class LimbAccumulator:
    """INTAC two-limb carry-save accumulation, exact within quantization:
    ``scale`` is the shared power of two (``intac.choose_scale``); push
    and merge are integer adds, ``finalize`` the one rounding.  Each push
    needs |x * scale| < 2^31, and each limb's sum must stay in int32.

    >>> import torch
    >>> acc = LimbAccumulator(2.0 ** 16)
    >>> a, b = acc.init(torch.zeros(1)), acc.init(torch.zeros(1))
    >>> for _ in range(10):
    ...     a = acc.push(a, torch.tensor([0.5]))
    ...     b = acc.push(b, torch.tensor([0.25]))
    >>> acc.finalize(acc.merge(a, b)).tolist()
    [7.5]
    """

    def __init__(self, scale):
        self.scale = scale

    def init(self, template) -> intac.LimbState:
        return intac.limb_init(template.shape, self.scale,
                               device=template.device)

    def push(self, state, x) -> intac.LimbState:
        return intac.limb_add(state, x)

    def merge(self, a, b) -> intac.LimbState:
        return intac.limb_merge(a, b)

    def finalize(self, state) -> torch.Tensor:
        return intac.limb_finalize(state)


class Limb3Accumulator:
    """INTAC three-limb carry-save accumulation, exact for any f32: each
    push splits its operand losslessly into (hi, lo, residual); the limbs
    add as integers (wraps counted in ``ovf``), the residual through a
    compensated pair; ``finalize`` is within 1 ulp of float64.

    >>> import torch
    >>> acc = Limb3Accumulator(2.0 ** 16)
    >>> st = acc.init(torch.zeros(1))
    >>> for _ in range(3):
    ...     st = acc.push(st, torch.tensor([1 / 3]))
    >>> bool(abs(acc.finalize(st)[0] - 1.0) < 1e-7)
    True
    """

    def __init__(self, scale):
        self.scale = scale

    def init(self, template) -> intac.Limb3State:
        return intac.limb3_init(template.shape, self.scale,
                                device=template.device)

    def push(self, state, x) -> intac.Limb3State:
        return intac.limb_add3(state, x)

    def merge(self, a, b) -> intac.Limb3State:
        return intac.limb_merge3(a, b)

    def merge_across(self, state, group) -> intac.Limb3State:
        """The merge of the ranks' states, taken by the module's
        ``merge_across`` in place of its generic paths: the shared
        three-limb merge (``intac.limb3_merge_across``: the residual pair
        re-binned as digits, one integer psum of [hi | lo | digits]); the
        scale passes through and the wrap count sums as an integer."""
        hi, lo, res, comp = intac.limb3_merge_across(
            state.hi, state.lo, state.res, state.comp, group)
        ovf = None if state.ovf is None else comm.psum(state.ovf, group)
        return intac.Limb3State(hi, lo, res, comp, state.scale, ovf)

    def finalize(self, state) -> torch.Tensor:
        return intac.limb3_finalize(state)


class BinAccumulator:
    """Exponent-indexed bin accumulation (procrastination bins): ``max_abs``
    anchors the fixed-point window a priori; each push adds an exact
    digit split as int32 bins, and the one rounding is ``finalize``'s.
    Up to ``intac.BIN_MAX_TERMS`` (2^22) pushes fit in the bins."""

    #: every state leaf merges by addition
    merge_is_add = True

    def __init__(self, max_abs):
        self.e_ref = intac.bin_ref_exponent(max_abs)
        self._anchors = {self.e_ref.device: self.e_ref}

    def _anchor(self, device) -> torch.Tensor:
        """``e_ref`` on ``device``, copied there once (not at every push)."""
        if device not in self._anchors:
            self._anchors[device] = self.e_ref.to(device)
        return self._anchors[device]

    def init(self, template) -> torch.Tensor:
        return torch.zeros((intac.NUM_BINS,) + tuple(template.shape),
                           dtype=torch.int32, device=template.device)

    def push(self, state, x) -> torch.Tensor:
        return state + intac.bin_split(x, self._anchor(x.device))

    def merge(self, a, b) -> torch.Tensor:
        return a + b

    def finalize(self, state) -> torch.Tensor:
        return intac.bin_combine(state, self._anchor(state.device))


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


class CascadeAccumulator:
    """``depth`` chained plain accumulators (the cascaded-PAC
    construction): each push folds the element into stage 1 and each
    stage's new value into the next, so after n pushes stage k holds
    ``sum_i C(n-1-i + k-1, k-1) x_i`` (``algebra.cascade_weights``), and
    a fixed combination of the stages (``algebra.cascade_poly_coeffs``)
    gives any polynomial time-index weighting.

    The state is ``(count, stage sums)``.  ``merge(a, b)`` concatenates
    the two streams in argument order by the closed-form stage mixing
    ``S_k = A_k + B_k + sum_{j<k} C(m+k-j-1, k-j) A_j`` with m = b's
    count, its coefficients built in float32 as the reference builds
    them.  ``finalize`` stacks the stages (leading axis).

    >>> import torch
    >>> acc = CascadeAccumulator(2)
    >>> st = acc.init(torch.zeros(()))
    >>> for v in (1.0, 10.0, 100.0):
    ...     st = acc.push(st, torch.tensor(v))
    >>> acc.finalize(st).tolist()               # [sum, 3*1+2*10+1*100]
    [111.0, 123.0]
    >>> a = acc.push(acc.init(torch.zeros(())), torch.tensor(1.0))
    >>> b = acc.init(torch.zeros(()))
    >>> for v in (10.0, 100.0):
    ...     b = acc.push(b, torch.tensor(v))
    >>> acc.finalize(acc.merge(a, b)).tolist()
    [111.0, 123.0]
    """

    def __init__(self, depth: int):
        if depth < 1:
            raise ValueError(f"cascade depth must be >= 1, got {depth}")
        self.depth = int(depth)

    def init(self, template):
        z = torch.zeros(template.shape, dtype=torch.float32,
                        device=template.device)
        return (torch.zeros((), dtype=torch.int32, device=template.device),
                (z,) * self.depth)

    def push(self, state, x):
        count, sums = state
        run = x.to(torch.float32)
        new = []
        for s in sums:
            run = s + run                # stage k folds stage k-1's value
            new.append(run)
        return (count + 1, tuple(new))

    def merge(self, a, b):
        ca, sa = a
        cb, sb = b
        m = cb.to(torch.float32)
        out = []
        for k in range(1, self.depth + 1):
            s = sa[k - 1] + sb[k - 1]
            for j in range(1, k):
                r = k - j                # C(m + r - 1, r)
                coef = torch.ones((), dtype=torch.float32, device=m.device)
                for t in range(r):
                    coef = coef * (m + t)
                # a tensor divisor: an IEEE division on every device (a
                # CPU-scalar divisor may become a reciprocal multiply)
                fact = torch.tensor(float(math.factorial(r)),
                                    dtype=torch.float32, device=m.device)
                s = s + (coef / fact) * sa[j - 1]
            out.append(s)
        return (ca + cb, tuple(out))

    def finalize(self, state):
        return torch.stack(state[1], dim=0)


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


def merge_across(acc: Accumulator, state, group):
    """Merge the accumulator states of ``group``'s ranks; every rank gets
    the merged state.

    ``merge`` is every accumulator's combiner; this is its collective
    face, as ``collective.merge_carry_across`` is the policies'.  An
    accumulator with its own ``merge_across`` method keeps the lowering
    (``Limb3Accumulator``); one declaring ``merge_is_add`` (its leaves
    integers: ``BinAccumulator``) sums each leaf with an integer
    ``psum``; any other state is gathered leaf by leaf and folded with
    ``merge`` strictly in rank order: deterministic, and exact wherever
    ``merge`` is (``LimbAccumulator``)."""
    own = getattr(acc, "merge_across", None)
    if callable(own):
        return own(state, group)
    if getattr(acc, "merge_is_add", False):
        return _map(lambda x: comm.psum(x, group), state)
    gathered = _map(lambda x: comm.all_gather(x, group), state)
    merged = _map(lambda g: g[0], gathered)
    for k in range(1, comm.axis_size(group)):
        merged = acc.merge(merged, _map(lambda g: g[k], gathered))
    return merged


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
                            backend=None, group=None):
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
    Returns (mean grads, stacked aux).

    ``group`` (a process group, the reference's ``mesh``): this rank's
    ``num_microbatches`` microbatches are its contiguous share of the
    group's, and each leaf's mean is over the whole group's stack,
    through the ``shard_map`` executor (auto-selected under more than one
    rank): under an integer tier the bits of one process running every
    microbatch.  The aux stays this rank's.
    """
    from .api import ReduceSpec, reduce as _reduce
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
        out[k] = _reduce(stream, spec=spec, device=dev,
                         group=group).reshape(shape).to(dtype)
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
