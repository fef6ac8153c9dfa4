"""Reduction algebra: the op registry above the accuracy policies.

Each ``ReduceOp`` declares a row-local ``pre`` (raw (N, D) rows -> the
(N, components*D) rows the schedule folds) and a segment-local ``post``
(per-segment sums, plus exact int32 counts where ``needs_count``, -> the
op's result).  ``pre`` runs above the policy layer, so every tier weights
in its own domain and every executor guarantee carries over unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

#: name -> registered ``ReduceOp`` instance
REDUCE_OPS: Dict[str, "ReduceOp"] = {}


def register_op(cls):
    """Class decorator: instantiate and register a ``ReduceOp``."""
    op = cls()
    if not op.name or op.name == "?":
        raise ValueError(f"ReduceOp subclass {cls.__name__} must set a name")
    if op.name in REDUCE_OPS:
        raise ValueError(f"reduce op {op.name!r} is already registered")
    REDUCE_OPS[op.name] = op
    return cls


def get_op(name: str) -> "ReduceOp":
    try:
        return REDUCE_OPS[name]
    except KeyError:
        raise ValueError(f"unknown reduce op {name!r}; registered ops: "
                         f"{sorted(REDUCE_OPS)}") from None


class ReduceOp:
    """One entry of the reduction algebra (see the module doc)."""

    name: str = "?"
    components: int = 1
    takes_weights: bool = False
    requires_weights: bool = False
    takes_coeffs: bool = False
    requires_coeffs: bool = False
    needs_count: bool = False

    def pre(self, values, *, weights=None, coeffs=None):
        """(N, D) raw rows -> (N, components*D) rows to fold."""
        return values

    def post(self, summed, counts):
        """(S, components*D) sums (+ (S, 1) counts) -> op result."""
        return summed


def _weighted(values, weights):
    return values.to(torch.float32) * weights.to(torch.float32)[:, None]


def _sub_square(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b*b rounded once to f32, as a fused multiply-add rounds it.

    The reference's ``post`` runs under XLA, which contracts
    ``m2 - m1*m1`` into one FMA on the CPU; this gives the same bits with
    elementwise float64 ops: b*b is exact in float64, the float64
    difference and its exact two-sum error locate the true value, and a
    float64 result that lands on an f32 rounding tie is nudged toward the
    error's side before the one rounding to f32.
    """
    a64 = a.to(torch.float64)
    p = b.to(torch.float64) * b.to(torch.float64)
    s = a64 - p
    bp = s - a64
    err = (a64 - (s - bp)) + (-p - bp)
    r = s.to(torch.float32)
    gap = s - r.to(torch.float64)
    toward = torch.where(gap > 0, torch.full_like(r, float("inf")),
                         torch.full_like(r, -float("inf")))
    other = torch.nextafter(r, toward)
    half = (other.to(torch.float64) - r.to(torch.float64)).abs() / 2
    tie = (gap != 0) & (gap.abs() == half) & (err != 0)
    beyond = tie & ((err > 0) == (gap > 0))
    return torch.where(beyond, other, r)


@register_op
class SumOp(ReduceOp):
    """Plain segmented sum (``pre`` is the identity)."""

    name = "sum"


@register_op
class MeanOp(ReduceOp):
    """Segmented mean over in-range rows (exact integer counts)."""

    name = "mean"
    needs_count = True

    def post(self, summed, counts):
        return summed / torch.clamp(counts, min=1).to(torch.float32)


@register_op
class WeightedSumOp(ReduceOp):
    """sum_i w_i * v_i with per-row weights, in every tier's own domain."""

    name = "weighted_sum"
    takes_weights = True
    requires_weights = True

    def pre(self, values, *, weights=None, coeffs=None):
        return _weighted(values, weights)


@register_op
class SumsqOp(ReduceOp):
    """sum_i v_i^2."""

    name = "sumsq"

    def pre(self, values, *, weights=None, coeffs=None):
        vf = values.to(torch.float32)
        return vf * vf


@register_op
class MomentsOp(ReduceOp):
    """Per-segment (mean, var) from one double-width ``[v | v*v]`` pass;
    the result grows a leading statistic axis: (S, 2, D)."""

    name = "moments"
    components = 2
    needs_count = True

    def pre(self, values, *, weights=None, coeffs=None):
        vf = values.to(torch.float32)
        return torch.cat([vf, vf * vf], 1)

    def post(self, summed, counts):
        d = summed.shape[1] // 2
        c = torch.clamp(counts, min=1).to(torch.float32)
        m1 = summed[:, :d] / c
        m2 = summed[:, d:] / c
        var = torch.clamp(_sub_square(m2, m1), min=0.0)
        return torch.stack([m1, var], 1)


@register_op
class PolyOp(ReduceOp):
    """sum_i p(i) * v_i with p(i) = coeffs[0] + coeffs[1]*i + ... over the
    global row index (Horner in f32)."""

    name = "poly"
    takes_coeffs = True
    requires_coeffs = True

    def pre(self, values, *, weights=None, coeffs=None):
        return _weighted(values, poly_weights(values.shape[0], coeffs,
                                              device=values.device))


def poly_weights(n: int, coeffs: Sequence[float],
                 device=None) -> torch.Tensor:
    """(n,) f32 weights ``w_i = p(i)`` by Horner's rule in f32 (a separate
    multiply and add per step).

    >>> [float(v) for v in poly_weights(4, (1.0, 2.0))]
    [1.0, 3.0, 5.0, 7.0]
    """
    i = torch.arange(n, dtype=torch.float32, device=device)
    w = torch.zeros(n, dtype=torch.float32, device=device)
    for c in reversed(tuple(coeffs)):
        w = w * i + float(np.float32(c))
    return w


def fir_weights(n: int, taps: Sequence[float]) -> torch.Tensor:
    """Weights that make ``weighted_sum`` emit one FIR output (newest
    sample gets tap 0).

    >>> [float(v) for v in fir_weights(4, (0.5, 0.25))]
    [0.0, 0.0, 0.25, 0.5]
    """
    w = np.zeros(n, np.float32)
    for k, t in enumerate(taps):
        if n - 1 - k >= 0:
            w[n - 1 - k] = t
    return torch.as_tensor(w)


def cascade_weights(n: int, depth: int) -> torch.Tensor:
    """(depth, n) f32 time-index weights of ``depth`` chained plain
    accumulators: row k-1 holds C(n-1-i + k-1, k-1).

    >>> cascade_weights(4, 2).tolist()
    [[1.0, 1.0, 1.0, 1.0], [4.0, 3.0, 2.0, 1.0]]
    """
    rows = [[math.comb(n - 1 - i + k - 1, k - 1) for i in range(n)]
            for k in range(1, depth + 1)]
    return torch.as_tensor(np.asarray(rows, np.float32))


def cascade_poly_coeffs(coeffs: Sequence[float], n: int) -> tuple:
    """Stage-combination weights ``alpha`` with
    ``sum_k alpha[k] * stage_{k+1}`` equal to the ``op="poly"`` weighting
    on an n-element stream (solved in float64 on the first ``deg`` rows).

    >>> [round(a, 9) for a in cascade_poly_coeffs((0.0, 1.0), 5)]
    [4.0, -1.0]
    """
    deg = len(coeffs)
    if deg == 0:
        return ()
    if n < deg:
        raise ValueError(f"need n >= {deg} stream elements to pin a "
                         f"degree-{deg - 1} weighting, got n={n}")
    basis = np.zeros((deg, deg), np.float64)
    target = np.zeros(deg, np.float64)
    for i in range(deg):
        for k in range(1, deg + 1):
            basis[i, k - 1] = math.comb(n - 1 - i + k - 1, k - 1)
        target[i] = sum(c * float(i) ** p for p, c in enumerate(coeffs))
    alpha = np.linalg.solve(basis, target)
    return tuple(float(a) for a in alpha)
