"""Segment-id utilities for back-to-back variable-length sets, the
scatter-add math oracle, and the flash-decode partial combines."""

from __future__ import annotations

from typing import Optional

import torch

from .trees import pairwise_tree_sum  # noqa: F401  (re-export)
from .trees import pairwise_tree_sum_pytree


def segment_sum_ref(values: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Oracle: scatter-add per segment. values (N, D) or (N,), ids (N,).

    Rows labeled outside [0, num_segments) — e.g. the padding sentinel
    ``OUT_OF_RANGE_LABEL`` — are dropped.  ``index_add_`` adds in no
    defined order: hold float results to it within a tolerance."""
    ids = segment_ids.to(torch.int64)
    ok = (ids >= 0) & (ids < num_segments)
    ids = torch.where(ok, ids, torch.full_like(ids, num_segments))
    vals = torch.where(ok.reshape(ok.shape + (1,) * (values.ndim - 1)),
                       values, torch.zeros((), dtype=values.dtype,
                                           device=values.device))
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=values.device)
    return out.index_add_(0, ids, vals)[:num_segments]


def segment_count_ref(segment_ids: torch.Tensor, num_segments: int,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows per segment, as f32 (the reference counts through the same
    scatter as its sums)."""
    w = torch.ones(segment_ids.shape, dtype=torch.float32,
                   device=segment_ids.device)
    if valid is not None:
        w = w * valid.to(torch.float32)
    return segment_sum_ref(w, segment_ids, num_segments)


def segments_from_lengths(lengths, total: int) -> torch.Tensor:
    """Build a monotone int32 segment-id vector from per-set lengths.

    ``lengths`` (S,) with sum == total -> ids (total,), on ``lengths``'s
    device.  The inverse of the paper's ``start`` bit:
    start[i] = ids[i] != ids[i-1].  Starts at or past ``total`` (trailing
    empty sets) are dropped, as the reference's scatter drops them.
    """
    lengths = torch.as_tensor(lengths)
    starts = torch.cumsum(lengths.to(torch.int64), 0)[:-1]
    starts = starts[(starts >= 0) & (starts < total)]
    marks = torch.zeros(total, dtype=torch.int32, device=lengths.device)
    marks.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    return torch.cumsum(marks, 0, dtype=torch.int32)


def max_live_segments(block_size: int) -> int:
    """Bounded-storage bound: with monotone ids, one block overlaps at most
    block_size + 1 segments."""
    return block_size + 1


def streaming_logsumexp_combine(m1, l1, m2, l2):
    """Combine two streaming softmax denominators (max m, sum-of-exp l)."""
    m = torch.maximum(m1, m2)
    return m, l1 * torch.exp(m1 - m) + l2 * torch.exp(m2 - m)


def flash_partial_combine(m1, l1, o1, m2, l2, o2):
    """Combine two flash-attention partial (max, denom, weighted-out)
    triples: m (...), l (...), o (..., d)."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    l = l1 * a1 + l2 * a2
    o = o1 * a1[..., None] + o2 * a2[..., None]
    return m, l, o


def flash_finalize(l, o):
    """The normalized output of a flash partial: ``o / max(l, 1e-30)``."""
    return o / torch.clamp_min(l, 1e-30)[..., None]


def combine_flash_partials_tree(m, l, o, axis: int = 0):
    """Fixed pairwise-tree combine of stacked flash partials along
    ``axis``; an odd remainder passes through at each level, so the result
    does not depend on arrival order."""
    m, l, o = (torch.movedim(t, axis, 0) for t in (m, l, o))
    return pairwise_tree_sum_pytree(
        list(zip(m, l, o)), combine=lambda a, b: flash_partial_combine(*a, *b))
