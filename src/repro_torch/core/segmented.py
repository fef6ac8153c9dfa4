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
    # detlint: ok[DET003] open fault (ROADMAP queue 3, F6): a float index_add_
    # adds with CUDA atomics in no fixed order; an oracle held to a tolerance,
    # but segment_mean routes float rows here by default, so on the card
    # segment_mean can differ run to run
    return out.index_add_(0, ids, vals)[:num_segments]


def segment_count_ref(segment_ids: torch.Tensor, num_segments: int,
                      valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Rows per segment, as f32 (the reference counts through the same
    scatter as its sums)."""
    w = torch.ones(segment_ids.shape, dtype=torch.float32,
                   device=segment_ids.device)
    if valid is not None:
        w = w * valid.to(torch.float32)
    # detlint: ok[DET006] counts ride the same impl as the sums (reference
    # core/segmented.py:66); ones add exactly in any order below 2^24, and
    # every caller bounds N well under it
    return segment_sum_ref(w, segment_ids, num_segments)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, *, impl=segment_sum_ref,
                 valid: Optional[torch.Tensor] = None,
                 eps: float = 1e-9) -> torch.Tensor:
    """Per-segment mean; the sums *and the counts* go through ``impl``.

    ``impl`` is any segment sum with the ``(values, ids, num_segments)``
    contract (the oracle above, a ``repro_torch.reduce`` executor, the
    kernel wrapper).  ``valid`` masks rows out of both by relabeling them
    ``OUT_OF_RANGE_LABEL``; a count is floored at ``eps``."""
    # imported here: repro_torch.reduce imports this module as it loads
    from ..reduce.backends import OUT_OF_RANGE_LABEL
    ids = segment_ids.to(torch.int32)
    if valid is not None:
        ids = torch.where(valid, ids,
                          torch.full_like(ids, OUT_OF_RANGE_LABEL))
    s = impl(values, ids, num_segments)
    c = impl(torch.ones(ids.shape, dtype=torch.float32, device=ids.device),
             ids, num_segments)
    c = torch.clamp_min(c.to(torch.float32), eps)
    return s / c.reshape((num_segments,) + (1,) * (s.ndim - 1))


def segments_from_lengths(lengths, total: int) -> torch.Tensor:
    """Build a monotone int32 segment-id vector from per-set lengths.

    ``lengths`` (S,) with sum == total -> ids (total,), on ``lengths``'s
    device.  The inverse of the paper's ``start`` bit:
    start[i] = ids[i] != ids[i-1].  Starts at or past ``total`` (trailing
    empty sets) are dropped, as the reference's scatter drops them.
    """
    lengths = torch.as_tensor(lengths)
    # detlint: ok[DET002] int64 domain: a prefix count of set lengths, exact in
    # any order
    starts = torch.cumsum(lengths.to(torch.int64), 0)[:-1]
    starts = starts[(starts >= 0) & (starts < total)]
    marks = torch.zeros(total, dtype=torch.int32, device=lengths.device)
    # detlint: ok[DET003] int32 domain: one int32 mark per set start, exact in
    # any order
    marks.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    # detlint: ok[DET002] int32 domain: a prefix count of the marks, exact in
    # any order
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
