"""Segment-id utilities for back-to-back variable-length sets."""

from __future__ import annotations

import torch


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
