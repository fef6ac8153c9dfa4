"""Plain math oracles for the kernels of this package."""

from __future__ import annotations

import torch


def segsum_ref(values: torch.Tensor, segment_ids: torch.Tensor,
               num_segments: int, seg_offset: int = 0) -> torch.Tensor:
    """Oracle for K1's fast tier: scatter-add into [seg_offset, +S).

    A math oracle, not a schedule one: ``index_add_`` adds in no defined
    order, so hold a kernel to it within a tolerance."""
    ids = segment_ids.to(torch.int64) - seg_offset
    ok = (ids >= 0) & (ids < num_segments)
    ids = torch.where(ok, ids, torch.full_like(ids, num_segments))
    vals = values.to(torch.float32)
    vals = torch.where(ok.reshape(ok.shape + (1,) * (vals.ndim - 1)), vals,
                       torch.zeros((), dtype=torch.float32,
                                   device=vals.device))
    out = torch.zeros((num_segments + 1,) + tuple(values.shape[1:]),
                      dtype=torch.float32, device=values.device)
    return out.index_add_(0, ids, vals)[:num_segments]
