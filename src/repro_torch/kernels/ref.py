"""Plain math oracles for the kernels of this package."""

from __future__ import annotations

import torch

from ..core.intac import LIMB_SHIFT


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
    # detlint: ok[DET003] math oracle held to a tolerance, called by tests only
    # (reference kernels/ref.py:13 is the same scatter)
    return out.index_add_(0, ids, vals)[:num_segments]


def intac_accum_ref(values: torch.Tensor, scale) -> torch.Tensor:
    """Oracle for K5: the same quantization, exact int64 column sums
    wrapped to int32 -> (2, D) int32 limbs."""
    x = values.to(torch.float32)
    q = torch.round(x * torch.as_tensor(scale, dtype=torch.float32,
                                         device=x.device))
    hi = torch.floor(q * (1.0 / (1 << LIMB_SHIFT)))
    lo = q - torch.floor(q * (1.0 / (1 << LIMB_SHIFT))) * (1 << LIMB_SHIFT)
    # detlint: ok[DET002] int32 domain: the oracle's limbs add in int64 and
    # wrap to int32, exact in any order
    return torch.stack([hi.to(torch.int64).sum(0), lo.to(torch.int64).sum(0)]
                       ).to(torch.int32)


def limbs_to_float(limbs: torch.Tensor, scale) -> torch.Tensor:
    return (limbs[0].to(torch.float32) * (1 << LIMB_SHIFT)
            + limbs[1].to(torch.float32)) / scale


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: torch.Tensor, *, sm_scale: float) -> torch.Tensor:
    """Oracle for one (batch, kv-head) pair of K2: q (G, d), k/v (S, d),
    bias (1, S) -> the materialized softmax attention rows (G, d) f32."""
    # detlint: ok[DET002] math oracle held to a tolerance: the materialized
    # softmax rows, called by tests only
    s = (q.to(torch.float32) @ k.to(torch.float32).T) * sm_scale
    s = s + bias.to(torch.float32)
    # detlint: ok[DET002] math oracle held to a tolerance, as above
    return torch.softmax(s, dim=-1) @ v.to(torch.float32)
