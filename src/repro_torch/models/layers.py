"""Basic layers: dense projections, norms, MLPs, rotary embeddings
(RoPE and Qwen2-VL's M-RoPE).

The PyTorch counterparts of the reference's ``repro.models.layers``, as
functions of plain tensors.  Every projection accumulates in float32 and
rounds once to the activation dtype (``dense``), as the reference's
``preferred_element_type=float32`` einsum does.  The reference's
``shard_hint`` is dropped: the port runs on one device.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

NEG = -1e30


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (m, k) @ b (k, n) summed in float32, as float32: two operands of
    one narrow dtype go to cuBLAS as they are (``out_dtype``); otherwise
    the narrow one is widened first (exact)."""
    if a.dtype == b.dtype and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class _NarrowMatmul(torch.autograd.Function):
    """x (T, d) @ w (d, f) of one narrow dtype on a CUDA device, summed in
    float32 and returned as ``out_dtype`` (float32, or x's dtype for
    ``dense``).  PyTorch has no derivative for ``mm(out_dtype=)``, so the
    backward is written here with the same float32-summing product: each
    gradient is one product of the incoming gradient (float32, or narrow
    when the output was rounded to it: then it holds narrow values
    exactly) with the other operand, rounded once to the operand's
    dtype — the reference's ``dot_general`` transpose with
    ``preferred_element_type=float32``."""

    @staticmethod
    def forward(ctx, x, w, out_dtype):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = _mm_f32(g, w.t()).to(x.dtype) if ctx.needs_input_grad[0] \
            else None
        gw = _mm_f32(x.t(), g).to(w.dtype) if ctx.needs_input_grad[1] \
            else None
        return gx, gw, None


def _matmul(x: torch.Tensor, w: torch.Tensor, out_dtype) -> torch.Tensor:
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda and x.dtype == w.dtype:
        x2 = x.reshape(-1, x.shape[-1])
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            y = _NarrowMatmul.apply(x2, w, out_dtype)
        else:        # serving: no graph, the same product
            y = torch.mm(x2, w, out_dtype=torch.float32).to(out_dtype)
        return y.reshape(x.shape[:-1] + (w.shape[1],))
    return torch.matmul(x.float(), w.float()).to(out_dtype)


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, f) summed in float32, as float32.

    A bf16 product is exact in float32, so on a CUDA device cuBLAS takes
    the narrow operands and sums in float32 (``out_dtype``, with the
    backward of ``_NarrowMatmul``); PyTorch's CPU backend has no such
    matmul, so there both are widened first.
    """
    return _matmul(x, w, torch.float32)


class _NarrowBmm(torch.autograd.Function):
    """a (E, m, k) @ b (E, k, n) of one narrow dtype on a CUDA device,
    summed in float32 and returned as float32: ``_NarrowMatmul`` batched.
    PyTorch has no derivative for ``bmm(out_dtype=)`` either, so each
    gradient is one float32-summing batched product of the incoming
    gradient with the other operand, rounded once to the operand's
    dtype (the reference's ``dot_general`` transpose with
    ``preferred_element_type=float32``)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = bmm_f32(g, b.transpose(1, 2)).to(a.dtype) \
            if ctx.needs_input_grad[0] else None
        gb = bmm_f32(a.transpose(1, 2), g).to(b.dtype) \
            if ctx.needs_input_grad[1] else None
        return ga, gb


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, m, k) @ b (E, k, n) summed in float32, as float32: the
    batched form of ``matmul_f32`` (cuBLAS takes two narrow operands of
    one dtype as they are, with the backward of ``_NarrowBmm``; elsewhere
    they are widened first, exactly)."""
    if a.is_cuda and a.dtype == b.dtype and a.dtype != torch.float32:
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return _NarrowBmm.apply(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def dense(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x (..., d) @ w (d, f) with float32 accumulation, rounded once to
    x's dtype."""
    return _matmul(x, w, x.dtype)


def rmsnorm(g: torch.Tensor, x: torch.Tensor, eps: float = 1e-5, *,
            policy: Optional[str] = None,
            backend: Optional[str] = None) -> torch.Tensor:
    """``policy=None``: the plain float32 mean square over the last axis.
    A policy name routes the per-token mean square through
    ``repro_torch.reduce`` instead (one (D, T) ``op="sumsq"`` pass, the
    tokens as the element width), on x's device: K1 on a CUDA device;
    ``backend`` picks another executor."""
    xf = x.float()
    if policy is None:
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
    else:
        from .. import reduce as _reduce
        d = xf.shape[-1]
        cols = xf.reshape(-1, d).T.contiguous()              # (D, T)
        ssq = _reduce.reduce(cols, op="sumsq", policy=policy,
                             backend=backend, device=x.device)
        var = (ssq / d).reshape(xf.shape[:-1] + (1,))
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * g


def swiglu(p, x: torch.Tensor) -> torch.Tensor:
    """``p`` has ``wi``, ``wg`` (d, d_ff) and ``wo`` (d_ff, d)."""
    h = F.silu(dense(p.wg, x).float()).to(x.dtype)
    return dense(p.wo, h * dense(p.wi, x))


class SwiGLU(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.wi = _param((d, d_ff), dtype, device)
        self.wg = _param((d, d_ff), dtype, device)
        self.wo = _param((d_ff, d), dtype, device)

    def forward(self, x):
        return swiglu(self, x)


def gelu_mlp(p, x: torch.Tensor) -> torch.Tensor:
    """``p`` has ``wi`` (d, d_ff) and ``wo`` (d_ff, d); the tanh form of
    GELU, as ``jax.nn.gelu``'s default."""
    h = F.gelu(dense(p.wi, x).float(), approximate="tanh").to(x.dtype)
    return dense(p.wo, h)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def rope_freqs(hdim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hdim, 2, dtype=torch.float32,
                                         device=device) / hdim))


def mrope_streams(sections, device=None) -> torch.Tensor:
    """(hd/2,) the position stream (0, 1 or 2: temporal, height, width)
    each frequency slot of M-RoPE takes, ``sections[i]`` slots of stream
    i in order."""
    return torch.repeat_interleave(
        torch.arange(3, device=device),
        torch.tensor(list(sections), device=device),
        output_size=sum(sections))


def rope_tables(positions: torch.Tensor, hdim: int, theta: float,
                sections=None):
    """(cos, sin), each (..., S, 1, hd/2) float32, of positions (..., S):
    what ``apply_rope`` rotates by.  With ``sections`` (Qwen2-VL's
    M-RoPE) positions are (..., S, 3) and frequency slot i turns by its
    stream's position (``mrope_streams``), gathered before the same
    ``pos.float() * freqs`` product: where the three streams are equal
    the tables are bitwise RoPE's.  Every layer rotates by the same
    tables, so a forward computes them once."""
    freqs = rope_freqs(hdim, theta, positions.device)        # (hd/2,)
    if sections is None:
        pos = positions[..., None]                           # (..., S, 1)
    else:
        if sum(sections) != hdim // 2:
            raise ValueError(f"M-RoPE sections {tuple(sections)} must sum "
                             f"to hd/2 = {hdim // 2}")
        pos = positions[..., mrope_streams(sections, positions.device)]
    ang = pos.to(torch.float32) * freqs                      # (..., S, hd/2)
    ang = ang[..., None, :]                                  # (..., S, 1, hd/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4, *, tables=None) -> torch.Tensor:
    """x (..., S, H, hd); positions (..., S) integer.  ``tables``: the
    ``rope_tables`` of these positions, if already computed."""
    cos, sin = tables if tables is not None else \
        rope_tables(positions, x.shape[-1], theta)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections=(16, 24, 24)) -> torch.Tensor:
    """Qwen2-VL's multimodal RoPE: x (B, S, H, hd), positions3 (B, S, 3)
    the (temporal, height, width) ids; the hd/2 frequency slots split
    into ``sections``, each rotated by its own stream."""
    return apply_rope(x, positions3, tables=rope_tables(
        positions3, x.shape[-1], theta, sections))


def causal_mask(s_q: int, s_k: int, *, offset: int = 0,
                window: Optional[int] = None, device=None) -> torch.Tensor:
    """(s_q, s_k) additive float32 mask; ``offset`` is the first query's
    position: 0 where the key is visible, -1e30 elsewhere."""
    qi = torch.arange(s_q, device=device)[:, None] + offset
    kj = torch.arange(s_k, device=device)[None, :]
    ok = kj <= qi
    if window is not None:
        ok &= kj > (qi - window)
    return torch.where(ok, 0.0, NEG).to(torch.float32)
