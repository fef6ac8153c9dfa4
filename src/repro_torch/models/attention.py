"""Grouped-query attention (GQA) with a dense or a ring KV cache.

The PyTorch counterpart of the GQA part of the reference's
``repro.models.attention``.  Three modes share one set of weights:

  * ``train`` / ``prefill``: full-sequence causal attention (``_sdpa``,
    or ``_sdpa_chunked`` over query blocks for long sequences), windowed
    when ``cfg.window`` is set; prefill also returns the KV cache;
  * ``decode``: ``s`` new tokens per row against a cache, each row
    appending at its own ``length`` (continuous-batching slots sit at
    different positions); writes past a dense cache's end are dropped.
    A step with ``s == 1`` attends through
    ``repro_torch.kernels.flash_decode`` (K2 on a CUDA device, its plain
    version on the CPU) on the just-written cache.  ``s > 1`` is a
    chunked-prefill extend: the chunk attends causally to
    ``[0, length + qi]`` through ``_sdpa``.

Caches (``cfg.window`` decides which, never the cache itself):

  * dense: k, v (B, T, K, hd), position p in row p; K2 reads
    ``kv_len = length + 1`` rows;
  * ring (sliding window W = ``cfg.window``): k, v (B, W, K, hd), slot j
    holding the latest position p with p % W == j.  Prefill packs the
    last W positions into that order (``ring_positions``) and decode
    writes position p at slot p % W.  K2 reads ``kv_len = min(length + 1,
    W)`` rows with no window: exactly the slots that hold one of the
    last W positions.  It folds them in **slot order**, which is not
    position order once the ring has wrapped, so a wrapped ring agrees
    with the reference's position-ordered softmax to a tolerance, not
    bit for bit.

The decode cache is written in place and returned with its new length.
K2 takes contiguous float32, so ``model.init_caches`` makes the cache
float32 whatever the model's dtype: widening bf16 keys and values is exact,
so the cache holds the values the reference's bf16 cache holds, at twice
the bytes.  Rows where ``active`` is False keep their cache and length
(the reference engine's masking of idle slots).  The port has no MLA and
no cross-attention: the model raises ``NotImplementedError`` for
configurations that need them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..kernels import ops
from .config import ModelConfig
from .layers import (NEG, _param, apply_rope, causal_mask, dense,
                     rope_tables)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S, K, hd), or (B, W, K, hd) for a ring
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32: tokens written so far


class DecodeAttention(nn.Module):
    """One-token decode attention over the first ``kv_len`` rows of a
    cache (a dense cache's positions, or a ring's live slots in slot
    order): q (B, H, hd), k/v (B, T, K, hd), kv_len (B,) -> (B, H, hd)
    float32, through ``repro_torch.kernels.flash_decode`` on q's device
    (K2 on a CUDA device).  A module of its own so that a forward hook can
    read its inputs and output."""

    def forward(self, q, k, v, kv_len, sm_scale: float):
        return ops.flash_decode(q, k, v, kv_len, sm_scale=sm_scale,
                                device=q.device)


class GQA(nn.Module):
    """The weights of one GQA block, in the reference's (d_in, d_out)
    layout: wq (d, H*hd), wk and wv (d, K*hd), wo (H*hd, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hdim
        self.wq = _param((d, h * hd), dtype, device)
        self.wk = _param((d, kv * hd), dtype, device)
        self.wv = _param((d, kv * hd), dtype, device)
        self.wo = _param((h * hd, d), dtype, device)
        self.decode_attn = DecodeAttention()

    def forward(self, x, *, positions, mode: str = "train",
                cache: Optional[KVCache] = None,
                active: Optional[torch.Tensor] = None, rope=None):
        return gqa_apply(self, x, self.cfg, positions=positions, mode=mode,
                         cache=cache, active=active, rope=rope)


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _sdpa(q, k, v, mask, sm_scale):
    """q (B,S,H,hd), k/v (B,T,K,hd) grouped; mask (B,S,T) or (S,T)
    additive.  Scores, softmax and ``p @ v`` in float32 -> (B,S,H,hd)."""
    b, s, h, hd = q.shape
    kheads = k.shape[2]
    g = h // kheads
    qg = q.reshape(b, s, kheads, g, hd).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) * sm_scale
    if mask.ndim == 2:
        mask = mask[None, None, None]
    else:
        mask = mask[:, None, None]                   # (B,1,1,S,T)
    p = torch.softmax(scores + mask, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, s, h, hd)


def _sdpa_chunked(q, k, v, cfg: ModelConfig, sm_scale, *, qchunk: int):
    """Causal attention one block of ``qchunk`` queries at a time, each
    against the full K/V: scores are (B, H, qc, S), never (S, S)."""
    s = q.shape[1]
    outs = []
    for i in range(s // qchunk):
        mask = causal_mask(qchunk, s, offset=i * qchunk, window=cfg.window,
                           device=q.device)
        outs.append(_sdpa(q[:, i * qchunk:(i + 1) * qchunk], k, v, mask,
                          sm_scale))
    return torch.cat(outs, dim=1)


def ring_positions(s: int, w: int, device=None) -> torch.Tensor:
    """(W,) the position slot j of a ring holds after ``s`` tokens: the
    latest p <= s - 1 with p % W == j.  Slots with p < 0 (s < W) are
    clipped to position 0; decode never reads them."""
    j = torch.arange(w, device=device)
    return ((s - 1) - ((s - 1 - j) % w)).clamp(0, s - 1)


def _write_rows(buf, pos, vals, active):
    """buf (B, T, ...)[b, pos[b, i]] = vals[b, i] where pos < T and row b
    is active; the rest of buf is left as it was.  ``pos`` is a dense
    cache's positions or a ring's slots (position % T, all below T).

    One scatter with no host round trip: a dropped write is sent to row
    b's spare slot, ``min(pos[b, 0] - 1, T - 1)`` (or 0), holding the
    value already there.  No kept write lands on it: a row drops a write
    either because it is inactive (then it keeps none) or because the
    position is past T (a dense cache only), and then its length is at
    least 1, below every kept position.  Positions from T on are dropped
    whatever the length, so they are cut first.
    """
    b, t = buf.shape[0], buf.shape[1]
    s = min(pos.shape[1], t)
    pos, vals = pos[:, :s].long(), vals[:, :s].to(buf.dtype)
    keep = pos < t
    if active is not None:
        keep = keep & active[:, None]
    spare = (pos[:, :1] - 1).clamp(0, t - 1)
    idx = torch.where(keep, pos, spare)
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, s)
    keep = keep.reshape((b, s) + (1,) * (vals.ndim - 2))
    buf[rows, idx] = torch.where(keep, vals, buf[rows, idx])


def gqa_apply(p: GQA, x, cfg: ModelConfig, *, positions, mode: str = "train",
              cache: Optional[KVCache] = None,
              active: Optional[torch.Tensor] = None, rope=None):
    """x (B, s, d) -> (out (B, s, d), new_cache).  ``rope``: the
    ``rope_tables`` of ``positions``, if the caller has them."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    sm_scale = hd ** -0.5

    if rope is None:
        rope = rope_tables(positions, hd, cfg.rope_theta)
    q = apply_rope(_split_heads(dense(p.wq, x), h, hd), positions,
                   tables=rope)
    k = apply_rope(_split_heads(dense(p.wk, x), kvh, hd), positions,
                   tables=rope)
    v = _split_heads(dense(p.wv, x), kvh, hd)

    new_cache = cache
    if mode in ("train", "prefill"):
        qchunk = cfg.attn_qchunk
        if s > qchunk and s % qchunk == 0:
            out = _sdpa_chunked(q, k, v, cfg, sm_scale, qchunk=qchunk)
        else:
            out = _sdpa(q, k, v, causal_mask(s, s, window=cfg.window,
                                             device=x.device), sm_scale)
        if mode == "prefill":
            if cfg.window is not None:       # pack the last W into the ring
                ring = ring_positions(s, cfg.window, x.device)
                k, v = k[:, ring], v[:, ring]
            new_cache = KVCache(k=k, v=v, length=torch.full(
                (b,), s, dtype=torch.int32, device=x.device))
    elif mode == "decode":
        if cache is None:
            raise ValueError("gqa_apply: mode='decode' needs a cache")
        length = cache.length
        newpos = length[:, None] + torch.arange(s, dtype=length.dtype,
                                                device=x.device)[None, :]
        t = cache.k.shape[1]
        if cfg.window is None:
            slots, kept = newpos, slice(None)
            kv_len = length + 1
        else:
            # a ring: position p goes to slot p % T; of a chunk longer
            # than the ring, the last T writes are the ones that stay
            slots, kept = newpos[:, -t:] % t, slice(-t, None)
            kv_len = torch.clamp(length + 1, max=t)
        _write_rows(cache.k, slots, k[:, kept], active)
        _write_rows(cache.v, slots, v[:, kept], active)
        if s == 1:
            out = p.decode_attn(q[:, 0], cache.k, cache.v, kv_len,
                                sm_scale)[:, None]
        else:
            j = torch.arange(t, device=x.device)[None, :]
            if cfg.window is None:
                pos_k = j[:, None, :]                        # (1, 1, T)
                valid = pos_k <= newpos[..., None]           # (B, s, T)
            else:
                # the position each slot holds after the chunk's writes;
                # query qi sees those in (newpos - W, newpos]
                last = length[:, None] + (s - 1)
                pos_k = (last - ((last - j) % t))[:, None, :]
                valid = (pos_k <= newpos[..., None]) \
                    & (pos_k > newpos[..., None] - t) & (pos_k >= 0)
            mask = torch.where(valid, 0.0, NEG).to(torch.float32)
            out = _sdpa(q, cache.k, cache.v, mask, sm_scale)
        step = s if active is None else s * active.to(length.dtype)
        new_cache = KVCache(cache.k, cache.v, length + step)
    else:
        raise ValueError(mode)

    out = out.to(x.dtype).reshape(b, s, h * hd)
    return dense(p.wo, out), new_cache
