"""Grouped-query attention (GQA) with a dense or a ring KV cache, and
multi-head latent attention (MLA, DeepSeek-V2) with a latent cache.

The PyTorch counterpart of the reference's ``repro.models.attention``.
Three modes share one set of weights:

  * ``train`` / ``prefill``: full-sequence causal attention (``_sdpa``,
    or ``_sdpa_chunked`` over query blocks for long sequences), windowed
    when ``cfg.window`` is set, or non-causal (``causal=False``, an
    encoder's); prefill also returns the KV cache;
  * ``decode``: ``s`` new tokens per row against a cache, each row
    appending at its own ``length`` (continuous-batching slots sit at
    different positions); writes past a dense cache's end are dropped.
    A step with ``s == 1`` attends through
    ``repro_torch.kernels.flash_decode`` (K2 on a CUDA device, its plain
    version on the CPU) on the just-written cache.  ``s > 1`` is a
    chunked-prefill extend: the chunk attends causally to
    ``[0, length + qi]`` through ``_sdpa``.

Queries and keys turn by RoPE, or, for an M-RoPE model (``cfg.mrope``,
Qwen2-VL), by three position streams over the head's frequency slots
(``mrope_sections``; positions (B, s, 3)).

Cross-attention (an encoder-decoder's decoder, ``cross=True``) takes its
keys and values as given (``kv_override``: the encoder memory's
projections, (B, T, K, hd)), turns nothing, masks nothing and returns no
cache.  The reference computes it in train mode on every call; here a
decode step with ``s == 1`` sends its one query a row through
``DecodeAttention`` (K2 on a CUDA device) with ``kv_len`` the memory's
length T on every row, the keys and values widened to contiguous
float32 (exact for bf16), and ``s > 1`` runs the train-mode path.  K2
folds the same function in its split order, so it agrees with the
reference to a tolerance.

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
(the reference engine's masking of idle slots).

MLA (``MLA``, ``mla_apply``) keeps one latent per token instead of keys
and values: the cache holds c_kv (B, T, r), the rmsnormed down-projection
of the input, and k_rope (B, T, rd), one rotary key shared by every head,
r + rd floats a token and layer (576 for deepseek-v2-lite-16b, against
2 * H * hd = 4,096 for GQA at its width).  Train and prefill expand the
latent into per-head keys and values (``wuk``, ``wuv``) and attend
unabsorbed; decode, at s == 1 and for a chunked-prefill extend, runs
absorbed in the latent space: ``wuk`` folded into the query, scores
against c_kv and k_rope, ``p @ c_kv``, then ``wuv`` (``LatentAttention``).
Both are float32 einsums, as the reference's are: K2 serves GQA only (its
keys would be r + rd = 576 wide, its values r wide).  Absorbed and
unabsorbed are one function rounded differently, so they agree to a
tolerance.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn as nn

from ..kernels import ops
from .config import ModelConfig
from .layers import (NEG, _param, apply_rope, causal_mask, dense, rmsnorm,
                     rope_tables)


class KVCache(NamedTuple):
    k: torch.Tensor          # (B, S, K, hd), or (B, W, K, hd) for a ring
    v: torch.Tensor
    length: torch.Tensor     # (B,) int32: tokens written so far


class MLACache(NamedTuple):
    c_kv: torch.Tensor       # (B, T, r): the normed latent
    k_rope: torch.Tensor     # (B, T, rd): the shared rotary key
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
                active: Optional[torch.Tensor] = None, rope=None,
                kv_override=None, cross: bool = False, causal: bool = True):
        return gqa_apply(self, x, self.cfg, positions=positions, mode=mode,
                         cache=cache, active=active, rope=rope,
                         kv_override=kv_override, cross=cross,
                         causal=causal)


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


def _sdpa_chunked(q, k, v, cfg: ModelConfig, sm_scale, *, qchunk: int,
                  causal: bool = True):
    """Attention one block of ``qchunk`` queries at a time, each against
    the full K/V (T rows): scores are (B, H, qc, T), never (S, T).
    Causal (windowed where ``cfg.window`` is set), or masking nothing."""
    s, t = q.shape[1], k.shape[1]
    outs = []
    for i in range(s // qchunk):
        if causal:
            mask = causal_mask(qchunk, t, offset=i * qchunk,
                               window=cfg.window, device=q.device)
        else:
            mask = torch.zeros((qchunk, t), dtype=torch.float32,
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
              active: Optional[torch.Tensor] = None, rope=None,
              kv_override=None, cross: bool = False, causal: bool = True):
    """x (B, s, d) -> (out (B, s, d), new_cache).  ``positions`` (B, s),
    or (B, s, 3) for an M-RoPE model; ``rope``: their ``rope_tables``, if
    the caller has them.  ``kv_override`` (k, v), each (B, T, K, hd),
    takes the place of x's keys and values; ``cross`` (with it: the
    decoder's cross-attention) turns neither q nor k, masks nothing and
    returns no cache (see the module docstring for its decode step);
    ``causal=False`` (an encoder's self-attention) masks nothing."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hdim
    sm_scale = hd ** -0.5

    q = _split_heads(dense(p.wq, x), h, hd)
    if kv_override is not None:
        k, v = kv_override
    else:
        k = _split_heads(dense(p.wk, x), kvh, hd)
        v = _split_heads(dense(p.wv, x), kvh, hd)
    if not cross:
        if rope is None:
            rope = rope_tables(positions, hd, cfg.rope_theta,
                               rope_sections(cfg))
        q = apply_rope(q, positions, tables=rope)
        if kv_override is None:
            k = apply_rope(k, positions, tables=rope)

    new_cache = cache
    if cross and mode == "decode" and s == 1:
        # one query a row against every row of the memory: K2
        kv_len = torch.full((b,), k.shape[1], dtype=torch.int32,
                            device=x.device)
        out = p.decode_attn(q[:, 0], k.float().contiguous(),
                            v.float().contiguous(), kv_len,
                            sm_scale)[:, None]
        new_cache = None
    elif mode in ("train", "prefill") or cross:
        qchunk = cfg.attn_qchunk
        masked = causal and not cross
        if s > qchunk and s % qchunk == 0:
            out = _sdpa_chunked(q, k, v, cfg, sm_scale, causal=masked,
                                qchunk=qchunk)
        elif masked:
            out = _sdpa(q, k, v, causal_mask(s, s, window=cfg.window,
                                             device=x.device), sm_scale)
        else:
            out = _sdpa(q, k, v, torch.zeros(
                (s, k.shape[1]), dtype=torch.float32, device=x.device),
                sm_scale)
        if cross:
            new_cache = None
        elif mode == "prefill":
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


# ---------------------------------------------------------------------------
# MLA: multi-head latent attention (DeepSeek-V2)
# ---------------------------------------------------------------------------


class LatentAttention(nn.Module):
    """Absorbed attention of ``s`` queries a row against a latent cache:
    qn (B, s, H, nd) and qr (B, s, H, rd), the cache's c_kv (B, T, r) and
    k_rope (B, T, rd), newpos (B, s) each query's position (it sees cache
    rows 0..newpos) -> (B, s, H, vd) float32.  ``wuk`` (r, H*nd) is folded
    into the query and ``wuv`` (r, H*vd) applied to ``p @ c_kv``, all in
    float32 einsums in the reference's order.  A module of its own so
    that a forward hook can read its inputs and output."""

    def forward(self, qn, qr, c_kv, k_rope, newpos, wuk, wuv,
                sm_scale: float):
        r, t = c_kv.shape[-1], c_kv.shape[1]
        h, nd = qn.shape[2], qn.shape[3]
        cf = c_kv.float()
        q_eff = torch.einsum("bshd,rhd->bshr", qn.float(),
                             wuk.reshape(r, h, nd).float())
        scores = (torch.einsum("bshr,btr->bhst", q_eff, cf)
                  + torch.einsum("bshd,btd->bhst", qr.float(),
                                 k_rope.float())) * sm_scale
        valid = torch.arange(t, device=c_kv.device)[None, None, :] \
            <= newpos[..., None]                                # (B, s, T)
        mask = torch.where(valid, 0.0, NEG).to(torch.float32)
        p = torch.softmax(scores + mask[:, None], dim=-1)
        o_lat = torch.einsum("bhst,btr->bshr", p, cf)
        return torch.einsum("bshr,rhd->bshd", o_lat,
                            wuv.reshape(r, h, -1).float())


class MLA(nn.Module):
    """The weights of one MLA block, in the reference's (d_in, d_out)
    layout (``mla_init``): wq (d, H*(nd+rd)), wdkv (d, r), wkr (d, rd),
    wuk (r, H*nd), wuv (r, H*vd), wo (H*vd, d) and the latent's rmsnorm
    gain c_norm (r,)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.n_heads
        r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
        self.wq = _param((d, h * (nd + rd)), dtype, device)
        self.wdkv = _param((d, r), dtype, device)
        self.wkr = _param((d, rd), dtype, device)
        self.wuk = _param((r, h * nd), dtype, device)
        self.wuv = _param((r, h * vd), dtype, device)
        self.wo = _param((h * vd, d), dtype, device)
        self.c_norm = _param((r,), dtype, device)
        self.latent_attn = LatentAttention()

    def forward(self, x, *, positions, mode: str = "train",
                cache: Optional[MLACache] = None,
                active: Optional[torch.Tensor] = None, rope=None):
        return mla_apply(self, x, self.cfg, positions=positions, mode=mode,
                         cache=cache, active=active, rope=rope)


def rope_dim(cfg: ModelConfig) -> int:
    """The width RoPE rotates: MLA's ``qk_rope_dim``, else the head."""
    return cfg.qk_rope_dim if cfg.attn_type == "mla" else cfg.hdim


def mrope_sections(hd: int):
    """M-RoPE's split of a head's hd/2 frequency slots into its
    (temporal, height, width) sections: Qwen2-VL's (16, 24, 24) at hd =
    128, scaled in proportion otherwise ((4, 6, 6) at 32)."""
    half = hd // 2
    s0 = max(1, round(half * 16 / 64))
    s1 = (half - s0) // 2
    return (s0, s1, half - s0 - s1)


def rope_sections(cfg: ModelConfig):
    """``rope_tables``' ``sections`` for ``cfg``: M-RoPE's split of the
    rotated width for an M-RoPE model, None (plain RoPE) otherwise."""
    return mrope_sections(rope_dim(cfg)) if cfg.mrope else None


def mla_apply(p: MLA, x, cfg: ModelConfig, *, positions, mode: str = "train",
              cache: Optional[MLACache] = None,
              active: Optional[torch.Tensor] = None, rope=None):
    """x (B, s, d) -> (out (B, s, d), new_cache).  ``rope``: the
    ``rope_tables`` of ``positions`` at ``qk_rope_dim``, if the caller has
    them.  Decode writes c_kv and k_rope at each row's own length and
    attends absorbed (``LatentAttention``); rows where ``active`` is
    False keep their cache and length."""
    b, s, _ = x.shape
    h = cfg.n_heads
    r, nd, rd, vd = (cfg.kv_lora_rank, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    sm_scale = (nd + rd) ** -0.5

    if rope is None:
        rope = rope_tables(positions, rd, cfg.rope_theta)
    q = _split_heads(dense(p.wq, x), h, nd + rd)              # (B,s,H,nd+rd)
    qn = q[..., :nd]
    qr = apply_rope(q[..., nd:], positions, tables=rope)
    c = rmsnorm(p.c_norm, dense(p.wdkv, x), cfg.norm_eps,
                policy=cfg.norm_reduce_policy)                # (B,s,r)
    kr = apply_rope(dense(p.wkr, x)[:, :, None, :], positions,
                    tables=rope)[:, :, 0]                     # (B,s,rd)

    new_cache = cache
    if mode in ("train", "prefill"):
        kn = _split_heads(dense(p.wuk, c), h, nd).float()     # (B,s,H,nd)
        v = _split_heads(dense(p.wuv, c), h, vd).float()      # (B,s,H,vd)
        krf = kr.float()

        def block(qn_blk, qr_blk, offset):
            sc = (torch.einsum("bshd,bthd->bhst", qn_blk, kn)
                  + torch.einsum("bshd,btd->bhst", qr_blk, krf)) * sm_scale
            sc = sc + causal_mask(qn_blk.shape[1], s, offset=offset,
                                  device=x.device)[None, None]
            return torch.einsum("bhst,bthd->bshd",
                                torch.softmax(sc, dim=-1), v)

        qnf, qrf = qn.float(), qr.float()
        qchunk = cfg.attn_qchunk
        if s > qchunk and s % qchunk == 0:
            out = torch.cat([block(qnf[:, i:i + qchunk], qrf[:, i:i + qchunk],
                                   i) for i in range(0, s, qchunk)], dim=1)
        else:
            out = block(qnf, qrf, 0)
        if mode == "prefill":
            new_cache = MLACache(c_kv=c, k_rope=kr, length=torch.full(
                (b,), s, dtype=torch.int32, device=x.device))
    elif mode == "decode":
        if cache is None:
            raise ValueError("mla_apply: mode='decode' needs a cache")
        length = cache.length
        newpos = length[:, None] + torch.arange(s, dtype=length.dtype,
                                                device=x.device)[None, :]
        _write_rows(cache.c_kv, newpos, c, active)
        _write_rows(cache.k_rope, newpos, kr, active)
        out = p.latent_attn(qn, qr, cache.c_kv, cache.k_rope, newpos,
                            p.wuk, p.wuv, sm_scale)
        step = s if active is None else s * active.to(length.dtype)
        new_cache = MLACache(cache.c_kv, cache.k_rope, length + step)
    else:
        raise ValueError(mode)

    out = out.to(x.dtype).reshape(b, s, h * vd)
    return dense(p.wo, out), new_cache
