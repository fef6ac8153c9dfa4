"""The language model: init, full-sequence forward, prefill and decode for
the GQA- and MLA-attention architectures, the Mamba hybrids and the
xLSTM stacks, dense or with experts.

The PyTorch counterpart of the reference's ``repro.models.model``, written
as ``nn.Module``s: ``LM`` holds the embedding, one ``Block`` per layer
(attention, then a SwiGLU, GELU or mixture-of-experts MLP, each behind an
rmsnorm) and the head.  The reference stacks each period position's parameters on a leading
``n_periods`` axis and scans over it; here the layers are a plain loop
(``_run_stack``), layer ``i * len(period) + j`` being period ``i``'s
position ``j``.  A block's core is attention or, at a ``mamba``,
``mlstm`` or ``slstm`` period position, that recurrent block (``ssm``).
The caches keep the reference's layout: one ``KVCache`` (an
``MLACache`` for an MLA model; a ``MambaState``, ``MLSTMState`` or
``SLSTMState`` at a recurrent position) per period position with a leading
``n_periods`` axis, so each layer's slice is contiguous; a sliding-window
model's caches are rings of ``cfg.window`` slots (``attention``).  Code
that handles caches reads their fields from the cache's own type.
``moe_impl`` picks the MoE layers' dispatch (``moe.moe_apply``:
``capacity``, the default, or ``dense``, the serving engine's), and
``aux`` is their load-balancing loss, summed over the layers.

``loss_fn`` is the training objective (next-token cross-entropy in
float32, sequence-chunked as the reference does); its gradients come from
torch autograd, ``remat`` recomputing each block in the backward.

An encoder-decoder (``cfg.is_encdec``) also holds ``encoder``: its
``cfg.encoder_layers`` non-causal attention + GELU blocks and a final
rmsnorm (``encode``), and each decoder block a cross-attention (``cross``
behind the rmsnorm ``norm_x``) that runs after the block's attention
wherever the caller gives the encoder memory ``enc_out`` and is skipped
where it does not, as the reference's.  Its keys and values are the
memory's projections, recomputed on every call as the reference does.

The port runs GQA attention (MHA included) with a dense or a ring KV
cache, under RoPE or M-RoPE (Qwen2-VL's three position streams), or MLA
with a latent cache, Mamba blocks beside either, mLSTM and sLSTM blocks,
an encoder with cross-attention, and a SwiGLU, GELU, MoE or no MLP, on
tokens or on embeddings given in their place: every configuration of the
repository (``unsupported`` is empty for each).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from . import attention as attn
from . import moe as moe_mod
from . import ssm
from .config import BlockSpec, MambaCfg, ModelConfig, XLSTMCfg
from .layers import (SwiGLU, _param, dense, embed_lookup, gelu_mlp,
                     matmul_f32, rmsnorm, rope_tables)


def unsupported(cfg: ModelConfig) -> List[str]:
    """What ``cfg`` needs that the port's model lacks (empty: it runs).
    Every configuration of the repository runs."""
    return []


def check_supported(cfg: ModelConfig) -> None:
    missing = unsupported(cfg)
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: the PyTorch port has no {', '.join(missing)} yet; "
            "it runs GQA attention models on dense or ring caches (M-RoPE, "
            "embedding inputs and encoder-decoders included), MLA models on "
            "latent caches, Mamba hybrids and xLSTM stacks, dense or with "
            "experts")


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

#: a recurrent period position's core module, by ``BlockSpec.kind``
_RECURRENT = {"mamba": ssm.Mamba, "mlstm": ssm.MLSTM, "slstm": ssm.SLSTM}
#: an encoder's one period position (the reference's ``encode``)
ENCODER_SPEC = BlockSpec("attn", "gelu")


class GeluMLP(nn.Module):
    def __init__(self, d: int, d_ff: int, dtype, device):
        super().__init__()
        self.wi = _param((d, d_ff), dtype, device)
        self.wo = _param((d_ff, d), dtype, device)

    def forward(self, x):
        return gelu_mlp(self, x)


class Block(nn.Module):
    """rmsnorm -> attention (or a Mamba, mLSTM or sLSTM block) -> residual,
    then, with ``cross`` (an encoder-decoder's decoder) and an encoder
    memory given, rmsnorm ``norm_x`` -> cross-attention -> residual, then
    rmsnorm -> MLP -> residual (no MLP where ``spec.mlp`` is "none")."""

    def __init__(self, spec: BlockSpec, cfg: ModelConfig, dtype, device, *,
                 cross: bool = False):
        super().__init__()
        self.cfg, self.spec = cfg, spec
        self.norm1 = _param((cfg.d_model,), dtype, device)
        if spec.kind in _RECURRENT:
            core = _RECURRENT[spec.kind]
        elif cfg.attn_type == "mla":
            core = attn.MLA
        else:
            core = attn.GQA
        self.core = core(cfg, dtype, device)
        if cross:
            self.norm_x = _param((cfg.d_model,), dtype, device)
            self.cross = attn.GQA(cfg, dtype, device)
        if spec.mlp == "moe":
            self.norm2 = _param((cfg.d_model,), dtype, device)
            self.mlp = moe_mod.MoE(cfg, dtype, device)
        elif spec.mlp != "none":
            self.norm2 = _param((cfg.d_model,), dtype, device)
            mlp = SwiGLU if spec.mlp == "swiglu" else GeluMLP
            self.mlp = mlp(cfg.d_model, cfg.d_ff, dtype, device)

    def forward(self, x, *, positions, mode, cache=None, active=None,
                rope=None, moe_impl: str = "capacity", enc_out=None,
                is_causal: bool = True):
        return _apply_block(self, x, self.cfg, positions=positions,
                            mode=mode, cache=cache, active=active, rope=rope,
                            moe_impl=moe_impl, enc_out=enc_out,
                            is_causal=is_causal)


class Encoder(nn.Module):
    """An encoder-decoder's encoder, named as the reference's ``encoder``
    subtree: ``cfg.encoder_layers`` blocks of ``ENCODER_SPEC`` (attention
    + GELU MLP, no cross-attention) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.blocks = nn.ModuleList(Block(ENCODER_SPEC, cfg, dtype, device)
                                    for _ in range(cfg.encoder_layers))
        self.final_norm = _param((cfg.d_model,), dtype, device)


class LM(nn.Module):
    """embed -> blocks -> final rmsnorm -> head, and for an
    encoder-decoder the ``encoder``.  ``forward`` returns (logits (B, S,
    padded_vocab) float32, new caches, aux)."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        dtype = getattr(torch, cfg.dtype)
        self.embed = _param((cfg.padded_vocab, cfg.d_model), dtype, device)
        self.blocks = nn.ModuleList(
            Block(cfg.period[layer % len(cfg.period)], cfg, dtype, device,
                  cross=cfg.is_encdec)
            for layer in range(cfg.n_layers))
        self.final_norm = _param((cfg.d_model,), dtype, device)
        if not cfg.tie_embeddings:
            self.lm_head = _param((cfg.d_model, cfg.padded_vocab), dtype,
                                  device)
        if cfg.is_encdec:
            self.encoder = Encoder(cfg, dtype, device)

    def hidden(self, tokens=None, *, embeds=None, positions, mode,
               caches=None, active=None, remat: bool = False,
               moe_impl: str = "capacity", enc_out=None):
        """``embeds`` (B, S, D), given, take the place of the embedded
        ``tokens`` as they are (a multimodal frontend's output);
        ``enc_out`` (B, T, D) is the encoder memory the decoder's
        cross-attention reads (none: no cross-attention)."""
        x = embed_lookup(self.embed, tokens) if embeds is None else embeds
        x, new_caches, aux = _run_stack(
            self.cfg, self.blocks, x, positions=positions, mode=mode,
            caches=caches, active=active, remat=remat, moe_impl=moe_impl,
            enc_out=enc_out)
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps,
                    policy=self.cfg.norm_reduce_policy)
        return x, new_caches, aux

    def forward(self, tokens=None, *, embeds=None, positions,
                mode: str = "train", caches=None, active=None,
                moe_impl: str = "capacity", enc_out=None):
        x, new_caches, aux = self.hidden(tokens, embeds=embeds,
                                         positions=positions, mode=mode,
                                         caches=caches, active=active,
                                         moe_impl=moe_impl, enc_out=enc_out)
        logits = matmul_f32(x, _lm_head(self))
        return logits, new_caches, aux


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, *, generator: Optional[torch.Generator]
                = None, device=None) -> LM:
    """A model of ``cfg`` with random weights drawn from ``generator``, as
    the reference draws them: the embedding N(0, 0.02^2), each projection
    N(0, 1/d_in) (an MoE router too, kept float32; the cross-attention's
    and the encoder's too), the experts' ``wi``
    and ``wg`` N(0, 1/d) and ``wo`` N(0, 1/(f * v)), a Mamba or mLSTM conv's
    ``conv_w`` N(0, 1/kernel^2) (``_init_scale``), norms ones (MLA's
    latent ``c_norm``, the mLSTM's ``out_norm``, ``norm_x`` and the
    encoder's too); drawn in
    float32, then cast to the parameter's dtype.  The recurrent blocks'
    other leaves are set, not drawn (``_FILLED``, as ``mamba_init``,
    ``mlstm_init`` and ``slstm_init``): ``a_log`` log(1..d_state) on
    every channel, ``d_skip`` ones, ``dt_bias`` and ``conv_b`` zeros; the
    mLSTM's ``b_i`` zeros and ``b_f`` 3.0 (open forget gates), the
    sLSTM's ``bias`` zeros.
    ``device=None`` means CUDA (``resolve_device``);
    ``device="meta"`` gives the shapes alone and allocates nothing (no
    generator needed).  The draws are made on the generator's device, so
    one generator state gives the same weights whatever ``device`` is."""
    dev = resolve_device(device)
    model = LM(cfg, device=dev)
    if dev.type == "meta":
        return model
    if generator is None:
        raise ValueError("init_params needs a torch.Generator (or "
                         "device='meta' for shapes alone)")
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.startswith("norm") or leaf.endswith("_norm"):
                p.fill_(1.0)
                continue
            if leaf in _FILLED:
                p.copy_(_FILLED[leaf](p))
                continue
            scale = _init_scale(cfg, name, p)
            w = torch.randn(p.shape, generator=generator,
                            device=generator.device, dtype=torch.float32)
            p.copy_((w * scale).to(p.dtype))
    return model


#: the recurrent blocks' leaves that ``mamba_init``, ``mlstm_init`` and
#: ``slstm_init`` set rather than draw
_FILLED = {
    "a_log": lambda p: torch.log(torch.arange(
        1, p.shape[1] + 1, dtype=torch.float32, device=p.device)).expand(
            p.shape),
    "d_skip": torch.ones_like,
    "dt_bias": torch.zeros_like,
    "conv_b": torch.zeros_like,
    "b_i": torch.zeros_like,
    "b_f": lambda p: torch.full_like(p, 3.0),
    "bias": torch.zeros_like,
}


def _init_scale(cfg: ModelConfig, name: str, p) -> float:
    """The standard deviation the reference draws parameter ``name`` at
    (``moe.py:moe_init`` for the 3-D expert leaves: (E*v, d, f) and
    (E*v, f, d); ``ssm.py:mamba_init`` and ``mlstm_init`` for ``conv_w``
    (kernel, di))."""
    if name == "embed":
        return 0.02
    if name.endswith(".conv_w"):
        return 1.0 / p.shape[0]
    if p.ndim == 3:
        if name.endswith(".wo"):
            return (p.shape[1] * cfg.moe_virtual_split) ** -0.5
        return p.shape[1] ** -0.5
    return p.shape[0] ** -0.5


def param_bytes(model: nn.Module) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


# ---------------------------------------------------------------------------
# blocks and the stack
# ---------------------------------------------------------------------------


def _apply_block(bp: Block, x, cfg: ModelConfig, *, positions, mode, cache,
                 active=None, rope=None, moe_impl: str = "capacity",
                 enc_out=None, is_causal: bool = True):
    """-> (x, new cache, aux): ``aux`` is the MoE layer's load-balancing
    loss, 0 for another MLP.  ``is_causal=False`` (the encoder's GQA
    blocks) masks nothing; the cross step runs where the block has
    ``cross`` and ``enc_out`` is given."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rmsnorm(bp.norm1, x, cfg.norm_eps, policy=cfg.norm_reduce_policy)
    extra = {} if is_causal else {"causal": False}
    out, new_cache = bp.core(h, positions=positions, mode=mode, cache=cache,
                             active=active, rope=rope, **extra)
    x = x + out
    if enc_out is not None and hasattr(bp, "cross"):
        hx = rmsnorm(bp.norm_x, x, cfg.norm_eps,
                     policy=cfg.norm_reduce_policy)
        kv = tuple(attn._split_heads(dense(w, enc_out), cfg.n_kv_heads,
                                     cfg.hdim)
                   for w in (bp.cross.wk, bp.cross.wv))
        out, _ = bp.cross(hx, positions=positions, mode=mode,
                          kv_override=kv, cross=True)
        x = x + out
    if bp.spec.mlp != "none":
        h2 = rmsnorm(bp.norm2, x, cfg.norm_eps,
                     policy=cfg.norm_reduce_policy)
        if bp.spec.mlp == "moe":
            out, a = bp.mlp(h2, impl=moe_impl)
            aux = aux + a
        else:
            out = bp.mlp(h2)
        x = x + out
    return x, new_cache, aux


def _run_stack(cfg: ModelConfig, blocks, x, *, positions, mode, caches,
               active=None, remat: bool = False, moe_impl: str = "capacity",
               enc_out=None, is_causal: bool = True, pattern=None):
    """Every layer of ``blocks`` in order, block ``i * len(pattern) + j``
    at period position ``j`` (``pattern`` defaults to ``cfg.period``; the
    encoder's is ``(ENCODER_SPEC,)``), the rope tables from
    ``positions``.  ``enc_out`` goes to every block (the decoder's cross
    step), ``is_causal=False`` makes the attention non-causal.
    ``caches``: one ``{"core": cache}`` per
    period position (a ``KVCache``, an ``MLACache``, or a recurrent
    block's state), leaves with a leading ``n_periods`` axis, or None.
    Decode writes each layer's rows in place through its view of them; a
    cache with a ``length`` comes back with the new lengths, one without
    (a recurrent state) as it is.
    ``remat`` (train mode, with autograd recording): each block runs under
    a non-reentrant ``torch.utils.checkpoint``, keeping only its input
    and recomputing the rest in the backward.
    Returns (x, new caches in the same layout, aux): aux sums each
    period's layers in order from 0, then the periods, as the
    reference."""
    pattern = pattern or cfg.period
    rope = rope_tables(positions, attn.rope_dim(cfg), cfg.rope_theta,
                       attn.rope_sections(cfg))
    per_pos = [[] for _ in pattern]
    auxs = []
    for i in range(len(blocks) // len(pattern)):
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for j in range(len(pattern)):
            c = None
            if caches is not None:
                full = caches[j]["core"]
                c = type(full)(*(t[i] for t in full))
            block = blocks[i * len(pattern) + j]
            kw = dict(positions=positions, mode=mode, rope=rope,
                      moe_impl=moe_impl, enc_out=enc_out,
                      is_causal=is_causal)
            if remat and mode == "train" and torch.is_grad_enabled():
                x, nc, a = checkpoint(block, x, use_reentrant=False, **kw)
            else:
                x, nc, a = block(x, cache=c, active=active, **kw)
            per_pos[j].append(nc)
            aux = aux + a
        auxs.append(aux)
    new_caches = []
    for j, ncs in enumerate(per_pos):
        if ncs[0] is None:
            new_caches.append({"core": None})
        elif mode == "decode":                 # the rows written in place
            core = caches[j]["core"]
            if "length" in core._fields:
                core = core._replace(
                    length=torch.stack([c.length for c in ncs]))
            new_caches.append({"core": core})
        else:
            new_caches.append({"core": type(ncs[0])(
                *(torch.stack(ts) for ts in zip(*ncs)))})
    return x, new_caches, torch.stack(auxs).sum()


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def _default_positions(cfg: ModelConfig, bsz: int, s: int, offset=0,
                       device=None):
    """(B, S) int32 positions from ``offset``, a scalar (shared position)
    or a (B,) tensor (serving slots in a continuous batch sit at
    per-request positions); (B, S, 3) for an M-RoPE model, the three
    streams equal (text)."""
    off = torch.as_tensor(offset, dtype=torch.int32, device=device)
    pos = torch.arange(s, dtype=torch.int32, device=device)[None, :]
    pos = (pos + (off[:, None] if off.ndim == 1 else off)).expand(bsz, s)
    return pos[..., None].expand(bsz, s, 3) if cfg.mrope else pos


def _positions_for(model: LM, tokens, embeds, positions, offset):
    """``positions`` if given, else the defaults for the input's (B, S)."""
    if positions is not None:
        return positions
    x = tokens if embeds is None else embeds
    return _default_positions(model.cfg, x.shape[0], x.shape[1], offset,
                              x.device)


def _lm_head(model: LM) -> torch.Tensor:
    return model.embed.T if model.cfg.tie_embeddings else model.lm_head


def encode(model: LM, enc_embeds, *, remat: bool = False):
    """The encoder stack of an encoder-decoder, as the reference's
    ``encode``: ``enc_embeds`` (B, T, D) (the modality frontend's output;
    a stub in the reference) at the default positions 0..T-1, every
    encoder block non-causal in train mode, then the encoder's final
    rmsnorm -> the memory (B, T, D) the decoder's cross-attention reads.
    ``remat`` recomputes each block in the backward."""
    cfg = model.cfg
    b, t, _ = enc_embeds.shape
    positions = _default_positions(cfg, b, t, 0, enc_embeds.device)
    x, _, _ = _run_stack(cfg, model.encoder.blocks, enc_embeds,
                         positions=positions, mode="train", caches=None,
                         remat=remat, is_causal=False,
                         pattern=(ENCODER_SPEC,))
    return rmsnorm(model.encoder.final_norm, x, cfg.norm_eps,
                   policy=cfg.norm_reduce_policy)


def forward_hidden(model: LM, *, tokens=None, embeds=None, positions=None,
                   mode: str = "train", caches=None, position_offset=0,
                   active=None, remat: bool = False,
                   moe_impl: str = "capacity", enc_out=None):
    """Backbone only: (final-norm hidden states, caches, aux).  As
    ``forward``."""
    positions = _positions_for(model, tokens, embeds, positions,
                               position_offset)
    return model.hidden(tokens, embeds=embeds, positions=positions,
                        mode=mode, caches=caches, active=active, remat=remat,
                        moe_impl=moe_impl, enc_out=enc_out)


def forward(model: LM, *, tokens=None, embeds=None, positions=None,
            mode: str = "train", caches=None, position_offset=0, active=None,
            moe_impl: str = "capacity", enc_out=None):
    """Returns (logits (B, S, padded_vocab) float32, new caches, aux).
    The input is ``tokens`` (B, S) or ``embeds`` (B, S, D), used as they
    are in place of the embedding; ``positions`` default to
    ``position_offset`` onwards ((B, S, 3), the streams equal, for an
    M-RoPE model).  ``aux`` is the MoE load-balance term of the reference
    (0 without experts).  ``active`` (B,) bool, decode only: rows where
    it is False keep their caches as they were.  ``enc_out`` (B, T, D),
    an encoder-decoder's memory (``encode``), is read by every decoder
    block's cross-attention; without it the decoder runs alone, as the
    reference's."""
    positions = _positions_for(model, tokens, embeds, positions,
                               position_offset)
    return model(tokens, embeds=embeds, positions=positions, mode=mode,
                 caches=caches, active=active, moe_impl=moe_impl,
                 enc_out=enc_out)


def _chunk_nll(h, head, labels, mask):
    """One sequence chunk's summed masked negative log-likelihood, float32:
    the logits (B, c, V) live only inside this call.  The label's logit is
    gathered: the reference's masked sum over the vocabulary adds it to
    zeros only, so both give the same value."""
    lg = matmul_f32(h, head)
    lse = torch.logsumexp(lg, dim=-1)
    lab = torch.gather(lg, -1, labels.long()[..., None])[..., 0]
    return torch.sum((lse - lab) * mask)


def loss_fn(model: LM, batch, *, moe_impl: str = "capacity",
            remat: bool = False, aux_weight: float = 0.01,
            logits_pspec=None):
    """batch: ``tokens`` (B, S) or ``embeds`` (B, S, D) [+ optional
    ``labels``, ``loss_mask``, ``positions``, (B, S, 3) for an M-RoPE
    model; ``enc_embeds`` (B, T, D) for an encoder-decoder, which the
    decoder reads through ``encode``, and which a decoder-only model
    ignores, as the reference does] -> (loss, metrics {xent, aux,
    tokens}), as the reference's
    ``loss_fn``: next-token cross-entropy in float32 plus ``aux_weight *
    aux`` (0 for a model without experts).

    Without ``labels`` the labels are ``tokens[:, 1:]`` against the
    hidden states of ``tokens[:, :-1]`` (an ``embeds`` batch brings its
    ``labels``, as the reference's training batch does).  The head and the cross-entropy
    run one sequence chunk of ``cfg.loss_chunk`` at a time (the whole
    sequence when it does not divide it), each chunk under a
    non-reentrant checkpoint so that only one chunk's (B, c, V) logits
    live; the chunk sums add in order onto 0 and the token count
    normalizes once at the end.  ``remat`` recomputes each block in the
    backward (the encoder's too).  ``moe_impl`` picks the MoE dispatch;
    ``logits_pspec`` raises."""
    cfg = model.cfg
    if logits_pspec is not None:
        raise NotImplementedError(
            "loss_fn(logits_pspec=): a sharded vocabulary needs "
            "distributed/sharding.py — ROADMAP.md queue 1, item 6 brings "
            "it")
    enc_out = (encode(model, batch["enc_embeds"], remat=remat)
               if cfg.is_encdec else None)
    tokens = batch.get("tokens")
    hidden, _, aux = forward_hidden(model, tokens=tokens,
                                    embeds=batch.get("embeds"),
                                    positions=batch.get("positions"),
                                    mode="train", remat=remat,
                                    moe_impl=moe_impl, enc_out=enc_out)
    labels = batch.get("labels")
    if labels is None:
        labels = tokens[:, 1:]
        hidden = hidden[:, :-1]
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=hidden.device)
    else:
        mask = mask.to(torch.float32)[:, :labels.shape[1]]
    head = _lm_head(model)
    s = labels.shape[1]
    chunk = cfg.loss_chunk if s % cfg.loss_chunk == 0 else s
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, s, chunk):
        args = (hidden[:, c:c + chunk], head, labels[:, c:c + chunk],
                mask[:, c:c + chunk])
        nll = nll + (checkpoint(_chunk_nll, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _chunk_nll(*args))
    count = mask.sum()
    xent = nll / torch.clamp(count, min=1.0)
    loss = xent + aux_weight * aux
    return loss, {"xent": xent, "aux": aux, "tokens": count}


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


def init_caches(cfg: ModelConfig, bsz: int, max_len: int, *, device=None,
                dtype=torch.float32) -> list:
    """Zeroed caches, one ``{"core": cache}`` per period position with a
    leading ``n_periods`` axis, in ``dtype`` (float32, the decode kernel's
    input, by default), length (n, B): a ``KVCache`` of k, v (n, B, T, K,
    hd), T being ``max_len``, or ``cfg.window`` for a sliding-window model
    (a ring, whatever ``max_len`` is); for an MLA model an ``MLACache`` of
    c_kv (n, B, max_len, r) and k_rope (n, B, max_len, rd); at a Mamba
    position a ``MambaState`` of h (n, B, di, d_state), float32 whatever
    ``dtype`` is, and conv (n, B, d_conv - 1, di); at an mLSTM position an
    ``MLSTMState`` of c (n, B, H, p, p), n (n, B, H, p) and m (n, B, H),
    float32, and conv (n, B, kconv - 1, di); at an sLSTM position an
    ``SLSTMState`` of c, n (ones), m (n, B, d), float32, and h (n, B, d).
    The recurrent states have no length (their size does not grow with
    the sequence).  Widening a narrow latent, key, value, conv input or
    sLSTM h is exact, so a float32 cache holds what the reference's cache
    in the model's dtype holds."""
    check_supported(cfg)
    dev = resolve_device(device)
    n = cfg.n_periods

    def zeros(*shape, dtype=dtype):
        return torch.zeros((n, bsz) + shape, dtype=dtype, device=dev)

    def cache(spec: BlockSpec):
        f32 = torch.float32
        if spec.kind == "mamba":
            m = cfg.mamba or MambaCfg()
            di = m.expand * cfg.d_model
            return ssm.MambaState(h=zeros(di, m.d_state, dtype=f32),
                                  conv=zeros(m.d_conv - 1, di))
        if spec.kind == "mlstm":
            x = cfg.xlstm or XLSTMCfg()
            di = int(x.proj_factor_m * cfg.d_model)
            nh, hd = x.num_heads, di // x.num_heads
            return ssm.MLSTMState(c=zeros(nh, hd, hd, dtype=f32),
                                  n=zeros(nh, hd, dtype=f32),
                                  m=zeros(nh, dtype=f32),
                                  conv=zeros(x.conv_kernel - 1, di))
        if spec.kind == "slstm":
            d = cfg.d_model
            return ssm.SLSTMState(c=zeros(d, dtype=f32),
                                  n=zeros(d, dtype=f32) + 1.0,
                                  h=zeros(d), m=zeros(d, dtype=f32))
        length = torch.zeros((n, bsz), dtype=torch.int32, device=dev)
        if cfg.attn_type == "mla":
            return attn.MLACache(zeros(max_len, cfg.kv_lora_rank),
                                 zeros(max_len, cfg.qk_rope_dim), length)
        slots = cfg.window if cfg.window is not None else max_len
        shape = (slots, cfg.n_kv_heads, cfg.hdim)
        return attn.KVCache(zeros(*shape), zeros(*shape), length)

    return [{"core": cache(spec)} for spec in cfg.period]


def cache_bytes(caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches
               for t in c["core"])


def pad_caches_to(cfg: ModelConfig, caches, max_len: int):
    """Grow prefill-shaped caches (sequence axis == prefill length) to
    ``max_len`` with zero rows so decode can append: a ``KVCache``'s k, v
    (n, B, S, K, hd), an ``MLACache``'s c_kv, k_rope (n, B, S, .).  Ring
    caches are ``cfg.window`` slots already and a recurrent state (no
    length) is O(1) in the sequence: both are left as they are."""
    if cfg.window is not None:
        return list(caches)
    out = []
    for c in caches:
        core = c["core"]
        if "length" not in core._fields:
            out.append(c)
            continue
        padn = max_len - core[0].shape[2]
        if padn > 0:
            core = type(core)(*(torch.nn.functional.pad(   # all but length
                t, (0, 0) * (t.ndim - 3) + (0, padn)) for t in core[:-1]),
                core.length)
        out.append({**c, "core": core})
    return out


def decode_step(model: LM, token, caches, position, *, active=None,
                moe_impl: str = "capacity", enc_out=None):
    """One serving step: token (B, s) -> (logits (B, s, V), new caches).

    ``position`` is a scalar (lock-step batch) or a (B,) tensor of
    per-request positions; each row appends at its own cache length.
    ``s > 1`` columns are a chunked-prefill extend.  ``active`` and
    ``enc_out``: see ``forward`` (at ``s == 1`` the cross-attention runs
    on K2)."""
    logits, new_caches, _ = forward(model, tokens=token, mode="decode",
                                    caches=caches, position_offset=position,
                                    active=active, moe_impl=moe_impl,
                                    enc_out=enc_out)
    return logits, new_caches


__all__ = ["LM", "Block", "Encoder", "SwiGLU", "GeluMLP", "init_params",
           "encode", "forward", "forward_hidden", "loss_fn", "decode_step", "init_caches", "pad_caches_to",
           "unsupported", "check_supported", "param_bytes", "cache_bytes"]
