"""Abstract inputs for every (arch x shape) cell, on the ``meta`` device.

The counterpart of the reference's ``repro.launch.specs``: nothing here
allocates.  A ``meta`` tensor has a shape and a dtype and no storage, so
the dry-run (``repro_torch.launch.dryrun``) runs a cell's step on these
stand-ins at full width.  The keys, shapes and dtypes are the
reference's: a ``[vlm]`` model gets precomputed patch embeddings and
M-RoPE position ids, an ``[audio]`` one precomputed frame embeddings for
its encoder.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import init_caches, init_params
from ..models.config import ModelConfig, ShapeCfg

#: encoder memory length of an encoder-decoder's *decode* shapes (the
#: encoder ran at prefill time; its output is bounded by the audio
#: segment, not by the decoder's growing sequence)
ENC_LEN_DECODE = 4096

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """A shape-and-dtype stand-in (the reference's ``ShapeDtypeStruct``)."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def abstract_params(cfg: ModelConfig):
    """The model of ``cfg`` with every parameter on ``meta``."""
    return init_params(cfg, device=META)


def abstract_caches(cfg: ModelConfig, bsz: int, max_len: int, *,
                    dtype=torch.float32):
    """Decode caches on ``meta``.  ``dtype`` defaults to float32, what the
    port's decode step takes (K2 reads float32); ``dtype=cfg.dtype``
    gives the reference's caches, leaf for leaf."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return init_caches(cfg, bsz, max_len, device=META, dtype=dtype)


def train_input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict[str, Any]:
    b, s, d = shape.global_batch, shape.seq_len, cfg.d_model
    batch: Dict[str, Any] = {}
    if cfg.embed_inputs and not cfg.is_encdec:
        batch["embeds"] = sds((b, s, d), cfg.dtype)
        batch["labels"] = sds((b, s), torch.int32)
        if cfg.mrope:
            batch["positions"] = sds((b, s, 3), torch.int32)
    else:
        batch["tokens"] = sds((b, s), torch.int32)
    if cfg.is_encdec:
        batch["enc_embeds"] = sds((b, s, d), cfg.dtype)
    return batch


def prefill_input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict[str, Any]:
    batch = train_input_specs(cfg, shape)
    batch.pop("labels", None)
    return batch


def decode_input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict[str, Any]:
    """token, position, the caches the port's decode step takes
    (``abstract_caches``: float32) and, for an encoder-decoder,
    ``enc_out``."""
    b = shape.global_batch
    out: Dict[str, Any] = {
        "token": sds((b, 1), torch.int32),
        "position": sds((), torch.int32),
        "caches": abstract_caches(cfg, b, shape.seq_len),
    }
    if cfg.is_encdec:
        out["enc_out"] = sds((b, ENC_LEN_DECODE, cfg.d_model), cfg.dtype)
    return out


def input_specs(cfg: ModelConfig, shape: ShapeCfg) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    raise ValueError(shape.kind)


def tensors_of(tree):
    """Every tensor of a nest of dicts, lists, tuples and NamedTuples, in
    order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()


def nbytes(tree) -> int:
    """Bytes of every tensor in ``tree`` (a model: its parameters)."""
    return sum(t.numel() * t.element_size() for t in tensors_of(tree))
