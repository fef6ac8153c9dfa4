"""Weights carried across from the reference's parameter tree.

``params_from_numpy(cfg, tree)`` takes the tree the reference's
``init_params`` returns, with its leaves as numpy arrays (any float dtype,
bf16 included), and loads it into the port's ``LM``: ``tree["blocks"][j]``
holds period position ``j``'s leaves stacked on a leading ``n_periods``
axis, and row ``i`` of each becomes layer ``i * len(period) + j``.  Both
packages then compute the same function, which is what the tests compare.
``to_reference`` goes the other way, for tensors named as the model's
parameters (the weights or their gradients), and ``stacked_leaves``
holds a model's parameters in that layout for training.  Nothing here
imports the reference; the tree is plain nested dicts.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from .. import resolve_device
from .config import ModelConfig
from .model import LM


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


@functools.lru_cache(maxsize=16)
def reference_leaves(cfg: ModelConfig) -> Tuple[Tuple[str, Tuple[str, ...]],
                                                ...]:
    """The reference tree's leaves in ``jax.tree.leaves`` order: (its path,
    ``/``-joined, and the model's parameter names it stacks, in period
    order; one name for a leaf outside ``blocks``).  Cached per
    configuration (a train step asks for it once a microbatch)."""
    per = len(cfg.period)
    groups: Dict[tuple, List[Tuple[int, str]]] = {}
    for name, _ in LM(cfg, device="meta").named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            layer = int(parts[1])
            key = ("blocks", layer % per) + tuple(parts[2:])
            groups.setdefault(key, []).append((layer // per, name))
        else:
            groups[tuple(parts)] = [(0, name)]
    return tuple(("/".join(map(str, key)),
                  tuple(n for _, n in sorted(groups[key])))
                 for key in sorted(groups))


def to_reference(cfg: ModelConfig, tensors: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Tensors named as the model's parameters -> {reference path: leaf},
    in the reference's leaf order; a ``blocks`` leaf is the period
    position's tensors stacked on a leading ``n_periods`` axis (a
    copy)."""
    out = {}
    for path, names in reference_leaves(cfg):
        out[path] = (torch.stack([tensors[n] for n in names])
                     if path.startswith("blocks/") else tensors[names[0]])
    return out


def stacked_leaves(model: LM) -> Dict[str, torch.Tensor]:
    """The model's parameters as the reference's leaves (``to_reference``'s
    layout), sharing their storage: the first call moves each period
    position's parameters into one stacked tensor and makes each of them
    a view of its row, so writing a leaf in place writes the model.
    Later calls return the same leaves while every parameter still views
    them (cached on the model), else stack anew."""
    named = dict(model.named_parameters())
    held = getattr(model, "_stacked_leaves", None)
    if held is not None and all(named[n].data_ptr() == ptr
                                for n, ptr in held[1]):
        return held[0]
    leaves, ptrs = {}, []
    with torch.no_grad():
        for path, names in reference_leaves(model.cfg):
            if path.startswith("blocks/"):
                leaf = torch.stack([named[n].detach() for n in names])
                for i, n in enumerate(names):
                    named[n].data = leaf[i]
            else:
                leaf = named[names[0]].detach()
            leaves[path] = leaf
            ptrs += [(n, named[n].data_ptr()) for n in names]
    model._stacked_leaves = (leaves, tuple(ptrs))
    return leaves


def params_from_numpy(cfg: ModelConfig, tree, *, device=None) -> LM:
    """An ``LM`` of ``cfg`` holding the reference tree's values, cast to
    ``cfg.dtype``, on ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    per = len(cfg.period)

    def tensor(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dtype)

    state = {}
    for path, leaf in _leaves({k: v for k, v in tree.items()
                               if k != "blocks"}):
        state[".".join(path)] = tensor(leaf)
    for j, block in enumerate(tree["blocks"]):
        for path, leaf in _leaves(block):
            arr = np.asarray(leaf, dtype=np.float32)
            if arr.shape[0] != cfg.n_periods:
                raise ValueError(f"blocks[{j}]/{'/'.join(path)}: leading "
                                 f"axis {arr.shape[0]}, want n_periods="
                                 f"{cfg.n_periods}")
            for i in range(cfg.n_periods):
                state[".".join(("blocks", str(i * per + j)) + path)] = \
                    tensor(arr[i])
    model = LM(cfg, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    # serving's parameters take no gradient; the train step switches it on
    return model.requires_grad_(False)
