"""Weights carried across from the reference's parameter tree.

``params_from_numpy(cfg, tree)`` takes the tree the reference's
``init_params`` returns, with its leaves as numpy arrays (any float dtype,
bf16 included), and loads it into the port's ``LM``: ``tree["blocks"][j]``
holds period position ``j``'s leaves stacked on a leading ``n_periods``
axis, and row ``i`` of each becomes layer ``i * len(period) + j``; an
encoder-decoder's ``tree["encoder"]`` holds ``blocks``, a dict of leaves
stacked on a leading ``encoder_layers`` axis (row ``i``: encoder layer
``i``), and ``final_norm``.  Both packages then compute the same
function, which is what the tests compare.
``to_reference`` goes the other way, for tensors named as the model's
parameters (the weights or their gradients), and ``stacked_leaves``
holds a model's parameters in that layout for training; ``nest`` turns
such a {path: leaf} dict back into the reference's nested tree (what a
checkpoint names its leaves by).  Nothing here imports the reference;
the tree is plain nested dicts, with a list under ``blocks``.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from .. import resolve_device
from .config import ModelConfig
from .model import LM

#: the reference paths whose leaves stack layers on a leading axis
_STACKED = ("blocks/", "encoder/blocks/")


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
    order, or in layer order under ``encoder/blocks``; one name for a
    leaf outside both).  Cached per configuration (a train step asks for
    it once a microbatch)."""
    per = len(cfg.period)
    groups: Dict[tuple, List[Tuple[int, str]]] = {}
    for name, _ in LM(cfg, device="meta").named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            layer = int(parts[1])
            key = ("blocks", layer % per) + tuple(parts[2:])
            groups.setdefault(key, []).append((layer // per, name))
        elif parts[:2] == ["encoder", "blocks"]:
            key = ("encoder", "blocks") + tuple(parts[3:])
            groups.setdefault(key, []).append((int(parts[2]), name))
        else:
            groups[tuple(parts)] = [(0, name)]
    return tuple(("/".join(map(str, key)),
                  tuple(n for _, n in sorted(groups[key])))
                 for key in sorted(groups))


def to_reference(cfg: ModelConfig, tensors: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Tensors named as the model's parameters -> {reference path: leaf},
    in the reference's leaf order; a ``blocks`` leaf is the period
    position's tensors stacked on a leading ``n_periods`` axis, an
    ``encoder/blocks`` leaf the encoder layers' on ``encoder_layers`` (a
    copy)."""
    out = {}
    for path, names in reference_leaves(cfg):
        out[path] = (torch.stack([tensors[n] for n in names])
                     if path.startswith(_STACKED) else tensors[names[0]])
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
            if path.startswith(_STACKED):
                leaf = torch.stack([named[n].detach() for n in names])
                for i, n in enumerate(names):
                    named[n].data = leaf[i]
            else:
                leaf = named[names[0]].detach()
            leaves[path] = leaf
            ptrs += [(n, named[n].data_ptr()) for n in names]
    model._stacked_leaves = (leaves, tuple(ptrs))
    return leaves


def nest(leaves: Mapping[str, torch.Tensor]) -> dict:
    """{reference path: leaf} (``to_reference``'s or ``stacked_leaves``'s
    layout) -> the reference's nested tree holding the same tensors:
    dicts, with ``blocks`` a list indexed by period position (the
    encoder's ``blocks`` stay a dict, as the reference's)."""
    tree: dict = {}
    for path, leaf in leaves.items():
        parts = path.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = leaf
    if "blocks" in tree:
        tree["blocks"] = [tree["blocks"][str(j)]
                          for j in range(len(tree["blocks"]))]
    return tree


def params_from_numpy(cfg: ModelConfig, tree, *, device=None) -> LM:
    """An ``LM`` of ``cfg`` holding the reference tree's values, each cast
    to its parameter's dtype (``cfg.dtype``; an MoE router stays
    float32), on ``device`` (None means CUDA)."""
    dev = resolve_device(device)
    per = len(cfg.period)
    model = LM(cfg, device="meta")
    dtypes = {n: p.dtype for n, p in model.named_parameters()}

    def tensor(name, a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=dev, dtype=dtypes.get(name, torch.float32))

    state = {}

    def unstack(where, block, n, layer_of):
        for path, leaf in _leaves(block):
            arr = np.asarray(leaf, dtype=np.float32)
            if arr.shape[0] != n:
                raise ValueError(f"{where}/{'/'.join(path)}: leading axis "
                                 f"{arr.shape[0]}, want {n}")
            for i in range(n):
                name = ".".join(layer_of(i) + path)
                state[name] = tensor(name, arr[i])

    rest = {k: v for k, v in tree.items() if k not in ("blocks", "encoder")}
    if "encoder" in tree:
        rest["encoder"] = {"final_norm": tree["encoder"]["final_norm"]}
        unstack("encoder/blocks", tree["encoder"]["blocks"],
                cfg.encoder_layers, lambda i: ("encoder", "blocks", str(i)))
    for path, leaf in _leaves(rest):
        name = ".".join(path)
        state[name] = tensor(name, leaf)
    for j, block in enumerate(tree["blocks"]):
        unstack(f"blocks[{j}]", block, cfg.n_periods,
                lambda i, j=j: ("blocks", str(i * per + j)))
    model.load_state_dict(state, strict=True, assign=True)
    # serving's parameters take no gradient; the train step switches it on
    return model.requires_grad_(False)
