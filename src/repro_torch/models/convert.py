"""Weights carried across from the reference's parameter tree.

``params_from_numpy(cfg, tree)`` takes the tree the reference's
``init_params`` returns, with its leaves as numpy arrays (any float dtype,
bf16 included), and loads it into the port's ``LM``: ``tree["blocks"][j]``
holds period position ``j``'s leaves stacked on a leading ``n_periods``
axis, and row ``i`` of each becomes layer ``i * len(period) + j``.  Both
packages then compute the same function, which is what the tests compare.
Nothing here imports the reference; the tree is plain nested dicts.
"""

from __future__ import annotations

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
    return model.requires_grad_(False)
