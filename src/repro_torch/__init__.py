"""repro_torch — the JugglePAC streaming-reduction front door in PyTorch,
with the block-schedule kernel written by hand in CUDA for Hopper.

This package is the PyTorch/CUDA counterpart of ``repro`` (the JAX/Pallas
reference).  It imports ``torch`` and numpy only; nothing here loads JAX
or the reference package.  The front door is the callable module
``repro_torch.reduce``:

    import repro_torch
    out = repro_torch.reduce(values, segment_ids=ids, num_segments=8,
                             policy="exact2")          # on the GPU
    out = repro_torch.reduce(values, policy="fast", device="cpu")

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; without CUDA they raise instead of falling back.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``None`` means ``"cuda"``.

    Raises ``RuntimeError`` when a CUDA device is asked for (explicitly or
    by default) and ``torch.cuda.is_available()`` is False — the port
    never falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device is required (device=None means "
            "'cuda'), but torch.cuda.is_available() is False — this torch "
            f"build ({torch.__version__}) sees no CUDA device; pass "
            "device='cpu' to run the plain PyTorch path on the CPU")
    return dev


from . import reduce  # noqa: E402,F401  (callable module: repro_torch.reduce(...))

__version__ = "1.3.0"
