#!/usr/bin/env python3
"""Where a train step's time goes on the GPU.

    python3 tools/train_profile.py [--seed 0] [--steps 2]   # needs CUDA
    python3 tools/train_profile.py --arch deepseek-v2-lite-16b --layers 4 \
        --exact-layers 2

Builds ``--arch`` (default stablelm-1.6b) at full width (bf16, random
weights from ``--seed``), its depth cut to ``--layers`` when given, and
``chip_smoke.py``'s train batch (``SyntheticLM``, 8 x 256 tokens, 4
microbatches), then times and profiles, each after a warm-up:

  * a juggler step (``make_train_step(num_microbatches=4)``; a model
    with experts under the ``capacity`` dispatch, the reference's
    default);
  * a step with ``grad_reduce="exact"`` and ``norm_policy="exact"``, at
    ``--exact-layers`` when given (it keeps the 4 microbatch gradients
    and a leaf's domain beside the moments: deepseek-v2-lite-16b's fits
    the card at 2 layers, as ``chip_smoke.py``'s phase 18 runs it).

For each it prints the wall time per step (host clock around
synchronized steps), the device's busy time per step (the sum of the
CUDA kernels' times in a ``torch.profiler`` trace, one stream), the idle
share (1 - busy / wall), and the ops with the most device time and the
most host time (``serve_profile.profile``).  The card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers")
    ap.add_argument("--exact-layers", type=int, default=None,
                    help="the exact step's depth (default: --layers)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from serve_profile import profile
    from repro_torch.configs import get_config
    from repro_torch.data import DataCfg, SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import init_state, make_train_step
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    full = get_config(args.arch)
    gen = torch.Generator(device=dev)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        DataCfg(vocab=full.vocab, seq_len=256, global_batch=8,
                seed=args.seed)).batch(0).items()}
    lr_fn = adamw.cosine_schedule(1e-4, 1, 5)
    exact_layers = args.exact_layers or args.layers
    for label, layers, kw in (
            ("juggler step (m=4)", args.layers, {}),
            ("exact step (m=4, grad_reduce and norm_policy exact)",
             exact_layers, {"grad_reduce": "exact",
                            "norm_policy": "exact"})):
        cfg = full if layers is None else \
            dataclasses.replace(full, n_layers=layers)
        gen.manual_seed(args.seed)
        model = M.init_params(cfg, generator=gen, device=dev)
        step = make_train_step(cfg, lr_fn=lr_fn, num_microbatches=4,
                               device=dev, **kw)
        hold = {"model": model, "state": init_state(model)}

        def one():
            hold["model"], hold["state"], _ = step(hold["model"],
                                                   hold["state"], batch)
        torch.cuda.reset_peak_memory_stats()
        profile(f"{cfg.name} at {cfg.n_layers} layers, {label}", one,
                args.steps, args.top)
        print(f"  peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
              f" GiB", flush=True)
        del hold, one, step, model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
