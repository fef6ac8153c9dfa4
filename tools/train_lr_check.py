#!/usr/bin/env python3
"""Whether a train run's loss rises from its lr or from its bf16 backward.

    python3 tools/train_lr_check.py [--seed 0] [--lr 1e-3] [--steps 5]   # needs CUDA

Builds ``chip_smoke.py``'s train phase: stablelm-1.6b at full width (bf16,
random weights from ``--seed`` + 21, as there), one ``SyntheticLM`` batch
of 8 x 256 tokens from ``--seed``, 4 microbatches, remat on.  Every bf16
product then runs one of two ways:

  * narrow: the port's own, ``layers._NarrowMatmul`` (cuBLAS on the bf16
    operands, float32 sums, the backward written by hand);
  * widened: the same product on float32 copies of the operands, its
    backward from autograd (each gradient rounded once to bf16 by the
    cast's own backward).

It prints, on the first microbatch from the starting weights, how far
the narrow gradients lie from the widened ones (the largest
max|narrow - widened| / max|widened| over the parameters, and the
relative L2 distance over all of them), then the losses of ``--steps``
juggler steps at ``cosine_schedule(--lr, 1, --steps)`` from the same
weights, each way.  If the widened run's loss moves as the narrow one's
does, the backward is not what moves it.  The card's name and power
limit come first.
"""

from __future__ import annotations

import argparse
import contextlib
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def widened(x, w, out_dtype):
    """``_NarrowMatmul.apply``'s product on float32 copies, through
    autograd."""
    import torch
    return torch.mm(x.float(), w.float()).to(out_dtype)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("train_lr_check: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.data import DataCfg, SyntheticLM
    from repro_torch.models import layers
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import init_state, make_train_step
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("stablelm-1.6b")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 21)
    model = M.init_params(cfg, generator=gen, device=dev)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    batch = {k: torch.as_tensor(v, device=dev) for k, v in SyntheticLM(
        DataCfg(vocab=cfg.vocab, seq_len=256, global_batch=8,
                seed=args.seed)).batch(0).items()}
    ways = (("narrow", contextlib.nullcontext),
            ("widened", lambda: mock.patch.object(
                layers._NarrowMatmul, "apply", widened)))

    def restart():
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(start[n])
        model.requires_grad_(True)

    grads = {}
    mb = {k: v[:2] for k, v in batch.items()}
    for way, patch in ways:
        restart()
        with patch():
            loss, _ = M.loss_fn(model, mb, remat=True)
            named = dict(model.named_parameters())
            grads[way] = dict(zip(named, torch.autograd.grad(
                loss, list(named.values()))))
        print(f"{way}: first microbatch loss {float(loss)!r}", flush=True)
    worst, name, num, den = 0.0, None, 0.0, 0.0
    for n, want in grads["widened"].items():
        diff = (grads["narrow"][n].float() - want.float())
        rel = float(diff.abs().max() / want.float().abs().max())
        if rel > worst:
            worst, name = rel, n
        num += float((diff * diff).sum())
        den += float((want.float() ** 2).sum())
    print(f"gradients, narrow vs widened: worst max|diff| / max|widened| "
          f"{worst!r} ({name}); relative L2 distance "
          f"{(num / den) ** 0.5!r}", flush=True)
    del grads

    lr_fn = adamw.cosine_schedule(args.lr, 1, args.steps)
    for way, patch in ways:
        restart()
        step = make_train_step(cfg, lr_fn=lr_fn, num_microbatches=4,
                               device=dev)
        state, losses = init_state(model), []
        with patch():
            for _ in range(args.steps):
                _, state, met = step(model, state, batch)
                losses.append(float(met["loss"]))
        print(f"{way}: {args.steps} juggler steps at peak lr {args.lr}: "
              f"losses {losses}", flush=True)
        del state, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
