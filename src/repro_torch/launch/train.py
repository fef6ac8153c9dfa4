"""Training launcher of the port, with the reference's flags and defaults.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --smoke --steps 50 --batch 8 --seq 256 --device cpu

Without ``--device`` it runs on the CUDA device (and fails without one).
The weights are random, drawn from ``--seed``; the tokens come from
``--data`` (a packed token file) or the seeded ``SyntheticLM`` stream,
whose ``batch(step)`` is a pure function of (seed, step).  Each step is
``train.make_train_step(remat=False)`` with the cosine schedule, as the
reference launcher runs it; ``--simulate-failure-at K`` exits with code
17 after step K.

What the port lacks raises ``NotImplementedError`` naming its
``ROADMAP.md`` item: ``--ckpt-dir`` / ``--ckpt-every`` (checkpointing,
queue 1, item 3), ``--compress-bits`` and ``--microbatches > 1`` (the
reference's shard_map step, queue 1, item 5).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..data.pipeline import DataCfg, make_source
from ..models import init_params
from ..optim import adamw
from ..train.steps import init_state, make_train_step

_ITEM3 = "checkpointing is ROADMAP.md queue 1, item 3"
_ITEM5 = "the shard_map step is ROADMAP.md queue 1, item 5 (multi-device)"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="",
                    help="not in the port yet: raises")
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="not in the port yet: raises (reference: 25)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data", default="", help="packed token file (optional)")
    ap.add_argument("--moe-impl", default="dense",
                    choices=("dense", "capacity"))
    ap.add_argument("--compress-bits", type=int, default=0,
                    help="not in the port yet: > 0 raises")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="not in the port yet: > 1 raises")
    ap.add_argument("--simulate-failure-at", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args(argv)

    if args.ckpt_dir or args.ckpt_every is not None:
        raise NotImplementedError(f"--ckpt-dir / --ckpt-every: {_ITEM3}")
    if args.compress_bits > 0:
        raise NotImplementedError(f"--compress-bits: {_ITEM5}")
    if args.microbatches > 1:
        raise NotImplementedError(f"--microbatches > 1: {_ITEM5}")

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = init_params(cfg, generator=gen, device=dev)
    opt_state = init_state(model)
    lr_fn = adamw.cosine_schedule(args.lr, args.warmup, args.steps)

    dcfg = DataCfg(vocab=cfg.vocab, seq_len=args.seq,
                   global_batch=args.batch, seed=args.seed)
    source = make_source(dcfg, args.data or None)
    step_fn = make_train_step(cfg, lr_fn=lr_fn, remat=False,
                              moe_impl=args.moe_impl, device=dev)

    t0 = time.time()
    metrics = None
    for step in range(args.steps):
        model, opt_state, metrics = step_fn(model, opt_state,
                                            source.batch(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        if args.simulate_failure_at and step == args.simulate_failure_at:
            print(f"[failure] simulated crash at step {step}", flush=True)
            os._exit(17)

    if metrics is None:
        print("done: 0 steps")
        return None
    print(f"done: {args.steps} steps, final loss "
          f"{float(metrics['loss']):.4f} on {dev}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
