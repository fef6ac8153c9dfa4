"""Training launcher of the port, with the reference's flags and defaults.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
        --smoke --steps 50 --batch 8 --seq 256 --device cpu

Without ``--device`` it runs on the CUDA device (and fails without one).
The weights are random, drawn from ``--seed``; the tokens come from
``--data`` (a packed token file) or the seeded ``SyntheticLM`` stream,
whose ``batch(step)`` is a pure function of (seed, step).  Each step is
``train.make_train_step(remat=False)`` with the cosine schedule, as the
reference launcher runs it.

Fault tolerance, as the reference launcher's:
  * with ``--ckpt-dir`` it snapshots the train state (``{"params": the
    12 stacked leaves, "opt": AdamWState}``, ``train.checkpoint_state``)
    every ``--ckpt-every`` steps through ``repro_torch.ckpt``: atomic
    renames, the newest 3 kept, files the reference reads too;
  * on start it restores the newest snapshot that verifies (a ``.tmp``
    left by a crash mid-save, or a shard with a flipped bit, falls back
    to the step before) into the live model and moments, and resumes at
    the snapshot's ``next_step``; ``batch(step)`` is pure, so the token
    stream replays exactly;
  * ``--simulate-failure-at K`` exits with code 17 after step K (and
    after its snapshot, when K is a checkpoint step).

What the port lacks raises ``NotImplementedError`` naming its
``ROADMAP.md`` item: ``--compress-bits`` and ``--microbatches > 1`` (the
reference's shard_map step, queue 1, item 5).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from .. import resolve_device
from ..ckpt import checkpoint as ckpt
from ..configs import get_config, get_smoke_config
from ..data.pipeline import DataCfg, make_source
from ..models import init_params
from ..optim import adamw
from ..train.steps import checkpoint_state, init_state, make_train_step

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
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
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

    start = 0
    if args.ckpt_dir:
        # the newest *valid* snapshot, written into the live leaves: a
        # crash mid-save leaves a .tmp directory (no manifest) and a
        # flipped bit fails the CRC sidecar; both fall back a step
        restored = ckpt.restore_latest_valid(
            args.ckpt_dir, checkpoint_state(model, opt_state), inplace=True)
        if restored is not None:
            _, manifest, latest = restored
            start = manifest["extra"]["next_step"]
            print(f"[restore] resumed from step {latest} -> next {start}",
                  flush=True)

    t0 = time.time()
    metrics = None
    for step in range(start, args.steps):
        model, opt_state, metrics = step_fn(model, opt_state,
                                            source.batch(step))
        if step % args.log_every == 0 or step == args.steps - 1:
            loss = float(metrics["loss"])
            dt = time.time() - t0
            print(f"step {step:5d} loss {loss:.4f} "
                  f"lr {float(metrics['lr']):.2e} ({dt:.1f}s)", flush=True)
        if args.ckpt_dir and ckpt.save_every(step, args.ckpt_every):
            ckpt.save(args.ckpt_dir, step, checkpoint_state(model, opt_state),
                      extra={"next_step": step + 1, "arch": args.arch})
            print(f"[ckpt] saved step {step}", flush=True)
        if args.simulate_failure_at and step == args.simulate_failure_at:
            print(f"[failure] simulated crash at step {step}", flush=True)
            os._exit(17)

    if metrics is None:
        print("done: 0 steps")
        return None
    print(f"done: {args.steps - start} steps, final loss "
          f"{float(metrics['loss']):.4f}")
    return float(metrics["loss"])


if __name__ == "__main__":
    main()
