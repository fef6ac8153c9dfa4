#!/usr/bin/env python3
"""Where a serving step's time goes on the GPU.

    python3 tools/serve_profile.py [--seed 0] [--steps 4]   # needs CUDA
    python3 tools/serve_profile.py --arch deepseek-v2-lite-16b --max-len 4096
    python3 tools/serve_profile.py --arch jamba-v0.1-52b --layers 16
    python3 tools/serve_profile.py --arch xlstm-125m --max-len 2176 \
        --prefill-tokens 2048
    python3 tools/serve_profile.py --arch qwen2-vl-7b

Builds ``--arch`` at full width (stablelm-1.6b by default; bf16, random
weights from ``--seed``), its depth cut to ``--layers`` (a multiple of
the period: whole periods; default all), and ``chip_smoke.py``'s serving
engine (8 slots x ``--max-len`` context, 32-token prefill chunks, the
dense MoE), fills the slots with one ``generate`` of 8 prompts of 64-768
tokens, then times and profiles, each after a warm-up:

  * a decode step of all 8 slots (``decode_step`` with every row active,
    each call writing the same cache row; a Mamba layer's state steps on
    from call to call);
  * a 32-token prefill chunk of slot 0 (``Engine._prefill_chunk``), or,
    for a model the engine prefills whole (ring caches, recurrent
    states), slot 0's whole prompt (``Engine._classic_prefill``), or a
    prompt of ``--prefill-tokens`` random tokens.

For each it prints the wall time per call (host clock around
synchronized calls), the device's busy time per call (the sum of the CUDA
kernels' times in a ``torch.profiler`` trace, one stream), the idle share
(1 - busy / wall), and the ops with the most device time and the most
host time.  The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def profile(label, fn, steps, top):
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / steps
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()

    def dev(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in events
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy = sum(dev(e) for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    print(f"{label}: wall {wall:.3f} ms a call (host clock), device busy "
          f"{busy:.3f} ms a call (profiler, {len(kernels)} kernel kinds, "
          f"{launches:.0f} launches a call), idle share "
          f"{1 - busy / wall:.3f}", flush=True)
    print(f"  by device time (ms a call, calls a call):")
    for e in sorted(kernels, key=dev, reverse=True)[:top]:
        print(f"    {dev(e) / 1e3 / steps:9.4f}  {e.count / steps:7.1f}  "
              f"{e.key[:90]}")
    ops = [e for e in events if e not in kernels]
    print(f"  by host time (self, ms a call, calls a call):")
    for e in sorted(ops, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:top]:
        print(f"    {e.self_cpu_time_total / 1e3 / steps:9.4f}  "
              f"{e.count / steps:7.1f}  {e.key[:90]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--top", type=int, default=14)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--max-len", type=int, default=1024)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (whole periods)")
    ap.add_argument("--prefill-tokens", type=int, default=None,
                    help="the whole-prompt prefill's length (default: slot "
                         "0's prompt)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("serve_profile: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, Request
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers is not None:
        if args.layers % len(cfg.period):
            ap.error(f"--layers {args.layers}: {cfg.name}'s period is "
                     f"{len(cfg.period)} layers")
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = M.init_params(cfg, generator=gen, device=dev)
    eng = Engine(cfg, model, max_len=args.max_len, max_batch=8,
                 prefill_chunk=32, device=dev)
    host = torch.Generator()
    host.manual_seed(args.seed + 1)
    lens = torch.randint(64, 769, (8,), generator=host).tolist()
    reqs = [Request(prompt=torch.randint(1, cfg.vocab, (n,),
                                         generator=host).tolist(),
                    max_new_tokens=8) for n in lens]
    res = eng.generate(reqs)
    # the slots' positions: every token but the last is in the cache
    lengths = torch.tensor([len(r.tokens) - 1 for r in res], device=dev)
    toks = torch.tensor([[r.tokens[-1]] for r in res], device=dev)
    active = torch.ones(8, dtype=torch.bool, device=dev)
    print(f"{cfg.name} at {cfg.n_layers} layers; prompts {lens}; cache "
          f"lengths {lengths.tolist()}", flush=True)
    with torch.no_grad():
        profile("decode step (B=8)", lambda: M.decode_step(
            model, toks, eng._caches, lengths, active=active,
            moe_impl="dense"), args.steps, args.top)
        if eng._extend_ok:
            chunk = torch.tensor([reqs[0].prompt[:32]], device=dev)
            profile("prefill chunk (32 tokens)", lambda: eng._prefill_chunk(
                0, chunk, 0, 32), args.steps, args.top)
        else:
            prompt = torch.tensor([reqs[0].prompt], device=dev)
            if args.prefill_tokens is not None:
                prompt = torch.randint(1, cfg.vocab, (1, args.prefill_tokens),
                                       generator=host).to(dev)
            profile(f"whole-prompt prefill ({prompt.shape[1]} tokens)",
                    lambda: eng._classic_prefill(0, prompt), args.steps,
                    args.top)
    return 0


if __name__ == "__main__":
    sys.exit(main())
