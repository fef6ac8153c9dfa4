"""Serving launcher: batched generation with the port's Engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \
        --smoke --requests 4 --new-tokens 16 --device cpu

Without ``--device`` it runs on the CUDA device (and fails without one).
Weights are random, drawn from ``--seed``.  Pass ``--arrival-gap G`` to
drive the continuous-batching path instead of the all-at-once wrapper:
requests arrive with mean-G-step Poisson gaps, admit mid-stream into freed
decode slots, and results report per-request latency (submission to
retirement, queue wait included).  Architectures whose inputs are
embeddings (qwen2-vl-7b) or that need an encoder exit with the
reference launcher's message: its demo serves token language models.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import get_config, get_smoke_config
from ..models import init_params
from ..serve.engine import Engine, Request


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--arrival-gap", type=float, default=0.0,
                    help="mean Poisson inter-arrival gap in engine steps; "
                         "0 = submit everything at time zero")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device; default: the CUDA device")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if cfg.embed_inputs or cfg.is_encdec:     # the reference's refusal
        raise SystemExit(f"{args.arch}: serve demo targets token-LM archs")
    dev = resolve_device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = init_params(cfg, generator=gen, device=dev)
    engine = Engine(cfg, model, max_len=args.max_len, seed=args.seed,
                    device=dev)

    rng = np.random.default_rng(args.seed)
    reqs = [Request(prompt=[int(t) for t in rng.integers(
                        1, cfg.vocab, size=rng.integers(4, 24))],
                    max_new_tokens=args.new_tokens,
                    temperature=args.temperature)
            for _ in range(args.requests)]
    t0 = time.time()
    if args.arrival_gap > 0:
        t = 0.0
        for r in reqs:
            t += float(rng.exponential(args.arrival_gap))
            engine.submit(r, arrival=t)
        results = engine.run()
    else:
        results = engine.generate(reqs)
    dt = time.time() - t0
    total_new = sum(len(r.tokens) - r.prompt_len for r in results)
    for i, r in enumerate(results):
        lat = f" latency={r.latency_s * 1e3:.0f}ms" if args.arrival_gap \
            else ""
        print(f"req{i}: prompt[{r.prompt_len}] -> "
              f"+{len(r.tokens) - r.prompt_len} tokens: "
              f"{r.tokens[r.prompt_len:][:12]} mean_logprob="
              f"{r.mean_logprob:.4f}{lat}")
    print(f"{total_new} tokens in {dt:.2f}s "
          f"({total_new / max(dt, 1e-9):.1f} tok/s batched) on {dev}")


if __name__ == "__main__":
    main()
