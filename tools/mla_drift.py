#!/usr/bin/env python3
"""Where deepseek-v2-lite-16b's served decode and a cache-free forward
part ways, layer by layer, on the GPU.

    python3 tools/mla_drift.py [--seed 0] [--prompt 3072] [--new 32]

Builds deepseek-v2-lite-16b's ``CONFIG`` (random weights from ``--seed``)
and serves one greedy request (a ``--prompt``-token prompt, ``--new`` new
tokens) through ``chip_smoke.py``'s engine (4,096 context, 32-token
prefill chunks, the dense MoE), then runs one cache-free forward over the
request's tokens (padded to a multiple of ``attn_qchunk``, causal, so the
padding is never seen).  For each layer it prints, at the last decode
step's position:

  * the block output's max |decode - forward| over the forward's std;
  * whether the router's top-k experts agree, and the forward's margin
    between its k-th and (k+1)-th router probabilities;

and over the prompt's positions, how many tokens' top-k expert sets
differ between the chunked prefill and the forward.  Last, the logits'
max |difference| over their std, as ``chip_smoke.py`` phase 15 measures
it.  ``--dtype float32 --layers N`` runs the same at N layers in float32
weights (the rounding of bf16 activations taken away).  The card's name
and power limit come first.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt", type=int, default=3072)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("mla_drift: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, Request
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    cfg = get_config("deepseek-v2-lite-16b")
    cfg = dataclasses.replace(cfg, dtype=args.dtype,
                              n_layers=args.layers or cfg.n_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    model = M.init_params(cfg, generator=gen, device=dev)
    host = torch.Generator()
    host.manual_seed(args.seed + 1)
    prompt = torch.randint(1, cfg.vocab, (args.prompt,),
                           generator=host).tolist()
    k = cfg.moe.top_k

    def top(mlp, x):
        """(top-k expert sets as sorted rows, k-th minus (k+1)-th
        probability) of the router on x (T, d)."""
        probs = torch.softmax(x.float() @ mlp.router, dim=-1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        return idx[:, :k].sort(dim=-1).values, w[:, k - 1] - w[:, k]

    # the served request: each layer's router input over the prefill
    # chunks and at the last decode step, each block's output there
    served = {"sets": [[] for _ in model.blocks], "out": {}, "x": {}}

    def router_in(i):
        def hook(mod, a):
            x = a[0]
            if x.shape[0] == 1:                  # a prefill chunk (B = 1)
                served["sets"][i].append(top(mod, x[0])[0])
            else:
                served["x"][i] = x[0, 0:1].clone()   # slot 0: the request
        return hook

    def block_out(i):
        def hook(mod, a, out):
            if out[0].shape[1] == 1:
                served["out"][i] = out[0][0, 0].float().clone()
        return hook

    def logits(mod, a, kw, out):
        if kw.get("mode") == "decode" and a[0].shape[1] == 1:
            served["logits"] = out[0][0, 0].clone()

    hooks = [model.register_forward_hook(logits, with_kwargs=True)]
    for i, blk in enumerate(model.blocks):
        hooks.append(blk.mlp.register_forward_pre_hook(router_in(i)))
        hooks.append(blk.register_forward_hook(block_out(i)))
    t0 = time.perf_counter()
    eng = Engine(cfg, model, max_len=4096, max_batch=8, prefill_chunk=32,
                 device=dev)
    res = eng.generate([Request(prompt=prompt,
                                max_new_tokens=args.new)])[0]
    for hk in hooks:
        hk.remove()
    del eng
    seq = res.tokens[:-1]
    got = served["logits"]
    print(f"{cfg.name} {cfg.dtype} {cfg.n_layers} layers: served "
          f"{len(res.tokens)} tokens in {time.perf_counter() - t0:.1f} s",
          flush=True)

    # the cache-free forward, the same taps at the last position
    fwd = {"out": {}, "sets": {}, "margin": {}, "x": {}}
    pos = len(seq) - 1

    def f_router(i):
        def hook(mod, a):
            x = a[0][0]
            sets, margin = top(mod, x)
            fwd["sets"][i], fwd["margin"][i] = sets, margin
            fwd["x"][i] = x[pos:pos + 1].clone()
        return hook

    def f_block(i):
        def hook(mod, a, out):
            fwd["out"][i] = out[0][0, pos].float().clone()
        return hook

    hooks = []
    for i, blk in enumerate(model.blocks):
        hooks.append(blk.mlp.register_forward_pre_hook(f_router(i)))
        hooks.append(blk.register_forward_hook(f_block(i)))
    pad = -len(seq) % cfg.attn_qchunk
    with torch.no_grad():
        full = M.forward(model, tokens=torch.tensor([seq + [0] * pad],
                                                     device=dev),
                         mode="train", moe_impl="dense")[0]
    for hk in hooks:
        hk.remove()
    ref = full[0, pos]
    del full
    print(f"the last decode step's position: {pos}", flush=True)
    print("layer  block max|d|/std  last top-k agree  forward margin  "
          "prompt tokens with other top-k", flush=True)
    for i in range(cfg.n_layers):
        a, b = served["out"][i], fwd["out"][i]
        rel = float((a - b).abs().max() / b.std())
        s_last = top(model.blocks[i].mlp, served["x"][i])[0]
        agree = bool(torch.equal(s_last, fwd["sets"][i][pos:pos + 1]))
        pre = torch.cat(served["sets"][i])[:args.prompt]
        flips = int((pre != fwd["sets"][i][:args.prompt]).any(-1).sum())
        print(f"{i:5d}  {rel:16.5f}  {str(agree):>16s}  "
              f"{float(fwd['margin'][i][pos]):14.3e}  {flips:6d} of "
              f"{args.prompt}", flush=True)
    rel = float((got - ref).abs().max() / ref.std())
    agree = int(got[:cfg.vocab].argmax()) == int(ref[:cfg.vocab].argmax())
    print(f"logits: max|decode - forward| / std = {rel:.5f}, argmax "
          f"{'agrees' if agree else 'differs'} | {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
