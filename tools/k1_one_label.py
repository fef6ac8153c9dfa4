#!/usr/bin/env python3
"""K1 at one label, the one-label schedule against the label schedule.

    python3 tools/k1_one_label.py [--seed 0] [--tiers fast,exact]   # GPU

Every K1 launch of a train step with ``grad_reduce`` and ``norm_policy``
set has one label.  This script makes streams of those launches' shapes
from the leaves of stablelm-1.6b (full width for fast, compensated and
exact; n_layers=2 for exact2 and procrastinate, as ``chip_smoke.py``
trains them), random domain values from ``--seed``, and for each tier:

  * the 12 ``grad_reduce`` launches: (4, |leaf|) at B = 1;
  * the 25 ``global_norm`` launches: per leaf (ceil(|leaf| / 1,024),
    1,024) and (1,024, 1) at B = 512, then (12, 1) at B = 512.

Each launch runs through ``segsum_policy_cuda`` (the one-label schedule)
and through the label schedule (``segsum_policy_launch`` with one label:
the pre-pass, one 16-column label tile a CUDA block), held bitwise to
each other and timed (CUDA-event medians of 5 after a warm-up, the two in
turns: label, one-label, one-label, label), beside ``torch.sum(0)`` on
the same stream where it computes the same function (the f32 tiers: not
the same order; exact: the same int32 sums) and the bound (bytes the
launch must move over 3.35 TB/s).  It prints the sums over each caller's
launches, per tier, and the card's name and power limit first.  For the
largest stream of each caller it also prints each CUDA kernel's device
time (``torch.profiler``), and last the host's microseconds per call of
K1 and of ``torch.sum`` on a small stream, and of the calls the launcher
makes before it launches (a CUDA event brackets host time too where the
card waits).
"""

from __future__ import annotations

import argparse
import dataclasses
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
TIERS = ("fast", "compensated", "exact", "exact2", "procrastinate")
REPS = 5


def cuda_ms(fn, reps=REPS):
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def kernel_split(fn, reps=3):
    """Device microseconds per call of each CUDA kernel ``fn`` launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0) or \
            getattr(e, "cuda_time_total", 0)
        if t:
            m = re.search(r"wide_\w+?_kernel|segsum_policy_kernel|"
                          r"block_ranges_kernel", e.key)
            key = m[0] if m else e.key[:40]
            out[key] = out.get(key, 0.0) + t / reps
    return out


def host_us(fn, n=200):
    """Host microseconds per call of ``fn`` (a loop of n calls, the card
    synchronized before and after, not inside)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def leaf_sizes(tier):
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import convert
    cfg = get_config("stablelm-1.6b")
    if tier in ("exact2", "procrastinate"):
        cfg = dataclasses.replace(cfg, n_layers=2)
    named = dict(M.init_params(cfg, device="meta").named_parameters())
    return [v.numel() for v in convert.to_reference(cfg, named).values()]


def launches(tier):
    """(caller, rows, raw width, block_rows) of a step's K1 launches."""
    out = []
    sizes = leaf_sizes(tier)
    for n in sizes:
        out.append(("grad_reduce", 4, n, 1))
    for n in sizes:
        w = max(1, min(n, 1024))
        out.append(("global_norm", -(-n // w), w, 512))
        out.append(("global_norm", w, 1, 512))
    out.append(("global_norm", len(sizes), 1, 512))
    return out


def label_schedule(values, ids, block, pol):
    """The label schedule at one label: ``segsum_policy_launch`` as
    ``segsum_policy_cuda`` called it before the one-label schedule."""
    import torch
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import jugglepac_segsum as K
    n, w = values.shape
    carry = tuple(torch.empty(c.shape, dtype=c.dtype, device=values.device)
                  for c in pol.init(1, w, device="meta"))
    ct, st, _ = K.launch_shape(pol, 1, w)
    chunk = 0 if pol.integer else ops.tree_rows_for(block, 1)
    ranges = torch.empty((-(-n // block), 2), dtype=torch.int32,
                         device=values.device)
    ptrs = [c.data_ptr() for c in carry] + [None] * (4 - len(carry))
    rc = _build.load("segsum").segsum_policy_launch(
        K._TIERS[pol.name], values.data_ptr(), ids.data_ptr(),
        ranges.data_ptr(), *ptrs, n, block, 1, 0, w // pol.parts, 1,
        st, ct, chunk, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"label schedule launch failed: CUDA error {rc}")
    return carry


def domain(pol, n, w, gen, dev):
    import torch
    if pol.name == "exact":
        return torch.randint(-2 ** 20, 2 ** 20, (n, w), generator=gen,
                             device=dev, dtype=torch.int32)
    if pol.name == "exact2":       # integers in f32, as q and the digits
        return torch.randint(-2 ** 20, 2 ** 20, (n, w), generator=gen,
                             device=dev, dtype=torch.float32)
    if pol.name == "procrastinate":
        return torch.randint(-2 ** 7, 2 ** 7, (n, w), generator=gen,
                             device=dev, dtype=torch.int32)
    return torch.randn((n, w), generator=gen, device=dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--tiers", default=",".join(TIERS))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_one_label: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.reduce import get_policy
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    for tier in args.tiers.split(","):
        pol = get_policy(tier)
        sums = {}
        plan = launches(tier)
        largest = {c: max((x for x in plan if x[0] == c),
                          key=lambda x: x[1] * x[2])
                   for c in ("grad_reduce", "global_norm")}
        for caller, n, d, block in plan:
            w = pol.parts * d
            vals = domain(pol, n, w, gen, dev)
            ids = torch.zeros(n, dtype=torch.int32, device=dev)
            new = K.segsum_policy_cuda(vals, ids, 1, policy=pol,
                                       block_rows=block)
            old = label_schedule(vals, ids, block, pol)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(new, old))
            if not same:
                print(f"FAIL {tier} {caller} ({n}, {w}) B={block}: the "
                      "two schedules differ", flush=True)
                return 1
            t_old = cuda_ms(lambda: label_schedule(vals, ids, block, pol))
            t_new = cuda_ms(lambda: K.segsum_policy_cuda(
                vals, ids, 1, policy=pol, block_rows=block))
            t_new = min(t_new, cuda_ms(lambda: K.segsum_policy_cuda(
                vals, ids, 1, policy=pol, block_rows=block)))
            t_old = min(t_old, cuda_ms(lambda: label_schedule(
                vals, ids, block, pol)))
            lib = None
            if tier in ("fast", "compensated", "exact"):
                lib = cuda_ms(lambda: vals.sum(0, dtype=vals.dtype))
            out = sum(c.numel() * 4 for c in new)
            bound = (n * 4 + n * w * 4 + out) / HBM_BYTES_PER_S * 1e3
            s = sums.setdefault(caller, [0, 0.0, 0.0, 0.0, 0.0])
            s[0] += 1
            s[1] += t_new
            s[2] += t_old
            s[3] += bound
            s[4] = None if lib is None or s[4] is None else s[4] + lib
            print(f"{tier} {caller} ({n}, {w}) B={block}: one-label "
                  f"{t_new:.4f} ms ({K.wide_plan(pol, w, n, block).kernels}"
                  f" CUDA kernels), label schedule {t_old:.4f} ms, bound "
                  f"{bound:.4f} ms, torch.sum "
                  f"{'n/a' if lib is None else f'{lib:.4f} ms'}; bitwise",
                  flush=True)
            if largest[caller] == (caller, n, d, block):
                split = kernel_split(lambda: K.segsum_policy_cuda(
                    vals, ids, 1, policy=pol, block_rows=block))
                print(f"split {tier} {caller} ({n}, {w}) B={block}: "
                      + ", ".join(f"{k} {v:.1f} us" for k, v in
                                  split.items()), flush=True)
            del vals, ids, new, old
            torch.cuda.empty_cache()
        for caller, (k, t_new, t_old, bound, lib) in sums.items():
            print(f"SUM {tier} {caller}: {k} launches, one-label "
                  f"{t_new:.3f} ms, label schedule {t_old:.3f} ms, bound "
                  f"{bound:.3f} ms, torch.sum "
                  f"{'n/a' if lib is None else f'{lib:.3f} ms'} | {smi}",
                  flush=True)
    pol = get_policy("fast")
    small = torch.randn((12, 1), generator=gen, device=dev)
    row = torch.randn((4, 1024), generator=gen, device=dev)
    z12, z4 = (torch.zeros(k, dtype=torch.int32, device=dev) for k in (12, 4))
    costs = {
        "K1 fast (12, 1) B=512": lambda: K.segsum_policy_cuda(
            small, z12, 1, policy=pol, block_rows=512),
        "K1 fast (4, 1024) B=1": lambda: K.segsum_policy_cuda(
            row, z4, 1, policy=pol, block_rows=1),
        "torch.sum(0) (12, 1)": lambda: small.sum(0),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch.empty((1, 1024))": lambda: torch.empty((1, 1024), device=dev),
        "policy.init(1, 1024, meta)": lambda: pol.init(1, 1024,
                                                       device="meta"),
    }
    print("host us per call: " + ", ".join(
        f"{k} {host_us(f):.1f}" for k, f in costs.items()) + f" | {smi}",
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
