#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Drives the port's main path, ``repro_torch.reduce(values, segment_ids=,
num_segments=1024, policy=p)``, once per accuracy tier on one NVIDIA GPU,
at N=4,000,000 rows x D=64 f32 in 1,024 back-to-back variable-length sets
(about 1% of rows labeled ``OUT_OF_RANGE_LABEL``, magnitudes spread over
2^-20..2^20, all drawn from ``--seed``).  Phases, in order; any failure
exits nonzero:

1. device — the card's name and power limit, as nvidia-smi prints them;
2. build  — every CUDA source of the path, one nvcc each, in parallel;
3. kernel against its plain version — K1 and ``segsum_policy_torch`` on
   the card, bitwise, for 5 tiers x {dot, lanes} x block sizes
   {64, 128, 512} at N=65,536, D=16, S=48, plus exact2 at S=4,096, D=64
   (many label tiles);
4. main path — each tier's result against a float64 segment sum on the
   card, within the tier's documented bound; K1 launched in every tier's
   run (launch counts reset just before the call, read just after);
   integer tiers bitwise across block sizes 128 and 512; ``op="mean"``
   and ``op="moments"`` on exact2;
5. timings — CUDA events, warm-up then median: end-to-end ``reduce``, K1,
   its plain version, and one PyTorch library call where one computes
   the same function; the least time the card could take (bytes moved
   over 3.35 TB/s, or operations over 67 T/s, whichever is larger).

The line before the last is the JSON kernel table; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the rest of
the repository beside it, the script exits nonzero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

TIERS = ("fast", "compensated", "exact", "exact2", "procrastinate")
INT_TIERS = ("exact", "exact2", "procrastinate")
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP32_OPS_PER_S = 67e12             # H100 SXM, outside the tensor cores
U = 2.0 ** -24
#: the main path's size: rows (not a multiple of 512), columns, sets
N_ROWS, WIDTH, SEGMENTS = 4_000_000, 64, 1024
#: timed repetitions of each call (after one warm-up), median kept
REPS = 5
#: exact2's mean against the float64 mean, relative: one ulp of the
#: exact2 sum and half an ulp of the f32 division, rounded up to 2 ulp
MEAN_REL = 2.0 ** -22


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def device_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1):
    """Median milliseconds of ``fn()`` by CUDA events (after warm-up)."""
    import torch
    for _ in range(warmup):
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
    times.sort()
    return times[len(times) // 2]


def make_stream(n, d, s, seed, device):
    """values (n, d) f32, ids (n,) int32: s back-to-back sets with lengths
    drawn from ``seed``, ~1% sentinel rows, magnitudes 2^-20..2^20."""
    import torch
    from repro_torch.core.segmented import segments_from_lengths
    from repro_torch.reduce import OUT_OF_RANGE_LABEL
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w = torch.rand(s, generator=g, device=device, dtype=torch.float64) + 0.05
    lengths = torch.floor(w / w.sum() * (n - s)).to(torch.int64) + 1
    lengths[-1] += n - int(lengths.sum())
    ids = segments_from_lengths(lengths, n)
    drop = torch.rand(n, generator=g, device=device) < 0.01
    ids = torch.where(drop, torch.full_like(ids, OUT_OF_RANGE_LABEL), ids)
    mag = torch.randint(-20, 21, (n, d), generator=g, device=device)
    vals = torch.randn(n, d, generator=g, device=device) \
        * torch.exp2(mag.to(torch.float32))
    return vals.contiguous(), ids.contiguous()


def f64_reference(vals, ids, s):
    """Per-segment float64 sums, |x| sums and counts on the card."""
    import torch
    keep = ids >= 0
    safe = torch.where(keep, ids, torch.full_like(ids, s)).to(torch.int64)
    v = vals.to(torch.float64)
    z = torch.zeros((s + 1, vals.shape[1]), dtype=torch.float64,
                    device=vals.device)
    tot = z.clone().index_add_(0, safe, v)[:s]
    ab = z.index_add_(0, safe, v.abs())[:s]
    cnt = torch.bincount(safe, minlength=s + 1)[:s].to(torch.float64)
    return tot, ab, cnt


def tier_bound(tier, ref, absum, cnt, blocks_per_seg, ctx, block):
    """Each tier's documented error bound (README's policy table), per
    cell, plus the float64 reference's own rounding."""
    import torch
    ulp = torch.abs(ref.to(torch.float32)).to(torch.float64)
    ulp = torch.nextafter(ulp.to(torch.float32),
                          torch.tensor(float("inf"), device=ref.device)) \
        .to(torch.float64) - ulp
    err64 = cnt[:, None] * 2.0 ** -52 * absum
    if tier == "exact2":
        return ulp + err64
    if tier == "procrastinate":         # absolute N * 2^-49 of the max
        return ulp + err64 + cnt[:, None] * 2.0 ** (int(ctx) - 48)
    if tier == "exact":                 # half a quantum per row
        return ulp + err64 + cnt[:, None] * 0.5 / float(ctx)
    depth = math.log2(block) + 2
    if tier == "fast":                  # tree, lanes and carry adds
        depth += blocks_per_seg[:, None]
    return ulp + err64 + depth * U * absum


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False: this smoke runs "
                    "only on a CUDA device")
    try:
        import repro_torch
        from repro_torch.kernels import _build
        from repro_torch.kernels import jugglepac_segsum as K
        from repro_torch.reduce import (get_policy, mask_out_of_range,
                                        plan_program)
    except ImportError as e:
        return fail(f"cannot import the port ({e}); run from the root of "
                    "the repository")
    dev = torch.device("cuda")

    # 1. device
    smi = device_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}",
          flush=True)

    # 2. build
    built = _build.build_all()
    for name, info in built.items():
        print(f"build {name}.cu: {info['seconds']:.1f} s", flush=True)
        for line in info["report"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {line.strip()}")

    # 3. K1 against its plain version, bitwise
    errs = {t: 0.0 for t in TIERS}
    cases = [(t, c, b, 65536, 16, 48) for t in TIERS
             for c in ("dot", "lanes") for b in (64, 128, 512)]
    cases.append(("exact2", "lanes", 512, 65536, 64, 4096))
    cases.append(("exact2", "dot", 512, 65536, 64, 4096))
    for tier, contrib, block, n, d, s in cases:
        vals, ids = make_stream(n, d, s, args.seed + 1, dev)
        pol = get_policy(tier)
        dom, _ = pol.prepare(vals, n)
        prog = plan_program(pol, num_segments=s, domain_width=dom.shape[1],
                            block_size=block, contrib=contrib)
        kern = K.segsum_policy_cuda(dom, ids, s, policy=pol, program=prog,
                                    block_rows=block)
        plain = K.segsum_policy_torch(dom, ids, s, policy=pol, program=prog,
                                      block_rows=block)
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(kern, plain))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(kern, plain))
        errs[tier] = max(errs[tier], err)
        ct, st, grid = K.launch_shape(pol, s, dom.shape[1], prog)
        print(f"check {tier:13s} {contrib:5s} B={block:3d} N={n} D={d} "
              f"S={s}: grid {grid[0]}x{grid[1]} (label tile {st}, "
              f"column tile {ct}) max|kernel-plain|={err:g} "
              f"{'bitwise' if ok else 'DIFFER'}", flush=True)
        if not ok:
            return fail(f"K1 differs from its plain version: {tier} "
                        f"{contrib} B={block} S={s}")
        del vals, ids, dom, kern, plain

    # 4. the main path at full size
    n, d, s = N_ROWS, WIDTH, SEGMENTS
    t0 = time.perf_counter()
    vals, ids = make_stream(n, d, s, args.seed, dev)
    ref, absum, cnt = f64_reference(vals, ids, s)
    torch.cuda.synchronize()
    print(f"main path: N={n} D={d} S={s} ({(ids < 0).sum().item()} "
          f"sentinel rows), data {time.perf_counter() - t0:.1f} s",
          flush=True)
    bsafe = torch.where(ids >= 0, ids, torch.full_like(ids, s)).to(torch.int64)
    blk = torch.arange(n, device=dev) // 512
    pairs = torch.unique(blk * (s + 1) + bsafe)
    blocks_per_seg = torch.bincount(pairs % (s + 1), minlength=s + 1)[:s] \
        .to(torch.float64)
    launches_of = {}
    for tier in TIERS:
        pol = get_policy(tier)
        K.LAUNCHES = 0
        out = repro_torch.reduce(vals, segment_ids=ids, num_segments=s,
                                 policy=tier)
        torch.cuda.synchronize()
        launches = K.LAUNCHES
        if launches < 1:
            return fail(f"{tier}: the main path did not launch K1")
        # the context reduce built: from the max |value| of kept rows
        ctx = pol.prepare_ctx(vals[ids >= 0].abs().max(), n) \
            if pol.needs_max_stat else None
        bound = tier_bound(tier, ref, absum, cnt, blocks_per_seg, ctx, 512)
        err = (out.double() - ref).abs()
        worst = float((err / bound).max())
        finite = bool(torch.isfinite(out).all())
        print(f"main {tier:13s}: launches={launches} shape "
              f"{tuple(out.shape)} max|out-f64|={float(err.max()):.6g} "
              f"max err/bound={worst:.4f}", flush=True)
        if out.shape != (s, d) or not finite or worst > 1.0:
            return fail(f"{tier}: result outside its bound "
                        f"(err/bound {worst}, finite {finite})")
        if tier in INT_TIERS:
            again = repro_torch.reduce(vals, segment_ids=ids, num_segments=s,
                                       policy=tier, block_size=128)
            if not torch.equal(again, out):
                return fail(f"{tier}: block sizes 128 and 512 differ")
            print(f"main {tier:13s}: block sizes 128 and 512 bitwise equal",
                  flush=True)
        launches_of[tier] = launches
    mean = repro_torch.reduce(vals, segment_ids=ids, num_segments=s,
                              op="mean", policy="exact2")
    mom = repro_torch.reduce(vals, segment_ids=ids, num_segments=s,
                             op="moments", policy="exact2")
    want = ref / cnt.clamp(min=1)[:, None]

    def rel_err(x):
        return float(((x.double() - want).abs()
                      / (want.abs() + 1e-30)).max())

    # moments folds [v | v*v] under one scale, chosen from the larger
    # v*v, so its mean may differ from op="mean" in the last bit (the
    # reference's does too; the CPU tests hold the port's moments to its
    # bits).  Both are held to the float64 mean within MEAN_REL.
    rel, mrel = rel_err(mean), rel_err(mom[:, 0])
    ok = (mean.shape == (s, d) and mom.shape == (s, 2, d)
          and bool(torch.isfinite(mom).all()) and rel < MEAN_REL
          and mrel < MEAN_REL and bool((mom[:, 1] >= 0).all()))
    print(f"main exact2 mean/moments: shapes {tuple(mean.shape)} "
          f"{tuple(mom.shape)}, max rel err vs float64: mean {rel:.3g}, "
          f"moments' mean {mrel:.3g} (limit {MEAN_REL:.3g})", flush=True)
    if not ok:
        return fail("exact2 mean/moments check")
    del mean, mom

    # 5. timings
    kernels = []
    for tier in TIERS:
        pol = get_policy(tier)
        e2e = cuda_ms(lambda: repro_torch.reduce(
            vals, segment_ids=ids, num_segments=s, policy=tier), REPS)
        mids = mask_out_of_range(ids, s)
        kv = torch.where((mids >= 0)[:, None], vals, torch.zeros((),
                                                           device=dev))
        dom, _ = pol.prepare(kv, n)
        del kv
        w = dom.shape[1]
        prog = plan_program(pol, num_segments=s, domain_width=w,
                            block_size=512)
        call = lambda: K.segsum_policy_cuda(  # noqa: E731
            dom, mids, s, policy=pol, program=prog, block_rows=512)
        kern_ms = cuda_ms(call, REPS)
        _, st, grid = K.launch_shape(pol, s, w, prog)
        kern = call()
        pad = (-n) % 512
        pdom = torch.cat([dom, dom.new_zeros((pad, w))]) if pad else dom
        pids = torch.cat([mids, mids.new_full((pad,), -1)]) if pad else mids
        t0 = time.perf_counter()
        plain = K.segsum_policy_torch(pdom, pids, s, policy=pol,
                                      program=prog, block_rows=512)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        del pdom, pids
        perr = max(float((a.double() - b.double()).abs().max())
                   for a, b in zip(kern, plain))
        if not all(torch.equal(a, b) for a, b in zip(kern, plain)):
            return fail(f"{tier}: K1 differs from its plain version at the "
                        "main path's shape")
        errs[tier] = max(errs[tier], perr)
        lib_ms = None
        if tier in ("fast", "exact"):     # one index_add_ is this function
            safe = torch.where(mids >= 0, mids, torch.full_like(mids, s)) \
                .to(torch.int64)
            lib_ms = cuda_ms(lambda: torch.zeros(
                (s + 1, w), dtype=dom.dtype, device=dev).index_add_(
                    0, safe, dom), REPS)
        out_bytes = sum(c.numel() * 4 for c in kern)
        bytes_ = n * (w + 1) * 4 + out_bytes
        ops = n * w
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        print(f"time {tier:13s}: reduce {e2e:.3f} ms | K1 {kern_ms:.3f} ms, "
              f"{launches_of[tier]} launch(es)/call, grid "
              f"{grid[0]}x{grid[1]} ({grid[1]} label tiles of {st}) | bound "
              f"{bound_ms:.3f} ms ({bytes_ / 1e9:.3f} GB) | plain "
              f"{plain_ms:.1f} ms | library "
              f"{'n/a' if lib_ms is None else f'{lib_ms:.3f} ms'} | {smi}",
              flush=True)
        kernels.append({
            "name": f"segsum_policy_kernel<{tier}>", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segsum.cu",
            "replaces": "src/repro/kernels/jugglepac_segsum.py:77",
            "launches": launches_of[tier], "max_abs_err": errs[tier],
            "ms": kern_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                         >= ops / FP32_OPS_PER_S else "operations"),
            "library_ms": lib_ms})
        del dom, kern, plain
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # a phase raised: fail without a result line
        import traceback
        traceback.print_exc()
        sys.exit(fail(f"{type(e).__name__}: {e}"))
