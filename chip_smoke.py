#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Drives the port's paths on one NVIDIA GPU.  First the reduce
front door: ``repro_torch.reduce(values, segment_ids=, num_segments=1024,
policy=p)`` once per accuracy tier, at N=4,000,000 rows x D=64 f32 in
1,024 back-to-back variable-length sets (about 1% of rows labeled
``OUT_OF_RANGE_LABEL``, magnitudes spread over 2^-20..2^20).  Then
the kernel entry points ``repro_torch.kernels.flash_decode``,
``flash_decode_paged`` and ``intac_accum``, at mixtral-8x22b's attention
width (H=48, K=8, d=128) over a decode batch of 16 requests x 32,768 f32
KV rows, and at N=32,768 x D=6,144 for INTAC.  The serving path:
stablelm-1.6b at full width (bf16, random weights) through the port's
``Engine``, decode attention on K2 and ``mean_logprob`` on K1.  The
training path: stablelm-1.6b at full width through the port's train step
(the JugglePAC gradient juggler; microbatch gradients and the clip norm
on K1; AdamW), then its train state checkpointed and resumed
(``repro_torch.ckpt``), and the streaming accumulators at the INTAC
shape.  All data is drawn from ``--seed``.  Phases, in order; any
failure exits nonzero:

1. device — the card's name and power limit, as nvidia-smi prints them;
2. build  — every CUDA source, one nvcc each, in parallel;
3. K1 against its plain version — bitwise, for 5 tiers x {dot, lanes} x
   block sizes {64, 128, 512} at N=65,536, D=16, S=48, plus exact2 at
   S=4,096, D=64 (many label tiles), plus fast and compensated x {dot,
   lanes} x block sizes {96, 4,096} on a stream of back-to-back runs with
   10% -0.0 values, one label all -0.0 and an all-sentinel block, plus
   each integer tier on a domain near +-2^30 (ovf ends nonzero), on
   random labels at S=4,096, D=64, at D=20 and D=18 (16-byte and scalar
   loads), at a ragged N and at a label offset; in every case K1's
   pre-pass (each schedule block's label range) bitwise against its
   plain version too;
4. reduce main path — each tier's result against a float64 segment sum
   on the card, within the tier's documented bound; K1 launched in every
   tier's run (launch counts reset just before the call, read just
   after); integer tiers bitwise across block sizes 128 and 512;
   ``op="mean"`` and ``op="moments"`` on exact2;
5. reduce timings — ``reduce``, K1, its plain version, ``index_add_``;
   K1 fast and exact on all-sentinel labels (the pre-pass and range walk
   alone); K1 exact on a shuffled copy of the labels; the pre-pass
   bitwise at the main path's size;
6. decode, kernel against plain — K2, K3 and K4 bitwise against their
   plain versions at (B, H, K, S, d) = (3, 8, 2, 1,000, 64), K2 and K4
   also at split_rows 128, 384 and 1,024 (per = 1 and > 1, dead splits
   at both ends with window 200, a request with kv_len 0), and at full
   width;
7. decode, full width — ``flash_decode`` (block_kv=512, window None and
   4,096), ``partial_chunks=4`` and ``flash_decode_paged`` (ps=256, a
   shuffled ``PagedKVPool``), each within its stated bound of a float64
   materialized softmax and launching its kernel once (counts reset just
   before each call, read just after); the paged result bitwise equal to
   ``flash_decode(block_kv=256)`` on the assembled cache; three requests
   bitwise the same alone as in the batch (window None and 4,096);
   ``flash_decode`` bitwise ``partial_chunks=C`` where no split is dead;
   per path: C, the computed splits and the split-pass CUDA blocks;
8. INTAC — ``intac_accum`` launching K5 once, bitwise against its plain
   version, against an int64 column sum of the quantized values, and
   across block_rows 64 and 256;
9. decode and INTAC timings — each kernel and its wrapper, the plain
   version, and one PyTorch call computing the same function where there
   is one (``scaled_dot_product_attention`` for K2); K2 at window 4,096
   timed apart;
10. serve — ``Engine(max_len=1024, max_batch=8, prefill_chunk=32,
   logprob_policy="compensated")`` over 8 greedy requests (prompts of
   64-768 tokens from ``--seed``, 32 new tokens each): results in order
   and complete; K2 launched once a layer at every decode step and K1
   once, by ``_finalize_logprobs`` (counts set to 0 just before the run,
   read after each step and just after); K2 bitwise against its plain
   version on the engine's own cache and query, captured at one decode
   step of the middle layer; three requests alone in fresh Engines give
   bitwise the same tokens, and under ``exact2`` the same
   ``mean_logprob``; one request's last decode-step logits against
   ``forward(mode="prefill")`` over its tokens, max |diff| / std within
   ``SERVE_LOGIT_BOUND``; K1 bitwise at the ``mean_logprob`` shape;
   timings: a decode step, a prefill chunk, K2 per layer per step
   against its bound and SDPA, the parameter and cache bytes;
11. train — stablelm-1.6b's ``CONFIG`` (random weights from the seed)
   on one ``SyntheticLM`` batch of 8 x 256 tokens, 4 microbatches, AdamW
   on ``cosine_schedule(1e-4, 1, 5)``: (1) five juggler steps, the loss
   finite and lower at step 5 than at step 1, K1 launched by none;
   (2) one step's four microbatch gradients through
   ``accumulate_microbatch_grads`` bitwise (0 + ((g1 + g2) + (g3 + g4)))
   / 4 written out in bf16; (3) ``reduce_microbatch_grads`` and
   ``global_norm`` under ``exact`` on the ``cuda`` backend bitwise the
   ``blocked`` executor at full width, and under ``exact2`` and
   ``procrastinate`` at 2 layers (full width otherwise), every K1 launch
   of a step also bitwise its plain version; (4) a step with
   ``grad_reduce`` and ``norm_policy`` set launches K1 exactly 37 times
   (counts set to 0 just before, read just after); (5) ``fast`` and
   ``compensated`` through K1's one-label schedule on the largest leaf's
   ``grad_reduce`` stream (4 x 276,824,064, B = 1) and ``global_norm``
   stream (270,336 x 1,024, B = 512), bitwise their plain versions and
   timed beside ``torch.sum(0)`` in f32; timings: ms per juggler and
   exact step, tokens/s, peak memory, and K1's and the domain
   preparation's ms inside an exact step;
12. checkpoint — the same ``CONFIG`` cut to 4 layers (the embedding and
   head leaves full width; weights from the seed) after one
   juggler step: the train state (12 bf16 parameter leaves, 24 f32
   moments, the count; ``train.checkpoint_state``) saved with
   ``ckpt.save`` at zlib level 6 (seconds, GB on disk, GB/s); two steps
   from one state bitwise equal (the step is repeatable); the snapshot
   restored in place with ``restore_latest_valid`` (seconds) over the
   state a step later, every leaf bitwise, the model's parameters still
   views of the leaves; the next step from it bitwise the uninterrupted
   one; a newer snapshot with one flipped bit (``faults.corrupt_
   checkpoint``): ``restore`` raises ``CheckpointError``,
   ``restore_latest_valid`` falls back to the older step bitwise; the
   snapshots live under a temporary directory in ``build/``, removed at
   the end; no kernel of the port on this path;
13. accumulators — phase 8's stream (32,768 x 6,144, |x| < 2^5) pushed
   row by row on the card: ``LimbAccumulator`` at scale 2^24 bitwise
   K5's limbs in canonical form; ``Limb3Accumulator`` and
   ``BinAccumulator`` bitwise their CPU runs, state and finalize;
   ``KahanAccumulator`` and ``CascadeAccumulator(2)`` within their
   stated bounds of float64; each accumulator's ms (CUDA events).

Times are CUDA-event medians after a warm-up (plain versions: one
host-clock run; K1 on the train path: the sum over a step's launches,
each a median); the bound is the least time the card could take, bytes
moved over 3.35 TB/s or operations over 67 T/s, whichever is larger,
counting only what this run's data needs (the rows of kept labels; the
KV rows below each request's length, every row for K3, which emits every
chunk's raw partial; distinct pages).
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
#: decode width: mixtral-8x22b's attention (src/repro/configs/
#: mixtral_8x22b.py: d_model=6144, n_heads=48, n_kv_heads=8, window=4096)
HEADS, KV_HEADS, HEAD_DIM, WINDOW = 48, 8, 6144 // 48, 4096
#: decode batch: requests x KV rows per request (f32 K+V: 4.29 GB)
BATCH, KV_ROWS = 16, 32_768
#: INTAC: the wrapper's row limit x mixtral's d_model; magnitudes < 2^5
#: and scale 2^24 keep |x| * scale < 2^29, inside intac_accum.py's contract
INTAC_ROWS, INTAC_COLS, INTAC_SCALE = 1 << 15, 6144, 2.0 ** 24
#: the serve phase: stablelm-1.6b at full width (src/repro_torch/configs/
#: stablelm_1_6b.py, bf16), 8 slots of 1,024 context, 32-token prefill
#: chunks, 8 greedy requests with prompts in [64, 768] and 32 new tokens
SERVE_ARCH, SERVE_LEN, SERVE_SLOTS, SERVE_CHUNK = "stablelm-1.6b", 1024, 8, 32
SERVE_PROMPTS, SERVE_NEW = (64, 768), 32
#: requests also run alone in a fresh Engine (check 1)
SERVE_ALONE = (0, 3, 7)
#: decode step whose attention inputs are captured in the middle layer
#: (check 2): late enough that every slot decodes
SERVE_TAP_STEP = 24
#: check 3: max |decode logits - cache-free prefill logits| over the
#: prefill logits' std.  The two paths round bf16 activations after
#: different f32 sums (1,024-key K2 splits against one softmax; 1- and
#: 32-row products against an 800-row one), so they differ by a few bf16
#: ulps a layer (2^-8 relative each), compounded over 24 layers: a bound
#: of a quarter of the logits' spread leaves room for that and catches a
#: wrong position, mask or cache row, which moves logits by about their
#: whole spread.
SERVE_LOGIT_BOUND = 0.25


#: the train phase: stablelm-1.6b at full width, one ``SyntheticLM``
#: batch of B=8 x S=256 tokens from ``--seed``, 4 microbatches of 2 rows,
#: AdamW on ``cosine_schedule(1e-4, 1, 5)``.  At a peak of 1e-3 the first
#: step (every weight moved by about lr, against weights of about 0.02)
#: overshoots: the loss went from 11.86 to 19.42 and stood at 14.03 after
#: five steps on the card
TRAIN_ARCH, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MB = "stablelm-1.6b", 8, 256, 4
TRAIN_STEPS, TRAIN_LR = 5, 1e-4
#: exact2 and procrastinate train at n_layers=2: their digit domain of
#: one stacked mlp leaf at 24 layers would take 35 GB (8 planes x 4 rows
#: x 276,824,064 columns x 4 bytes), and 26 GB
TRAIN_CUT_LAYERS = 2
#: K1 launches of a dense model's step with grad_reduce and norm_policy
#: set: one microbatch mean per reference leaf (12), two launches a leaf
#: for the norm's sums of squares (24) and one across the leaves
TRAIN_LEAVES = 12
K1_PER_STEP = TRAIN_LEAVES + 2 * TRAIN_LEAVES + 1
#: the checkpoint phase keeps its two snapshots (steps 1 and 2) under a
#: temporary directory in the checkout's build/ and removes it
CKPT_KEEP = 2
#: the checkpoint phase runs stablelm-1.6b at 4 layers: at 24 its state
#: (16.4 GB) took 317-380 s of the phase, most of it deflating on the
#: host's 8 cores, and the script 633-800 s of its 1,200; at 4 the state
#: is 6.2 GB, 4.1 of them the full-width embedding and head leaves
CKPT_LAYERS = 4


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


def runs_stream(n, d, s, seed, device, block):
    """``make_stream`` with 10% of the values -0.0, every row of label 3
    -0.0, and rows [block, 2 * block) all sentinel: a whole schedule
    block with no label."""
    import torch
    from repro_torch.reduce import OUT_OF_RANGE_LABEL
    vals, ids = make_stream(n, d, s, seed, device)
    g = torch.Generator(device=device)
    g.manual_seed(seed + 7)
    neg = torch.rand(n, d, generator=g, device=device) < 0.1
    neg |= (ids == 3)[:, None]
    vals = torch.where(neg, torch.full_like(vals, -0.0), vals)
    ids[block:2 * block] = OUT_OF_RANGE_LABEL
    return vals.contiguous(), ids


def wrapping_domain(pol, n, d, seed, device):
    """A domain of the tier's dtype and width, half its entries near
    +-2^30, the rest below 2^20: block sums and carries wrap, so exact2's
    and procrastinate's ``ovf`` ends nonzero."""
    import torch
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    w = pol.parts * d
    near = (2 ** 30 - 64 * torch.randint(0, 1024, (n, w), generator=g,
                                         device=device)) \
        * (2 * torch.randint(0, 2, (n, w), generator=g, device=device) - 1)
    small = torch.randint(-2 ** 20, 2 ** 20, (n, w), generator=g,
                          device=device)
    dom = torch.where(torch.rand((n, w), generator=g, device=device) < 0.5,
                      near, small)
    return dom.to(torch.float32 if pol.name == "exact2" else torch.int32) \
        .contiguous()


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


def check(ok: bool, msg: str) -> None:
    """Fail the phase (the script exits nonzero, with no result line)."""
    if not ok:
        raise RuntimeError(msg)


def host_ms(fn):
    """Milliseconds of one ``fn()`` on the host clock, synchronized; and
    its result."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def same(a, b):
    """Bitwise equality of two tensors or tuples of them, and the largest
    absolute difference."""
    import torch
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    ok = all(torch.equal(x, y) for x, y in zip(a, b))
    if ok:          # no float64 copies of a carry that may take GBs
        return ok, 0.0
    err = max(float((x.double() - y.double()).abs().max())
              for x, y in zip(a, b))
    return ok, err


def shuffled_pool(kv_len, ps, nb, kheads, d, gen, dev):
    """A PagedKVPool filled with random pages through interleaved
    alloc/free, so each request's pages lie shuffled in the pool: a churn
    request is allocated before each request and freed after the next
    one.  Returns the K and V pools, the (B, nb) int32 page tables, and
    the logically assembled dense K and V (B, nb * ps, K, d)."""
    import torch
    from repro_torch.serve import PagedKVPool
    b = len(kv_len)
    pool = PagedKVPool(num_pages=b * nb + 4, page_size=ps)
    for bi in range(b):
        pool.alloc(1000 + bi, 2 * ps)
        pool.alloc(bi, int(kv_len[bi]))
        if bi:
            pool.free(1000 + bi - 1)
    tables = torch.tensor(
        [pool.page_table(bi, max_pages=nb).tolist() for bi in range(b)],
        dtype=torch.int32, device=dev)
    shape = (pool.num_pages, ps, kheads, d)
    kp = torch.randn(shape, generator=gen, device=dev)
    vp = torch.randn(shape, generator=gen, device=dev)
    idx = tables.clamp_min(0).long()
    k = kp[idx].reshape(b, nb * ps, kheads, d)
    v = vp[idx].reshape(b, nb * ps, kheads, d)
    return kp, vp, tables, k, v


def decode_f64(q, k, v, kv_len, window, sm_scale, block, calls):
    """The float64 materialized softmax attention, on the card, one
    request at a time, and each output's error bound for an f32 online
    softmax with ``calls`` rescale steps (blocks, plus partial merges).

    Per (b, h): E = max over valid rows j of
    (ceil(log2 d) + 2) u * sm_scale * sum_c |q_c k_jc| + 2u (|s_j| +
    |s_j - max s|)  (the score and its exponent's rounding), plus
    (8 + ceil(log2 block) + 6 * calls) u (exp within 2 ulp, products,
    trees, the per-step rescale and update roundings).  Then
    |o - o64| <= 2 E (sum_j p_j |v_jc| + |o64_c|), u = 2^-24, the factor
    2 covering second-order terms and the float64 reference's own error.
    """
    import torch
    from repro_torch.kernels import ops
    b, h, d = q.shape
    s_len, kheads = k.shape[1], k.shape[2]
    g = h // kheads
    ld = math.ceil(math.log2(d))
    lb = math.ceil(math.log2(block))
    bias = ops.length_bias(kv_len, s_len, window, q.device).double()
    o64 = torch.empty((b, h, d), dtype=torch.float64, device=q.device)
    bound = torch.empty_like(o64)
    for bi in range(b):
        qb = q[bi].double().reshape(kheads, g, d)
        kb, vb = k[bi].double(), v[bi].double()
        s = torch.einsum("kgd,skd->kgs", qb, kb) * sm_scale + bias[bi]
        ab = torch.einsum("kgd,skd->kgs", qb.abs(), kb.abs()) * sm_scale
        p = torch.softmax(s, -1)
        o = torch.einsum("kgs,skd->kgd", p, vb)
        pv = torch.einsum("kgs,skd->kgd", p, vb.abs())
        e = (ld + 2) * U * ab + 2 * U * (s.abs() + (s - s.amax(-1, True))
                                         .abs())
        e = torch.where(bias[bi] == 0, e, torch.zeros_like(e)).amax(-1)
        e = e + (8 + lb + 6 * calls) * U
        o64[bi] = o.reshape(h, d)
        bound[bi] = (2 * e[..., None] * (pv + o.abs())).reshape(h, d)
        del kb, vb, s, ab, p
    return o64, bound


def decode_phases(seed, dev, smi):
    """Phases 6, 7 and the decode half of 9; returns the kernel entries
    of K2, K3 and K4."""
    import importlib
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 2)

    # 6. kernel against plain at a small size
    b, h, kh, s_len, d = 3, 8, 2, 1000, 64
    q = torch.randn((b, h, d), generator=gen, device=dev)
    kv_len = torch.tensor([0, 517, 1000], device=dev)
    kp, vp, tables, k, v = shuffled_pool(kv_len, 128, 8, kh, d, gen, dev)
    k, v = k[:, :s_len].contiguous(), v[:, :s_len].contiguous()
    sc = d ** -0.5
    for window in (None, 200):
        bias = ops.length_bias(kv_len, s_len, window, dev)
        for block in (256, 512):
            cases = [("dense", fd.flash_decode_cuda, fd.flash_decode_torch,
                      {"block_kv": block})]
            cases += [("partial", fd.flash_decode_partial_cuda,
                       fd.flash_decode_partial_torch,
                       {"block_kv": block, "per": per}) for per in (1, 3)]
            for name, kern, plain, kw in cases:
                ok, err = same(kern(q, k, v, bias, sm_scale=sc, **kw),
                               plain(q, k, v, bias, sm_scale=sc, **kw))
                print(f"check {name:7s} (3, 8, 2, 1000, 64) window="
                      f"{window} {kw}: max|kernel-plain|={err:g} "
                      f"{'bitwise' if ok else 'DIFFER'}", flush=True)
                check(ok, f"{name} kernel differs from its plain version")
    # K2 and K4's splits: per = 1 (split_rows 128 at block 256 and 512,
    # ps 128) and > 1, dead splits at both ends (window 200), kv_len 0
    for window in (None, 200):
        pbias = ops.length_bias(kv_len, 8 * 128, window, dev)
        bias = ops.length_bias(kv_len, s_len, window, dev)
        for rows in (128, 384, 1024):
            for block in (128, 256):
                ok, err = same(fd.flash_decode_cuda(
                    q, k, v, bias, sm_scale=sc, block_kv=block,
                    split_rows=rows), fd.flash_decode_torch(
                    q, k, v, bias, sm_scale=sc, block_kv=block,
                    split_rows=rows))
                print(f"check dense   (3, 8, 2, 1000, 64) window={window} "
                      f"block_kv={block} split_rows={rows} (per "
                      f"{fd.split_shape(-(-s_len // block), block, rows)[0]}"
                      f"): max|kernel-plain|={err:g} "
                      f"{'bitwise' if ok else 'DIFFER'}", flush=True)
                check(ok, "dense kernel differs from its plain version")
            ok, err = same(fd.flash_decode_paged_cuda(
                q, kp, vp, pbias, tables, sm_scale=sc, split_rows=rows),
                fd.flash_decode_paged_torch(q, kp, vp, pbias, tables,
                                            sm_scale=sc, split_rows=rows))
            print(f"check paged   (3, 8, 2, 1024, 64) ps=128 window="
                  f"{window} split_rows={rows}: max|kernel-plain|={err:g} "
                  f"{'bitwise' if ok else 'DIFFER'}", flush=True)
            check(ok, "paged kernel differs from its plain version")
    del q, kp, vp, k, v

    # full width: a shuffled pool at ps=256 and its assembled dense cache
    b, h, kh, s_len, d = BATCH, HEADS, KV_HEADS, KV_ROWS, HEAD_DIM
    sc = d ** -0.5
    ps, nb = 256, KV_ROWS // 256
    q = torch.randn((b, h, d), generator=gen, device=dev)
    kv_len = torch.randint(1, s_len + 1, (b,), generator=gen, device=dev)
    kv_len[3] = 0
    kp, vp, tables, k, v = shuffled_pool(kv_len, ps, nb, kh, d, gen, dev)
    bias = ops.length_bias(kv_len, s_len, None, dev)
    print(f"decode: B={b} H={h} K={kh} d={d} S={s_len} f32, K+V "
          f"{2 * k.numel() * 4 / 1e9:.3f} GB, pool {kp.shape[0]} pages of "
          f"{ps}, kv_len {kv_len.tolist()}", flush=True)

    # 6. kernel against plain at full width (the plain runs are timed)
    per = 16
    full = {
        "dense": (lambda: fd.flash_decode_cuda(q, k, v, bias, sm_scale=sc,
                                               block_kv=512),
                  lambda: fd.flash_decode_torch(q, k, v, bias, sm_scale=sc,
                                                block_kv=512)),
        "partial": (lambda: fd.flash_decode_partial_cuda(
                        q, k, v, bias, sm_scale=sc, block_kv=512, per=per),
                    lambda: fd.flash_decode_partial_torch(
                        q, k, v, bias, sm_scale=sc, block_kv=512, per=per)),
        "paged": (lambda: fd.flash_decode_paged_cuda(q, kp, vp, bias, tables,
                                                     sm_scale=sc),
                  lambda: fd.flash_decode_paged_torch(q, kp, vp, bias,
                                                      tables, sm_scale=sc)),
    }
    plain_ms, errs = {}, {}
    for name, (kern, plain) in full.items():
        plain_ms[name], want = host_ms(plain)
        ok, errs[name] = same(kern(), want)
        print(f"check {name:7s} full width: max|kernel-plain|="
              f"{errs[name]:g} {'bitwise' if ok else 'DIFFER'}; plain "
              f"{plain_ms[name]:.1f} ms", flush=True)
        check(ok, f"{name} kernel differs from its plain version at full "
                  "width")
        del want
    torch.cuda.empty_cache()

    # 7. the main path: the public wrappers, counts reset around each call
    launches = {}

    def drive(mode, fn):
        for key in fd.LAUNCHES:
            fd.LAUNCHES[key] = 0
        out = fn()
        torch.cuda.synchronize()
        counts = dict(fd.LAUNCHES)
        check(counts[mode] == 1 and sum(counts.values()) == 1,
              f"{mode}: expected one launch of its kernel, got {counts}")
        launches[mode] = counts[mode]
        return out

    nbk = s_len // 512
    runs = [
        ("dense", "window=None", None, 512, nbk,
         lambda: ops.flash_decode(q, k, v, kv_len, sm_scale=sc,
                                  block_kv=512)),
        ("dense", f"window={WINDOW}", WINDOW, 512, nbk,
         lambda: ops.flash_decode(q, k, v, kv_len, sm_scale=sc,
                                  window=WINDOW, block_kv=512)),
        ("partial", "partial_chunks=4", None, 512, nbk + 4,
         lambda: ops.flash_decode(q, k, v, kv_len, sm_scale=sc,
                                  block_kv=512, partial_chunks=4)),
        ("paged", "paged ps=256", None, ps, nb,
         lambda: ops.flash_decode_paged(q, kp, vp, tables, kv_len,
                                        sm_scale=sc)),
    ]
    outs = {}
    for mode, label, window, block, calls, fn in runs:
        out = drive(mode, fn)
        o64, bound = decode_f64(q, k, v, kv_len, window, sc, block, calls)
        err = (out.double() - o64).abs()
        worst = float((err / bound).max())
        finite = bool(torch.isfinite(out).all())
        print(f"main {label:16s}: launches={launches[mode]} shape {tuple(out.shape)} "
              f"max|out-f64|={float(err.max()):.4g} max err/bound="
              f"{worst:.4f}", flush=True)
        check(out.shape == (b, h, d) and finite and worst <= 1.0,
              f"{label}: outside its bound of float64 (err/bound {worst})")
        outs[label] = out
        del o64, bound, err
    dense256 = drive("dense", lambda: ops.flash_decode(
        q, k, v, kv_len, sm_scale=sc, block_kv=ps))
    ok, err = same(outs["paged ps=256"], dense256)
    print(f"main paged vs flash_decode(block_kv=256): max|diff|={err:g} "
          f"{'bitwise' if ok else 'DIFFER'}", flush=True)
    check(ok, "paged result differs from flash_decode(block_kv=256)")
    del outs, dense256

    # 7. batch independence and the partial_chunks equality on the card
    for window in (None, WINDOW):
        batch = ops.flash_decode(q, k, v, kv_len, sm_scale=sc,
                                 window=window, block_kv=512)
        for bi in (0, 3, b - 1):
            alone = ops.flash_decode(q[bi:bi + 1], k[bi:bi + 1],
                                     v[bi:bi + 1], kv_len[bi:bi + 1],
                                     sm_scale=sc, window=window,
                                     block_kv=512)
            ok = torch.equal(alone[0], batch[bi])
            print(f"main request {bi} (kv_len {int(kv_len[bi])}) window="
                  f"{window}: alone vs in the batch "
                  f"{'bitwise' if ok else 'DIFFER'}", flush=True)
            check(ok, "a request's output depends on its batch")
    ngrp = (h // kh) // fd.group_rows(h // kh)
    _, c2 = fd.split_shape(nbk, 512)
    full_len = torch.full_like(kv_len, s_len)
    ok, err = same(ops.flash_decode(q, k, v, full_len, sm_scale=sc,
                                    block_kv=512),
                   ops.flash_decode(q, k, v, full_len, sm_scale=sc,
                                    block_kv=512, partial_chunks=c2))
    print(f"main kv_len=S (no dead split): flash_decode vs partial_chunks="
          f"{c2}: max|diff|={err:g} {'bitwise' if ok else 'DIFFER'}",
          flush=True)
    check(ok, "flash_decode differs from flash_decode(partial_chunks=C)")
    for label, blk, window, pl in (("dense window=None", 512, None, None),
                                   (f"dense window={WINDOW}", 512, WINDOW,
                                    None),
                                   ("paged ps=256", ps, None, None)):
        bias_w = ops.length_bias(kv_len, s_len, window, dev)
        nbl = s_len // blk
        per_l, c_l = fd.split_shape(nbl, blk)
        live = fd.split_liveness(bias_w, blk, nbl, per_l)
        print(f"splits {label}: per={per_l} C={c_l}; computed splits "
              f"{int(live.sum())} of {b * c_l}; split-pass CUDA blocks "
              f"launched {b * kh * ngrp * c_l} ({int(live.sum()) * kh * ngrp}"
              f" run past the liveness test)", flush=True)

    # 9. timings.  The bound counts what this run's data needs: request b
    # needs its kv_len[b] rows (a masked row after a valid one adds
    # exactly 0), all S rows where kv_len is 0 (its output is the mean of
    # V over them); K4 reads each distinct pool page those rows lie in
    # once (FREE_PAGE entries all clamp to page 0).
    lens = torch.where(kv_len > 0, kv_len, torch.full_like(kv_len, s_len))
    rows = int(lens.sum())
    row_bytes = 2 * kh * d * 4
    io_bytes = b * h * d * 4 * 2 + rows * 4           # q, out, bias rows
    need = torch.arange(nb, device=dev)[None, :] < -(-lens[:, None] // ps)
    pages = int(torch.unique(tables.clamp_min(0)[need]).numel())
    print(f"bound: {rows} of {b * s_len} KV rows needed (K3: all "
          f"{b * s_len}); paged: {pages} distinct pages of {ps} rows",
          flush=True)
    chunks = -(-nbk // per)
    sdpa = None
    major_minor = tuple(int(x) for x in
                        torch.__version__.split("+")[0].split(".")[:2])
    if major_minor >= (2, 5):          # enable_gqa arrived in torch 2.5
        k4 = k.permute(0, 2, 1, 3).contiguous()
        v4 = v.permute(0, 2, 1, 3).contiguous()
        mask = bias[:, None, None, :]
        q4 = q[:, :, None, :]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, k4, v4, attn_mask=mask, scale=sc, enable_gqa=True)
    timed = {
        "dense": (full["dense"][0],
                  lambda: ops.flash_decode(q, k, v, kv_len, sm_scale=sc,
                                           block_kv=512),
                  rows * row_bytes + io_bytes, sdpa, 72),
        # K3 emits every chunk's raw partial, masked or not (a masked
        # chunk's o is the sum of its V rows), so it must read every row
        "partial": (full["partial"][0],
                    lambda: ops.flash_decode(q, k, v, kv_len, sm_scale=sc,
                                             block_kv=512,
                                             partial_chunks=4),
                    b * s_len * (row_bytes + 4) + b * h * d * 4
                    + chunks * b * h * (d + 2) * 4, None, 92),
        "paged": (full["paged"][0],
                  lambda: ops.flash_decode_paged(q, kp, vp, tables, kv_len,
                                                 sm_scale=sc),
                  pages * ps * row_bytes + io_bytes + int(need.sum()) * 4,
                  None, 117),
    }
    entries = []
    for name, (kern, wrap, bytes_, lib, line) in timed.items():
        ops_ = (b * s_len if name == "partial" else rows) * h * (4 * d + 1)
        kern_ms = cuda_ms(kern, REPS)
        wrap_ms = cuda_ms(wrap, REPS)
        lib_ms = None if lib is None else cuda_ms(lib, REPS)
        lib_note = "n/a"
        if lib is not None:
            lib_err = float((lib()[:, :, 0].double()
                             - kern().double()).abs().max())
            lib_note = f"{lib_ms:.3f} ms (max|sdpa-kernel|={lib_err:.3g})"
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S) * 1e3
        print(f"time {name:7s}: kernel {kern_ms:.3f} ms | wrapper "
              f"{wrap_ms:.3f} ms | bound {bound_ms:.3f} ms "
              f"({bytes_ / 1e9:.3f} GB) | plain {plain_ms[name]:.1f} ms | "
              f"library {lib_note} | {smi}", flush=True)
        entries.append({
            "name": f"flash_decode_kernel<{name}>", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": f"src/repro/kernels/flash_decode.py:{line}",
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": kern_ms, "plain_ms": plain_ms[name], "bound_ms": bound_ms,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                         >= ops_ / FP32_OPS_PER_S else "operations"),
            "library_ms": lib_ms})
    # K2 at window 4,096, timed apart: a request needs its last
    # min(kv_len, 4,096) rows (all S where kv_len is 0)
    wbias = ops.length_bias(kv_len, s_len, WINDOW, dev)
    wrows = int(torch.where(kv_len > 0, kv_len.clamp(max=WINDOW),
                            torch.full_like(kv_len, s_len)).sum())
    wbytes = wrows * row_bytes + b * h * d * 4 * 2 + wrows * 4
    wbound = max(wbytes / HBM_BYTES_PER_S,
                 wrows * h * (4 * d + 1) / FP32_OPS_PER_S) * 1e3
    kern_ms = cuda_ms(lambda: fd.flash_decode_cuda(
        q, k, v, wbias, sm_scale=sc, block_kv=512), REPS)
    wrap_ms = cuda_ms(lambda: ops.flash_decode(
        q, k, v, kv_len, sm_scale=sc, window=WINDOW, block_kv=512), REPS)
    print(f"time dense window={WINDOW}: kernel {kern_ms:.3f} ms | wrapper "
          f"{wrap_ms:.3f} ms | bound {wbound:.3f} ms ({wbytes / 1e9:.3f} GB,"
          f" {wrows} rows) | {smi}", flush=True)
    del q, k, v, kp, vp, tables, bias, wbias
    torch.cuda.empty_cache()
    return entries


def intac_phase(seed, dev, smi):
    """Phase 8 and the INTAC half of 9; returns K5's kernel entry."""
    import importlib
    import torch
    from repro_torch.kernels import ops
    ia = importlib.import_module("repro_torch.kernels.intac_accum")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)
    n, d, scale = INTAC_ROWS, INTAC_COLS, INTAC_SCALE
    mag = torch.randint(-12, 4, (n, d), generator=gen, device=dev)
    x = (torch.randn((n, d), generator=gen, device=dev)
         * torch.exp2(mag.to(torch.float32))).clamp(-31.0, 31.0)
    del mag
    ia.LAUNCHES = 0
    limbs = ops.intac_accum(x, scale)
    torch.cuda.synchronize()
    launches = ia.LAUNCHES
    check(launches == 1, f"intac_accum: expected one launch, got {launches}")
    plain_ms, plain = host_ms(lambda: ia.intac_accum_torch(x, scale))
    q64 = torch.round(x * scale).to(torch.int64).sum(0)
    ok_plain, err = same(limbs, plain)
    ok_int = torch.equal(limbs[0].long() * 32768 + limbs[1].long(), q64)
    ok_blk = torch.equal(ops.intac_accum(x, scale, block_rows=64), limbs)
    print(f"intac N={n} D={d} scale 2^{int(math.log2(scale))}: launches="
          f"{launches} shape {tuple(limbs.shape)}; kernel vs plain "
          f"{'bitwise' if ok_plain else 'DIFFER'}, vs int64 column sum "
          f"{'bitwise' if ok_int else 'DIFFER'}, block_rows 64 vs 256 "
          f"{'bitwise' if ok_blk else 'DIFFER'}", flush=True)
    check(ok_plain and ok_int and ok_blk, "INTAC check")
    kern_ms = cuda_ms(lambda: ia.intac_accum_cuda(x, scale), REPS)
    wrap_ms = cuda_ms(lambda: ops.intac_accum(x, scale), REPS)
    bytes_ = n * d * 4 + 2 * d * 4
    ops_ = 8 * n * d
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S) * 1e3
    print(f"time intac  : kernel {kern_ms:.3f} ms | wrapper {wrap_ms:.3f} "
          f"ms | bound {bound_ms:.3f} ms ({bytes_ / 1e9:.3f} GB) | plain "
          f"{plain_ms:.1f} ms | library n/a | {smi}", flush=True)
    return {"name": "intac_accum_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/intac_accum.cu",
            "replaces": "src/repro/kernels/intac_accum.py:26",
            "launches": launches, "max_abs_err": err, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                         >= ops_ / FP32_OPS_PER_S else "operations"),
            "library_ms": None}


def serve_phase(seed, dev, smi):
    """Phase 10: the serving path at stablelm-1.6b's full width through
    the port's ``Engine``; returns the kernel entries of K2 and K1 on
    this path."""
    import importlib
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.reduce import get_policy, mask_out_of_range, \
        plan_program
    from repro_torch.serve import Engine, Request
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    cfg = get_config(SERVE_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 11)
    t0 = time.perf_counter()
    model = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = torch.Generator()
    host.manual_seed(seed + 12)
    lens = torch.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1,
                         (SERVE_SLOTS,), generator=host).tolist()
    requests = [Request(prompt=torch.randint(1, cfg.vocab, (n,),
                                             generator=host).tolist(),
                        max_new_tokens=SERVE_NEW) for n in lens]

    def engine(policy):
        return Engine(cfg, model, max_len=SERVE_LEN, max_batch=SERVE_SLOTS,
                      prefill_chunk=SERVE_CHUNK, logprob_policy=policy,
                      device=dev)

    # taps (forward hooks): decode steps seen by layer 0; the middle
    # layer's K2 inputs and output at one step; the model's last
    # decode-step logits
    layer = cfg.n_layers // 2
    tap = {"steps": 0, "mid": 0, "logits": None}

    def count_steps(mod, args, out):
        tap["steps"] += 1

    def capture(mod, args, out):
        tap["mid"] += 1
        if tap["mid"] == SERVE_TAP_STEP:
            q, k, v, kv_len, sc = args
            tap.update(q=q.clone(), k=k.clone(), v=v.clone(),
                       kv_len=kv_len.clone(), sc=sc, out=out.clone())

    def last_logits(mod, args, kwargs, out):
        if kwargs.get("mode") == "decode" and args[0].shape[1] == 1:
            tap["logits"] = out[0][:, 0].clone()

    hooks = [model.blocks[0].core.decode_attn.register_forward_hook(
                 count_steps),
             model.blocks[layer].core.decode_attn.register_forward_hook(
                 capture)]
    print(f"serve: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}), "
          f"{sum(p.numel() for p in model.parameters())} parameters "
          f"({M.param_bytes(model) / 1e9:.3f} GB) drawn in {init_s:.2f} s; "
          f"{SERVE_SLOTS} slots x {SERVE_LEN} context, prefill chunks of "
          f"{SERVE_CHUNK}; prompts {lens}, {SERVE_NEW} new tokens each, "
          f"greedy", flush=True)

    # the main path: counts set to 0 just before, read just after; K1's
    # count is read after every engine step too (0 until the run's end,
    # when _finalize_logprobs takes the mean)
    eng = engine("compensated")
    stream = {}
    k1_during = []

    def on_step(e, step):
        k1_during.append(K.LAUNCHES)
        stream["vals"], stream["ids"] = list(e._lp_vals), list(e._lp_ids)

    rids = [eng.submit(r) for r in requests]
    for key in fd.LAUNCHES:
        fd.LAUNCHES[key] = 0
    K.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2_launches, k1_launches = dict(fd.LAUNCHES), K.LAUNCHES
    for hk in hooks:
        hk.remove()
    steps = tap["steps"]
    new = sum(len(r.tokens) - r.prompt_len for r in results)
    print(f"main serve: {len(results)} results in order "
          f"{[r.rid for r in results]}, {new} tokens, {steps} decode "
          f"steps, {eng._clock} engine steps in {wall * 1e3:.1f} ms; K2 "
          f"launches {k2_launches['dense']} (want {steps} x "
          f"{cfg.n_layers}), K1 launches {k1_launches} (after each step: "
          f"{sorted(set(k1_during))}); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"mean_logprob {[round(r.mean_logprob, 4) for r in results]}",
          flush=True)
    check([r.rid for r in results] == rids
          and all(len(r.tokens) - r.prompt_len == SERVE_NEW
                  and r.tokens[:r.prompt_len] == q.prompt
                  and all(0 <= t < cfg.vocab for t in r.tokens)
                  and math.isfinite(r.mean_logprob)
                  for r, q in zip(results, requests)),
          "serve: results out of order, short, out of the vocabulary or "
          "with a non-finite mean_logprob")
    # 4. K2 on every decode step of every layer; K1 for the mean alone
    check(steps >= SERVE_NEW - 1
          and k2_launches == {"dense": steps * cfg.n_layers, "partial": 0,
                              "paged": 0},
          f"serve: K2 launches {k2_launches} for {steps} decode steps")
    check(k1_launches == 1 and set(k1_during) == {0},
          f"serve: the mean_logprob reduce did not run on K1 (launches "
          f"{k1_launches}, during the steps {sorted(set(k1_during))})")
    print(f"check mean_logprob on the cuda backend: K1 launched "
          f"{k1_launches} time, by _finalize_logprobs (0 after every "
          f"step)", flush=True)

    # 2. K2 against its plain version on the engine's own cache and query
    q, k, v, kv_len, sc = (tap[x] for x in ("q", "k", "v", "kv_len", "sc"))
    qf = q.float().contiguous()
    bias = ops.length_bias(kv_len, k.shape[1], None, dev)
    plain_ms, plain = host_ms(lambda: fd.flash_decode_torch(
        qf, k, v, bias, sm_scale=sc, block_kv=512))
    kern = fd.flash_decode_cuda(qf, k, v, bias, sm_scale=sc, block_kv=512)
    ok, k2_err = same(kern, plain)
    ok_engine = torch.equal(kern, tap["out"])
    print(f"check K2 at the serving shape (layer {layer}, decode step "
          f"{SERVE_TAP_STEP}: q {tuple(q.shape)} {q.dtype}, cache "
          f"{tuple(k.shape)} {k.dtype}, kv_len {kv_len.tolist()}): "
          f"max|kernel-plain|={k2_err:g} {'bitwise' if ok else 'DIFFER'}; "
          f"the engine's own output {'bitwise' if ok_engine else 'DIFFER'}",
          flush=True)
    check(ok and ok_engine, "serve: K2 differs from its plain version on "
                            "the engine's cache")

    # timings on the engine's final state: every slot active at its
    # length, each call writing the same row (the caches are not kept)
    lengths = eng._caches[0]["core"].length[0].clone()
    toks = torch.tensor([[r.tokens[-1]] for r in results], device=dev)
    active = torch.ones(SERVE_SLOTS, dtype=torch.bool, device=dev)
    with torch.no_grad():
        step_ms = cuda_ms(lambda: M.decode_step(
            model, toks, eng._caches, lengths, active=active), REPS)
        chunk = torch.tensor([requests[0].prompt[:SERVE_CHUNK]], device=dev)
        chunk_ms = cuda_ms(lambda: eng._prefill_chunk(
            0, chunk, 0, SERVE_CHUNK), REPS)
    k2_ms = cuda_ms(lambda: fd.flash_decode_cuda(
        qf, k, v, bias, sm_scale=sc, block_kv=512), REPS)
    rows = int(kv_len.clamp(max=k.shape[1]).sum())
    kh, d = k.shape[2], k.shape[3]
    h = q.shape[1]
    k2_bytes = rows * (2 * kh * d * 4 + 4) + 2 * q.numel() * 4
    k2_ops = rows * h * (4 * d + 1)
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S,
                   k2_ops / FP32_OPS_PER_S) * 1e3
    k4 = k.permute(0, 2, 1, 3).contiguous()
    v4 = v.permute(0, 2, 1, 3).contiguous()
    mask = bias[:, None, None, :]
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qf[:, :, None], k4, v4, attn_mask=mask, scale=sc), REPS)
    del k4, v4, mask
    print(f"time serve: decode step at B={SERVE_SLOTS} {step_ms:.3f} ms "
          f"({SERVE_SLOTS * 1e3 / step_ms:.1f} tokens/s decoding) | "
          f"{SERVE_CHUNK}-token prefill chunk {chunk_ms:.3f} ms | the run: "
          f"{new} tokens in {wall * 1e3:.1f} ms ({new / wall:.1f} "
          f"generated tokens/s, prefill included) | K2 per layer per step "
          f"{k2_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.2f} "
          f"MB: the f32 KV rows below each length), plain {plain_ms:.1f} "
          f"ms, SDPA {sdpa_ms:.4f} ms | parameters "
          f"{M.param_bytes(model) / 1e9:.3f} GB, caches "
          f"{M.cache_bytes(eng._caches) / 1e9:.3f} GB (f32 k/v) | {smi}",
          flush=True)
    entries = [{
        "name": "flash_decode_kernel<dense>/serve", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:72",
        "launches": k2_launches["dense"], "max_abs_err": k2_err,
        "ms": k2_ms, "plain_ms": plain_ms, "bound_ms": k2_bound,
        "bound_by": ("bytes" if k2_bytes / HBM_BYTES_PER_S
                     >= k2_ops / FP32_OPS_PER_S else "operations"),
        "library_ms": sdpa_ms}]
    del q, k, v, qf, bias, kern, plain
    tap.update(q=None, k=None, v=None, out=None)

    # K1 at the mean_logprob shape: the run's (step x slot) stream
    vals = torch.cat(stream["vals"])[:, None]
    ids = torch.from_numpy(np.concatenate(stream["ids"])).to(dev)
    nseg = len(requests)
    pol = get_policy("compensated")
    mids = mask_out_of_range(ids, nseg)
    dom, _ = pol.prepare(torch.where((mids >= 0)[:, None], vals,
                                     torch.zeros((), device=dev)), len(ids))
    prog = plan_program(pol, num_segments=nseg, domain_width=dom.shape[1],
                        block_size=512, op="mean")
    pad = (-len(ids)) % 512
    k1_plain_ms, k1_plain = host_ms(lambda: K.segsum_policy_torch(
        torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))]),
        torch.cat([mids, mids.new_full((pad,), -1)]), nseg, policy=pol,
        program=prog, block_rows=512))
    k1 = K.segsum_policy_cuda(dom, mids, nseg, policy=pol, program=prog,
                              block_rows=512)
    ok, k1_err = same(tuple(k1), tuple(k1_plain))
    k1_ms = cuda_ms(lambda: K.segsum_policy_cuda(
        dom, mids, nseg, policy=pol, program=prog, block_rows=512), REPS)
    kept = int((mids >= 0).sum())
    k1_bytes = len(ids) * 4 + kept * dom.shape[1] * 4 \
        + sum(c.numel() * 4 for c in k1)
    k1_bound = max(k1_bytes / HBM_BYTES_PER_S,
                   kept * dom.shape[1] / FP32_OPS_PER_S) * 1e3
    print(f"check K1 compensated at the mean_logprob shape ({len(ids)} "
          f"rows, {kept} kept, {nseg} sets): max|kernel-plain|={k1_err:g} "
          f"{'bitwise' if ok else 'DIFFER'}; kernel {k1_ms:.4f} ms, bound "
          f"{k1_bound:.4f} ms, plain {k1_plain_ms:.1f} ms | {smi}",
          flush=True)
    check(ok, "serve: K1 differs from its plain version at the "
              "mean_logprob shape")
    entries.append({
        "name": "segsum_policy_kernel<compensated>/serve", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/segsum.cu",
        "replaces": "src/repro/kernels/jugglepac_segsum.py:77",
        "launches": k1_launches, "max_abs_err": k1_err, "ms": k1_ms,
        "plain_ms": k1_plain_ms, "bound_ms": k1_bound,
        "bound_by": ("bytes" if k1_bytes / HBM_BYTES_PER_S
                     >= kept * dom.shape[1] / FP32_OPS_PER_S
                     else "operations"),
        "library_ms": None})
    del eng
    torch.cuda.empty_cache()

    # 1. batch independence: the same requests alone in fresh Engines,
    # greedy tokens bitwise; exact2's mean_logprob bitwise too
    batch2 = engine("exact2").generate(requests)
    torch.cuda.empty_cache()
    check([r.tokens for r in batch2] == [r.tokens for r in results],
          "serve: the exact2 batch's tokens differ from the first run's")
    hook = model.register_forward_hook(last_logits, with_kwargs=True)
    for i in SERVE_ALONE:
        alone = engine("exact2").generate([requests[i]])[0]
        torch.cuda.empty_cache()
        same_toks = alone.tokens == results[i].tokens
        same_lp = alone.mean_logprob == batch2[i].mean_logprob
        print(f"check request {i} (prompt {lens[i]}) alone vs in the "
              f"batch: tokens {'bitwise' if same_toks else 'DIFFER'}; "
              f"exact2 mean_logprob {alone.mean_logprob!r} / "
              f"{batch2[i].mean_logprob!r} "
              f"{'bitwise' if same_lp else 'DIFFER'}", flush=True)
        check(same_toks and same_lp,
              f"serve: request {i} depends on its batch")
    # 3. the last decode step's logits (cache, K2) against one
    # cache-free prefill forward over the same tokens (alone: slot 0)
    seq = torch.tensor([alone.tokens[:-1]], device=dev)
    with torch.no_grad():
        ref = M.forward(model, tokens=seq, mode="prefill")[0][0, -1]
    got = tap["logits"][0]
    hook.remove()
    rel = float((got - ref).abs().max() / ref.std())
    agree = int(got[:cfg.vocab].argmax()) == int(ref[:cfg.vocab].argmax())
    print(f"check request {SERVE_ALONE[-1]}'s last decode step (position "
          f"{seq.shape[1] - 1}) vs forward(mode='prefill') over its "
          f"{seq.shape[1]} tokens: max|diff| / std(logits) = {rel:.5f} "
          f"(bound {SERVE_LOGIT_BOUND}), std {float(ref.std()):.4f}, argmax "
          f"{'agrees' if agree else 'differs'}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= SERVE_LOGIT_BOUND,
          "serve: decode logits outside the bound of the cache-free "
          "forward")
    del model, results, batch2
    torch.cuda.empty_cache()
    return entries


class K1Probe:
    """Inside ``with``: each K1 launch and each integer tier's domain
    preparation bracketed by CUDA events (``k1_ms``, ``prep_ms`` sum them
    after a synchronize).  With ``measure``, each launch is also run
    alone: timed (``cuda_ms``), its plain version run once on the same
    inputs (host clock) and held bitwise, and for an unsegmented ``exact``
    stream ``torch.sum`` over the rows timed (the same int32 column sums);
    the probe's own launches are taken off K1's count."""

    def __init__(self, measure: bool = False):
        self.measure = measure
        self.k1, self.prep, self.records = [], [], []
        self.caller = None          # set by ``K1ByCaller``; kept per record

    def __enter__(self):
        from repro_torch.kernels import jugglepac_segsum as K
        from repro_torch.reduce import get_policy
        self.K, self.real = K, K.segsum_policy_cuda
        K.segsum_policy_cuda = self._launch
        self.pols = [get_policy(t) for t in INT_TIERS]
        for pol in self.pols:
            pol.prepare = self._prepare_of(pol)
        return self

    def __exit__(self, *exc):
        self.K.segsum_policy_cuda = self.real
        for pol in self.pols:
            del pol.prepare               # the class's method again

    @staticmethod
    def _events():
        import torch
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    def _prepare_of(self, pol):
        real = type(pol).prepare.__get__(pol)

        def prepare(values, num_terms, **kw):
            a, b = self._events()
            a.record()
            out = real(values, num_terms, **kw)
            b.record()
            self.prep.append((a, b))
            return out
        return prepare

    def _launch(self, values, ids, num_segments, **kw):
        a, b = self._events()
        a.record()
        out = self.real(values, ids, num_segments, **kw)
        b.record()
        self.k1.append((a, b))
        if self.measure:
            self._measure(values, ids, num_segments, kw, out)
        return out

    def _measure(self, values, ids, num_segments, kw, out):
        import torch
        K = self.K
        count = K.LAUNCHES
        pol, block = kw["policy"], kw["block_rows"]
        ms = cuda_ms(lambda: self.real(values, ids, num_segments, **kw),
                     REPS)
        n, w = values.shape
        pad = (-n) % block
        pv = torch.cat([values, values.new_zeros((pad, w))]) if pad \
            else values
        pi = torch.cat([ids, ids.new_full((pad,), -1)]) if pad else ids
        plain_ms, plain = host_ms(lambda: K.segsum_policy_torch(
            pv, pi, num_segments, policy=pol, program=kw.get("program"),
            block_rows=block))
        del pv, pi
        ok, err = same(tuple(out), tuple(plain))
        del plain
        lib_ms = None
        if pol.name == "exact" and num_segments == 1:
            lib_ms = cuda_ms(lambda: values.sum(0, dtype=torch.int32), REPS)
        kept = int(((ids >= 0) & (ids < num_segments)).sum())
        self.records.append({
            "caller": self.caller, "policy": pol.name, "shape": (n, w),
            "ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "ok": ok,
            "err": err, "ops": kept * w,
            "bytes": n * 4 + kept * w * 4 + sum(c.numel() * 4 for c in out)})
        K.LAUNCHES = count

    def k1_ms(self):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.k1)

    def prep_ms(self):
        import torch
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.prep)


class K1ByCaller:
    """Inside ``with``: K1's launches counted by the train step's caller,
    read from ``LAUNCHES`` around each call (``counts``):
    ``grad_reduce`` (``reduce_microbatch_grads``, the microbatch mean) and
    ``global_norm`` (``adamw.global_norm``, the clip's norm).  A
    ``K1Probe`` given here tags its records with the caller."""

    def __init__(self, probe=None):
        self.probe = probe
        self.counts = {"grad_reduce": 0, "global_norm": 0}

    def __enter__(self):
        from repro_torch.optim import adamw
        from repro_torch.train import steps
        self.saved = [(steps, "reduce_microbatch_grads", "grad_reduce"),
                      (adamw, "global_norm", "global_norm")]
        for mod, attr, caller in self.saved:
            setattr(mod, attr, self._counted(getattr(mod, attr), caller))
        return self

    def __exit__(self, *exc):
        for mod, attr, _ in self.saved:
            setattr(mod, attr, getattr(mod, attr).__wrapped__)

    def _counted(self, real, caller):
        from repro_torch.kernels import jugglepac_segsum as K

        def call(*args, **kw):
            before = K.LAUNCHES
            if self.probe is not None:
                self.probe.caller = caller
            try:
                return real(*args, **kw)
            finally:
                self.counts[caller] += K.LAUNCHES - before
                if self.probe is not None:
                    self.probe.caller = None
        call.__wrapped__ = real
        return call


def k1_train_entry(name, records, launches):
    """One kernel-table entry for the K1 launches of a train step: the
    sums over those launches (kernel, plain, library and bound ms) and
    the largest kernel-vs-plain difference."""
    bytes_ = sum(r["bytes"] for r in records)
    ops_ = sum(r["ops"] for r in records)
    lib = [r["library_ms"] for r in records]
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segsum.cu",
            "replaces": "src/repro/kernels/jugglepac_segsum.py:77",
            "launches": launches,
            "max_abs_err": max(r["err"] for r in records),
            "ms": sum(r["ms"] for r in records),
            "plain_ms": sum(r["plain_ms"] for r in records),
            "bound_ms": sum(max(r["bytes"] / HBM_BYTES_PER_S,
                                r["ops"] / FP32_OPS_PER_S)
                            for r in records) * 1e3,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                         >= ops_ / FP32_OPS_PER_S else "operations"),
            "library_ms": None if None in lib else sum(lib)}


def microbatch_grads(model, batch, m):
    """Each microbatch's gradients in the reference's layout, as the train
    step's autograd pass computes them (remat on)."""
    import torch
    from repro_torch.models import convert
    from repro_torch.models import model as M
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    out = []
    for i in range(m):
        mb = {k: v.reshape((m, v.shape[0] // m) + v.shape[1:])[i]
              for k, v in batch.items()}
        loss, _ = M.loss_fn(model, mb, remat=True)
        g = torch.autograd.grad(loss, list(named.values()))
        out.append(convert.to_reference(model.cfg, dict(zip(named, g))))
        del loss, g
    return out


def check_juggler(gs):
    """Check 2: ``accumulate_microbatch_grads`` over four microbatch
    gradients bitwise (0 + ((g1 + g2) + (g3 + g4))) / 4, written out in
    the leaf dtype."""
    import torch
    from repro_torch.reduce import accumulate_microbatch_grads
    acc, _ = accumulate_microbatch_grads(
        lambda _, i: (gs[int(i)], torch.zeros(())), None,
        torch.arange(len(gs)), num_microbatches=len(gs))
    ok = True
    for k in acc:
        g1, g2, g3, g4 = (g[k] for g in gs)
        want = (torch.zeros_like(g1) + ((g1 + g2) + (g3 + g4))) \
            / torch.tensor(4.0, dtype=g1.dtype, device=g1.device)
        ok &= torch.equal(acc[k], want)
    print(f"check juggler: accumulate_microbatch_grads over {len(gs)} "
          f"microbatch gradients ({acc['embed'].dtype}) "
          f"{'bitwise' if ok else 'DIFFER'} (0 + ((g1 + g2) + (g3 + g4))) "
          f"/ 4 in every leaf", flush=True)
    check(ok, "train: the juggler's sum differs from its schedule")


def check_grad_reductions(gs, tier, what):
    """Check 3: ``reduce_microbatch_grads`` and ``global_norm`` under
    ``tier`` on the ``cuda`` backend (K1: one launch a leaf; two a leaf
    and one more for the norm) bitwise the ``blocked`` executor on the
    same gradients.  Returns the mean gradients."""
    import torch
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.optim import adamw
    from repro_torch.reduce import reduce_microbatch_grads

    def fn(_, i):
        return gs[int(i)], torch.zeros(())

    m = len(gs)
    idx = torch.arange(m)
    K.LAUNCHES = 0
    cuda, _ = reduce_microbatch_grads(fn, None, idx, num_microbatches=m,
                                      policy=tier)
    torch.cuda.synchronize()
    mean_launches = K.LAUNCHES
    plain, _ = reduce_microbatch_grads(fn, None, idx, num_microbatches=m,
                                       policy=tier, backend="blocked")
    ok_mean = all(torch.equal(cuda[k], plain[k]) for k in cuda)
    del plain
    K.LAUNCHES = 0
    norm = adamw.global_norm(cuda, policy=tier)
    torch.cuda.synchronize()
    norm_launches = K.LAUNCHES
    norm_plain = adamw.global_norm(cuda, policy=tier, backend="blocked")
    ok_norm = torch.equal(norm, norm_plain)
    print(f"check {what} {tier}: reduce_microbatch_grads over {m} "
          f"microbatches, {len(cuda)} leaves (largest "
          f"{max(v.numel() for v in cuda.values())} values): cuda vs blocked "
          f"{'bitwise' if ok_mean else 'DIFFER'}, K1 launches "
          f"{mean_launches}; global_norm {float(norm)!r} vs "
          f"{float(norm_plain)!r} {'bitwise' if ok_norm else 'DIFFER'}, K1 "
          f"launches {norm_launches}", flush=True)
    check(ok_mean and ok_norm and mean_launches == len(cuda)
          and norm_launches == 2 * len(cuda) + 1,
          f"train {what}: {tier} on the cuda backend differs from blocked "
          f"or launched K1 {mean_launches} + {norm_launches} times")
    return cuda


def check_one_label_float(gs, means, smi):
    """Check 5: ``fast`` and ``compensated`` through K1's one-label
    schedule on the largest leaf's ``grad_reduce`` stream (its microbatch
    gradients, (4, |leaf|) at B = 1) and its ``global_norm`` stream (the
    squares of its mean gradient, (|leaf| / 1,024, 1,024) at B = 512),
    each bitwise its plain version, timed beside ``torch.sum(0)`` in f32
    on the same stream and the bound."""
    import torch
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.reduce import get_policy
    from repro_torch.reduce.algebra import get_op
    big = max(means, key=lambda k: means[k].numel())
    n = means[big].numel()
    dev = means[big].device
    stream = torch.empty((len(gs), n), dtype=torch.float32, device=dev)
    for i, g in enumerate(gs):
        stream[i].copy_(g[big].reshape(-1))
    w = 1024
    xf = means[big].to(torch.float32).reshape(-1)
    xf = torch.cat([xf, xf.new_zeros((-n) % w)])
    sq = get_op("sumsq").pre(xf.reshape(-1, w))
    del xf
    for what, vals, block in (("grad_reduce", stream, 1),
                              ("global_norm", sq, 512)):
        rows = vals.shape[0]
        ids = torch.zeros(rows, dtype=torch.int32, device=dev)
        pad = (-rows) % block
        pv = torch.cat([vals, vals.new_zeros((pad, vals.shape[1]))]) \
            if pad else vals
        pi = torch.cat([ids, ids.new_full((pad,), -1)]) if pad else ids
        for tier in ("fast", "compensated"):
            pol = get_policy(tier)
            kern = K.segsum_policy_cuda(vals, ids, 1, policy=pol,
                                        block_rows=block)
            plain = K.segsum_policy_torch(pv, pi, 1, policy=pol,
                                          block_rows=block)
            ok, _ = same(tuple(kern), tuple(plain))
            del plain
            ms = cuda_ms(lambda: K.segsum_policy_cuda(
                vals, ids, 1, policy=pol, block_rows=block), REPS)
            lib_ms = cuda_ms(lambda: vals.sum(0), REPS)
            out = sum(c.numel() * 4 for c in kern)
            bound = (rows * 4 + vals.numel() * 4 + out) / HBM_BYTES_PER_S
            plan = K.wide_plan(pol, vals.shape[1], rows, block)
            print(f"check one-label {tier} {what} stream of {big} "
                  f"{tuple(vals.shape)} B={block}: K1 "
                  f"{'bitwise' if ok else 'DIFFERS from'} its plain version"
                  f"; K1 {ms:.3f} ms ({plan.kernels} CUDA kernel(s)), "
                  f"torch.sum(0) f32 {lib_ms:.3f} ms, bound "
                  f"{bound * 1e3:.3f} ms | {smi}", flush=True)
            check(ok, f"train: K1 {tier} on the one-label {what} stream "
                      "differs from its plain version")
        del pv, pi
    del stream, sq
    torch.cuda.empty_cache()


def train_phase(seed, dev, smi):
    """Phase 11: the training path at stablelm-1.6b's full width through
    the port's train step; returns K1's train-path kernel entries."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataCfg, SyntheticLM
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.train import init_state, make_train_step

    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 21)
    model = M.init_params(cfg, generator=gen, device=dev)
    data = SyntheticLM(DataCfg(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=seed))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(0).items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    lr_fn = adamw.cosine_schedule(TRAIN_LR, 1, TRAIN_STEPS)
    print(f"train: {cfg.name} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.dtype}), {sum(p.numel() for p in model.parameters())} "
          f"parameters in {len(convert.reference_leaves(cfg))} reference "
          f"leaves; batch {TRAIN_BATCH} x {TRAIN_SEQ} (SyntheticLM seed "
          f"{seed}), {TRAIN_MB} microbatches, lr cosine({TRAIN_LR}, 1, "
          f"{TRAIN_STEPS}), remat on", flush=True)

    def stepper(step, state):
        hold = {"model": model, "state": state}

        def one():
            hold["model"], hold["state"], hold["metrics"] = step(
                hold["model"], hold["state"], batch)
        return hold, one

    # 1. the juggler: five steps on the same batch, the loss falls; no
    # kernel of the port on this path (counts set to 0 just before)
    step = make_train_step(cfg, lr_fn=lr_fn, num_microbatches=TRAIN_MB,
                           device=dev)
    hold, one = stepper(step, init_state(model))
    K.LAUNCHES = 0
    losses = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(TRAIN_STEPS):
        one()
        losses.append(float(hold["metrics"]["loss"]))
    torch.cuda.synchronize()
    jug_launches = K.LAUNCHES
    print(f"main train (juggler, m={TRAIN_MB}): losses {losses}, grad norm "
          f"{float(hold['metrics']['grad_norm']):.4f}, K1 launches "
          f"{jug_launches}", flush=True)
    check(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0]
          and jug_launches == 0,
          f"train: the juggler's losses {losses} did not fall, or K1 ran "
          f"{jug_launches} times")
    jug_ms = cuda_ms(one, REPS)
    jug_peak = torch.cuda.max_memory_allocated()
    del hold, one, step
    torch.cuda.empty_cache()

    # 4. grad_reduce and norm_policy under exact: K1 37 times a step
    step = make_train_step(cfg, lr_fn=lr_fn, num_microbatches=TRAIN_MB,
                           grad_reduce="exact", norm_policy="exact",
                           device=dev)
    hold, one = stepper(step, init_state(model))
    torch.cuda.reset_peak_memory_stats()
    K.LAUNCHES = 0
    with K1ByCaller() as calls:
        one()
    torch.cuda.synchronize()
    exact_launches, by_caller = K.LAUNCHES, calls.counts
    met = hold["metrics"]
    print(f"main train (grad_reduce=exact, norm_policy=exact, m="
          f"{TRAIN_MB}): loss {float(met['loss']):.4f}, grad norm "
          f"{float(met['grad_norm']):.4f}, K1 launches {exact_launches} "
          f"(want {K1_PER_STEP}): grad_reduce {by_caller['grad_reduce']}, "
          f"global_norm {by_caller['global_norm']}", flush=True)
    check(exact_launches == K1_PER_STEP
          and by_caller == {"grad_reduce": TRAIN_LEAVES,
                            "global_norm": 2 * TRAIN_LEAVES + 1}
          and bool(torch.isfinite(met["loss"]))
          and bool(torch.isfinite(met["grad_norm"])),
          f"train: the exact step launched K1 {exact_launches} times "
          f"({by_caller})")
    exact_ms = cuda_ms(one, REPS)
    exact_peak = torch.cuda.max_memory_allocated()
    with K1Probe() as probe:
        step_ms = cuda_ms(one, 1, warmup=0)
    in_step_k1, in_step_prep = probe.k1_ms(), probe.prep_ms()
    with K1Probe(measure=True) as probe, K1ByCaller(probe):
        one()
    check(all(r["ok"] for r in probe.records)
          and len(probe.records) == K1_PER_STEP
          and all(r["caller"] in by_caller for r in probe.records),
          "train: K1 differs from its plain version on a train step's "
          "launches")
    entries = [k1_train_entry(f"segsum_policy_kernel<exact>/train {c}",
                              [r for r in probe.records
                               if r["caller"] == c], by_caller[c])
               for c in ("grad_reduce", "global_norm")]
    big = max((r["shape"] for r in probe.records), key=lambda s: s[0] * s[1])
    print(f"check K1 exact on the step's {len(probe.records)} launches "
          f"(largest stream {big[0]} x {big[1]}): every one bitwise its "
          f"plain version", flush=True)
    print(f"time train: juggler step {jug_ms:.3f} ms ({tokens * 1e3 / jug_ms:.1f} "
          f"tokens/s, peak memory {jug_peak / 2 ** 30:.2f} GiB) | exact step "
          f"{exact_ms:.3f} ms ({tokens * 1e3 / exact_ms:.1f} tokens/s, peak "
          f"memory {exact_peak / 2 ** 30:.2f} GiB) | inside one exact step "
          f"of {step_ms:.3f} ms: K1 {in_step_k1:.3f} ms ({K1_PER_STEP} "
          f"launches), domain preparation {in_step_prep:.3f} ms | K1 "
          f"grad_reduce {entries[0]['ms']:.3f} ms (bound "
          f"{entries[0]['bound_ms']:.3f}, plain {entries[0]['plain_ms']:.1f}, "
          f"torch.sum {entries[0]['library_ms']:.3f}), global_norm "
          f"{entries[1]['ms']:.3f} ms (bound {entries[1]['bound_ms']:.3f}, "
          f"plain {entries[1]['plain_ms']:.1f}, torch.sum "
          f"{entries[1]['library_ms']}) | {smi}", flush=True)
    del hold, one, step, probe
    torch.cuda.empty_cache()

    # 2. one step's four microbatch gradients through the juggler:
    # bitwise the pairing written by hand in the leaf dtype
    gs = microbatch_grads(model, batch, TRAIN_MB)
    del model
    torch.cuda.empty_cache()
    check_juggler(gs)
    # 3. K1 against blocked at full width (exact)
    means = check_grad_reductions(gs, "exact", "full width")
    # 5. fast and compensated through the one-label schedule
    check_one_label_float(gs, means, smi)
    del gs, means
    torch.cuda.empty_cache()

    # exact2 and procrastinate at n_layers=2
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CUT_LAYERS)
    gen.manual_seed(seed + 22)
    small = M.init_params(cut, generator=gen, device=dev)
    for tier in ("exact2", "procrastinate"):
        step = make_train_step(cut, lr_fn=lr_fn, num_microbatches=TRAIN_MB,
                               grad_reduce=tier, norm_policy=tier,
                               device=dev)
        state = init_state(small)
        K.LAUNCHES = 0
        small, state, met = step(small, state, batch)
        torch.cuda.synchronize()
        launches = K.LAUNCHES
        check(launches == K1_PER_STEP and bool(torch.isfinite(met["loss"])),
              f"train: the {tier} step (n_layers={TRAIN_CUT_LAYERS}) "
              f"launched K1 {launches} times")
        loss = float(met["loss"])
        del step, state, met
        torch.cuda.empty_cache()
        # the same reductions on one step's microbatch gradients, each K1
        # launch also timed and held against its plain version (no model
        # or moments alive: an embedding-wide exact2 domain is 26 GB)
        torch.cuda.reset_peak_memory_stats()
        gs = microbatch_grads(small, batch, TRAIN_MB)
        with K1Probe(measure=True) as probe:
            check_grad_reductions(gs, tier, f"n_layers={TRAIN_CUT_LAYERS}")
        check(all(r["ok"] for r in probe.records)
              and len(probe.records) == K1_PER_STEP,
              f"train: K1 {tier} differs from its plain version")
        entry = k1_train_entry(f"segsum_policy_kernel<{tier}>/train "
                               f"n_layers={TRAIN_CUT_LAYERS}",
                               probe.records, launches)
        print(f"main train ({tier}, n_layers={TRAIN_CUT_LAYERS}): loss "
              f"{loss:.4f}, K1 launches {launches}, each of a step's "
              f"{len(probe.records)} bitwise its plain version; K1 "
              f"{entry['ms']:.3f} ms a step (bound {entry['bound_ms']:.3f}, "
              f"plain {entry['plain_ms']:.1f}); peak memory of the check "
              f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | "
              f"{smi}", flush=True)
        entries.append(entry)
        del gs, probe
        torch.cuda.empty_cache()
    del small
    torch.cuda.empty_cache()
    return entries


def reset_launches():
    """Set every kernel's launch count to 0."""
    import importlib
    from repro_torch.kernels import jugglepac_segsum as K
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    ia = importlib.import_module("repro_torch.kernels.intac_accum")
    K.LAUNCHES = 0
    ia.LAUNCHES = 0
    for mode in fd.LAUNCHES:
        fd.LAUNCHES[mode] = 0


def read_launches() -> dict:
    """Every kernel's launch count since ``reset_launches``."""
    import importlib
    from repro_torch.kernels import jugglepac_segsum as K
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    ia = importlib.import_module("repro_torch.kernels.intac_accum")
    return {"K1": K.LAUNCHES, "K2": fd.LAUNCHES["dense"],
            "K3": fd.LAUNCHES["partial"], "K4": fd.LAUNCHES["paged"],
            "K5": ia.LAUNCHES}


def state_leaves(model, state) -> dict:
    """The train state's 37 live leaves under the reference's keys."""
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.train import checkpoint_state
    return ckpt.flatten(checkpoint_state(model, state))


def differing(leaves, copies) -> list:
    """Keys whose live leaf is not bitwise its copy."""
    import torch
    return [k for k, v in leaves.items() if not torch.equal(v, copies[k])]


def ckpt_phase(seed, dev, smi):
    """Phase 12: the train state of stablelm-1.6b at full width, cut to
    ``CKPT_LAYERS`` layers, saved, restored in place, trained on,
    corrupted and fallen back from."""
    import dataclasses
    import shutil
    import tempfile
    import torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import DataCfg, SyntheticLM
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.testing import faults
    from repro_torch.train import checkpoint_state, init_state, make_train_step

    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=CKPT_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 23)
    model = M.init_params(cfg, generator=gen, device=dev)
    data = SyntheticLM(DataCfg(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=seed))
    batches = [{k: torch.as_tensor(v, device=dev)
                for k, v in data.batch(i).items()} for i in (0, 1)]
    step = make_train_step(cfg, lr_fn=adamw.cosine_schedule(TRAIN_LR, 1,
                                                            TRAIN_STEPS),
                           num_microbatches=TRAIN_MB, device=dev)
    state = init_state(model)
    torch.cuda.reset_peak_memory_stats()

    # 1. one juggler step, so the moments are nonzero; no kernel of the
    # port on this path (counts set to 0 just before, read just after)
    reset_launches()
    model, state, met = step(model, state, batches[0])
    torch.cuda.synchronize()
    counts = read_launches()
    live = state_leaves(model, state)
    raw = sum(v.numel() * v.element_size() for v in live.values())
    kinds = {}
    for v in live.values():
        kinds[str(v.dtype).split(".")[1]] = \
            kinds.get(str(v.dtype).split(".")[1], 0) + 1
    print(f"ckpt: {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {cfg.dtype}) after one juggler step (loss "
          f"{float(met['loss']):.4f}, kernel launches {counts}): "
          f"{len(live)} leaves {kinds}, {raw / 1e9:.3f} GB raw", flush=True)
    check(len(live) == 3 * TRAIN_LEAVES + 1 and sum(counts.values()) == 0
          and kinds == {"bfloat16": TRAIN_LEAVES, "float32": 2 * TRAIN_LEAVES,
                        "int32": 1}
          and all(bool(torch.any(v != 0)) for k, v in live.items()
                  if ".mu/" in k or ".nu/" in k),
          "ckpt: the train state is not 12 bf16 leaves, 24 nonzero f32 "
          "moments and a count, or the juggler step launched a kernel")
    held = {k: v.clone() for k, v in live.items()}        # state 1

    (ROOT / "build").mkdir(exist_ok=True)
    root = Path(tempfile.mkdtemp(prefix="ckpt_smoke_", dir=ROOT / "build"))
    try:
        # 2. save step 1 at the reference's zlib level, timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save(root, 1, checkpoint_state(model, state), keep=CKPT_KEEP,
                  extra={"next_step": 2})
        save_s = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in (root / "step_00000001").iterdir())
        print(f"time ckpt save: {save_s:.3f} s for {raw / 1e9:.3f} GB raw "
              f"({raw / 1e9 / save_s:.3f} GB/s), {disk / 1e9:.3f} GB on disk "
              f"(ratio {disk / raw:.4f}), zlib level {ckpt.LEVEL}, "
              f"{ckpt._threads()} threads, chunks of {ckpt.CHUNK_BYTES >> 20} "
              f"MiB | {smi}", flush=True)

        # 5a. two steps from one state agree: a step from state 1, then
        # state 1 written back in place and the step again
        model, state, met_a = step(model, state, batches[1])
        after = {k: v.clone() for k, v in state_leaves(model, state).items()}
        for k, v in state_leaves(model, state).items():
            v.copy_(held[k])
        model, state, met_b = step(model, state, batches[1])
        bad = differing(state_leaves(model, state), after)
        same_loss = float(met_a["loss"]) == float(met_b["loss"])
        print(f"check step repeatable: two juggler steps from one state: "
              f"loss {float(met_a['loss'])!r} and {float(met_b['loss'])!r}, "
              f"{len(after) - len(bad)} of {len(after)} leaves bitwise"
              f"{'' if not bad else ' (differ: ' + ', '.join(bad) + ')'}",
              flush=True)
        check(same_loss and not bad,
              "ckpt: a train step from one state is not repeatable")

        # 3. restore the newest valid snapshot into the live leaves (which
        # hold state 2 now), timed; every leaf bitwise state 1
        leaves_before = convert.stacked_leaves(model)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = ckpt.restore_latest_valid(root, checkpoint_state(model, state),
                                        inplace=True)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        bad = differing(state_leaves(model, state), held)
        print(f"time ckpt restore: {restore_s:.3f} s ({raw / 1e9 / restore_s:.3f} "
              f"GB/s raw), step {got[2]}, next_step "
              f"{got[1]['extra']['next_step']} | {smi}", flush=True)
        # 4. the model's parameters still view the restored leaves
        leaves = convert.stacked_leaves(model)
        named = dict(model.named_parameters())
        views = leaves is leaves_before and all(
            [named[n].data_ptr() for n in names]
            == [r.data_ptr() for r in (leaves[path] if path.startswith(
                "blocks/") else [leaves[path]])]
            for path, names in convert.reference_leaves(cfg))
        print(f"check restore: {len(held) - len(bad)} of {len(held)} leaves "
              f"bitwise the saved state (12 bf16 parameters, 24 f32 moments, "
              f"count {int(state.count)}); the model's parameters "
              f"{'still views' if views else 'NOT views'} of the restored "
              f"leaves", flush=True)
        check(got[2] == 1 and not bad and views,
              "ckpt: the restore is not bitwise, or broke the views")

        # 5b. the same next step from the restored state
        model, state, met_c = step(model, state, batches[1])
        bad = differing(state_leaves(model, state), after)
        print(f"check resumed step: loss {float(met_c['loss'])!r} (the "
              f"uninterrupted {float(met_a['loss'])!r}), {len(after) - len(bad)} "
              f"of {len(after)} leaves bitwise the uninterrupted step",
              flush=True)
        check(float(met_c["loss"]) == float(met_a["loss"]) and not bad,
              "ckpt: the step from the restored state differs")
        del after

        # 6. a newer snapshot, a flipped bit in it: restore raises, the
        # newest valid one is step 1.  Step 2 is written as stored zlib
        # blocks (level 0: the same format, a few seconds); the save timed
        # above is step 1's
        ckpt.save(root, 2, checkpoint_state(model, state), keep=CKPT_KEEP,
                  extra={"next_step": 3}, level=0)
        target = faults.corrupt_checkpoint(root, 2, mode="bitflip")
        t0 = time.perf_counter()
        try:
            ckpt.restore(root, 2, checkpoint_state(model, state), inplace=True)
            err = None
        except ckpt.CheckpointError as e:
            err = e
        detect_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = ckpt.restore_latest_valid(root, checkpoint_state(model, state),
                                        inplace=True)
        torch.cuda.synchronize()
        fall_s = time.perf_counter() - t0
        bad = differing(state_leaves(model, state), held)
        print(f"check corruption: one bit flipped in {target.name} of step 2: "
              f"restore {'raised CheckpointError (' + str(err)[-120:] + ')' if err else 'DID NOT RAISE'} "
              f"in {detect_s:.3f} s; restore_latest_valid fell back to step "
              f"{got[2]} in {fall_s:.3f} s, {len(held) - len(bad)} of "
              f"{len(held)} leaves bitwise step 1; peak memory of the "
              f"phase {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
              flush=True)
        check(err is not None and "CRC32" in str(err) and got[2] == 1
              and not bad, "ckpt: the corruption was not detected, or the "
              "fall-back did not restore step 1")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    # ``got`` holds the live leaves too (the restored tree)
    del model, state, held, live, leaves, leaves_before, named, got, step
    del batches, met, met_a, met_b, met_c
    torch.cuda.empty_cache()


def push_rows(acc, x):
    """Push the rows of ``x`` through ``acc`` in order -> (state, ms by
    CUDA events, or by the host clock on the CPU).  Inference mode: each
    push is dozens of small launches, and autograd's bookkeeping on them
    is host time."""
    import torch
    with torch.inference_mode():
        st = acc.init(x[0])
        if not x.is_cuda:
            t0 = time.perf_counter()
            for row in x:
                st = acc.push(st, row)
            return st, (time.perf_counter() - t0) * 1e3
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for row in x:
            st = acc.push(st, row)
        b.record()
        b.synchronize()
        return st, a.elapsed_time(b)


def accum_phase(seed, dev, smi):
    """Phase 13: the streaming accumulators at the INTAC shape on the
    card, each row of the stream one push."""
    import torch
    import repro_torch.reduce as R
    from repro_torch.core import intac as I
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)                 # phase 8's stream
    n, d, scale = INTAC_ROWS, INTAC_COLS, INTAC_SCALE
    torch.cuda.reset_peak_memory_stats()
    mag = torch.randint(-12, 4, (n, d), generator=gen, device=dev)
    x = (torch.randn((n, d), generator=gen, device=dev)
         * torch.exp2(mag.to(torch.float32))).clamp(-31.0, 31.0)
    del mag
    xc = x.cpu()
    times = {}

    # LimbAccumulator against K5 under the same scale (no kernel of the
    # port in the pushes: counts set to 0 just before, read just after)
    reset_launches()
    limb, times["LimbAccumulator"] = push_rows(R.LimbAccumulator(scale), x)
    counts = read_launches()
    k5 = ops.intac_accum(x, scale)
    raw_ok = torch.equal(limb.hi, k5[0]) and torch.equal(limb.lo, k5[1])
    ch, cl = I.limbs_canonical(limb.hi, limb.lo)
    kh, kl = I.limbs_canonical(k5[0], k5[1])
    canon_ok = torch.equal(ch, kh) and torch.equal(cl, kl)
    print(f"check LimbAccumulator: {n} pushes of ({d},) rows, scale 2^"
          f"{int(math.log2(scale))}, kernel launches {counts}: (hi, lo) "
          f"{'bitwise' if canon_ok else 'DIFFER from'} K5's intac_accum in "
          f"canonical form (raw limbs {'bitwise' if raw_ok else 'differ'})",
          flush=True)
    check(canon_ok and sum(counts.values()) == 0,
          "accumulators: LimbAccumulator differs from K5")

    # Limb3Accumulator and BinAccumulator: bitwise their CPU run
    max_abs = float(x.abs().max())
    for name, acc in (("Limb3Accumulator", R.Limb3Accumulator(scale)),
                      ("BinAccumulator", R.BinAccumulator(max_abs))):
        reset_launches()
        st, times[name] = push_rows(acc, x)
        counts = read_launches()
        st_c, cpu_ms = push_rows(acc, xc)
        fields = list(st) if isinstance(st, tuple) else [st]
        fields_c = list(st_c) if isinstance(st_c, tuple) else [st_c]
        ok = all(torch.equal(a.cpu(), b) for a, b in zip(fields, fields_c)
                 if a is not None)
        fin_ok = torch.equal(acc.finalize(st).cpu(), acc.finalize(st_c))
        print(f"check {name}: card state {'bitwise' if ok else 'DIFFERS from'} "
              f"its CPU run, finalize {'bitwise' if fin_ok else 'DIFFERS'} "
              f"(CPU {cpu_ms:.1f} ms on the host clock), kernel launches "
              f"{counts}", flush=True)
        check(ok and fin_ok and sum(counts.values()) == 0,
              f"accumulators: {name} on the card differs from the CPU")
        del st, st_c

    # Kahan (Sum2: |res - s| <= u|s| + gamma_{n-1}^2 sum|x|, Ogita, Rump
    # and Oishi 2005) and a depth-2 Cascade (stage k: k gamma_n of its
    # weighted |x| sum) against float64
    x64 = x.double()
    absum = x64.abs().sum(0)
    s64 = x64.sum(0)
    gam = lambda k: k * U / (1 - k * U)  # noqa: E731
    reset_launches()
    kahan, times["KahanAccumulator"] = push_rows(R.KahanAccumulator(), x)
    cascade_acc = R.CascadeAccumulator(2)
    casc, times["CascadeAccumulator(2)"] = push_rows(cascade_acc, x)
    counts = read_launches()
    k_err = (R.KahanAccumulator().finalize(kahan).double() - s64).abs()
    k_bound = U * s64.abs() + gam(n - 1) ** 2 * absum
    w = R.cascade_weights(n, 2).to(dev).double()
    c_ref = w @ x64
    c_bound = torch.stack([(k + 1) * gam(n) * (w[k] @ x64.abs())
                           for k in range(2)])
    c_err = (cascade_acc.finalize(casc).double() - c_ref).abs()
    k_ok, c_ok = bool((k_err <= k_bound).all()), bool((c_err <= c_bound).all())
    print(f"check KahanAccumulator: max |err| {float(k_err.max()):.3e} vs "
          f"float64, within its bound {'everywhere' if k_ok else 'NOT'} (max "
          f"err/bound {float((k_err / k_bound).max()):.3e}); "
          f"CascadeAccumulator(2): max |err| {float(c_err.max()):.3e}, within "
          f"its bound {'everywhere' if c_ok else 'NOT'} (max err/bound "
          f"{float((c_err / c_bound).max()):.3e}); kernel launches {counts}",
          flush=True)
    check(k_ok and c_ok and sum(counts.values()) == 0,
          "accumulators: Kahan or Cascade outside its bound")
    print("time accumulators: " + ", ".join(
        f"{k} {v:.1f} ms" for k, v in times.items())
        + f" for {n} pushes of ({d},) rows (CUDA events); peak memory of "
        f"the phase {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | "
        f"{smi}", flush=True)
    del x, xc, x64, absum, s64, kahan, casc, w, c_ref
    torch.cuda.empty_cache()


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
    t_start = time.perf_counter()

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
    cases = [(t, c, b, 65536, 16, 48, "sets", 0) for t in TIERS
             for c in ("dot", "lanes") for b in (64, 128, 512)]
    cases.append(("exact2", "lanes", 512, 65536, 64, 4096, "sets", 0))
    cases.append(("exact2", "dot", 512, 65536, 64, 4096, "sets", 0))
    cases += [(t, c, b, 65536, 16, 48, "runs", 0) for t in ("fast", "compensated")
              for c in ("dot", "lanes") for b in (96, 4096)]
    # the integer tiers' register runs: sums that wrap (ovf != 0), random
    # labels over 128 label tiles, a ragged 4-column tile (D=20), the
    # scalar loads (D=18), a ragged N, a label window at an offset
    for t in INT_TIERS:
        cases += [(t, "lanes", 512, 65536, 16, 48, "wrap", 0),
                  (t, "lanes", 512, 65536, 64, 4096, "random", 0),
                  (t, "lanes", 128, 65536, 20, 48, "sets", 0),
                  (t, "dot", 128, 65536, 18, 48, "sets", 0),
                  (t, "lanes", 512, 65536 + 77, 16, 48, "sets", 0),
                  (t, "lanes", 128, 65536, 16, 16, "sets", 24)]
    for tier, contrib, block, n, d, s, stream, off in cases:
        pol = get_policy(tier)
        if stream == "runs":
            vals, ids = runs_stream(n, d, s, args.seed + 1, dev, block)
        else:
            vals, ids = make_stream(n, d, s + off, args.seed + 1, dev)
        if stream == "random":
            g = torch.Generator(device=dev)
            g.manual_seed(args.seed + 5)
            ids = torch.randint(-1, s, (n,), generator=g, device=dev,
                                dtype=torch.int32)
        if stream == "wrap":
            dom = wrapping_domain(pol, n, d, args.seed + 6, dev)
        else:
            dom, _ = pol.prepare(vals, n)
        prog = plan_program(pol, num_segments=s, domain_width=dom.shape[1],
                            block_size=block, contrib=contrib)
        kern = K.segsum_policy_cuda(dom, ids, s, policy=pol, program=prog,
                                    block_rows=block, seg_offset=off)
        pad = (-n) % block              # the kernel reads these as sentinels
        plain = K.segsum_policy_torch(
            torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))]),
            torch.cat([ids, ids.new_full((pad,), -1)]), s, policy=pol,
            program=prog, block_rows=block, seg_offset=off)
        ranges_ok = torch.equal(
            K.block_label_ranges_cuda(ids, block, s, off),
            K.block_label_ranges_torch(ids, block, s, off))
        torch.cuda.synchronize()
        ok = all(torch.equal(a, b) for a, b in zip(kern, plain))
        err = max(float((a.double() - b.double()).abs().max())
                  for a, b in zip(kern, plain))
        errs[tier] = max(errs[tier], err)
        ct, st, grid = K.launch_shape(pol, s, dom.shape[1])
        wrapped = stream == "wrap" and tier != "exact"
        print(f"check {tier:13s} {contrib:5s} B={block:3d} N={n} D={d} "
              f"S={s} offset={off} {stream}: grid {grid[0]}x{grid[1]} "
              f"(label tile {st}, column tile {ct}) max|kernel-plain|="
              f"{err:g} {'bitwise' if ok else 'DIFFER'}; pre-pass "
              f"{'bitwise' if ranges_ok else 'DIFFER'}"
              + (f"; ovf cells nonzero {int((kern[-1] != 0).sum())}"
                 if wrapped else ""), flush=True)
        if not (ok and ranges_ok):
            return fail(f"K1 differs from its plain version: {tier} "
                        f"{contrib} B={block} S={s} {stream}")
        if wrapped and not bool(kern[-1].any()):
            return fail(f"{tier}: the wrapping domain left ovf zero")
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
        if tier in ("fast", "exact"):
            # the same launch where no row holds a label: the pre-pass, the
            # range walk and (fast) the folds of +0 alone
            none = torch.full_like(mids, -1)
            walk_ms = cuda_ms(lambda: K.segsum_policy_cuda(
                dom, none, s, policy=pol, program=prog, block_rows=512), REPS)
            print(f"time {tier} K1 split: pre-pass and range walk alone "
                  f"{walk_ms:.3f} ms, touched blocks "
                  f"{kern_ms - walk_ms:.3f} ms", flush=True)
            del none
        if tier == "fast":
            ok = torch.equal(K.block_label_ranges_cuda(mids, 512, s),
                             K.block_label_ranges_torch(mids, 512, s))
            print(f"check pre-pass at the main path: "
                  f"{'bitwise' if ok else 'DIFFER'}", flush=True)
            check(ok, "the pre-pass differs from its plain version")
        if tier == "exact":
            # the same values under a shuffled label stream: every schedule
            # block touches every label tile
            g = torch.Generator(device=dev)
            g.manual_seed(args.seed + 9)
            shuf = mids[torch.randperm(n, generator=g, device=dev)] \
                .contiguous()
            shuf_ms = cuda_ms(lambda: K.segsum_policy_cuda(
                dom, shuf, s, policy=pol, program=prog, block_rows=512), REPS)
            pad = (-n) % 512
            ok, _ = same(K.segsum_policy_cuda(dom, shuf, s, policy=pol,
                                              program=prog, block_rows=512),
                         K.segsum_policy_torch(
                             torch.cat([dom, dom.new_zeros((pad, w))]),
                             torch.cat([shuf, shuf.new_full((pad,), -1)]), s,
                             policy=pol, program=prog, block_rows=512))
            print(f"time exact K1 on shuffled labels: {shuf_ms:.3f} ms "
                  f"(back-to-back {kern_ms:.3f} ms); kernel vs plain "
                  f"{'bitwise' if ok else 'DIFFER'} | {smi}", flush=True)
            check(ok, "exact: K1 differs from its plain version on shuffled "
                      "labels")
            del shuf
        _, st, grid = K.launch_shape(pol, s, w)
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
        kept = int((mids >= 0).sum())   # sentinel rows' values go unread
        bytes_ = n * 4 + kept * w * 4 + out_bytes
        ops = kept * w
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        print(f"time {tier:13s}: reduce {e2e:.3f} ms | K1 {kern_ms:.3f} ms, "
              f"{launches_of[tier]} launch(es)/call (2 CUDA kernels each: "
              f"pre-pass, block schedule), grid "
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

    del vals, ids, ref, absum, cnt, blocks_per_seg
    torch.cuda.empty_cache()
    kernels += decode_phases(args.seed, dev, smi)
    kernels.append(intac_phase(args.seed, dev, smi))
    kernels += serve_phase(args.seed, dev, smi)
    kernels += train_phase(args.seed, dev, smi)
    print(f"elapsed after phase 11: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    ckpt_phase(args.seed, dev, smi)
    print(f"elapsed after phase 12: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    accum_phase(args.seed, dev, smi)
    print(f"elapsed after phase 13: {time.perf_counter() - t_start:.1f} s",
          flush=True)

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
