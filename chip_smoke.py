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
shape.  Then mixtral-8x22b at full width (8 of its 56 layers) served
through the same ``Engine`` on sliding-window ring caches, its experts
through the dense MoE.  Then deepseek-v2-lite-16b whole (all 27 layers,
full width) served through the ``Engine`` on latent caches, its
multi-head latent attention decoding absorbed.  Then jamba-v0.1-52b at
full width (16 of its 32 layers) served through the ``Engine``: Mamba
blocks on O(1) states beside GQA attention on K2.  Then xlstm-125m whole
served through the ``Engine``: mLSTM and sLSTM blocks on O(1) states.
Then deepseek-v2-lite-16b at full width (4 of its 27 layers) trained
through the port's train step: its experts under the capacity dispatch
with an ordered backward, the microbatch mean and the clip's norm on K1.
Then qwen2-vl-7b whole served through the ``Engine`` (K2 at 7 query heads
a KV head), its embedding-input forward and its M-RoPE on a patch grid's
positions.  Then seamless-m4t-large-v2 whole, an encoder-decoder: its
encoder over each request's memory, the decoder prefilled and decoded
through the train module's step factories with cross-attention on K2.
Then data parallelism across ranks of a process group on the one card:
groups of 2, 4 and 1 fresh interpreters (gloo) reduce phase 5's stream
through the sharded executor and train xlstm-125m whole through the
elastic step, resumed from 2 ranks onto 4 and onto 1 bit for bit.
Then the paper's own circuit: the JugglePAC state machine as a batched
scan (``repro_torch.core.circuit_scan``, one CUDA thread a circuit) at
65,536 circuits x 16,384 cycles, and Table II searched on the card.
Last, the reduce knobs under autograd: ``rmsnorm(policy=)`` on K1 with
its gradient, a stablelm train step with ``cfg.norm_reduce_policy`` set,
and the dry-run's bytes (``repro_torch.launch.dryrun``) against what the
serving phase allocated.
All data is drawn from ``--seed``.  Phases, in order; any failure exits nonzero:

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
   plain versions at (B, H, K, S, d) = (3, 8, 2, 1,000, 64) and (3, 14,
   2, 1,000, 128) (G = 7), K2 and K4 also at split_rows 128, 384 and
   1,024 (per = 1 and > 1, dead splits at both ends with window 200, a
   request with kv_len 0), and at full width;
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
   exact step, tokens/s, peak memory, K1's and the domain
   preparation's ms inside an exact step, and each integer tier's K1
   launches beside ``torch.sum`` of their int32 domains;
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
   ``BinAccumulator`` bitwise their CPU runs, state and finalize (each
   CPU run in a fresh interpreter, pushing while the card does);
   ``KahanAccumulator`` and ``CascadeAccumulator(2)`` within their
   stated bounds of float64; each accumulator's ms (CUDA events);
14. serve-moe — mixtral-8x22b's ``CONFIG`` at full width cut to 8 of 56
   layers (random weights from the seed, 40.87 GB) through
   ``Engine(max_len=6144, max_batch=8)`` on f32 rings of 4,096 slots
   (whole-prompt prefill, the dense MoE), 8 greedy requests of 32 new
   tokens (six prompts of 64-768 tokens, one of 4,096 and one of 5,120):
   every result complete and in order; K2 launched once a layer at every
   decode step and K1 once (counts set to 0 just before the run, read
   just after); K2 bitwise its plain version on the engine's own ring
   and query at a decode step of the middle layer after the 4,096
   request's ring has wrapped; ``router_topk`` with
   ``router_norm_policy="exact"`` over the 5,120 prefill's router stream
   through K1 bitwise ``blocked``; ``combine_segsum`` at the decode shape
   (16 rows x 6,144, 8 tokens) through K1 bitwise ``blocked``; the 4,096
   request alone gives bitwise its batched tokens; the 5,120 request's
   last decode logits within ``MOE_LOGIT_BOUND`` of a cache-free
   windowed forward; timings: a decode step against the weights' bound,
   the whole-prompt prefills at 4,096 and 5,120, generated tokens/s, K2
   per layer against its bound and SDPA, peak memory;
15. serve-mla — deepseek-v2-lite-16b's ``CONFIG`` whole: 27 layers at
   full width, nothing cut (random weights from the seed, 32.42 GB),
   through ``Engine(max_len=4096, max_batch=8, prefill_chunk=32)`` on f32
   latent caches (the chunked extend prefill, the dense MoE), 8 greedy
   requests of 32 new tokens (six prompts of 64-768 tokens, one of 2,048
   and one of 3,072): every result complete and in order; K1 launched
   once, for ``mean_logprob``, and K2 never (counts set to 0 just before
   the run, read just after); the 2,048 request alone gives bitwise its
   batched tokens; ``router_topk`` with ``router_norm_policy="exact"``
   over that request's prefill router stream (6 choices a token) and the
   latent's ``rmsnorm(policy="exact")`` over its (2,048, 512) latent,
   each through K1 bitwise ``blocked``; the 3,072 request's last decode
   logits within ``MLA_LOGIT_BOUND`` of a cache-free forward, and within
   ``MLA_F32_BOUND`` in float32 weights, dense SwiGLUs in place of the
   experts (no router choice to flip); timings: a
   decode step against the weights' bound, a prefill chunk, generated
   tokens/s, the absorbed decode attention a layer, the cache bytes
   beside a GQA cache's, peak memory;
16. serve-hybrid — jamba-v0.1-52b's ``CONFIG`` at full width cut to 16
   of 32 layers, two whole periods (14 Mamba layers, attention at layers
   4 and 12, 8 MoE layers; random weights from the seed, 52.11 GB),
   through ``Engine(max_len=5120, max_batch=8)`` (whole-prompt prefill,
   the dense MoE), 8 greedy requests of 32 new tokens (six prompts of
   64-768 tokens, one of 4,096 and one of 2,600): every result complete
   and in order; K2 launched once an attention layer at every decode step
   and K1 once (counts set to 0 just before the run, read just after);
   K2 bitwise its plain version on the engine's own cache and query in
   layer 12; a decode step with two slots inactive keeps their Mamba
   states, attention rows and lengths bitwise while the others move; the
   4,096 request alone gives bitwise its batched tokens; layer 0's
   chunked scan over that prompt within ``HYB_SCAN_BOUND`` of a float64
   sequential recurrence; its last decode logits within
   ``HYB_LOGIT_BOUND`` of a cache-free forward in bf16, and within
   ``HYB_F32_BOUND`` in float32 weights with dense SwiGLUs in place of
   the experts; timings: a decode step against the weights' bound, the
   whole-prompt prefills at 4,096 and 2,600, a Mamba layer's decode and
   prefill, K2 per layer against its bound and SDPA, generated tokens/s,
   the parameter and cache bytes, peak memory;
17. serve-xlstm — xlstm-125m's ``CONFIG`` whole: 12 layers at full width
   (9 mLSTM, 3 sLSTM), nothing cut (random weights from the seed, 0.307
   GB), through ``Engine(max_len=2176, max_batch=8)`` (whole-prompt
   prefill; float32 states of 0.172 GB), 8 greedy requests of 32 new
   tokens (six prompts of 64-768 tokens, one of 2,048 and one of 1,300):
   every result complete and in order; K1 launched once, for
   ``mean_logprob``, and K2-K5 never (counts set to 0 just before the
   run, read just after); K1 bitwise its plain version at the
   ``mean_logprob`` shape; a decode step with two slots inactive keeps
   their mLSTM and sLSTM states bitwise while the others move; layer 0's
   chunked mLSTM over the 2,048 prompt within ``XL_SCAN_BOUND`` of a
   float64 sequential recurrence (h and the final c, n, m); layer 3's
   sLSTM prefill loop bitwise the cell on its own projections and within
   ``XL_SLSTM_BOUND`` of 2,048 decode steps at batch 1; the 2,048 request
   alone gives bitwise its batched tokens; the 1,300 request's last
   decode logits within ``XL_LOGIT_BOUND`` of a cache-free forward in
   bf16, and within ``XL_F32_BOUND`` in float32 weights; timings: a
   decode step against the bytes' bound (weights once, states read and
   written), the whole-prompt prefills at 2,048 and 1,300, an mLSTM and
   an sLSTM layer's decode and prefill, generated tokens/s, the
   parameter and state bytes, peak memory;
18. train-moe — deepseek-v2-lite-16b's ``CONFIG`` at full width cut to
   4 of 27 layers (random weights from the seed, 2,758,823,936
   parameters) on phase 11's batch, microbatches and schedule, remat on,
   the ``capacity`` dispatch: (1) each MoE layer's share of dropped
   (token, choice) pairs at step 1; five juggler steps, the loss finite
   and lower at step 5 than at step 1, ``aux`` finite and positive, no
   kernel launched (counts set to 0 just before, read just after);
   (2) one microbatch's gradients computed twice from the same weights
   bitwise equal in all 19 leaves (the dispatch's ordered backward; the
   same with autograd's ``scatter_add`` backward is printed beside it);
   (3) one MoE layer in float32 at full width (64 experts top-6, d 2,048,
   f 1,408) over 512 tokens: ``capacity`` with room for every choice
   against ``dense``, the loss and the gradients of x, the router, the
   experts and the shared SwiGLU within ``MOE_DISPATCH_REL``; at the
   configured capacity choices drop and every gradient is finite; (4) at
   2 layers a step with ``grad_reduce`` and ``norm_policy`` under
   ``exact`` launches K1 exactly 58 times (19 + 2 x 19 + 1) and no other
   kernel, each launch bitwise its plain version, and the step's
   reductions bitwise the ``blocked`` executor; timings: ms per juggler
   and exact step, tokens/s, peak memory, K1's and the domain
   preparation's ms inside an exact step, K1 against its bound and
   ``torch.sum``, one MoE layer's forward and backward at a microbatch's
   shape under both dispatches;
19. serve-vlm — qwen2-vl-7b's ``CONFIG`` whole: 28 layers at full width,
   nothing cut (random weights from the seed, 15.23 GB; 28 heads on 4 KV
   heads, hd 128, M-RoPE sections (16, 24, 24)), through phase 10's
   ``Engine`` and traffic (8 slots x 1,024 on f32 caches, 32-token
   prefill chunks, 8 greedy requests of prompts in [64, 768] and 32 new
   tokens): every result complete and in order; K2 launched 28 times at
   every decode step and K1 once (counts set to 0 just before the run,
   read after every engine step and just after); K2 bitwise its plain
   version on the engine's own cache and query in layer 14 (G = 7:
   ``split_kernel<7, NT>``); three requests alone in fresh Engines give
   bitwise their batched tokens; the last one's final decode logits
   within ``SERVE_LOGIT_BOUND`` of ``forward(mode="prefill")``;
   ``forward(embeds=embed_lookup(tokens))`` on the default (1, S, 3)
   positions bitwise ``forward(tokens=)``; on one prompt's positions of
   text, a 16 x 16 patch grid and text (S = 600), the full-width M-RoPE
   rotation within ``VLM_ROPE_BOUND`` of a float64 rotation and the whole
   forward on ``embeds`` finite; timings: a decode step against the
   weights' bound, a prefill chunk, K2 per layer against its bound and
   SDPA, generated tokens/s, the embeds forward, the parameter and cache
   bytes, peak memory;
20. serve-encdec — seamless-m4t-large-v2's ``CONFIG`` whole: 24 encoder
   and 24 decoder layers at full width, nothing cut (random weights from
   the seed, 3.264 GB; 16 heads on 16 KV heads, hd 64): 8 requests, each
   with its own (4,096, 1,024) bf16 memory (``ENCDEC_*``), 32-token
   prompts through ``make_prefill_step`` (which encodes ``enc_embeds``),
   caches padded to 128 (``pad_caches_to``), 96 greedy steps through
   ``make_decode_step(enc_out=encode(...))``: K2 launched 48 times at
   every decode step, 24 on the self caches and 24 on the memory (counts
   set to 0 just before the run, read after every step and just after);
   K2 bitwise its plain version and the model's own output on one
   cross-attention call (kv_len 4,096) and one self-attention call of
   layer 12; requests 0, 3 and 7 alone (their row of an otherwise empty
   batch) give bitwise their batched tokens over the first 32; the last
   step's logits within ``SERVE_LOGIT_BOUND`` of a cache-free
   ``forward(enc_out=)`` over prompt and generated tokens; two requests'
   memories swapped move their logits and leave the other rows'
   bitwise; timings: ``encode`` at (8, 4,096), the prefill step, a decode
   step against its bound (the weights once over 3.35 TB/s, or the cross
   projections' operations over 989 T/s in bf16, whichever is larger),
   generated tokens/s, a step's 48 cross K/V projections, K2 at the cross
   and the self shape against their bounds and SDPA, peak memory;
21. train-elastic — ``repro_torch.distributed`` on one card: each bytes
   reckoning printed first, then groups of 2, 4 and 1 ranks
   (``ELASTIC_WORLDS``; fresh interpreters started by
   ``distributed.spawn.run_ranks``, gloo over a ``file://`` store, every
   CUDA payload staged through the host and counted; each rank a
   ``RANK_TIMEOUT``, any failure fails the script).  Check 1: phase 5's
   stream, each rank its slice of the reference's split, every tier
   through ``reduce(backend="shard_map", group=)``, K1 in each rank:
   the integer tiers bitwise this process's ``reduce(backend="cuda")``
   on the whole stream at W = 1, 2 and 4, the float tiers bitwise the
   port's own rank-order merge of the ranks' carries and within their
   float64 bound (phase 4's, plus W * 2^-24 of the |x| sums for the merge
   adds), each rank's K1 launches printed.  Check 2: an (8, 768, 3,072)
   stack split over the ranks: ``elastic_reduce_mean`` bitwise across W
   for the integer tiers, ``collective_mean_tree`` of each rank's item
   the same on every rank, compensated's residual returned.  Check 3:
   xlstm-125m's ``CONFIG`` whole through ``make_elastic_train_step``
   (exact2, one-row microbatches, 8 x ``ELASTIC_SEQ`` tokens a step): 4
   steps on 2 ranks with a snapshot after step 2, steps 3 and 4 resumed
   from it on 4 ranks and on 1: the parameters (a SHA-256 of every
   leaf's bytes) and every loss bitwise the uninterrupted run's; K1
   launches of each step counted (set to 0 just before it); ms a step,
   bytes across ranks and staged, each rank's peak.  Check 4: the
   launcher, ``--compress-bits 8 --microbatches 2`` on 2 ranks for
   ``LAUNCH_STEPS`` steps: losses falling, rank 0 alone printing.  K1
   bitwise its plain version at the elastic step's shape (a leaf's 4
   microbatch rows, one label), timed beside ``index_add_``; K1 at the
   embedding's shape timed.  One card's SMs serve every rank: the times
   are not a scaling result;
22. circuit — the JugglePAC kernel (``kernels/jugglepac_fsm.py``).
   Check 1: bitwise its plain version on all four per-cycle outputs
   (``res_v`` as int32 bits) at (L, R) in ``CIRCUIT_SHAPES``, B = 3 and
   B = 1, ``CIRCUIT_CHECK_T`` cycles: Table I's sets, 20 sets of 5 (at
   R = 2 the FIFO overflows and its count passes 4), idle gaps inside and
   between sets, starts on invalid cycles, -0.0, +-Inf and NaN.  Check 2:
   Table II on the card: every candidate circuit of
   ``circuit.jugglepac_min_set_size`` (n in [2, 200] x t in {0, 1, 2},
   12 sets of n + (7i + t) % 3 values i * 1000 + j) in one launch per
   (L, R), T = the longest input + the Python run's guard; each
   candidate's verdict the one the Python ``ok`` computes (the results up
   to the cycle its run stops at: exactly 12, sets 0..11 in order, within
   1e-6 of each sum, no overflow), the same binary search over them; the
   minimum equal to the port's Python search at L = 14 and R in
   ``CIRCUIT_REGS`` (the paper's 94, 29, 18 printed beside it, and the
   count of failing n above the minimum), then at L in
   ``CIRCUIT_SWEEP_L``; two of those launches bitwise the plain version
   on their first ``CIRCUIT_PREFIX`` cycles.  Check 3:
   ``circuit_scan.jugglepac_scan`` at ``CIRCUIT_B`` x ``CIRCUIT_T``, L =
   14, R = 4 (launches counted, set to 0 just before): back-to-back sets
   of lengths in [64, 512], integer values in [1, 49] as float32 (every
   partial sum exact), sets starting while 8L + 32 + 512 cycles remain;
   (a) the first ``CIRCUIT_PREFIX`` cycles of ``CIRCUIT_PREFIX``
   circuits bitwise the plain version; (b) ``CIRCUIT_ORACLE`` circuits
   whole equal to the Python ``JugglePAC.run`` (set, value, cycle,
   overflow); (c) the share of circuits with every result present, in
   order, equal to an int64 sum of its set and free of overflow, the
   worst latency constant (latency - set length) beside Table II's DS +
   110..113, and up to ``CIRCUIT_ORACLE`` flagged circuits re-run in the
   Python oracle, whose verdict must agree; timings: the kernel's ms,
   simulated cycles/s, its bound by bytes (16 B a circuit-cycle), the
   plain version's ms on check (a)'s prefix, the oracle's us a cycle,
   the blocks an SM holds at L = 14, R = 4 (the occupancy calculator),
   the waves the run takes, and the kernel's ptxas line (registers,
   stack frame, spills); its kernel entry gives the circuit-cycles each
   time covers (``cycles`` for ``ms``, ``plain_cycles`` for
   ``plain_ms``);
23. knobs under autograd — ``rmsnorm(g, x, policy=tier)`` at
   stablelm-1.6b's width on ``KNOB_BATCH`` x ``KNOB_SEQ`` bf16 tokens,
   every tier on the ``cuda`` executor (K1 once in the forward, a gather
   by label in the backward) and on ``blocked``: the output, dL/dx and
   dL/dg bitwise equal; stablelm cut to ``KNOB_LAYERS`` layers with
   ``cfg.norm_reduce_policy`` set to each of ``KNOB_TIERS``: the loss
   finite, every gradient leaf bitwise across two runs, K1
   ``KNOB_K1_PER_STEP`` times a step (counts set to 0 just before the
   step, read just after); K1 at the knob's launch bitwise its plain
   version, timed beside ``torch.sum(0)``, with the step's ms; the
   dry-run's parameter and cache bytes for phase 10's serving
   configuration equal to what phase 10 allocated, exactly.

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
#: phase 6's second small shape (B, H, K, S, d): qwen2-vl-7b's group of 7
#: query heads a KV head at its head width
DECODE_G7 = (3, 14, 2, 1000, 128)
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
#: the serve-moe phase: mixtral-8x22b's published CONFIG (src/repro_torch/
#: configs/mixtral_8x22b.py, hf:mistralai/Mixtral-8x22B-v0.1) at full
#: width, cut to 8 of its 56 layers (one layer's 2,504,011,776 bf16
#: parameters and f32 router take 5.008 GB, all 56 take 281 GB: 8 take
#: 40.87 GB with the embedding and head); 8 slots of 6,144 context on
#: f32 rings of 4,096 slots (2.15 GB); 8 greedy requests of 32 new
#: tokens: six prompts in [64, 768], one of 4,096 tokens (it fills the
#: ring, so every decode step overwrites its oldest slot) and one of
#: 5,120 (it wraps in the prefill packing); both long prompts are
#: multiples of attn_qchunk (1,024), so their prefill takes the chunked
#: attention
MOE_ARCH, MOE_LAYERS, MOE_LEN, MOE_SLOTS, MOE_NEW = \
    "mixtral-8x22b", 8, 6144, 8, 32
MOE_PROMPTS, MOE_LONG = (64, 768), (4096, 5120)
#: decode step whose K2 inputs are captured in the middle layer
MOE_TAP_STEP = 24
#: max |decode logits - cache-free forward logits| over the latter's std,
#: for the 5,120-token request's last decode step: the two paths round
#: bf16 activations after different f32 sums (K2's slot-ordered splits of
#: the ring against one windowed softmax per 1,024-query chunk; 8-row
#: expert products against 6,144-row ones), a few bf16 ulps (2^-8
#: relative) a layer over 8 layers; as phase 10's bound, a wrong ring
#: slot, position or window moves the logits by about their whole spread
MOE_LOGIT_BOUND = 0.25
#: the serve-mla phase: deepseek-v2-lite-16b's published CONFIG (src/
#: repro_torch/configs/deepseek_v2_lite_16b.py, arXiv:2405.04434,
#: hf:deepseek-ai/DeepSeek-V2-Lite) whole, nothing cut: 27 layers, d_model
#: 2,048, 16 heads, latent rank 512, nd 128, rd 64, vd 128, 64 experts
#: top-6 and 2 shared of d_ff 1,408, vocab 102,400; 16,210,198,528 bf16
#: parameters and f32 routers (32.42 GB).  8 slots of 4,096 context on f32
#: latent caches (27 x 8 x 4,096 x 576 x 4 B = 2.04 GB; GQA caches of the
#: same 16 x 128 heads would take 14.50 GB), 32-token prefill chunks (the
#: extend path), 8 greedy requests of 32 new tokens: six prompts in [64,
#: 768], one of 2,048 and one of 3,072 tokens; both long prompts are
#: multiples of attn_qchunk (1,024), so the cache-free forward below,
#: padded to 4,096, takes the chunked attention
MLA_ARCH, MLA_LEN, MLA_SLOTS, MLA_CHUNK, MLA_NEW = \
    "deepseek-v2-lite-16b", 4096, 8, 32, 32
MLA_PROMPTS, MLA_LONG = (64, 768), (2048, 3072)
#: decode step whose absorbed attention inputs are captured (middle layer)
MLA_TAP_STEP = 24
#: max |decode logits - cache-free forward logits| over the latter's std,
#: for the 3,072-token request's last decode step.  In bf16 the two paths
#: round activations after different f32 sums (absorbed attention on the
#: f32 latent against keys and values expanded to bf16; 1- and 32-row
#: products against 4,096-row ones), and with 64 experts a few router
#: probabilities apart by 1e-4 to 1e-3, those roundings flip top-6
#: choices: tools/mla_drift.py counted flips in 52 of 3,072 prompt tokens
#: at layer 0, rising to about 1,300 by layer 26, the last token's
#: choices flipping in 3 layers, and logits 0.268 apart (0.589 for this
#: phase's request).  Logits of an unrelated position or cache row lie
#: about 6 std apart (two independent draws, max over 102,400 entries),
#: so this bound catches gross faults only; the float32 check below
#: catches the rest
MLA_LOGIT_BOUND = 1.5
#: the same comparison with float32 weights at full width and depth, the
#: experts replaced by a dense SwiGLU of d_ff 1,408 (4.1 GB): with no bf16
#: rounding and no router, absorbed and unabsorbed attention are one
#: function summed in another order, a few float32 ulps a layer.  With
#: the experts kept, float32 still flips a few near-tied top-6 choices
#: among the prompt's tokens (9.2e-4 measured at 8 layers); without them
#: any wrong latent row, position, RoPE slice, mask or absorption moves
#: the logits far past this bound
MLA_F32_BOUND = 1e-3
#: the serve-hybrid phase: jamba-v0.1-52b's published CONFIG (src/
#: repro_torch/configs/jamba_v0_1_52b.py, arXiv:2403.19887) at full width
#: (d_model 4,096, Mamba di 8,192, d_state 16, d_conv 4; 32 heads, 8 kv;
#: 16 experts top-2 of d_ff 14,336; vocab 65,536; bf16), cut to 16 of its
#: 32 layers: two whole periods of 8, so 14 Mamba layers, attention at
#: layers 4 and 12 and 8 MoE layers, 26,053,595,136 parameters (52.11 GB
#: with the f32 leaves); 32 layers are 103.15 GB and do not fit, 24 would
#: be 77.6 GB and leave no room to run.  8 slots of 5,120 context: f32 KV
#: for the two attention layers (0.671 GB) and a fixed Mamba state a
#: layer (14 x 8 x (8,192 x 16 + 3 x 8,192) x 4 B = 69.7 MB).  8 greedy
#: requests of 32 new tokens, all prefilled whole: six prompts in [64,
#: 768], one of 4,096 tokens (8 full scan chunks of 512, 4 attention
#: query chunks) and one of 2,600 (its last scan chunk 40 rows)
HYB_ARCH, HYB_LAYERS, HYB_LEN, HYB_SLOTS, HYB_NEW = \
    "jamba-v0.1-52b", 16, 5120, 8, 32
HYB_PROMPTS, HYB_LONG = (64, 768), (4096, 2600)
#: decode step whose K2 inputs are captured in layer 12
HYB_TAP_STEP = 24
#: slots held inactive in the masked decode step (check 5)
HYB_FROZEN = (1, 5)
#: layer 0's chunked scan on the 4,096 prompt against a float64
#: sequential recurrence, max |diff| / max |ref| of y and of the final h.
#: The doubling tree is log2(512) = 9 combines deep, each a float32
#: multiply and add (u = 2^-24 relative each), on decay and drive that
#: carry about 4 roundings of their own (two products, exp at 2 ulps on
#: the card, one more product): at most 2 x 9 + 4 = 22 u, 1.3e-6 of an
#: element when nothing cancels, and y's sum over d_state = 16 adds 4
#: levels more.  The state forgets (decay < 1), so the carry across the 8
#: chunks adds little.  4e-6 (about 64 u) leaves room for that; a wrong
#: carry, order or decay moves y by a tenth of its size or more
HYB_SCAN_BOUND = 4e-6
#: the 4,096-token request's last decode logits against a cache-free
#: forward over its tokens, max |diff| / std, in bf16.  The two paths
#: round bf16 activations after different f32 sums (1-row against
#: 5,120-row products, K2's splits against chunked softmax, the Mamba
#: recurrence against the chunked scan), and a few router probabilities
#: then cross: with top-2 of 16 experts in 8 layers a flipped choice
#: moves the logits by a share of their spread, as in phase 15 (three
#: flips, 0.589).  Unrelated logits lie about 6 std apart, so this bound
#: catches gross faults (a wrong state, cache row, position or period
#: index); the float32 check below catches the rest
HYB_LOGIT_BOUND = 1.0
#: the same comparison with float32 weights at full width and all 16
#: layers, the experts replaced by dense SwiGLUs of d_ff 14,336 (4.91B
#: parameters, 19.66 GB): no bf16 rounding and no router, so prefill's
#: chunked scan and decode's recurrence are one function summed in
#: another order across 14 Mamba layers, a few float32 ulps a layer; as
#: MLA_F32_BOUND
HYB_F32_BOUND = 1e-3
#: the serve-xlstm phase: xlstm-125m's published CONFIG (src/repro_torch/
#: configs/xlstm_125m.py, arXiv:2405.04517) whole: 12 layers at full
#: width (d_model 768; 9 mLSTM layers of di 1,536 in 4 heads of 384,
#: conv kernel 4; 3 sLSTM layers with a GELU FFN of 1,024; no MLP; tied
#: embeddings of the padded vocabulary 50,432; bf16), 153,370,440
#: parameters (0.307 GB with the f32 leaves), nothing cut.  8 slots of
#: 2,176 context: the states are fixed, 8 x (9 x (4 x 384 x 384 + 4 x
#: 384 + 4 + 3 x 1,536) + 3 x 4 x 768) x 4 B = 0.172 GB.  8 greedy
#: requests of 32 new tokens, all prefilled whole: six prompts in [64,
#: 768], one of 2,048 tokens (the xLSTM paper's training context: four
#: whole scan chunks of 512) and one of 1,300 (its last chunk 276 rows)
XL_ARCH, XL_LEN, XL_SLOTS, XL_NEW = "xlstm-125m", 2176, 8, 32
XL_PROMPTS, XL_LONG = (64, 768), (2048, 1300)
#: slots held inactive in the masked decode step (check 4)
XL_FROZEN = (1, 5)
#: layer 0's chunked mLSTM on the 2,048 prompt against a float64
#: sequential recurrence (``mlstm_step`` in float64 on the same q, k, v
#: and gates), max |diff| / max |ref| of h and of the final c, n, m.  The
#: chunked form's weights are exp(logi_s - F_s - w_t), F the gates'
#: prefix sum: its doubling tree is log2(512) = 9 additions deep, each
#: rounding by u = 2^-24 of a partial sum no larger than |F| (the
#: forget gates' log sigmoids at b_f = 3 are about -0.05 a row, so |F|
#: reaches about 25 at a chunk's end), so F, u and w carry an absolute
#: error of up to 9 u |F| = 1.3e-5 each, and an exponent error e moves
#: its weight by e relative: 2 x 1.3e-5 = 2.7e-5 for a weight, carried
#: into h, c and n as weighted averages (num and den share most of it).
#: The contractions (512 rows, 384 columns) add a few u more.  1e-4
#: leaves room for that; a wrong carry, stabilizer, mask or order moves
#: h by a tenth of its size or more
XL_SCAN_BOUND = 1e-4
#: layer 3's sLSTM after the 2,048 prompt, its prefill's token loop
#: against the same tokens fed one at a time through decode at batch 1,
#: max |diff| / max |ref| of c, n, h, m.  The cells are the same code on
#: the same shapes; the input projections are not (one product of 2,048
#: rows against 2,048 of one row, summed in other orders, then rounded
#: to bf16), so a few of the 6.3M projected values differ by one bf16 ulp
#: (2^-8 relative).  The state forgets at the forget gate's rate (about
#: a half a token at bias 0), so at the end it holds the flips of the
#: last few tokens, each moving an exponential gate by up to its
#: preactivation (a few units) x 2^-8, and h, rounded to bf16 again, by
#: one more ulp: 2^-4 holds up to a few such flips at one element; a
#: wrong gate, order, stabilizer or initial n moves the state by O(1).
#: (On an H100 cuBLAS summed both products alike: bitwise, 0 flips.)
XL_SLSTM_BOUND = 2.0 ** -4
#: the 1,300-token request's last decode logits against a cache-free
#: forward over its tokens, max |diff| / std, in bf16: prefill's chunked
#: form against decode's recurrence in 9 mLSTM layers and 1-row against
#: 1,331-row products everywhere round bf16 activations after different
#: float32 sums, a bf16 ulp (2^-8) here and there through 12 layers;
#: there is no router to flip, but the mLSTM's h = num / max(|n . q|,
#: exp(-m)) divides by a dot product that can cancel, which magnifies
#: such a flip (0.172 measured at seed 0 on an H100).  As
#: SERVE_LOGIT_BOUND: the logits of another position or state lie about
#: 6 std apart at their largest difference
XL_LOGIT_BOUND = 0.25
#: the same comparison with float32 weights (0.61 GB, nothing cut): no
#: bf16 rounding, so the chunked form and the recurrence are one
#: function summed in other orders, a few float32 ulps a layer; as
#: HYB_F32_BOUND
XL_F32_BOUND = 1e-3
#: the train-moe phase: deepseek-v2-lite-16b's published CONFIG (phase
#: 15's) at full width, cut in depth: a layer adds 584,847,872 parameters
#: (MLA about 13.8 M; 64 routed experts of 3 x 2,048 x 1,408; 2 shared of
#: 1,408 columns each; the router, 2,048 x 64), the embedding and the
#: untied head 419,432,448.  Whole (27 layers) its train state (bf16
#: weights and gradients, two float32 AdamW moments) needs about 195 GB;
#: at 4 layers it holds 2,758,823,936 parameters (5.52 GB of bf16
#: weights, 22.07 GB of moments).  Phase 11's batch (8 x 256 tokens of
#: ``SyntheticLM``), 4 microbatches and schedule; remat on; the
#: ``capacity`` dispatch (the reference's default)
MOE_TRAIN_ARCH, MOE_TRAIN_LAYERS = "deepseek-v2-lite-16b", 4
#: the exact step (``grad_reduce`` and ``norm_policy`` "exact") keeps the
#: m microbatch gradients and the domain of the leaf it reduces: phase
#: 11's exact step peaked at about 29.5 bytes a parameter, so it runs at
#: 2 layers (1,589,128,192 parameters; its largest leaf, blocks/0/mlp/wi
#: at 2 x 64 x 2,048 x 1,408 = 369,098,752 values, larger than any phase
#: 11 reduced)
MOE_K1_LAYERS = 2
#: deepseek's reference leaves (19 whatever the depth) and K1's launches
#: in its exact step: one microbatch mean a leaf, two a leaf and one
#: across the leaves for the clip's norm
MOE_LEAVES = 19
MOE_K1_PER_STEP = MOE_LEAVES + 2 * MOE_LEAVES + 1
#: the dispatch check: one MoE layer at full width in float32 over 512
#: tokens (one microbatch's 2 x 256) of N(0, 1) values, the loss
#: sum(y * c) + 0.01 aux for N(0, 1) c.  With a capacity of 512 nothing
#: drops (a token chooses an expert once), so ``capacity`` and ``dense``
#: are one function of the same router choices, summed in other orders:
#: the combine over 6 choices against 64 gates (58 of them exact zeros),
#: x's gradient over the kept choices against all 64 experts, the
#: experts' gradients over the capacity buffer's rows against all 512
#: tokens (the unchosen exact zeros).  So each gradient leaf agrees to a
#: few float32 ulps of its sums: max |capacity - dense| over the leaf's
#: largest |dense| within MOE_DISPATCH_REL
MOE_DISPATCH_TOKENS, MOE_DISPATCH_REL = 512, 1e-5
#: the serve-vlm phase: qwen2-vl-7b's published CONFIG (src/repro_torch/
#: configs/qwen2_vl_7b.py, arXiv:2409.12191) whole, nothing cut: 28
#: layers, d_model 3,584, 28 heads on 4 KV heads (7 query heads a KV head,
#: hd 128, M-RoPE sections (16, 24, 24)), d_ff 18,944, vocab 152,064,
#: rope_theta 1e6; 7,615,283,200 bf16 parameters (15.23 GB).  Phase 10's
#: engine and traffic (SERVE_*): 8 slots of 1,024 context on f32 caches
#: (28 x 2 x 8 x 1,024 x 4 x 128 x 4 B = 0.94 GB), 32-token prefill
#: chunks, 8 greedy requests with prompts in [64, 768] and 32 new tokens;
#: the decode logits held to SERVE_LOGIT_BOUND over 28 layers
VLM_ARCH = "qwen2-vl-7b"
#: requests also run alone in a fresh Engine
VLM_ALONE = (0, 3, 7)
#: the distinct-stream prompt: 200 text tokens, a 16 x 16 patch grid, 144
#: text tokens (S = 600, positions up to 359)
VLM_TEXT, VLM_GRID = (200, 144), 16
#: M-RoPE at full width against a float64 rotation, each element's
#: |diff| over (|x1| + |x2|) (|angle| + 1) u, u = 2^-24: the frequency
#: (powf, 4 ulps on the card, then a division) and the angle's product
#: carry up to 10 u of the angle, cosf and sinf 2 ulps (4 u) absolute, the
#: rotation's two products and sum 3 u of |x1| + |x2|: at most about 17.
#: A slot turned by the wrong stream is off by up to 15 positions times
#: its frequency (at least 1.5e-6 rad a position), about 385 u at the
#: least; a wrong frequency or section by far more
VLM_ROPE_BOUND = 32
#: the serve-encdec phase: seamless-m4t-large-v2's published CONFIG
#: (src/repro_torch/configs/seamless_m4t_large_v2.py, arXiv:2308.11596)
#: whole, nothing cut: 24 encoder layers, 24 decoder layers each with a
#: cross-attention, d_model 1,024, 16 heads on 16 KV heads (hd 64), d_ff
#: 8,192, vocab 256,206; 1,632,233,472 bf16 parameters (3.264 GB).  B = 8
#: requests, each with its own encoder memory: ``enc_embeds`` (8, 4,096,
#: 1,024) bf16, N(0, 1), standing for the stub speech frontend's output at
#: the reference's ENC_LEN_DECODE (src/repro/launch/specs.py:22);
#: decoder prompts of 32 tokens prefilled in lock step through
#: ``make_prefill_step``, caches padded to 128, 96 greedy steps through
#: ``make_decode_step(enc_out=)``: K2 24 times a step on the self caches
#: (kv_len 33-128) and 24 times on the memory (kv_len 4,096, 4 splits x
#: 16 heads x 8 requests = 512 CUDA blocks a launch)
ENCDEC_ARCH, ENCDEC_PARAMS = "seamless-m4t-large-v2", 1_632_233_472
ENCDEC_BATCH, ENCDEC_MEMORY, ENCDEC_PROMPT = 8, 4096, 32
ENCDEC_LEN, ENCDEC_NEW = 128, 96
#: requests also decoded alone (their row of an otherwise empty batch:
#: token-0 prompts and zero memories), held over their first 32 tokens
ENCDEC_ALONE, ENCDEC_ALONE_TOKENS = (0, 3, 7), 32
#: the memory-swap check: two requests' memories exchanged move their
#: last logits by more than this share of the logits' std (a forward on
#: the same inputs repeats bit for bit, so any change is the memory's)
ENCDEC_SWAP_MIN = 1e-3
#: the card's dense bf16 tensor-core peak (H100 SXM data sheet), for the
#: decode step's bound by operations
BF16_OPS_PER_S = 989e12
#: the train-elastic phase: groups of 1, 2 and 4 ranks on the one card,
#: each a fresh interpreter (gloo: NCCL takes one rank a GPU), W = 2 first
#: (its snapshot is what W = 4 and W = 1 resume from)
ELASTIC_WORLDS = (2, 4, 1)
#: xlstm-125m's published CONFIG (src/repro_torch/configs/xlstm_125m.py,
#: arXiv:2405.04517) whole, nothing cut: 12 layers (3 periods of 3 mLSTM
#: and 1 sLSTM), d_model 768, vocab 50,304; 153,370,440 parameters, 44
#: leaves.  The elastic step (exact2, one-row microbatches): a global
#: batch of 8 sequences of ELASTIC_SEQ tokens a step, 4 steps on 2 ranks
#: with a snapshot after step 2, then steps 3 and 4 from it on 4 ranks and
#: on 1.  A step's exact2 carries cross the ranks as 10 int32 words a
#: parameter (6.13 GB a rank, staged through the host both ways), which
#: gloo moves at about 0.6 GB/s: most of a step at W = 2 and 4 (PERF.md,
#: PR 33).  The rows are 64 tokens to keep the model's share small
ELASTIC_ARCH, ELASTIC_BATCH, ELASTIC_SEQ = "xlstm-125m", 8, 64
ELASTIC_STEPS, ELASTIC_SAVE = 4, 2
#: check 2's gradient-shaped stack: 8 items the shape of one mLSTM
#: up-projection leaf (768 x 3,072), split over the ranks
ELASTIC_ITEMS = (8, 768, 3072)
#: check 4: the launcher's compressed step (8 bits, 2 microbatches a
#: rank) on 2 ranks, LAUNCH_STEPS steps of 8 x LAUNCH_SEQ tokens
LAUNCH_STEPS, LAUNCH_SEQ = 4, 64
#: each rank's timeout, seconds
RANK_TIMEOUT = 300
#: the circuit phase (src/repro_torch/core/circuit_scan.py, the paper's
#: Fig. 3 and Algorithms 1-2): check 1's (adder latency L, PIS registers
#: R), from one slot and one register to the kernel's limit of 64 each,
#: and its streams' length
CIRCUIT_SHAPES = ((1, 1), (2, 4), (14, 2), (14, 4), (14, 8), (32, 16),
                  (64, 64))
CIRCUIT_CHECK_T = 2048
#: Table II (paper: minimum set size 94, 29 and 18 at L = 14 and R = 2,
#: 4, 8), searched on the card at R in CIRCUIT_REGS, then at each L of
#: CIRCUIT_SWEEP_L; (L, R) of the sweep held to the plain version
CIRCUIT_REGS = (2, 4, 8, 16)
CIRCUIT_PAPER_MIN = {2: 94, 4: 29, 8: 18}
CIRCUIT_SWEEP_L = (2, 4, 8, 14, 20, 32)
CIRCUIT_SWEEP_PLAIN = ((2, 2), (32, 16))
#: the real-size run: 65,536 circuits x 16,384 cycles at the paper's
#: design point (L = 14 as the IP adder, R = 4), sets of [64, 512]
#: values: 6 bytes in and 10 out a circuit-cycle, 17.2 GB on the card
CIRCUIT_B, CIRCUIT_T, CIRCUIT_L, CIRCUIT_R = 65536, 16384, 14, 4
CIRCUIT_SETS = (64, 512)
#: check (a)'s prefix (cycles, and circuits of the real-size run), the
#: circuits run whole in the Python oracle (check (b)) and the most of
#: (c)'s flagged ones re-run there
CIRCUIT_PREFIX, CIRCUIT_ORACLE = 4096, 16
#: Table II's latency constant, DS + 110..113 (paper)
CIRCUIT_PAPER_C = (110, 113)
#: phase 23: the rmsnorm knob per layer at stablelm-1.6b's width on
#: (KNOB_BATCH x KNOB_SEQ) tokens, and its train step cut to KNOB_LAYERS
#: layers on a batch of that shape
KNOB_ARCH, KNOB_BATCH, KNOB_SEQ, KNOB_LAYERS = "stablelm-1.6b", 8, 256, 2
#: the knob's train-step tiers: a float tier (a gather backward) and an
#: integer one (outside the graph)
KNOB_TIERS = ("fast", "exact2")
#: K1 launches of a knob train step: each block's two rmsnorms and the
#: final one in the forward, the blocks' two again where remat recomputes
#: them; the backward launches none (a gather by label)
KNOB_K1_PER_STEP = 2 * KNOB_LAYERS + 1 + 2 * KNOB_LAYERS
#: the parameter and cache bytes phase 10's serving run allocated
PHASE10_BYTES = {}


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


def small_decode_checks(gen, dev, b, h, kh, s_len, d):
    """Phase 6 at one small shape (B, H, K, S, d): K2, K3 and K4 bitwise
    their plain versions on a shuffled pool of 8 pages of 128 rows, kv_len
    (0, 517, S), window None and 200; K2 and K4 also at split_rows 128,
    384 and 1,024 (per = 1 and > 1, dead splits at both ends with the
    window, the request with kv_len 0)."""
    import importlib
    import torch
    from repro_torch.kernels import ops
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    shape = f"({b}, {h}, {kh}, {s_len}, {d})"
    pshape = f"({b}, {h}, {kh}, {8 * 128}, {d})"
    q = torch.randn((b, h, d), generator=gen, device=dev)
    kv_len = torch.tensor([0, 517, s_len], device=dev)
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
                print(f"check {name:7s} {shape} window="
                      f"{window} {kw}: max|kernel-plain|={err:g} "
                      f"{'bitwise' if ok else 'DIFFER'}", flush=True)
                check(ok, f"{name} kernel differs from its plain version at "
                          f"{shape}")
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
                print(f"check dense   {shape} window={window} "
                      f"block_kv={block} split_rows={rows} (per "
                      f"{fd.split_shape(-(-s_len // block), block, rows)[0]}"
                      f"): max|kernel-plain|={err:g} "
                      f"{'bitwise' if ok else 'DIFFER'}", flush=True)
                check(ok, f"dense kernel differs from its plain version at "
                          f"{shape}")
            ok, err = same(fd.flash_decode_paged_cuda(
                q, kp, vp, pbias, tables, sm_scale=sc, split_rows=rows),
                fd.flash_decode_paged_torch(q, kp, vp, pbias, tables,
                                            sm_scale=sc, split_rows=rows))
            print(f"check paged   {pshape} ps=128 window="
                  f"{window} split_rows={rows}: max|kernel-plain|={err:g} "
                  f"{'bitwise' if ok else 'DIFFER'}", flush=True)
            check(ok, f"paged kernel differs from its plain version at "
                      f"{pshape}")
    del q, kp, vp, k, v


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

    # 6. kernel against plain at small sizes: G = 4, and G = 7 (qwen2-vl-
    # 7b's group at its head width: one CUDA block of 7 query rows, a
    # thread's last row past the group's end), from a generator of its own
    small_decode_checks(gen, dev, 3, 8, 2, 1000, 64)
    g7 = torch.Generator(device=dev)
    g7.manual_seed(seed + 20)
    small_decode_checks(g7, dev, *DECODE_G7)

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
    PHASE10_BYTES.update(params=M.param_bytes(model),
                         caches=M.cache_bytes(eng._caches))
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

    # K1 at the mean_logprob shape: the run's (step x slot) stream, beside
    # one index_add_ of the same values
    vals = torch.cat(stream["vals"])[:, None]
    ids = torch.from_numpy(np.concatenate(stream["ids"])).to(dev)
    nseg = len(requests)
    safe = torch.where(ids >= 0, ids, nseg).long()
    entry = k1_entry("serve", vals, ids, nseg, "compensated", smi,
                     op="mean", library=lambda: torch.zeros(
                         (nseg + 1, 1), device=dev).index_add_(0, safe, vals))
    entries.append(dict(entry, launches=k1_launches))
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
    inputs (host clock) and held bitwise, and for an unsegmented stream of
    an integer tier ``torch.sum`` over the rows of its int32 domain timed
    (the same int32 column sums);
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
        if pol.name in INT_TIERS and num_segments == 1:
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
              f"plain {entry['plain_ms']:.1f}, torch.sum "
              f"{entry['library_ms']}); peak memory of the check "
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
    from repro_torch.kernels import jugglepac_fsm
    K.LAUNCHES = 0
    ia.LAUNCHES = 0
    jugglepac_fsm.LAUNCHES = 0
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


def accum_cpu_rank(group, path, name, scale, max_abs):
    """One fresh interpreter of phase 13 (``spawn.run_ranks``, one rank):
    ``name``'s pushes of the stream saved at ``path``, on the CPU ->
    {"st": the state, "ms": host ms}."""
    import torch
    import repro_torch.reduce as R
    x = torch.load(path, mmap=True, weights_only=True)
    acc = (R.Limb3Accumulator(scale) if name == "Limb3Accumulator"
           else R.BinAccumulator(max_abs))
    st, ms = push_rows(acc, x)
    return {"st": st, "ms": ms}


def start_cpu_pushes(xc, names, scale, max_abs, tmp):
    """Start ``accum_cpu_rank`` for each of ``names`` on ``xc`` (saved once
    under ``tmp``), each in its own interpreter, waited on by a thread ->
    (threads, results by name: the rank's return value or its error)."""
    import threading
    import torch
    from repro_torch.distributed import spawn
    path = Path(tmp) / "x.pt"
    torch.save(xc, path)
    results = {}

    def run(name):
        try:
            results[name] = spawn.run_ranks(
                "chip_smoke:accum_cpu_rank", 1, workdir=Path(tmp) / name,
                kwargs={"path": str(path), "name": name, "scale": scale,
                        "max_abs": max_abs},
                threads=2, paths=[str(ROOT)], timeout=RANK_TIMEOUT)[0]
        except Exception as e:                       # noqa: BLE001
            results[name] = e

    threads = [threading.Thread(target=run, args=(nm,)) for nm in names]
    for th in threads:
        th.start()
    return threads, results


def accum_phase(seed, dev, smi):
    """Phase 13: the streaming accumulators at the INTAC shape on the
    card, each row of the stream one push."""
    import shutil
    import tempfile
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 3)                 # phase 8's stream
    n, d, scale = INTAC_ROWS, INTAC_COLS, INTAC_SCALE
    torch.cuda.reset_peak_memory_stats()
    mag = torch.randint(-12, 4, (n, d), generator=gen, device=dev)
    x = (torch.randn((n, d), generator=gen, device=dev)
         * torch.exp2(mag.to(torch.float32))).clamp(-31.0, 31.0)
    del mag
    # the CPU runs Limb3 and Bin are held to push while the card does:
    # the host's two longest loops, each in a fresh interpreter
    max_abs = float(x.abs().max())
    tmp = tempfile.mkdtemp(prefix="accum_smoke_", dir=ROOT / "build")
    threads = []
    try:
        threads, cpu_runs = start_cpu_pushes(
            x.cpu(), ("Limb3Accumulator", "BinAccumulator"), scale, max_abs,
            tmp)
        accum_checks(x, scale, max_abs, threads, cpu_runs, smi)
    finally:
        for th in threads:
            th.join()
        shutil.rmtree(tmp, ignore_errors=True)
    del x
    torch.cuda.empty_cache()


def accum_checks(x, scale, max_abs, threads, cpu_runs, smi):
    """Phase 13's checks on the card's stream ``x``; ``cpu_runs`` fills
    with the CPU runs as ``threads`` end."""
    import torch
    import repro_torch.reduce as R
    from repro_torch.core import intac as I
    from repro_torch.kernels import ops
    n, d = x.shape
    dev = x.device
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
    for (name, acc), th in zip(
            (("Limb3Accumulator", R.Limb3Accumulator(scale)),
             ("BinAccumulator", R.BinAccumulator(max_abs))), threads):
        reset_launches()
        st, times[name] = push_rows(acc, x)
        counts = read_launches()
        th.join()
        got = cpu_runs[name]
        check(isinstance(got, dict), f"accumulators: {name}'s CPU run "
                                     f"failed: {got}")
        st_c, cpu_ms = got["st"], got["ms"]
        fields = list(st) if isinstance(st, tuple) else [st]
        fields_c = list(st_c) if isinstance(st_c, tuple) else [st_c]
        ok = all(torch.equal(a.cpu(), b) for a, b in zip(fields, fields_c)
                 if a is not None)
        fin_ok = torch.equal(acc.finalize(st).cpu(), acc.finalize(st_c))
        print(f"check {name}: card state {'bitwise' if ok else 'DIFFERS from'} "
              f"its CPU run, finalize {'bitwise' if fin_ok else 'DIFFERS'} "
              f"(CPU {cpu_ms:.1f} ms on the host clock, in a fresh "
              f"interpreter beside the card's pushes), kernel launches "
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
    del x64, absum, s64, kahan, casc, w, c_ref


def k1_entry(name, vals, ids, nseg, tier, smi, library=None, op="sum"):
    """K1 on one stream (``vals`` (N, D) f32, ``ids`` (N,) int32) under
    ``tier``, as the front door launches it for ``op``: its domain
    prepared, the kernel bitwise its plain version (checked), both timed
    beside ``library()`` (one PyTorch call computing the same sums, where
    there is one) and the bound; returns the kernel-table entry with
    ``launches`` 0 (the caller sets the main path's count)."""
    import torch
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.reduce import get_policy, mask_out_of_range, \
        plan_program
    pol = get_policy(tier)
    dev = vals.device
    mids = mask_out_of_range(ids, nseg)
    dom, _ = pol.prepare(torch.where((mids >= 0)[:, None], vals,
                                     torch.zeros((), device=dev)), len(ids))
    prog = plan_program(pol, num_segments=nseg, domain_width=dom.shape[1],
                        block_size=512, op=op)
    pad = (-len(ids)) % 512
    plain_ms, plain = host_ms(lambda: K.segsum_policy_torch(
        torch.cat([dom, dom.new_zeros((pad, dom.shape[1]))]),
        torch.cat([mids, mids.new_full((pad,), -1)]), nseg, policy=pol,
        program=prog, block_rows=512))
    kern = K.segsum_policy_cuda(dom, mids, nseg, policy=pol, program=prog,
                                block_rows=512)
    ok, err = same(tuple(kern), tuple(plain))
    ms = cuda_ms(lambda: K.segsum_policy_cuda(
        dom, mids, nseg, policy=pol, program=prog, block_rows=512), REPS)
    lib_ms = None if library is None else cuda_ms(library, REPS)
    kept = int((mids >= 0).sum())
    bytes_ = len(ids) * 4 + kept * dom.shape[1] * 4 \
        + sum(c.numel() * 4 for c in kern)
    ops_ = kept * dom.shape[1]
    bound = max(bytes_ / HBM_BYTES_PER_S, ops_ / FP32_OPS_PER_S) * 1e3
    print(f"check K1 {tier} at the {name} shape ({tuple(vals.shape)}, "
          f"{nseg} label(s)): max|kernel-plain|={err:g} "
          f"{'bitwise' if ok else 'DIFFER'}; kernel {ms:.4f} ms, bound "
          f"{bound:.4f} ms, plain {plain_ms:.1f} ms, library "
          f"{'n/a' if lib_ms is None else f'{lib_ms:.4f} ms'} | {smi}",
          flush=True)
    check(ok, f"{name}: K1 differs from its plain version")
    return {"name": f"segsum_policy_kernel<{tier}>/{name}", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segsum.cu",
            "replaces": "src/repro/kernels/jugglepac_segsum.py:77",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                         >= ops_ / FP32_OPS_PER_S else "operations"),
            "library_ms": lib_ms}


def serve_moe_phase(seed, dev, smi):
    """Phase 14: mixtral-8x22b at full width, cut to ``MOE_LAYERS``
    layers, served through the port's ``Engine`` on ring caches; returns
    the kernel entries of K2 on the ring and of K1 on the router's
    normalization and on ``combine_segsum``."""
    import dataclasses
    import gc
    import importlib
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.serve import Engine, Request
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(MOE_ARCH), n_layers=MOE_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 21)
    t0 = time.perf_counter()
    model = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    weights_gb = M.param_bytes(model) / 1e9
    host = torch.Generator()
    host.manual_seed(seed + 22)
    lens = torch.randint(MOE_PROMPTS[0], MOE_PROMPTS[1] + 1,
                         (MOE_SLOTS - len(MOE_LONG),),
                         generator=host).tolist() + list(MOE_LONG)
    requests = [Request(prompt=torch.randint(1, cfg.vocab, (n,),
                                             generator=host).tolist(),
                        max_new_tokens=MOE_NEW) for n in lens]
    last = MOE_SLOTS - 1                 # the 5,120-token request
    print(f"serve-moe: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, {cfg.moe.num_experts}"
          f" experts top-{cfg.moe.top_k}, d_ff {cfg.moe.d_ff_expert}, vocab "
          f"{cfg.vocab}, window {cfg.window}, {cfg.dtype}), {cfg.n_layers} "
          f"of 56 layers: {sum(p.numel() for p in model.parameters())} "
          f"parameters ({weights_gb:.3f} GB) drawn in {init_s:.2f} s "
          f"({held / 2 ** 30:.2f} GiB held before); {MOE_SLOTS} slots x "
          f"{MOE_LEN} context on rings of {cfg.window} slots; prompts "
          f"{lens}, {MOE_NEW} new tokens each, greedy", flush=True)

    def engine():
        return Engine(cfg, model, max_len=MOE_LEN, max_batch=MOE_SLOTS,
                      logprob_policy="compensated", device=dev)

    # taps: decode steps seen by layer 0; the middle layer's K2 inputs and
    # output at one step; the decode logits; the MoE input of the middle
    # layer in the 5,120-token prefill and at the tapped decode step
    layer = cfg.n_layers // 2
    tap = {"steps": 0, "mid": 0, "logits": None}

    def count_steps(mod, args, out):
        tap["steps"] += 1

    def capture(mod, args, out):
        tap["mid"] += 1
        if tap["mid"] == MOE_TAP_STEP:
            q, k, v, kv_len, sc = args
            tap.update(q=q.clone(), k=k.clone(), v=v.clone(),
                       kv_len=kv_len.clone(), sc=sc, out=out.clone())

    def moe_input(mod, args):
        x = args[0]
        if x.shape[1] == MOE_LONG[-1]:
            tap["prefill_x"] = x.clone()
        elif x.shape[1] == 1 and tap["mid"] == MOE_TAP_STEP \
                and "decode_x" not in tap:
            tap["decode_x"] = x.clone()

    def last_logits(mod, args, kwargs, out):
        if kwargs.get("mode") == "decode" and args[0].shape[1] == 1:
            tap["logits"] = out[0][:, 0].clone()

    hooks = [model.blocks[0].core.decode_attn.register_forward_hook(
                 count_steps),
             model.blocks[layer].core.decode_attn.register_forward_hook(
                 capture),
             model.blocks[layer].mlp.register_forward_pre_hook(moe_input),
             model.register_forward_hook(last_logits, with_kwargs=True)]

    # the main path: counts set to 0 just before, read just after
    eng = engine()
    slot_of = {}

    def on_step(e, step):
        slot_of.update((tr.rid, tr.slot)
                       for tr in e.scheduler.in_state("decode"))

    rids = [eng.submit(r) for r in requests]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for hk in hooks:
        hk.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = tap["steps"]
    new = sum(len(r.tokens) - r.prompt_len for r in results)
    print(f"main serve-moe: {len(results)} results in order "
          f"{[r.rid for r in results]}, {new} tokens, {steps} decode steps "
          f"in {wall * 1e3:.1f} ms; launches {launches} (K2 want {steps} x "
          f"{cfg.n_layers}, K1 want 1); peak memory {peak_gb:.2f} GiB; "
          f"mean_logprob {[round(r.mean_logprob, 4) for r in results]}",
          flush=True)
    check([r.rid for r in results] == rids
          and all(len(r.tokens) - r.prompt_len == MOE_NEW
                  and r.tokens[:r.prompt_len] == q.prompt
                  and all(0 <= t < cfg.vocab for t in r.tokens)
                  and math.isfinite(r.mean_logprob)
                  for r, q in zip(results, requests)),
          "serve-moe: results out of order, short, out of the vocabulary "
          "or with a non-finite mean_logprob")
    check(steps >= MOE_NEW - 1
          and launches == {"K1": 1, "K2": steps * cfg.n_layers, "K3": 0,
                           "K4": 0, "K5": 0},
          f"serve-moe: launches {launches} for {steps} decode steps")

    # K2 against its plain version on the engine's own ring and query, at
    # a step where the 4,096-token request's ring has wrapped
    q, k, v, kv_len, sc = (tap[x] for x in ("q", "k", "v", "kv_len", "sc"))
    qf = q.float().contiguous()
    bias = ops.length_bias(kv_len, k.shape[1], None, dev)
    plain_ms, plain = host_ms(lambda: fd.flash_decode_torch(
        qf, k, v, bias, sm_scale=sc, block_kv=512))
    kern = fd.flash_decode_cuda(qf, k, v, bias, sm_scale=sc, block_kv=512)
    ok, k2_err = same(kern, plain)
    ok_engine = torch.equal(kern, tap["out"])
    lengths_then = [lens[r] + MOE_TAP_STEP - 1 for r in range(MOE_SLOTS)]
    print(f"check K2 on the ring (layer {layer}, decode step "
          f"{MOE_TAP_STEP}: cache {tuple(k.shape)} {k.dtype}, kv_len "
          f"{kv_len.tolist()}, request lengths {lengths_then}): "
          f"max|kernel-plain|={k2_err:g} {'bitwise' if ok else 'DIFFER'}; "
          f"the engine's own output {'bitwise' if ok_engine else 'DIFFER'}",
          flush=True)
    check(int(kv_len.max()) == cfg.window and ok and ok_engine,
          "serve-moe: K2 differs from its plain version on the wrapped ring")
    k2_ms = cuda_ms(lambda: fd.flash_decode_cuda(
        qf, k, v, bias, sm_scale=sc, block_kv=512), REPS)
    rows = int(kv_len.sum())
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
        qf[:, :, None], k4, v4, attn_mask=mask, scale=sc, enable_gqa=True),
        REPS)
    del k4, v4, mask
    entries = [{
        "name": "flash_decode_kernel<dense>/serve-moe-ring",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:72",
        "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": plain_ms, "bound_ms": k2_bound,
        "bound_by": ("bytes" if k2_bytes / HBM_BYTES_PER_S
                     >= k2_ops / FP32_OPS_PER_S else "operations"),
        "library_ms": sdpa_ms}]

    # timings on the engine's final state: every slot active at its
    # length, each call writing the same ring slot (the caches not kept)
    lengths = eng._caches[0]["core"].length[0].clone()
    toks = torch.tensor([[r.tokens[-1]] for r in results], device=dev)
    active = torch.ones(MOE_SLOTS, dtype=torch.bool, device=dev)
    with torch.no_grad():
        step_ms = cuda_ms(lambda: M.decode_step(
            model, toks, eng._caches, lengths, active=active,
            moe_impl="dense"), REPS)
        prefill_ms = {}
        for i in (MOE_SLOTS - 2, last):
            ptoks = torch.tensor([requests[i].prompt], device=dev)
            prefill_ms[lens[i]] = cuda_ms(
                lambda: eng._classic_prefill(i, ptoks), 3)
    print(f"time serve-moe: decode step at B={MOE_SLOTS} {step_ms:.3f} ms "
          f"(bound {weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms: the "
          f"weights once over 3.35 TB/s; {MOE_SLOTS * 1e3 / step_ms:.1f} "
          f"tokens/s decoding) | whole-prompt prefill "
          + ", ".join(f"{n} tokens {ms:.1f} ms" for n, ms in
                      prefill_ms.items())
          + f" | the run: {new} tokens in {wall * 1e3:.1f} ms "
          f"({new / wall:.1f} generated tokens/s, prefill included) | K2 "
          f"per layer per step {k2_ms:.4f} ms, bound {k2_bound:.4f} ms "
          f"({k2_bytes / 1e6:.2f} MB: the live ring rows), plain "
          f"{plain_ms:.1f} ms, SDPA {sdpa_ms:.4f} ms | weights "
          f"{weights_gb:.3f} GB, rings {M.cache_bytes(eng._caches) / 1e9:.3f}"
          f" GB (f32 k/v), peak {peak_gb:.2f} GiB | {smi}", flush=True)
    del q, k, v, qf, bias, kern, plain, eng
    tap.update(q=None, k=None, v=None, out=None)
    gc.collect()
    torch.cuda.empty_cache()

    # K1 on the router's normalization: mixtral's router with
    # router_norm_topk and the exact policy over the 5,120-token prefill's
    # router stream of the middle layer (k = 2 rows x 5,120, one label)
    router = model.blocks[layer].mlp.router
    m = dataclasses.replace(cfg.moe, router_norm_topk=True,
                            router_norm_policy="exact")
    xs = tap.pop("prefill_x").reshape(-1, cfg.d_model)
    K.LAUNCHES = 0
    w_k1, idx_k1, _ = moe.router_topk(router, xs, m)
    k1_count = K.LAUNCHES
    w_bl, idx_bl, _ = moe.router_topk(router, xs, m, backend="blocked")
    ok = torch.equal(idx_k1, idx_bl) and torch.equal(w_k1, w_bl)
    print(f"check router_topk with router_norm_policy='exact' over the "
          f"{xs.shape[0]}-token prefill's router stream: K1 launched "
          f"{k1_count} time(s); weights through K1 "
          f"{'bitwise' if ok else 'DIFFER from'} blocked's", flush=True)
    check(ok and k1_count == 1, "serve-moe: the router's normalization "
                                "through K1 differs from blocked's")
    raw = moe.router_topk(router, xs, cfg.moe)[0]
    wt = raw.T.contiguous()
    entries.append(k1_entry("router-norm", wt, torch.zeros(
        wt.shape[0], dtype=torch.int32, device=dev), 1, "exact", smi,
        lambda: torch.sum(wt, 0)))

    # K1 on combine_segsum at the decode shape: the middle layer's
    # gate-weighted expert rows at the tapped step (8 tokens x top-2)
    xd = tap.pop("decode_x").reshape(-1, cfg.d_model)
    t = xd.shape[0]
    w, idx, _ = moe.router_topk(router, xd, cfg.moe)
    mlp = model.blocks[layer].mlp
    with torch.no_grad():
        ye = moe._expert_ffn(mlp, xd.expand(cfg.moe.num_experts, t,
                                            cfg.d_model))
    tok = torch.arange(t, device=dev)[:, None].expand_as(idx)
    rows_ = (ye[idx, tok].float() * w[..., None]).reshape(-1, cfg.d_model)
    ids = tok.reshape(-1).to(torch.int32).contiguous()
    K.LAUNCHES = 0
    got = moe.combine_segsum(rows_, ids, t)
    k1_count = K.LAUNCHES
    ok = torch.equal(got, moe.combine_segsum(rows_, ids, t,
                                             backend="blocked"))
    print(f"check combine_segsum at the decode shape ({tuple(rows_.shape)},"
          f" {t} tokens): K1 launched {k1_count} time(s), "
          f"{'bitwise' if ok else 'DIFFERS from'} blocked", flush=True)
    check(ok and k1_count == 1, "serve-moe: combine_segsum through K1 "
                                "differs from blocked")
    entries.append(k1_entry("combine-segsum", rows_, ids, t, "fast", smi,
                            lambda: torch.zeros(
                                (t, cfg.d_model), device=dev).index_add_(
                                    0, ids, rows_)))
    del xs, xd, ye, rows_, raw, wt

    # batch independence: the 4,096-token request alone in a fresh Engine
    i = MOE_SLOTS - 2
    alone = engine().generate([requests[i]])[0]
    gc.collect()
    torch.cuda.empty_cache()
    same_toks = alone.tokens == results[i].tokens
    print(f"check request {i} (prompt {lens[i]}) alone vs in the batch: "
          f"tokens {'bitwise' if same_toks else 'DIFFER'}", flush=True)
    check(same_toks, f"serve-moe: request {i} depends on its batch")

    # the 5,120-token request's last decode logits against a cache-free
    # forward over its tokens with the window mask, padded to 6,144
    # tokens (causal: the padding is never seen) so that its attention
    # takes the chunked path
    seq = results[last].tokens[:-1]
    pad = -len(seq) % cfg.attn_qchunk
    with torch.no_grad():
        full = M.forward(model, tokens=torch.tensor(
            [seq + [0] * pad], device=dev), mode="train",
            moe_impl="dense")[0]
    ref = full[0, len(seq) - 1]
    del full
    got = tap["logits"][slot_of[last]]
    rel = float((got - ref).abs().max() / ref.std())
    agree = int(got[:cfg.vocab].argmax()) == int(ref[:cfg.vocab].argmax())
    print(f"check request {last}'s last decode step (position "
          f"{len(seq) - 1}, slot {slot_of[last]}) vs a cache-free forward "
          f"over its {len(seq)} tokens (+{pad} padding): max|diff| / "
          f"std(logits) = {rel:.5f} (bound {MOE_LOGIT_BOUND}), std "
          f"{float(ref.std()):.4f}, argmax {'agrees' if agree else 'differs'}"
          f" | {smi}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= MOE_LOGIT_BOUND,
          "serve-moe: decode logits outside the bound of the cache-free "
          "forward")
    del model, results, tap
    gc.collect()
    torch.cuda.empty_cache()
    return entries


def serve_mla_phase(seed, dev, smi):
    """Phase 15: deepseek-v2-lite-16b whole, at full width and all 27
    layers, served through the port's ``Engine`` on latent caches;
    returns the kernel entries of K1 on ``mean_logprob``, on the router's
    normalization and on the latent's rmsnorm."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.models.layers import dense, rmsnorm
    from repro_torch.serve import Engine, Request

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = get_config(MLA_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 31)
    t_phase = time.perf_counter()
    model = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    weights_gb = M.param_bytes(model) / 1e9
    host = torch.Generator()
    host.manual_seed(seed + 32)
    lens = torch.randint(MLA_PROMPTS[0], MLA_PROMPTS[1] + 1,
                         (MLA_SLOTS - len(MLA_LONG),),
                         generator=host).tolist() + list(MLA_LONG)
    requests = [Request(prompt=torch.randint(1, cfg.vocab, (n,),
                                             generator=host).tolist(),
                        max_new_tokens=MLA_NEW) for n in lens]
    two_k, last = MLA_SLOTS - 2, MLA_SLOTS - 1   # the 2,048 and 3,072
    print(f"serve-mla: {cfg.name} whole (d_model {cfg.d_model}, "
          f"{cfg.n_layers} layers, {cfg.n_heads} heads, latent "
          f"{cfg.kv_lora_rank} + rope {cfg.qk_rope_dim}, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} + "
          f"{cfg.moe.num_shared} shared, d_ff {cfg.moe.d_ff_expert}, vocab "
          f"{cfg.vocab}, {cfg.dtype}): "
          f"{sum(p.numel() for p in model.parameters())} parameters "
          f"({weights_gb:.3f} GB) drawn in {init_s:.2f} s "
          f"({held / 2 ** 30:.2f} GiB held before); {MLA_SLOTS} slots x "
          f"{MLA_LEN} context, "
          f"prefill chunks of {MLA_CHUNK}; prompts {lens}, {MLA_NEW} new "
          f"tokens each, greedy", flush=True)

    def engine():
        return Engine(cfg, model, max_len=MLA_LEN, max_batch=MLA_SLOTS,
                      prefill_chunk=MLA_CHUNK, logprob_policy="compensated",
                      device=dev)

    # taps: decode steps seen by layer 0's absorbed attention (s = 1; a
    # prefill chunk goes through it too, at s = 32); the middle layer's
    # absorbed attention inputs and output at one decode step; the
    # model's last decode-step logits
    layer = cfg.n_layers // 2
    tap = {"steps": 0, "mid": 0, "logits": None}

    def count_steps(mod, args, out):
        tap["steps"] += int(args[0].shape[1] == 1)

    def capture(mod, args, out):
        if args[0].shape[1] != 1:
            return
        tap["mid"] += 1
        if tap["mid"] == MLA_TAP_STEP:
            tap["attn"] = tuple(a.clone() if torch.is_tensor(a) else a
                                for a in args)
            tap["attn_out"] = out.clone()

    def last_logits(mod, args, kwargs, out):
        if kwargs.get("mode") == "decode" and args[0].shape[1] == 1:
            tap["logits"] = out[0][:, 0].clone()

    hooks = [model.blocks[0].core.latent_attn.register_forward_hook(
                 count_steps),
             model.blocks[layer].core.latent_attn.register_forward_hook(
                 capture),
             model.register_forward_hook(last_logits, with_kwargs=True)]

    # the main path: counts set to 0 just before, read just after
    eng = engine()
    slot_of, stream = {}, {}

    def on_step(e, step):
        slot_of.update((tr.rid, tr.slot)
                       for tr in e.scheduler.in_state("decode"))
        stream["vals"], stream["ids"] = list(e._lp_vals), list(e._lp_ids)

    rids = [eng.submit(r) for r in requests]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for hk in hooks:
        hk.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = tap["steps"]
    new = sum(len(r.tokens) - r.prompt_len for r in results)
    print(f"main serve-mla: {len(results)} results in order "
          f"{[r.rid for r in results]}, {new} tokens, {steps} decode steps, "
          f"{eng._clock} engine steps in {wall * 1e3:.1f} ms; launches "
          f"{launches} (K1 want 1, K2 want 0); peak memory {peak_gb:.2f} "
          f"GiB; mean_logprob {[round(r.mean_logprob, 4) for r in results]}",
          flush=True)
    check([r.rid for r in results] == rids
          and all(len(r.tokens) - r.prompt_len == MLA_NEW
                  and r.tokens[:r.prompt_len] == q.prompt
                  and all(0 <= t < cfg.vocab for t in r.tokens)
                  and math.isfinite(r.mean_logprob)
                  for r, q in zip(results, requests)),
          "serve-mla: results out of order, short, out of the vocabulary "
          "or with a non-finite mean_logprob")
    check(steps >= MLA_NEW - 1
          and launches == {"K1": 1, "K2": 0, "K3": 0, "K4": 0, "K5": 0},
          f"serve-mla: launches {launches} for {steps} decode steps")

    # K1 at the mean_logprob shape: the run's (step x slot) stream
    vals = torch.cat(stream["vals"])[:, None]
    ids = torch.from_numpy(np.concatenate(stream["ids"])).to(dev)
    nseg = len(requests)
    safe = torch.where((ids >= 0) & (ids < nseg), ids,
                       torch.full_like(ids, nseg)).to(torch.int64)
    entries = [dict(k1_entry(
        "serve-mla", vals, ids, nseg, "compensated", smi,
        lambda: torch.zeros((nseg + 1, 1), device=dev).index_add_(
            0, safe, vals), op="mean"), launches=launches["K1"])]

    # timings on the engine's final state: every slot active at its
    # length, each call writing the same latent row (the caches not kept);
    # the absorbed attention on the inputs captured in the middle layer
    lengths = eng._caches[0]["core"].length[0].clone()
    toks = torch.tensor([[r.tokens[-1]] for r in results], device=dev)
    active = torch.ones(MLA_SLOTS, dtype=torch.bool, device=dev)
    attn = model.blocks[layer].core.latent_attn
    args = tap.pop("attn")
    with torch.no_grad():
        step_ms = cuda_ms(lambda: M.decode_step(
            model, toks, eng._caches, lengths, active=active,
            moe_impl="dense"), REPS)
        chunk = torch.tensor([requests[0].prompt[:MLA_CHUNK]], device=dev)
        chunk_ms = cuda_ms(lambda: eng._prefill_chunk(
            0, chunk, 0, MLA_CHUNK), REPS)
        again = attn(*args)
        attn_ms = cuda_ms(lambda: attn(*args), REPS)
    check(torch.equal(again, tap.pop("attn_out")),
          "serve-mla: the absorbed attention does not repeat its output")
    qn, _, c_kv, k_rope, newpos = args[:5]
    live = int((newpos[:, 0] + 1).sum())        # latent rows attended
    attn_bytes = live * (c_kv.shape[-1] + k_rope.shape[-1]) * 4
    cache_gb = M.cache_bytes(eng._caches) / 1e9
    gqa_gb = (cfg.n_layers * MLA_SLOTS * MLA_LEN * 2 * cfg.n_kv_heads
              * cfg.hdim * 4) / 1e9
    print(f"time serve-mla: decode step at B={MLA_SLOTS} {step_ms:.3f} ms "
          f"(bound {weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms: the "
          f"weights once over 3.35 TB/s; {MLA_SLOTS * 1e3 / step_ms:.1f} "
          f"tokens/s decoding) | {MLA_CHUNK}-token prefill chunk "
          f"{chunk_ms:.3f} ms | the run: {new} tokens in {wall * 1e3:.1f} ms"
          f" ({new / wall:.1f} generated tokens/s, prefill included) | "
          f"absorbed decode attention per layer {attn_ms:.4f} ms (layer "
          f"{layer}, step {MLA_TAP_STEP}: q {tuple(qn.shape)}, latent cache "
          f"{tuple(c_kv.shape)} {c_kv.dtype}, {live} live rows: bound "
          f"{attn_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), "
          f"{cfg.n_layers} layers {cfg.n_layers * attn_ms:.3f} ms = "
          f"{cfg.n_layers * attn_ms / step_ms:.3f} of a step | weights "
          f"{weights_gb:.3f} GB, latent caches {cache_gb:.3f} GB (f32; a "
          f"GQA cache of {cfg.n_kv_heads} x {cfg.hdim} heads {gqa_gb:.3f} "
          f"GB), peak {peak_gb:.2f} GiB | {smi}", flush=True)
    del args, qn, c_kv, k_rope, newpos, again, eng, vals, ids, safe
    gc.collect()
    torch.cuda.empty_cache()

    # batch independence: the 2,048-token request alone in a fresh
    # Engine; its prefill chunks' middle-layer attention and MoE inputs
    # are kept for the two K1 checks below
    chunks = {"core": [], "mlp": []}

    def keep(name):
        def hook(mod, args):
            if args[0].shape[1] == MLA_CHUNK:
                chunks[name].append(args[0].clone())
        return hook

    hooks = [model.blocks[layer].core.register_forward_pre_hook(
                 keep("core")),
             model.blocks[layer].mlp.register_forward_pre_hook(keep("mlp"))]
    alone = engine().generate([requests[two_k]])[0]
    for hk in hooks:
        hk.remove()
    gc.collect()
    torch.cuda.empty_cache()
    same_toks = alone.tokens == results[two_k].tokens
    print(f"check request {two_k} (prompt {lens[two_k]}) alone vs in the "
          f"batch: tokens {'bitwise' if same_toks else 'DIFFER'}", flush=True)
    check(same_toks, f"serve-mla: request {two_k} depends on its batch")
    xa = torch.cat(chunks["core"], dim=1)[0]             # (2,048, d)
    xm = torch.cat(chunks["mlp"], dim=1)[0]
    check(xa.shape[0] == xm.shape[0] == lens[two_k],
          f"serve-mla: captured {xa.shape[0]} and {xm.shape[0]} prefill "
          f"rows, want {lens[two_k]}")

    # K1 on the router's normalization: deepseek's router_norm_topk with
    # the exact policy over that prefill's router stream (k = 6 rows x
    # 2,048, one label)
    core, mlp = model.blocks[layer].core, model.blocks[layer].mlp
    m = dataclasses.replace(cfg.moe, router_norm_policy="exact")
    K.LAUNCHES = 0
    w_k1, idx_k1, _ = moe.router_topk(mlp.router, xm, m)
    k1_count = K.LAUNCHES
    w_bl, idx_bl, _ = moe.router_topk(mlp.router, xm, m, backend="blocked")
    ok = torch.equal(idx_k1, idx_bl) and torch.equal(w_k1, w_bl)
    print(f"check router_topk with router_norm_policy='exact' over the "
          f"{xm.shape[0]}-token prefill's router stream (top-{m.top_k}): K1 "
          f"launched {k1_count} time(s); weights through K1 "
          f"{'bitwise' if ok else 'DIFFER from'} blocked's", flush=True)
    check(ok and k1_count == 1, "serve-mla: the router's normalization "
                                "through K1 differs from blocked's")
    raw = moe.router_topk(mlp.router, xm, dataclasses.replace(
        cfg.moe, router_norm_topk=False))[0]
    wt = raw.T.contiguous()
    entries.append(k1_entry("router-norm-mla", wt, torch.zeros(
        wt.shape[0], dtype=torch.int32, device=dev), 1, "exact", smi,
        lambda: torch.sum(wt, 0)))

    # K1 on the latent's rmsnorm: that prefill's (2,048, 512) latent
    # (the down-projection before its norm) under the exact policy
    with torch.no_grad():
        lat = dense(core.wdkv, xa)
        K.LAUNCHES = 0
        got = rmsnorm(core.c_norm, lat, cfg.norm_eps, policy="exact")
        k1_count = K.LAUNCHES
        ok = torch.equal(got, rmsnorm(core.c_norm, lat, cfg.norm_eps,
                                      policy="exact", backend="blocked"))
    print(f"check the latent's rmsnorm(policy='exact') over "
          f"{tuple(lat.shape)}: K1 launched {k1_count} time(s), "
          f"{'bitwise' if ok else 'DIFFERS from'} blocked", flush=True)
    check(ok and k1_count == 1, "serve-mla: the latent's rmsnorm through "
                                "K1 differs from blocked")
    sq = lat.float().T.contiguous() ** 2            # the stream K1 sums
    entries.append(k1_entry("latent-norm", sq, torch.zeros(
        sq.shape[0], dtype=torch.int32, device=dev), 1, "exact", smi,
        lambda: torch.sum(sq, 0), op="sumsq"))
    del xa, xm, lat, got, raw, wt, sq, chunks

    # the 3,072-token request's last decode logits against a cache-free
    # forward over its tokens, padded to 4,096 (causal: the padding is
    # never seen) so that its attention takes the chunked path
    seq = results[last].tokens[:-1]
    pad = -len(seq) % cfg.attn_qchunk
    with torch.no_grad():
        full = M.forward(model, tokens=torch.tensor(
            [seq + [0] * pad], device=dev), mode="train",
            moe_impl="dense")[0]
    ref = full[0, len(seq) - 1]
    del full
    got = tap["logits"][slot_of[last]]
    rel = float((got - ref).abs().max() / ref.std())
    agree = int(got[:cfg.vocab].argmax()) == int(ref[:cfg.vocab].argmax())
    print(f"check request {last}'s last decode step (position "
          f"{len(seq) - 1}, slot {slot_of[last]}) vs a cache-free forward "
          f"over its {len(seq)} tokens (+{pad} padding): max|diff| / "
          f"std(logits) = {rel:.5f} (bound {MLA_LOGIT_BOUND}), std "
          f"{float(ref.std()):.4f}, argmax {'agrees' if agree else 'differs'}"
          f" | phase {time.perf_counter() - t_phase:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {smi}",
          flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= MLA_LOGIT_BOUND,
          "serve-mla: decode logits outside the bound of the cache-free "
          "forward")
    del model, results, got, ref, tap
    gc.collect()
    torch.cuda.empty_cache()
    mla_f32_check(cfg, requests[last], seed, dev, smi)
    print(f"serve-mla: the phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def mla_f32_check(cfg, request, seed, dev, smi):
    """Phase 15's float32 check: ``request`` through a fresh ``Engine``
    on ``cfg``'s attention at full width and depth in float32 weights,
    its experts replaced by a dense SwiGLU of ``cfg.d_ff``; the last
    decode step's logits against a cache-free forward, max |diff| / std
    within ``MLA_F32_BOUND``."""
    import dataclasses
    import gc
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.config import BlockSpec
    from repro_torch.serve import Engine

    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                period=(BlockSpec("attn", "swiglu"),))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 33)
    model = M.init_params(cfg32, generator=gen, device=dev)
    tap = {}

    def last_logits(mod, args, kwargs, out):
        if kwargs.get("mode") == "decode" and args[0].shape[1] == 1:
            tap["logits"] = out[0][0, 0].clone()     # slot 0: alone

    hook = model.register_forward_hook(last_logits, with_kwargs=True)
    res = Engine(cfg32, model, max_len=MLA_LEN, max_batch=MLA_SLOTS,
                 prefill_chunk=MLA_CHUNK, device=dev).generate([request])[0]
    hook.remove()
    seq = res.tokens[:-1]
    pad = -len(seq) % cfg.attn_qchunk
    with torch.no_grad():
        ref = M.forward(model, tokens=torch.tensor(
            [seq + [0] * pad], device=dev), mode="train")[0][0, len(seq) - 1]
    got = tap["logits"]
    rel = float((got - ref).abs().max() / ref.std())
    print(f"check the {len(request.prompt)}-token request in float32 "
          f"weights, {cfg32.n_layers} MLA layers with dense SwiGLUs of "
          f"{cfg32.d_ff} ({M.param_bytes(model) / 1e9:.3f} GB): last decode"
          f" step vs a cache-free forward over {len(seq)} tokens: max|diff|"
          f" / std(logits) = {rel:.3g} (bound {MLA_F32_BOUND:g}) | {smi}",
          flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= MLA_F32_BOUND,
          "serve-mla: float32 decode logits outside the bound of the "
          "cache-free forward")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def serve_hybrid_phase(seed, dev, smi):
    """Phase 16: jamba-v0.1-52b at full width, cut to ``HYB_LAYERS``
    layers, served through the port's ``Engine``: Mamba states and dense
    KV caches, whole-prompt prefill; returns the kernel entries of K2 in
    the attention layers and of K1 on ``mean_logprob``."""
    import dataclasses
    import gc
    import importlib
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.models.layers import dense
    from repro_torch.serve import Engine, Request
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_config(HYB_ARCH), n_layers=HYB_LAYERS)
    per = len(cfg.period)
    mamba_pos = [j for j, sp in enumerate(cfg.period) if sp.kind == "mamba"]
    attn_pos = [j for j, sp in enumerate(cfg.period) if sp.kind == "attn"]
    attn_layers = [i * per + j for i in range(cfg.n_periods)
                   for j in attn_pos]
    n_mamba = len(mamba_pos) * cfg.n_periods
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 41)
    t_phase = time.perf_counter()
    model = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    param_bytes = M.param_bytes(model)
    weights_gb = param_bytes / 1e9
    host = torch.Generator()
    host.manual_seed(seed + 42)
    lens = torch.randint(HYB_PROMPTS[0], HYB_PROMPTS[1] + 1,
                         (HYB_SLOTS - len(HYB_LONG),),
                         generator=host).tolist() + list(HYB_LONG)
    requests = [Request(prompt=torch.randint(1, cfg.vocab, (n,),
                                             generator=host).tolist(),
                        max_new_tokens=HYB_NEW) for n in lens]
    four_k, ragged = HYB_SLOTS - 2, HYB_SLOTS - 1
    m = cfg.mamba
    print(f"serve-hybrid: {cfg.name} at full width (d_model {cfg.d_model},"
          f" Mamba di {m.expand * cfg.d_model} d_state {m.d_state} d_conv "
          f"{m.d_conv}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv, "
          f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k}, d_ff "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}, {cfg.dtype}), "
          f"{cfg.n_layers} of 32 layers ({n_mamba} Mamba, attention at "
          f"layers {attn_layers}): "
          f"{sum(p.numel() for p in model.parameters())} parameters "
          f"({param_bytes} bytes by param_bytes, {weights_gb:.3f} GB) drawn "
          f"in {init_s:.2f} s ({held / 2 ** 30:.2f} GiB held before); "
          f"{HYB_SLOTS} slots x {HYB_LEN} context, whole-prompt prefill; "
          f"prompts {lens}, {HYB_NEW} new tokens each, greedy", flush=True)

    def engine():
        return Engine(cfg, model, max_len=HYB_LEN, max_batch=HYB_SLOTS,
                      logprob_policy="compensated", device=dev)

    # taps: decode steps seen by the first attention layer; the last
    # attention layer's K2 inputs and output at one step; layer 0's Mamba
    # input in the 4,096-token prefill; the last decode-step logits
    tap = {"steps": 0, "mid": 0, "logits": None}

    def count_steps(mod, args, out):
        tap["steps"] += 1

    def capture(mod, args, out):
        tap["mid"] += 1
        if tap["mid"] == HYB_TAP_STEP:
            q, k, v, kv_len, sc = args
            tap.update(q=q.clone(), k=k.clone(), v=v.clone(),
                       kv_len=kv_len.clone(), sc=sc, out=out.clone())

    def mamba_input(mod, args, kwargs):
        if args[0].shape[1] == HYB_LONG[0] and "x0" not in tap:
            tap["x0"] = args[0].clone()

    def last_logits(mod, args, kwargs, out):
        if kwargs.get("mode") == "decode" and args[0].shape[1] == 1:
            tap["logits"] = out[0][:, 0].clone()

    hooks = [model.blocks[attn_layers[0]].core.decode_attn
             .register_forward_hook(count_steps),
             model.blocks[attn_layers[-1]].core.decode_attn
             .register_forward_hook(capture),
             model.blocks[0].core.register_forward_pre_hook(
                 mamba_input, with_kwargs=True),
             model.register_forward_hook(last_logits, with_kwargs=True)]

    # the main path: counts set to 0 just before, read just after
    eng = engine()
    slot_of, stream = {}, {}

    def on_step(e, step):
        slot_of.update((tr.rid, tr.slot)
                       for tr in e.scheduler.in_state("decode"))
        stream["vals"], stream["ids"] = list(e._lp_vals), list(e._lp_ids)

    rids = [eng.submit(r) for r in requests]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for hk in hooks:
        hk.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = tap["steps"]
    new = sum(len(r.tokens) - r.prompt_len for r in results)
    n_attn = len(attn_layers)
    print(f"main serve-hybrid: {len(results)} results in order "
          f"{[r.rid for r in results]}, {new} tokens, {steps} decode steps "
          f"in {wall * 1e3:.1f} ms; launches {launches} (K2 want {steps} x "
          f"{n_attn}, K1 want 1); peak memory {peak_gb:.2f} GiB; "
          f"mean_logprob {[round(r.mean_logprob, 4) for r in results]}",
          flush=True)
    check([r.rid for r in results] == rids
          and all(len(r.tokens) - r.prompt_len == HYB_NEW
                  and r.tokens[:r.prompt_len] == q.prompt
                  and all(0 <= t < cfg.vocab for t in r.tokens)
                  and math.isfinite(r.mean_logprob)
                  for r, q in zip(results, requests)),
          "serve-hybrid: results out of order, short, out of the "
          "vocabulary or with a non-finite mean_logprob")
    check(steps >= HYB_NEW - 1
          and launches == {"K1": 1, "K2": steps * n_attn, "K3": 0,
                           "K4": 0, "K5": 0},
          f"serve-hybrid: launches {launches} for {steps} decode steps")

    # K2 against its plain version on the engine's own cache and query,
    # in the last attention layer at one decode step
    q, k, v, kv_len, sc = (tap[x] for x in ("q", "k", "v", "kv_len", "sc"))
    qf = q.float().contiguous()
    bias = ops.length_bias(kv_len, k.shape[1], None, dev)
    plain_ms, plain = host_ms(lambda: fd.flash_decode_torch(
        qf, k, v, bias, sm_scale=sc, block_kv=512))
    kern = fd.flash_decode_cuda(qf, k, v, bias, sm_scale=sc, block_kv=512)
    ok, k2_err = same(kern, plain)
    ok_engine = torch.equal(kern, tap["out"])
    print(f"check K2 (layer {attn_layers[-1]}, decode step {HYB_TAP_STEP}: "
          f"cache {tuple(k.shape)} {k.dtype}, kv_len {kv_len.tolist()}): "
          f"max|kernel-plain|={k2_err:g} {'bitwise' if ok else 'DIFFER'}; "
          f"the engine's own output {'bitwise' if ok_engine else 'DIFFER'}",
          flush=True)
    check(ok and ok_engine, "serve-hybrid: K2 differs from its plain "
                            "version on the engine's cache")
    k2_ms = cuda_ms(lambda: fd.flash_decode_cuda(
        qf, k, v, bias, sm_scale=sc, block_kv=512), REPS)
    rows = int(kv_len.sum())
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
        qf[:, :, None], k4, v4, attn_mask=mask, scale=sc, enable_gqa=True),
        REPS)
    del k4, v4, mask, q, k, v, qf, bias, kern, plain
    tap.update(q=None, k=None, v=None, out=None)
    entries = [{
        "name": "flash_decode_kernel<dense>/serve-hybrid", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:72",
        "launches": launches["K2"], "max_abs_err": k2_err, "ms": k2_ms,
        "plain_ms": plain_ms, "bound_ms": k2_bound,
        "bound_by": ("bytes" if k2_bytes / HBM_BYTES_PER_S
                     >= k2_ops / FP32_OPS_PER_S else "operations"),
        "library_ms": sdpa_ms}]

    # K1 at the mean_logprob shape: the run's (step x slot) stream
    vals = torch.cat(stream["vals"])[:, None]
    ids = torch.from_numpy(np.concatenate(stream["ids"])).to(dev)
    nseg = len(requests)
    safe = torch.where((ids >= 0) & (ids < nseg), ids,
                       torch.full_like(ids, nseg)).to(torch.int64)
    entries.append(dict(k1_entry(
        "serve-hybrid", vals, ids, nseg, "compensated", smi,
        lambda: torch.zeros((nseg + 1, 1), device=dev).index_add_(
            0, safe, vals), op="mean"), launches=launches["K1"]))
    del vals, ids, safe

    # one decode step on the engine's own caches with two slots inactive:
    # their Mamba states, attention rows and lengths stay bitwise, the
    # other slots' states move
    caches = eng._caches
    frozen = list(HYB_FROZEN)
    live = [s for s in range(HYB_SLOTS) if s not in frozen]
    before = {j: tuple(t[:, frozen].clone() for t in caches[j]["core"])
              for j in mamba_pos + attn_pos}
    live_h = {j: caches[j]["core"].h[:, live].clone() for j in mamba_pos}
    lengths = caches[attn_pos[0]]["core"].length[0].clone()
    toks = torch.tensor([[r.tokens[-1]] for r in results], device=dev)
    active = torch.ones(HYB_SLOTS, dtype=torch.bool, device=dev)
    active[frozen] = False
    with torch.no_grad():
        _, stepped = M.decode_step(model, toks, caches, lengths,
                                   active=active, moe_impl="dense")
    kept = all(torch.equal(a, b[:, frozen]) for j in mamba_pos
               for a, b in zip(before[j], caches[j]["core"]))
    kept_attn = all(
        torch.equal(before[j][0], caches[j]["core"].k[:, frozen])
        and torch.equal(before[j][1], caches[j]["core"].v[:, frozen])
        and torch.equal(before[j][2], stepped[j]["core"].length[:, frozen])
        for j in attn_pos)
    moved = all(not torch.equal(live_h[j][:, i], caches[j]["core"].h[:,
                                                                      s])
                for j in mamba_pos for i, s in enumerate(live))
    grown = all(torch.equal(stepped[j]["core"].length[:, live],
                            caches[j]["core"].length[:, live] + 1)
                for j in attn_pos)
    print(f"check a decode step with slots {frozen} inactive: their h and "
          f"conv in all {n_mamba} Mamba layers "
          f"{'bitwise unchanged' if kept else 'CHANGED'}, their attention "
          f"rows and lengths {'bitwise unchanged' if kept_attn else 'CHANGED'}"
          f"; every active slot's h {'moved' if moved else 'DID NOT MOVE'} "
          f"and its length {'grew by 1' if grown else 'DID NOT GROW'}",
          flush=True)
    check(kept and kept_attn and moved and grown,
          "serve-hybrid: the active mask does not hold")
    del before, live_h, stepped

    # timings on the engine's state: every slot active (each call writes
    # the same attention row; the Mamba states step on from call to call)
    active = torch.ones(HYB_SLOTS, dtype=torch.bool, device=dev)
    x0 = tap.pop("x0")
    layers = [i * per + j for i in range(cfg.n_periods) for j in mamba_pos]
    xd = x0[:, -HYB_SLOTS:].reshape(HYB_SLOTS, 1, cfg.d_model).contiguous()
    with torch.no_grad():
        step_ms = cuda_ms(lambda: M.decode_step(
            model, toks, caches, lengths, active=active,
            moe_impl="dense"), REPS)
        prefill_ms = {}
        for i in (four_k, ragged):
            ptoks = torch.tensor([requests[i].prompt], device=dev)
            prefill_ms[lens[i]] = cuda_ms(
                lambda: eng._classic_prefill(i, ptoks), 3)
        dec_ms, pre_ms = [], []
        for layer in layers:
            core = model.blocks[layer].core
            full = caches[layer % per]["core"]
            view = type(full)(*(t[layer // per] for t in full))
            dec_ms.append(cuda_ms(lambda: core(
                xd, mode="decode", cache=view, active=active), REPS))
            pre_ms.append(cuda_ms(lambda: core(x0, mode="prefill"), 3))
    mamba_dec, mamba_pre = sum(dec_ms) / len(dec_ms), \
        sum(pre_ms) / len(pre_ms)
    state_b = sum(t.numel() * t.element_size() for j in mamba_pos
                  for t in caches[j]["core"])
    kv_b = sum(t.numel() * t.element_size() for j in attn_pos
               for t in caches[j]["core"])
    gqa_gb = (cfg.n_layers * HYB_SLOTS * HYB_LEN * 2 * cfg.n_kv_heads
              * cfg.hdim * 4) / 1e9
    print(f"time serve-hybrid: decode step at B={HYB_SLOTS} {step_ms:.3f} "
          f"ms (bound {weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms: "
          f"the weights once over 3.35 TB/s, the dense MoE reading every "
          f"expert; {HYB_SLOTS * 1e3 / step_ms:.1f} tokens/s decoding) | "
          f"whole-prompt prefill "
          + ", ".join(f"{n} tokens {ms:.1f} ms" for n, ms in
                      prefill_ms.items())
          + f" | a Mamba layer (mean of {len(layers)}, CUDA events): decode "
          f"at B={HYB_SLOTS} {mamba_dec:.4f} ms ({len(layers)} layers "
          f"{len(layers) * mamba_dec:.3f} ms = "
          f"{len(layers) * mamba_dec / step_ms:.3f} of a step), prefill at "
          f"{x0.shape[1]} tokens {mamba_pre:.3f} ms (range "
          f"{min(pre_ms):.3f}-{max(pre_ms):.3f}) | the run: {new} tokens in "
          f"{wall * 1e3:.1f} ms ({new / wall:.1f} generated tokens/s, "
          f"prefill included) | K2 per attention layer per step "
          f"{k2_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_bytes / 1e6:.2f} "
          f"MB: the live KV rows), plain {plain_ms:.1f} ms, SDPA "
          f"{sdpa_ms:.4f} ms | weights {weights_gb:.3f} GB; caches "
          f"{M.cache_bytes(caches) / 1e9:.3f} GB: Mamba states "
          f"{state_b / 1e6:.1f} MB, the {n_attn} attention layers' f32 KV "
          f"{kv_b / 1e9:.3f} GB (GQA caches for all {cfg.n_layers} layers "
          f"{gqa_gb:.2f} GB); peak {peak_gb:.2f} GiB | {smi}", flush=True)
    del xd, eng, caches, toks
    gc.collect()
    torch.cuda.empty_cache()

    # layer 0's chunked scan on the 4,096 prompt against a float64
    # sequential recurrence on the card
    core = model.blocks[0].core
    with torch.no_grad():
        di = core.conv_b.shape[0]
        xi, _ = dense(core.in_proj, x0).split(di, dim=-1)
        xpad = torch.cat([xi.new_zeros((1, m.d_conv - 1, di)), xi], dim=1)
        xc = F.silu(ssm._depthwise_conv(xpad, core.conv_w, core.conv_b))
        dt, bm, cm = ssm._mamba_gates(core, xc.to(x0.dtype), m)
        a = torch.exp(core.a_log)
        y, h_n = ssm.mamba_scan(xc, dt, bm, cm, a, cfg.scan_chunk)
        a64, h64 = a.double(), torch.zeros_like(h_n, dtype=torch.float64)
        dt64, xc64, b64, c64 = (t[0].double() for t in (dt, xc, bm, cm))
        y64 = torch.empty_like(xc64)
        for t in range(xc64.shape[0]):
            h64 = torch.exp(dt64[t, :, None] * -a64) * h64 \
                + (dt64[t] * xc64[t])[:, None] * b64[t, None, :]
            y64[t] = (h64[0] * c64[t]).sum(-1)
    y_rel = float((y[0].double() - y64).abs().max() / y64.abs().max())
    h_rel = float((h_n.double() - h64).abs().max() / h64.abs().max())
    print(f"check layer 0's chunked scan over the {xc.shape[1]}-token "
          f"prompt ({xc.shape[1] // cfg.scan_chunk} chunks of "
          f"{cfg.scan_chunk}, di {di}, d_state {m.d_state}) vs a float64 "
          f"sequential recurrence: max|diff| / max|ref| y {y_rel:.3g}, final "
          f"h {h_rel:.3g} (bound {HYB_SCAN_BOUND:g}); dt in "
          f"[{float(dt.min()):.3g}, {float(dt.max()):.3g}] | {smi}",
          flush=True)
    check(y_rel <= HYB_SCAN_BOUND and h_rel <= HYB_SCAN_BOUND,
          "serve-hybrid: the chunked scan is outside its bound of the "
          "float64 recurrence")
    del x0, xi, xpad, xc, dt, bm, cm, y, h_n, y64, h64, dt64, xc64, b64, c64

    # batch independence: the 4,096-token request alone in a fresh Engine
    alone = engine().generate([requests[four_k]])[0]
    gc.collect()
    torch.cuda.empty_cache()
    same_toks = alone.tokens == results[four_k].tokens
    print(f"check request {four_k} (prompt {lens[four_k]}) alone vs in the "
          f"batch: tokens {'bitwise' if same_toks else 'DIFFER'}", flush=True)
    check(same_toks, f"serve-hybrid: request {four_k} depends on its batch")

    # the 4,096-token request's last decode logits against a cache-free
    # forward over its tokens, padded to 5,120 (causal: the padding is
    # never seen) so that its attention takes the chunked path
    seq = results[four_k].tokens[:-1]
    pad = -len(seq) % cfg.attn_qchunk
    with torch.no_grad():
        full = M.forward(model, tokens=torch.tensor(
            [seq + [0] * pad], device=dev), mode="train",
            moe_impl="dense")[0]
    ref = full[0, len(seq) - 1]
    del full
    got = tap["logits"][slot_of[four_k]]
    rel = float((got - ref).abs().max() / ref.std())
    agree = int(got[:cfg.vocab].argmax()) == int(ref[:cfg.vocab].argmax())
    print(f"check request {four_k}'s last decode step (position "
          f"{len(seq) - 1}, slot {slot_of[four_k]}) vs a cache-free forward "
          f"over its {len(seq)} tokens (+{pad} padding): max|diff| / "
          f"std(logits) = {rel:.5f} (bound {HYB_LOGIT_BOUND}), std "
          f"{float(ref.std()):.4f}, argmax {'agrees' if agree else 'differs'}"
          f" | phase {time.perf_counter() - t_phase:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {smi}",
          flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= HYB_LOGIT_BOUND,
          "serve-hybrid: decode logits outside the bound of the cache-free "
          "forward")
    del model, results, got, ref, tap
    gc.collect()
    torch.cuda.empty_cache()
    hybrid_f32_check(cfg, requests[four_k], seed, dev, smi)
    print(f"serve-hybrid: the phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def hybrid_f32_check(cfg, request, seed, dev, smi):
    """Phase 16's float32 check: ``request`` through a fresh ``Engine``
    on ``cfg`` in float32 weights at full width and all its layers, the
    experts replaced by dense SwiGLUs of ``cfg.d_ff`` (every Mamba and
    attention layer kept); the last decode step's logits against a
    cache-free forward, max |diff| / std within ``HYB_F32_BOUND``."""
    import dataclasses
    import gc
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.config import BlockSpec
    from repro_torch.serve import Engine

    cfg32 = dataclasses.replace(cfg, dtype="float32", period=tuple(
        BlockSpec(sp.kind, "swiglu") for sp in cfg.period))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 43)
    t0 = time.perf_counter()
    model = M.init_params(cfg32, generator=gen, device=dev)
    tap = {}

    def last_logits(mod, args, kwargs, out):
        if kwargs.get("mode") == "decode" and args[0].shape[1] == 1:
            tap["logits"] = out[0][0, 0].clone()     # slot 0: alone

    hook = model.register_forward_hook(last_logits, with_kwargs=True)
    res = Engine(cfg32, model, max_len=HYB_LEN, max_batch=HYB_SLOTS,
                 device=dev).generate([request])[0]
    hook.remove()
    seq = res.tokens[:-1]
    pad = -len(seq) % cfg.attn_qchunk
    with torch.no_grad():
        ref = M.forward(model, tokens=torch.tensor(
            [seq + [0] * pad], device=dev), mode="train")[0][0, len(seq) - 1]
    got = tap["logits"]
    rel = float((got - ref).abs().max() / ref.std())
    n_mamba = sum(sp.kind == "mamba" for sp in cfg32.period) \
        * cfg32.n_periods
    print(f"check the {len(request.prompt)}-token request in float32 "
          f"weights, {cfg32.n_layers} layers ({n_mamba} Mamba) with dense "
          f"SwiGLUs of {cfg32.d_ff} ({M.param_bytes(model) / 1e9:.3f} GB): "
          f"last decode"
          f" step vs a cache-free forward over {len(seq)} tokens: max|diff|"
          f" / std(logits) = {rel:.3g} (bound {HYB_F32_BOUND:g}); "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= HYB_F32_BOUND,
          "serve-hybrid: float32 decode logits outside the bound of the "
          "cache-free forward")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def serve_xlstm_phase(seed, dev, smi):
    """Phase 17: xlstm-125m whole (12 layers, full width) served through
    the port's ``Engine``: mLSTM and sLSTM states, whole-prompt prefill;
    returns the kernel entry of K1 on ``mean_logprob``."""
    import gc
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models import ssm
    from repro_torch.models.layers import dense
    from repro_torch.serve import Engine, Request

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    cfg = get_config(XL_ARCH)
    x = cfg.xlstm
    per = len(cfg.period)
    m_pos = [j for j, sp in enumerate(cfg.period) if sp.kind == "mlstm"]
    s_pos = [j for j, sp in enumerate(cfg.period) if sp.kind == "slstm"]
    m_layers = [i * per + j for i in range(cfg.n_periods) for j in m_pos]
    s_layers = [i * per + j for i in range(cfg.n_periods) for j in s_pos]
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 51)
    t_phase = time.perf_counter()
    model = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    param_bytes = M.param_bytes(model)
    host = torch.Generator()
    host.manual_seed(seed + 52)
    lens = torch.randint(XL_PROMPTS[0], XL_PROMPTS[1] + 1,
                         (XL_SLOTS - len(XL_LONG),),
                         generator=host).tolist() + list(XL_LONG)
    requests = [Request(prompt=torch.randint(1, cfg.vocab, (n,),
                                             generator=host).tolist(),
                        max_new_tokens=XL_NEW) for n in lens]
    long_i, ragged = XL_SLOTS - 2, XL_SLOTS - 1
    di = int(x.proj_factor_m * cfg.d_model)
    print(f"serve-xlstm: {cfg.name} whole (d_model {cfg.d_model}, "
          f"{len(m_layers)} mLSTM layers of di {di} in {x.num_heads} heads,"
          f" {len(s_layers)} sLSTM layers at {s_layers} with a GELU FFN of "
          f"{int(x.proj_factor_s * cfg.d_model)}, vocab {cfg.vocab} padded "
          f"to {cfg.padded_vocab}, tied, {cfg.dtype}): "
          f"{sum(p.numel() for p in model.parameters())} parameters "
          f"({param_bytes} bytes by param_bytes) drawn in {init_s:.2f} s "
          f"({held / 2 ** 30:.2f} GiB held before); {XL_SLOTS} slots x "
          f"{XL_LEN} context, whole-prompt prefill, scan chunk "
          f"{cfg.scan_chunk}; prompts {lens}, {XL_NEW} new tokens each, "
          f"greedy", flush=True)

    def engine():
        return Engine(cfg, model, max_len=XL_LEN, max_batch=XL_SLOTS,
                      logprob_policy="compensated", device=dev)

    # taps: the decode steps and the last one's logits; layer 0's and
    # layer 3's inputs in the 2,048-token prefill
    tap = {"steps": 0, "logits": None}

    def last_logits(mod, args, kwargs, out):
        if kwargs.get("mode") == "decode" and args[0].shape[1] == 1:
            tap["steps"] += 1
            tap["logits"] = out[0][:, 0].clone()

    def layer_input(name):
        def hook(mod, args, kwargs):
            if args[0].shape[1] == XL_LONG[0] and name not in tap:
                tap[name] = args[0].clone()
        return hook

    hooks = [model.register_forward_hook(last_logits, with_kwargs=True),
             model.blocks[m_layers[0]].core.register_forward_pre_hook(
                 layer_input("xm"), with_kwargs=True),
             model.blocks[s_layers[0]].core.register_forward_pre_hook(
                 layer_input("xs"), with_kwargs=True)]

    # the main path: counts set to 0 just before, read just after
    eng = engine()
    slot_of, stream = {}, {}

    def on_step(e, step):
        slot_of.update((tr.rid, tr.slot)
                       for tr in e.scheduler.in_state("decode"))
        stream["vals"], stream["ids"] = list(e._lp_vals), list(e._lp_ids)

    rids = [eng.submit(r) for r in requests]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = eng.run(on_step=on_step)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for hk in hooks:
        hk.remove()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = tap["steps"]
    new = sum(len(r.tokens) - r.prompt_len for r in results)
    print(f"main serve-xlstm: {len(results)} results in order "
          f"{[r.rid for r in results]}, {new} tokens, {steps} decode steps "
          f"in {wall * 1e3:.1f} ms; launches {launches} (K1 want 1, K2-K5 "
          f"0); peak memory {peak_gb:.2f} GiB; mean_logprob "
          f"{[round(r.mean_logprob, 4) for r in results]}", flush=True)
    check([r.rid for r in results] == rids
          and all(len(r.tokens) - r.prompt_len == XL_NEW
                  and r.tokens[:r.prompt_len] == q.prompt
                  and all(0 <= t < cfg.vocab for t in r.tokens)
                  and math.isfinite(r.mean_logprob)
                  for r, q in zip(results, requests)),
          "serve-xlstm: results out of order, short, out of the vocabulary "
          "or with a non-finite mean_logprob")
    check(steps >= XL_NEW - 1
          and launches == {"K1": 1, "K2": 0, "K3": 0, "K4": 0, "K5": 0},
          f"serve-xlstm: launches {launches} for {steps} decode steps")

    # K1 at the mean_logprob shape: the run's (step x slot) stream
    vals = torch.cat(stream["vals"])[:, None]
    ids = torch.from_numpy(np.concatenate(stream["ids"])).to(dev)
    nseg = len(requests)
    safe = torch.where((ids >= 0) & (ids < nseg), ids,
                       torch.full_like(ids, nseg)).to(torch.int64)
    entries = [dict(k1_entry(
        "serve-xlstm", vals, ids, nseg, "compensated", smi,
        lambda: torch.zeros((nseg + 1, 1), device=dev).index_add_(
            0, safe, vals), op="mean"), launches=launches["K1"])]
    del vals, ids, safe

    # one decode step on the engine's own states with two slots inactive:
    # their mLSTM (c, n, m, conv) and sLSTM (c, n, h, m) stay bitwise, the
    # other slots' states move
    caches = eng._caches
    frozen = list(XL_FROZEN)
    live = [s for s in range(XL_SLOTS) if s not in frozen]
    before = {j: tuple(t[:, frozen].clone() for t in caches[j]["core"])
              for j in range(per)}
    live_c = {j: caches[j]["core"].c[:, live].clone() for j in range(per)}
    toks = torch.tensor([[r.tokens[-1]] for r in results], device=dev)
    pos = torch.tensor([len(r.tokens) - 1 for r in results], device=dev)
    active = torch.ones(XL_SLOTS, dtype=torch.bool, device=dev)
    active[frozen] = False
    with torch.no_grad():
        M.decode_step(model, toks, caches, pos, active=active)
    kept = all(torch.equal(a, b[:, frozen]) for j in range(per)
               for a, b in zip(before[j], caches[j]["core"]))
    moved = all(not torch.equal(live_c[j][:, i], caches[j]["core"].c[:, s])
                for j in range(per) for i, s in enumerate(live))
    print(f"check a decode step with slots {frozen} inactive: their mLSTM "
          f"(c, n, m, conv) and sLSTM (c, n, h, m) states in all "
          f"{cfg.n_layers} layers {'bitwise unchanged' if kept else 'CHANGED'}"
          f"; every active slot's c {'moved' if moved else 'DID NOT MOVE'}",
          flush=True)
    check(kept and moved, "serve-xlstm: the active mask does not hold")
    del before, live_c

    # timings on the engine's states: every slot active (the states step
    # on from call to call)
    active = torch.ones(XL_SLOTS, dtype=torch.bool, device=dev)
    xm, xs = tap.pop("xm"), tap.pop("xs")
    with torch.no_grad():
        step_ms = cuda_ms(lambda: M.decode_step(model, toks, caches, pos,
                                                active=active), REPS)
        prefill_ms = {}
        for i in (long_i, ragged):
            ptoks = torch.tensor([requests[i].prompt], device=dev)
            prefill_ms[lens[i]] = cuda_ms(
                lambda: eng._classic_prefill(i, ptoks), 3)
        layer_ms = {}
        for kind, layer, xin in (("mLSTM", m_layers[0], xm),
                                 ("sLSTM", s_layers[0], xs)):
            core = model.blocks[layer].core
            full = caches[layer % per]["core"]
            view = type(full)(*(t[layer // per] for t in full))
            xd = xin[:, -XL_SLOTS:].reshape(XL_SLOTS, 1, cfg.d_model) \
                .contiguous()
            layer_ms[kind] = (
                cuda_ms(lambda: core(xd, mode="decode", cache=view,
                                     active=active), REPS),
                cuda_ms(lambda: core(xin, mode="prefill"), 3))
    state_b = M.cache_bytes(caches)
    bound_ms = (param_bytes + 2 * state_b) / HBM_BYTES_PER_S * 1e3
    n_m, n_s = len(m_layers), len(s_layers)
    print(f"time serve-xlstm: decode step at B={XL_SLOTS} {step_ms:.3f} ms "
          f"(bound {bound_ms:.4f} ms: the weights once and the states read "
          f"and written, {(param_bytes + 2 * state_b) / 1e9:.3f} GB over "
          f"3.35 TB/s; {XL_SLOTS * 1e3 / step_ms:.1f} tokens/s decoding) | "
          f"whole-prompt prefill "
          + ", ".join(f"{n} tokens {ms:.1f} ms" for n, ms in
                      prefill_ms.items())
          + f" | an mLSTM layer (layer {m_layers[0]}, CUDA events): decode "
          f"at B={XL_SLOTS} {layer_ms['mLSTM'][0]:.4f} ms ({n_m} layers "
          f"{n_m * layer_ms['mLSTM'][0]:.3f} ms), prefill at {xm.shape[1]} "
          f"tokens {layer_ms['mLSTM'][1]:.3f} ms | an sLSTM layer (layer "
          f"{s_layers[0]}): decode {layer_ms['sLSTM'][0]:.4f} ms ({n_s} "
          f"layers {n_s * layer_ms['sLSTM'][0]:.3f} ms), prefill at "
          f"{xs.shape[1]} tokens {layer_ms['sLSTM'][1]:.3f} ms (a token "
          f"loop: {layer_ms['sLSTM'][1] * 1e3 / xs.shape[1]:.1f} us a "
          f"token) | the run: {new} tokens in {wall * 1e3:.1f} ms "
          f"({new / wall:.1f} generated tokens/s, prefill included) | "
          f"weights {param_bytes / 1e9:.3f} GB; states {state_b / 1e9:.4f} "
          f"GB ({state_b} bytes, mLSTM "
          f"{sum(t.numel() * t.element_size() for j in m_pos for t in caches[j]['core']) / 1e9:.4f}"
          f" GB); peak {peak_gb:.2f} GiB | {smi}", flush=True)
    del eng, caches, toks
    gc.collect()
    torch.cuda.empty_cache()

    with torch.no_grad():
        # layer 0's chunked mLSTM over the 2,048 prompt against a float64
        # sequential recurrence on the card, on the same heads and gates
        core = model.blocks[m_layers[0]].core
        xi, _ = dense(core.in_proj, xm).split(di, dim=-1)
        window = torch.cat([xi.new_zeros((1, x.conv_kernel - 1, di)), xi],
                           dim=1)
        xc = F.silu(ssm._depthwise_conv(window, core.conv_w, core.conv_b)) \
            .to(xm.dtype)
        q, k, v, logi, logf = ssm.mlstm_gates(core, xi, xc, x.num_heads)
        hd = di // x.num_heads
        state = ssm.mlstm_init_state(1, x.num_heads, hd, dev)
        h, (c, n, m) = ssm.mlstm_core(q, k, v, logi, logf, state,
                                      cfg.scan_chunk)
        st64 = tuple(t.double() for t in state)
        h64 = torch.empty(h.shape, dtype=torch.float64, device=dev)
        for t in range(q.shape[2]):
            h64[:, :, t], st64 = ssm.mlstm_step(
                q[:, :, t], k[:, :, t], v[:, :, t], logi[..., t].double(),
                logf[..., t].double(), st64)

        def rel(a, b):
            return float((a.double() - b).abs().max() / b.abs().max())

        scan_err = {"h": rel(h, h64), "c": rel(c, st64[0]),
                    "n": rel(n, st64[1]), "m": rel(m, st64[2])}
        f_chunk = float(logf[..., :cfg.scan_chunk].sum(-1).abs().max())
        print(f"check layer {m_layers[0]}'s chunked mLSTM over the "
              f"{q.shape[2]}-token prompt ({q.shape[2] // cfg.scan_chunk} "
              f"chunks of {cfg.scan_chunk}, {x.num_heads} heads of {hd}) vs "
              f"a float64 sequential recurrence: max|diff| / max|ref| "
              + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in scan_err.items())
              + f" (bound {XL_SCAN_BOUND:g}); |F| at a chunk's end up to "
              f"{f_chunk:.3g} | {smi}", flush=True)
        check(max(scan_err.values()) <= XL_SCAN_BOUND,
              "serve-xlstm: the chunked mLSTM is outside its bound of the "
              "float64 recurrence")
        del q, k, v, logi, logf, h, h64, st64, xi, window, xc

        # layer 3's sLSTM: prefill's token loop against the same tokens
        # fed one at a time through decode at batch 1; and the loop
        # against the cell run on prefill's own projections, bitwise
        core = model.blocks[s_layers[0]].core
        _, pre = core(xs, mode="prefill")
        xg = dense(core.w_x, xs).float()
        st = ssm.slstm_init_state(1, cfg.d_model, dev)
        for t in range(xs.shape[1]):
            _, st = ssm.slstm_cell(core, xg[:, t], st)
        cells_same = all(torch.equal(a, b) for a, b in zip(pre, st))
        dec = M.init_caches(cfg, 1, 1, device=dev)[s_pos[0]]["core"]
        dec = type(dec)(*(t[0] for t in dec))
        for t in range(xs.shape[1]):
            core(xs[:, t:t + 1], mode="decode", cache=dec)
        proj_flips = int((torch.cat([dense(core.w_x, xs[:, t:t + 1])
                                     for t in range(xs.shape[1])], dim=1)
                          != dense(core.w_x, xs)).sum())
        slstm_err = {f: rel(getattr(dec, f), getattr(pre, f).double())
                     for f in pre._fields}
        print(f"check layer {s_layers[0]}'s sLSTM over the {xs.shape[1]}-"
              f"token prompt: prefill's loop vs the cell on its own "
              f"projections {'bitwise' if cells_same else 'DIFFER'}; vs "
              f"{xs.shape[1]} decode steps at batch 1: max|diff| / max|ref| "
              + ", ".join(f"{k_} {v_:.3g}" for k_, v_ in slstm_err.items())
              + f" (bound {XL_SLSTM_BOUND:g}; {proj_flips} of "
              f"{xg.numel()} projected values differ between the 2,048-row "
              f"and the 1-row products) | {smi}", flush=True)
        check(cells_same and max(slstm_err.values()) <= XL_SLSTM_BOUND,
              "serve-xlstm: the sLSTM's decode and prefill disagree")
        del pre, xg, st, dec, xm, xs

    # batch independence: the 2,048-token request alone in a fresh Engine
    alone = engine().generate([requests[long_i]])[0]
    same_toks = alone.tokens == results[long_i].tokens
    print(f"check request {long_i} (prompt {lens[long_i]}) alone vs in the "
          f"batch: tokens {'bitwise' if same_toks else 'DIFFER'}", flush=True)
    check(same_toks, f"serve-xlstm: request {long_i} depends on its batch")

    # the 1,300-token request's last decode logits against a cache-free
    # forward over its tokens
    seq = results[ragged].tokens[:-1]
    with torch.no_grad():
        ref = M.forward(model, tokens=torch.tensor([seq], device=dev))[0][
            0, -1]
    got = tap["logits"][slot_of[ragged]]
    err = float((got - ref).abs().max() / ref.std())
    agree = int(got[:cfg.vocab].argmax()) == int(ref[:cfg.vocab].argmax())
    print(f"check request {ragged}'s last decode step (position "
          f"{len(seq) - 1}, slot {slot_of[ragged]}) vs a cache-free forward "
          f"over its {len(seq)} tokens: max|diff| / std(logits) = "
          f"{err:.5f} (bound {XL_LOGIT_BOUND}), std {float(ref.std()):.4f}, "
          f"argmax {'agrees' if agree else 'differs'} | phase "
          f"{time.perf_counter() - t_phase:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB | {smi}",
          flush=True)
    check(bool(torch.isfinite(got).all()) and err <= XL_LOGIT_BOUND,
          "serve-xlstm: decode logits outside the bound of the cache-free "
          "forward")
    del model, results, got, ref, tap
    gc.collect()
    torch.cuda.empty_cache()
    xlstm_f32_check(cfg, requests[ragged], seed, dev, smi)
    print(f"serve-xlstm: the phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def xlstm_f32_check(cfg, request, seed, dev, smi):
    """Phase 17's float32 check: ``request`` through a fresh ``Engine`` on
    ``cfg`` in float32 weights, whole; the last decode step's logits
    against a cache-free forward, max |diff| / std within
    ``XL_F32_BOUND``."""
    import dataclasses
    import gc
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve import Engine

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 53)
    t0 = time.perf_counter()
    model = M.init_params(cfg32, generator=gen, device=dev)
    tap = {}

    def last_logits(mod, args, kwargs, out):
        if kwargs.get("mode") == "decode" and args[0].shape[1] == 1:
            tap["logits"] = out[0][0, 0].clone()     # slot 0: alone

    hook = model.register_forward_hook(last_logits, with_kwargs=True)
    res = Engine(cfg32, model, max_len=XL_LEN, max_batch=XL_SLOTS,
                 device=dev).generate([request])[0]
    hook.remove()
    seq = res.tokens[:-1]
    with torch.no_grad():
        ref = M.forward(model, tokens=torch.tensor([seq], device=dev))[0][
            0, -1]
    got = tap["logits"]
    err = float((got - ref).abs().max() / ref.std())
    print(f"check the {len(request.prompt)}-token request in float32 "
          f"weights, all {cfg32.n_layers} layers "
          f"({M.param_bytes(model) / 1e9:.3f} GB): last decode step vs a "
          f"cache-free forward over {len(seq)} tokens: max|diff| / "
          f"std(logits) = {err:.3g} (bound {XL_F32_BOUND:g}); "
          f"{time.perf_counter() - t0:.1f} s | {smi}", flush=True)
    check(bool(torch.isfinite(got).all()) and err <= XL_F32_BOUND,
          "serve-xlstm: float32 decode logits outside the bound of the "
          "cache-free forward")
    del model
    gc.collect()
    torch.cuda.empty_cache()


def moe_drop_shares(model, batch, m):
    """Each MoE layer's share of (token, choice) pairs that the capacity
    dispatch drops over the m microbatches of ``batch``, at the model's
    present weights (the routing a train step's forward takes)."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe
    kept, total, hooks = {}, {}, []
    for i, blk in enumerate(model.blocks):
        if not isinstance(blk.mlp, moe.MoE):
            continue

        def hook(mod, args, _out, i=i):
            x = args[0]
            r = moe.capacity_route(mod.router, x.reshape(-1, x.shape[-1]),
                                   mod.cfg)
            n = x.shape[0] * x.shape[1] * r.w.shape[2]   # padding cut off
            kept[i] = kept.get(i, 0) + int(r.keep.reshape(-1)[:n].sum())
            total[i] = total.get(i, 0) + n
        hooks.append(blk.mlp.register_forward_hook(hook))
    try:
        with torch.no_grad():
            for j in range(m):
                toks = batch["tokens"].reshape(
                    (m, -1) + batch["tokens"].shape[1:])[j]
                M.forward(model, tokens=toks)
    finally:
        for h in hooks:
            h.remove()
    return {i: 1.0 - kept[i] / total[i] for i in sorted(kept)}


def one_microbatch_grads(model, batch, m):
    """The first microbatch's gradients in the reference's layout, as the
    train step's autograd pass computes them (remat on, ``capacity``)."""
    return microbatch_grads(model, {k: v.reshape((m, v.shape[0] // m)
                                                 + v.shape[1:])[0]
                                    for k, v in batch.items()}, 1)[0]


class PlainDispatch:
    """Inside ``with``: the capacity dispatch's gather with autograd's own
    backward (a ``scatter_add`` of the slots' gradients, float atomics on
    the card) in place of ``moe._DispatchGather``'s ordered sum."""

    @staticmethod
    def apply(xg, slots, src, k):
        import torch
        import torch.nn.functional as F
        ng, g, d = xg.shape
        return torch.gather(F.pad(xg, (0, 0, 0, 1)), 1,
                            slots[..., None].expand(ng, slots.shape[1], d))

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.real = moe, moe._DispatchGather
        moe._DispatchGather = PlainDispatch
        return self

    def __exit__(self, *exc):
        self.moe._DispatchGather = self.real


def moe_dispatch_check(cfg, seed, dev, smi):
    """Check 3 of phase 18: one MoE layer of ``cfg`` at full width in
    float32 over ``MOE_DISPATCH_TOKENS`` tokens; ``capacity`` with room
    for every choice against ``dense``, every gradient within
    ``MOE_DISPATCH_REL``; then ``capacity`` at the configured capacity:
    drops, and every gradient finite."""
    import dataclasses
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import moe

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 61)
    layer = moe.MoE(cfg32, torch.float32, dev)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.normal_(generator=gen).mul_(
                M._init_scale(cfg32, "blocks.0.mlp." + name, p))
    layer.requires_grad_(True)
    t, d = MOE_DISPATCH_TOKENS, cfg.d_model
    x = torch.randn((1, t, d), generator=gen, device=dev)
    ct = torch.randn((1, t, d), generator=gen, device=dev)
    names = ["x"] + [n for n, _ in layer.named_parameters()]

    def grads(impl, capacity=None):
        xx = x.clone().requires_grad_(True)
        y, aux = moe.moe_apply(layer, xx, cfg32, impl=impl,
                               capacity=capacity)
        loss = torch.sum(y * ct) + 0.01 * aux
        gs = torch.autograd.grad(loss, [xx] + list(layer.parameters()))
        return dict(zip(names, gs)), float(loss.detach())

    full = moe.capacity_route(layer.router, x[0], cfg32, capacity=t)
    configured = moe.capacity_route(layer.router, x[0], cfg32)
    gc_, lc = grads("capacity", capacity=t)
    gd, ld = grads("dense")
    rel = {n: float((gc_[n] - gd[n]).abs().max() / gd[n].abs().max())
           for n in names}
    worst = max(rel, key=rel.get)
    dropped = int((~configured.keep).sum())
    gq, lq = grads("capacity")
    finite = all(bool(torch.isfinite(g).all()) for g in gq.values())
    print(f"check train-moe dispatch: one MoE layer at full width in "
          f"float32 (E {cfg.moe.num_experts}, top-{cfg.moe.top_k}, d {d}, "
          f"f {cfg.moe.d_ff_expert}, {cfg.moe.num_shared} shared) over "
          f"{t} tokens: capacity {t} ({int((~full.keep).sum())} dropped) "
          f"vs dense, loss {lc!r} vs {ld!r}, gradients max|diff| / "
          f"max|dense|: " + ", ".join(f"{n} {rel[n]:.3g}" for n in names)
          + f" (worst {worst}; bound {MOE_DISPATCH_REL:g}) | configured "
          f"capacity {configured.cg}: {dropped} of {full.keep.numel()} "
          f"choices dropped ({dropped / full.keep.numel():.4f}), loss "
          f"{lq!r}, every gradient {'finite' if finite else 'NOT finite'}"
          f" | {smi}", flush=True)
    check(not bool((~full.keep).any()) and rel[worst] <= MOE_DISPATCH_REL
          and dropped > 0 and finite,
          f"train-moe: the capacity dispatch's gradients differ from the "
          f"dense dispatch's ({worst} {rel[worst]:g}), or the configured "
          f"capacity dropped {dropped} choices, or a gradient is not "
          f"finite")
    del layer, gc_, gd, gq
    torch.cuda.empty_cache()


def train_moe_phase(seed, dev, smi):
    """Phase 18: deepseek-v2-lite-16b trained at full width through the
    port's train step (the capacity dispatch under autograd, its ordered
    backward); returns K1's entries for its exact step."""
    import dataclasses
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataCfg, SyntheticLM
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.models import moe
    from repro_torch.optim import adamw
    from repro_torch.train import init_state, make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    full = get_config(MOE_TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 41)
    model = M.init_params(cfg, generator=gen, device=dev)
    data = SyntheticLM(DataCfg(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH, seed=seed))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(0).items()}
    tokens = TRAIN_BATCH * TRAIN_SEQ
    lr_fn = adamw.cosine_schedule(TRAIN_LR, 1, TRAIN_STEPS)
    nparams = sum(p.numel() for p in model.parameters())
    leaves = len(convert.reference_leaves(cfg))
    print(f"train-moe: {cfg.name} at full width (d_model {cfg.d_model}, "
          f"MLA latent {cfg.kv_lora_rank}, {cfg.moe.num_experts} experts "
          f"top-{cfg.moe.top_k} + {cfg.moe.num_shared} shared, d_ff "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}, {cfg.dtype}) cut to "
          f"{cfg.n_layers} of {full.n_layers} layers: {nparams} parameters "
          f"({M.param_bytes(model) / 1e9:.3f} GB) in {leaves} reference "
          f"leaves; batch {TRAIN_BATCH} x {TRAIN_SEQ} (SyntheticLM seed "
          f"{seed}), {TRAIN_MB} microbatches, lr cosine({TRAIN_LR}, 1, "
          f"{TRAIN_STEPS}), remat on, the capacity dispatch", flush=True)
    check(leaves == MOE_LEAVES, f"train-moe: {leaves} reference leaves")

    # 1. the juggler: five steps on the same batch, the loss falls, aux
    # finite and positive; no kernel of the port (counts set to 0 just
    # before, read just after).  Each layer's drops at step 1 first.
    drops = moe_drop_shares(model, batch, TRAIN_MB)
    print("train-moe: the share of (token, choice) pairs dropped by the "
          "capacity dispatch at step 1, by layer: "
          + ", ".join(f"{i} {v:.4f}" for i, v in drops.items()),
          flush=True)
    step = make_train_step(cfg, lr_fn=lr_fn, num_microbatches=TRAIN_MB,
                           device=dev)
    hold = {"model": model, "state": init_state(model)}

    def one():
        hold["model"], hold["state"], hold["metrics"] = step(
            hold["model"], hold["state"], batch)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, auxs = [], []
    for _ in range(TRAIN_STEPS):
        one()
        losses.append(float(hold["metrics"]["loss"]))
        auxs.append(float(hold["metrics"]["aux"]))
    torch.cuda.synchronize()
    launched = read_launches()
    print(f"main train-moe (juggler, m={TRAIN_MB}, {cfg.n_layers} layers):"
          f" losses {losses}, aux {auxs}, grad norm "
          f"{float(hold['metrics']['grad_norm']):.4f}, launches {launched}",
          flush=True)
    check(all(math.isfinite(v) for v in losses + auxs)
          and losses[-1] < losses[0] and all(a > 0 for a in auxs)
          and not any(launched.values()),
          f"train-moe: the juggler's losses {losses} did not fall, aux "
          f"{auxs} is not finite and positive, or a kernel ran "
          f"({launched})")
    jug_ms = cuda_ms(one, REPS)
    jug_peak = torch.cuda.max_memory_allocated()
    model = hold["model"]
    del hold, one, step
    gc.collect()
    torch.cuda.empty_cache()

    # 2. one microbatch's gradients twice from the same weights: bitwise
    # in every leaf (the ordered dispatch backward); with autograd's own
    # scatter_add backward instead, how many leaves differ
    g1 = one_microbatch_grads(model, batch, TRAIN_MB)
    g2 = one_microbatch_grads(model, batch, TRAIN_MB)
    diff = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    del g2
    with PlainDispatch():
        p1 = one_microbatch_grads(model, batch, TRAIN_MB)
        p2 = one_microbatch_grads(model, batch, TRAIN_MB)
    plain_diff = [k for k in p1 if not torch.equal(p1[k], p2[k])]
    plain_vs = [k for k in p1 if not torch.equal(p1[k], g1[k])]
    del p1, p2, g1
    print(f"check train-moe repeatable: one microbatch's gradients twice "
          f"from the same weights: {len(diff)} of {MOE_LEAVES} leaves "
          f"differ{' (' + ', '.join(diff) + ')' if diff else ''}; with "
          f"autograd's scatter_add dispatch backward instead: "
          f"{len(plain_diff)} of {MOE_LEAVES} differ between two runs "
          f"({', '.join(plain_diff) or 'none'}), {len(plain_vs)} differ "
          f"from the ordered sum's", flush=True)
    check(not diff, f"train-moe: a microbatch's gradients differ between "
                    f"two runs in {diff}")

    # 5. one MoE layer's forward and backward at a microbatch's shape
    layer = model.blocks[0].mlp
    hx = torch.randn((TRAIN_BATCH // TRAIN_MB, TRAIN_SEQ, cfg.d_model),
                     generator=gen, device=dev).to(torch.bfloat16)
    hc = torch.randn(hx.shape, generator=gen, device=dev)

    def layer_fwd(impl):
        def run():
            with torch.no_grad():
                moe.moe_apply(layer, hx, cfg, impl=impl)
        return run

    def layer_fwd_bwd(impl):
        def run():
            xx = hx.clone().requires_grad_(True)
            y, aux = moe.moe_apply(layer, xx, cfg, impl=impl)
            torch.autograd.grad(torch.sum(y.float() * hc) + 0.01 * aux,
                                [xx] + list(layer.parameters()))
        return run

    layer_ms = {(impl, what): cuda_ms(fn(impl), REPS)
                for impl in ("capacity", "dense")
                for what, fn in (("forward", layer_fwd),
                                 ("forward and backward", layer_fwd_bwd))}
    del layer, hx, hc, model
    gc.collect()
    torch.cuda.empty_cache()

    # 3. capacity against dense at full width in float32
    moe_dispatch_check(full, seed, dev, smi)

    # 4. K1 on the train path at 2 layers: grad_reduce and norm_policy
    # under exact launch K1 58 times a step, each launch bitwise its
    # plain version; the step's reductions bitwise the blocked executor
    cut = dataclasses.replace(full, n_layers=MOE_K1_LAYERS)
    gen.manual_seed(seed + 42)
    small = M.init_params(cut, generator=gen, device=dev)
    step = make_train_step(cut, lr_fn=lr_fn, num_microbatches=TRAIN_MB,
                           grad_reduce="exact", norm_policy="exact",
                           device=dev)
    hold = {"model": small, "state": init_state(small)}

    def one():
        hold["model"], hold["state"], hold["metrics"] = step(
            hold["model"], hold["state"], batch)

    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    with K1ByCaller() as calls:
        one()
    torch.cuda.synchronize()
    launched, by_caller = read_launches(), calls.counts
    met = hold["metrics"]
    print(f"main train-moe (grad_reduce=exact, norm_policy=exact, m="
          f"{TRAIN_MB}, {cut.n_layers} layers): loss "
          f"{float(met['loss']):.4f}, aux {float(met['aux']):.4f}, grad "
          f"norm {float(met['grad_norm']):.4f}, launches {launched} (K1 "
          f"want {MOE_K1_PER_STEP}): grad_reduce {by_caller['grad_reduce']},"
          f" global_norm {by_caller['global_norm']}", flush=True)
    check(launched == {"K1": MOE_K1_PER_STEP, "K2": 0, "K3": 0, "K4": 0,
                       "K5": 0}
          and by_caller == {"grad_reduce": MOE_LEAVES,
                            "global_norm": 2 * MOE_LEAVES + 1}
          and bool(torch.isfinite(met["loss"]))
          and bool(torch.isfinite(met["grad_norm"])),
          f"train-moe: the exact step launched {launched} ({by_caller})")
    exact_ms = cuda_ms(one, REPS)
    exact_peak = torch.cuda.max_memory_allocated()
    with K1Probe() as probe:
        step_ms = cuda_ms(one, 1, warmup=0)
    in_step_k1, in_step_prep = probe.k1_ms(), probe.prep_ms()
    with K1Probe(measure=True) as probe, K1ByCaller(probe):
        one()
    check(all(r["ok"] for r in probe.records)
          and len(probe.records) == MOE_K1_PER_STEP
          and all(r["caller"] in by_caller for r in probe.records),
          "train-moe: K1 differs from its plain version on an exact "
          "step's launches")
    entries = [k1_train_entry(f"segsum_policy_kernel<exact>/train-moe "
                              f"{c} n_layers={MOE_K1_LAYERS}",
                              [r for r in probe.records
                               if r["caller"] == c], by_caller[c])
               for c in ("grad_reduce", "global_norm")]
    big = max((r["shape"] for r in probe.records), key=lambda s: s[0] * s[1])
    print(f"check train-moe K1 exact on the step's {len(probe.records)} "
          f"launches (largest stream {big[0]} x {big[1]}): every one "
          f"bitwise its plain version", flush=True)
    small = hold["model"]
    del hold, one, step, probe
    gc.collect()
    torch.cuda.empty_cache()
    gs = microbatch_grads(small, batch, TRAIN_MB)
    del small
    gc.collect()
    torch.cuda.empty_cache()
    check_grad_reductions(gs, "exact", f"train-moe n_layers={MOE_K1_LAYERS}")
    del gs
    gc.collect()
    torch.cuda.empty_cache()

    print(f"time train-moe: juggler step at {cfg.n_layers} layers "
          f"{jug_ms:.3f} ms ({tokens * 1e3 / jug_ms:.1f} tokens/s, peak "
          f"memory {jug_peak / 2 ** 30:.2f} GiB) | exact step at "
          f"{cut.n_layers} layers {exact_ms:.3f} ms ({tokens * 1e3 / exact_ms:.1f}"
          f" tokens/s, peak memory {exact_peak / 2 ** 30:.2f} GiB) | inside "
          f"one exact step of {step_ms:.3f} ms: K1 {in_step_k1:.3f} ms "
          f"({MOE_K1_PER_STEP} launches), domain preparation "
          f"{in_step_prep:.3f} ms | K1 grad_reduce {entries[0]['ms']:.3f} "
          f"ms (bound {entries[0]['bound_ms']:.3f}, plain "
          f"{entries[0]['plain_ms']:.1f}, torch.sum "
          f"{entries[0]['library_ms']:.3f}), global_norm "
          f"{entries[1]['ms']:.3f} ms (bound {entries[1]['bound_ms']:.3f}, "
          f"plain {entries[1]['plain_ms']:.1f}, torch.sum "
          f"{entries[1]['library_ms']}) | one MoE layer at "
          f"{TRAIN_BATCH // TRAIN_MB} x {TRAIN_SEQ} tokens: "
          + ", ".join(f"{impl} {what} {ms:.3f} ms"
                      for (impl, what), ms in layer_ms.items())
          + f" | the phase {time.perf_counter() - t_phase:.1f} s | {smi}",
          flush=True)
    return entries


def serve_vlm_phase(seed, dev, smi):
    """Phase 19: qwen2-vl-7b whole, at full width, served through the
    port's ``Engine`` on tokens (K2 at 7 query heads a KV head), its
    embedding-input forward and M-RoPE on distinct position streams;
    returns the kernel entries of K2 and K1 on this path."""
    import gc
    import importlib
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.kernels import ops
    from repro_torch.models import attention as A
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.serve import Engine, Request
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config(VLM_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 61)
    model = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    weights_gb = M.param_bytes(model) / 1e9
    host = torch.Generator()
    host.manual_seed(seed + 62)
    lens = torch.randint(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1,
                         (SERVE_SLOTS,), generator=host).tolist()
    requests = [Request(prompt=torch.randint(1, cfg.vocab, (n,),
                                             generator=host).tolist(),
                        max_new_tokens=SERVE_NEW) for n in lens]
    group = cfg.n_heads // cfg.n_kv_heads
    print(f"serve-vlm: {cfg.name} whole ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} kv: "
          f"{group} query heads a KV head, K2's CUDA block of "
          f"{fd.group_rows(group)} rows; hd {cfg.hdim}, M-RoPE sections "
          f"{A.rope_sections(cfg)}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"rope_theta {cfg.rope_theta:g}, {cfg.dtype}), "
          f"{sum(p.numel() for p in model.parameters())} parameters "
          f"({weights_gb:.3f} GB) drawn in {init_s:.2f} s; {SERVE_SLOTS} "
          f"slots x {SERVE_LEN} context, prefill chunks of {SERVE_CHUNK}; "
          f"prompts {lens}, {SERVE_NEW} new tokens each, greedy",
          flush=True)

    def engine():
        return Engine(cfg, model, max_len=SERVE_LEN, max_batch=SERVE_SLOTS,
                      prefill_chunk=SERVE_CHUNK,
                      logprob_policy="compensated", device=dev)

    # taps (forward hooks): decode steps seen by layer 0; the middle
    # layer's K2 inputs and output at one step; the last decode logits
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

    # the main path: counts set to 0 just before, read after every engine
    # step (K2 at 28 a decode step so far, K1 at 0 until _finalize_
    # logprobs takes the mean) and just after
    eng = engine()
    stream, during = {}, []

    def on_step(e, step):
        during.append((tap["steps"], fd.LAUNCHES["dense"], K.LAUNCHES))
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
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for hk in hooks:
        hk.remove()
    steps = tap["steps"]
    new = sum(len(r.tokens) - r.prompt_len for r in results)
    per_step = all(k2 == st * cfg.n_layers and k1 == 0
                   for st, k2, k1 in during)
    print(f"main serve-vlm: {len(results)} results in order "
          f"{[r.rid for r in results]}, {new} tokens, {steps} decode "
          f"steps, {eng._clock} engine steps in {wall * 1e3:.1f} ms; K2 "
          f"launches {k2_launches['dense']} (want {steps} x "
          f"{cfg.n_layers}; after every engine step {cfg.n_layers} a decode"
          f" step so far: {per_step}), K1 launches {k1_launches} (after "
          f"each step: {sorted({k1 for _, _, k1 in during})}); peak memory "
          f"{peak_gb:.2f} GiB; mean_logprob "
          f"{[round(r.mean_logprob, 4) for r in results]}", flush=True)
    check([r.rid for r in results] == rids
          and all(len(r.tokens) - r.prompt_len == SERVE_NEW
                  and r.tokens[:r.prompt_len] == q.prompt
                  and all(0 <= t < cfg.vocab for t in r.tokens)
                  and math.isfinite(r.mean_logprob)
                  for r, q in zip(results, requests)),
          "serve-vlm: results out of order, short, out of the vocabulary "
          "or with a non-finite mean_logprob")
    check(steps >= SERVE_NEW - 1 and per_step
          and k2_launches == {"dense": steps * cfg.n_layers, "partial": 0,
                              "paged": 0},
          f"serve-vlm: K2 launches {k2_launches} for {steps} decode steps")
    check(k1_launches == 1,
          f"serve-vlm: the mean_logprob reduce did not run on K1 once "
          f"(launches {k1_launches})")

    # K2 against its plain version on the engine's own cache and query:
    # split_kernel<7, NT>, qwen2-vl's group of 7 rows
    q, k, v, kv_len, sc = (tap[x] for x in ("q", "k", "v", "kv_len", "sc"))
    qf = q.float().contiguous()
    bias = ops.length_bias(kv_len, k.shape[1], None, dev)
    plain_ms, plain = host_ms(lambda: fd.flash_decode_torch(
        qf, k, v, bias, sm_scale=sc, block_kv=512))
    kern = fd.flash_decode_cuda(qf, k, v, bias, sm_scale=sc, block_kv=512)
    ok, k2_err = same(kern, plain)
    ok_engine = torch.equal(kern, tap["out"])
    print(f"check K2 at G = {group} (layer {layer}, decode step "
          f"{SERVE_TAP_STEP}: q {tuple(q.shape)} {q.dtype}, cache "
          f"{tuple(k.shape)} {k.dtype}, kv_len {kv_len.tolist()}): "
          f"max|kernel-plain|={k2_err:g} {'bitwise' if ok else 'DIFFER'}; "
          f"the engine's own output {'bitwise' if ok_engine else 'DIFFER'}",
          flush=True)
    check(ok and ok_engine, "serve-vlm: K2 differs from its plain version "
                            "on the engine's cache")

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
    kh, d, h = k.shape[2], k.shape[3], q.shape[1]
    k2_bytes = rows * (2 * kh * d * 4 + 4) + 2 * q.numel() * 4
    k2_ops = rows * h * (4 * d + 1)
    k2_bound = max(k2_bytes / HBM_BYTES_PER_S,
                   k2_ops / FP32_OPS_PER_S) * 1e3
    k4 = k.permute(0, 2, 1, 3).contiguous()
    v4 = v.permute(0, 2, 1, 3).contiguous()
    mask = bias[:, None, None, :]
    sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qf[:, :, None], k4, v4, attn_mask=mask, scale=sc,
        enable_gqa=True), REPS)
    del k4, v4, mask
    cache_gb = M.cache_bytes(eng._caches) / 1e9
    print(f"time serve-vlm: decode step at B={SERVE_SLOTS} {step_ms:.3f} "
          f"ms (bound {weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3:.3f} ms: "
          f"the weights once over 3.35 TB/s; {SERVE_SLOTS * 1e3 / step_ms:.1f}"
          f" tokens/s decoding) | {SERVE_CHUNK}-token prefill chunk "
          f"{chunk_ms:.3f} ms | the run: {new} tokens in {wall * 1e3:.1f} ms "
          f"({new / wall:.1f} generated tokens/s, prefill included) | K2 "
          f"per layer per step {k2_ms:.4f} ms, bound {k2_bound:.4f} ms "
          f"({k2_bytes / 1e6:.2f} MB: the f32 KV rows below each length), "
          f"plain {plain_ms:.1f} ms, SDPA {sdpa_ms:.4f} ms | parameters "
          f"{weights_gb:.3f} GB, caches {cache_gb:.3f} GB (f32 k/v), peak "
          f"{peak_gb:.2f} GiB | {smi}", flush=True)
    entries = [{
        "name": "flash_decode_kernel<dense>/serve-vlm", "route": "cuda",
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
    safe = torch.where(ids >= 0, ids, nseg).long()
    entry = k1_entry("serve-vlm", vals, ids, nseg, "compensated", smi,
                     op="mean", library=lambda: torch.zeros(
                         (nseg + 1, 1), device=dev).index_add_(0, safe, vals))
    entries.append(dict(entry, launches=k1_launches))
    del eng
    torch.cuda.empty_cache()

    # batch independence: requests alone in fresh Engines, greedy tokens
    # bitwise; the last one's final decode logits kept
    hook = model.register_forward_hook(last_logits, with_kwargs=True)
    for i in VLM_ALONE:
        alone = engine().generate([requests[i]])[0]
        torch.cuda.empty_cache()
        same_toks = alone.tokens == results[i].tokens
        print(f"check request {i} (prompt {lens[i]}) alone vs in the "
              f"batch: tokens {'bitwise' if same_toks else 'DIFFER'}",
              flush=True)
        check(same_toks, f"serve-vlm: request {i} depends on its batch")
    hook.remove()
    # its last decode step's logits (cache, K2) against one cache-free
    # prefill forward over the same tokens
    seq = torch.tensor([alone.tokens[:-1]], device=dev)
    with torch.no_grad():
        ref = M.forward(model, tokens=seq, mode="prefill")[0][0, -1]
    got = tap["logits"][0]
    rel = float((got - ref).abs().max() / ref.std())
    agree = int(got[:cfg.vocab].argmax()) == int(ref[:cfg.vocab].argmax())
    print(f"check request {VLM_ALONE[-1]}'s last decode step (position "
          f"{seq.shape[1] - 1}) vs forward(mode='prefill') over its "
          f"{seq.shape[1]} tokens: max|diff| / std(logits) = {rel:.5f} "
          f"(bound {SERVE_LOGIT_BOUND}), std {float(ref.std()):.4f}, argmax "
          f"{'agrees' if agree else 'differs'}", flush=True)
    check(bool(torch.isfinite(got).all()) and rel <= SERVE_LOGIT_BOUND,
          "serve-vlm: decode logits outside the bound of the cache-free "
          "forward")
    del ref, got, seq

    # the embedding-input path at full width: embed_lookup(tokens) given as
    # embeds on the default (B, S, 3) positions is bitwise the token forward
    toks = torch.tensor([requests[0].prompt], device=dev)
    with torch.no_grad():
        on_toks = M.forward(model, tokens=toks)[0]
        pos = M._default_positions(cfg, 1, toks.shape[1], 0, dev)
        on_emb = M.forward(model, embeds=L.embed_lookup(model.embed, toks),
                           positions=pos)[0]
    ok = torch.equal(on_toks, on_emb)
    print(f"check forward(embeds=embed_lookup(tokens), positions "
          f"{tuple(pos.shape)}) vs forward(tokens=) over request 0's "
          f"{toks.shape[1]} tokens: {'bitwise' if ok else 'DIFFER'}",
          flush=True)
    check(ok, "serve-vlm: the embedding-input forward differs from the "
              "token forward")
    del on_toks, on_emb

    # M-RoPE on distinct streams: text, a patch grid, text
    pos1 = vlm_positions(*VLM_TEXT, VLM_GRID, dev)             # (S, 3)
    s_len = pos1.shape[0]
    pos3 = pos1[None]
    hd, secs = cfg.hdim, A.rope_sections(cfg)
    x = torch.randn((1, s_len, cfg.n_heads, hd), generator=gen, device=dev)
    got = L.apply_mrope(x, pos3, cfg.rope_theta, secs)
    slot = torch.repeat_interleave(torch.arange(3, device=dev),
                                   torch.tensor(secs, device=dev))
    freqs = 1.0 / (cfg.rope_theta ** (torch.arange(
        0, hd, 2, dtype=torch.float64, device=dev) / hd))
    ang = (pos3[..., slot].double() * freqs)[..., None, :]  # (1, S, 1, hd/2)
    x1, x2 = torch.chunk(x.double(), 2, dim=-1)
    want = torch.cat([x1 * torch.cos(ang) - x2 * torch.sin(ang),
                      x1 * torch.sin(ang) + x2 * torch.cos(ang)], dim=-1)
    scale = torch.cat([(x1.abs() + x2.abs()) * (ang.abs() + 1)] * 2,
                      dim=-1) * U
    err = (got.double() - want).abs()
    ratio = float((err / scale).max())
    print(f"check M-RoPE at full width (B=1, S={s_len}: {VLM_TEXT[0]} text, "
          f"a {VLM_GRID} x {VLM_GRID} patch grid, {VLM_TEXT[1]} text; "
          f"positions up to {int(pos1.max())}; H={cfg.n_heads}, hd={hd}, "
          f"sections {secs}) vs float64: max|diff|={float(err.max()):.4g} "
          f"({float(err.max() / x.abs().max()):.3g} of max|x|), max |diff| "
          f"/ ((|x1| + |x2|)(|angle| + 1) u) = {ratio:.3f} (bound "
          f"{VLM_ROPE_BOUND})", flush=True)
    check(ratio <= VLM_ROPE_BOUND, "serve-vlm: M-RoPE outside its bound "
                                   "of the float64 rotation")
    del x, got, want, scale, err, ang, x1, x2

    # the whole forward on embeds with those positions: text tokens'
    # embeddings around random patch embeddings at the table's scale
    t_ids = torch.randint(1, cfg.vocab, (s_len,), generator=gen, device=dev)
    emb = L.embed_lookup(model.embed, t_ids)
    n0, g2 = VLM_TEXT[0], VLM_GRID * VLM_GRID
    emb[n0:n0 + g2] = (0.02 * torch.randn((g2, cfg.d_model), generator=gen,
                                          device=dev)).to(emb.dtype)
    emb = emb[None]
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: M.forward(model, embeds=emb,
                                           positions=pos3), 3)
        logits = M.forward(model, embeds=emb, positions=pos3)[0]
    finite = bool(torch.isfinite(logits).all())
    print(f"check forward(embeds=, positions=) with the patch grid: logits "
          f"{tuple(logits.shape)} {'finite' if finite else 'NOT FINITE'}, "
          f"std {float(logits.std()):.4f}; {fwd_ms:.3f} ms | {smi}",
          flush=True)
    check(finite and logits.shape == (1, s_len, cfg.padded_vocab),
          "serve-vlm: the embeds forward's logits are not finite")
    del logits, emb, model, results
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve-vlm: the phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def serve_encdec_phase(seed, dev, smi):
    """Phase 20: seamless-m4t-large-v2 whole, at full width: each request's
    memory encoded, the decoder prefilled and decoded through the train
    module's step factories, its self- and cross-attention on K2;
    returns the kernel entries of K2 at the cross and the self shape."""
    import gc
    import importlib
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import model as M
    from repro_torch.models.layers import dense
    from repro_torch.train import make_decode_step, make_prefill_step
    fd = importlib.import_module("repro_torch.kernels.flash_decode")

    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    cfg = get_config(ENCDEC_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 71)
    model = M.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    n_params = sum(p.numel() for p in model.parameters())
    weights_gb = M.param_bytes(model) / 1e9
    b, t, s0 = ENCDEC_BATCH, ENCDEC_MEMORY, ENCDEC_PROMPT
    enc_embeds = torch.randn((b, t, cfg.d_model), generator=gen,
                             device=dev).to(torch.bfloat16)
    prompts = torch.randint(1, cfg.vocab, (b, s0), generator=gen,
                            device=dev)
    print(f"serve-encdec: {cfg.name} whole ({cfg.encoder_layers} encoder "
          f"and {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.hdim}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}), {n_params} "
          f"parameters ({weights_gb:.3f} GB) drawn in {init_s:.2f} s; "
          f"{b} requests, memories {tuple(enc_embeds.shape)} bf16, prompts "
          f"of {s0}, caches padded to {ENCDEC_LEN}, {ENCDEC_NEW} greedy "
          f"steps", flush=True)
    check(n_params == ENCDEC_PARAMS, f"serve-encdec: {n_params} "
                                     f"parameters, want {ENCDEC_PARAMS}")
    prefill = make_prefill_step(cfg, device=dev)
    dstep = make_decode_step(cfg, device=dev)

    def generate(prompts, enc_embeds, steps, on_step=None):
        """Greedy decoding through the step factories: the prefill step
        encodes ``enc_embeds`` itself, the decode steps take the memory
        from ``encode``.  -> (tokens (B, 1 + steps), the last step's
        logits (B, V), the memory)."""
        with torch.no_grad():
            enc_out = M.encode(model, enc_embeds)
        logits, caches = prefill(model, {"tokens": prompts,
                                         "enc_embeds": enc_embeds})
        caches = M.pad_caches_to(cfg, caches, ENCDEC_LEN)
        tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
        out = [tok]
        for i in range(steps):
            logits, caches = dstep(model, tok, caches, s0 + i,
                                   enc_out=enc_out)
            tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True)
            out.append(tok)
            if on_step is not None:
                on_step(i)
        return torch.cat(out, 1), logits[:, -1], enc_out

    # taps (forward hooks): every DecodeAttention call, self and cross;
    # layer 12's K2 inputs and output at one step of each
    layer = cfg.n_layers // 2
    tap = {"self": 0, "cross": 0}

    def counter(kind):
        def hook(mod, args, out):
            tap[kind] += 1
        return hook

    def capture(kind):
        def hook(mod, args, out):
            tap[kind + "_seen"] = tap.get(kind + "_seen", 0) + 1
            if tap[kind + "_seen"] == SERVE_TAP_STEP:
                q, k, v, kv_len, sc = args
                tap[kind + "_args"] = (q.clone(), k.clone(), v.clone(),
                                       kv_len.clone(), sc, out.clone())
        return hook

    hooks = []
    for blk in model.blocks:
        hooks.append(blk.core.decode_attn.register_forward_hook(
            counter("self")))
        hooks.append(blk.cross.decode_attn.register_forward_hook(
            counter("cross")))
    for kind, mod in (("self", model.blocks[layer].core.decode_attn),
                      ("cross", model.blocks[layer].cross.decode_attn)):
        hooks.append(mod.register_forward_hook(capture(kind)))

    # the main path: counts set to 0 just before, read after every decode
    # step (48 a step so far) and just after
    per_step = 2 * cfg.n_layers
    during = []
    for key in fd.LAUNCHES:
        fd.LAUNCHES[key] = 0
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    toks, last, enc_out = generate(
        prompts, enc_embeds, ENCDEC_NEW,
        on_step=lambda i: during.append(fd.LAUNCHES["dense"]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k2_launches = dict(fd.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    for hk in hooks:
        hk.remove()
    in_step = during == [per_step * (i + 1) for i in range(ENCDEC_NEW)]
    new = toks.numel()
    print(f"main serve-encdec: {b} requests, {new} tokens ({ENCDEC_NEW} "
          f"decode steps after the prefill) in {wall * 1e3:.1f} ms; K2 "
          f"launches {k2_launches['dense']} (want {ENCDEC_NEW} x "
          f"{per_step}; {per_step} a step after every step: {in_step}; "
          f"self {tap['self']}, cross {tap['cross']}); peak memory "
          f"{peak_gb:.2f} GiB; request 0's first tokens "
          f"{toks[0, :8].tolist()}", flush=True)
    check(toks.shape == (b, ENCDEC_NEW + 1)
          and bool(((toks >= 0) & (toks < cfg.vocab)).all())
          and bool(torch.isfinite(last).all()),
          "serve-encdec: tokens out of the vocabulary or logits not finite")
    check(in_step and k2_launches == {"dense": ENCDEC_NEW * per_step,
                                      "partial": 0, "paged": 0}
          and tap["self"] == tap["cross"] == ENCDEC_NEW * cfg.n_layers,
          f"serve-encdec: K2 launches {k2_launches} (self {tap['self']}, "
          f"cross {tap['cross']}) for {ENCDEC_NEW} decode steps")

    # K2 against its plain version on the model's own inputs, a cross and
    # a self call of layer 12 (the plain runs timed), and beside SDPA; the
    # prefill step's caches are bf16, widened by the wrapper as here
    entries, k2 = [], {}
    for kind in ("cross", "self"):
        q, k, v, kv_len, sc, out = tap.pop(kind + "_args")
        print(f"serve-encdec: K2's {kind} call as the model made it: k/v "
              f"{k.dtype}", flush=True)
        qf, k, v = (x.float().contiguous() for x in (q, k, v))
        bias = ops.length_bias(kv_len, k.shape[1], None, dev)
        plain_ms, plain = host_ms(lambda: fd.flash_decode_torch(
            qf, k, v, bias, sm_scale=sc, block_kv=512))
        kern = fd.flash_decode_cuda(qf, k, v, bias, sm_scale=sc,
                                    block_kv=512)
        ok, err = same(kern, plain)
        ok_model = torch.equal(kern, out)
        print(f"check K2 {kind}-attention (layer {layer}, decode step "
              f"{SERVE_TAP_STEP}: q {tuple(q.shape)} {q.dtype}, k/v "
              f"{tuple(k.shape)} {k.dtype}, kv_len {kv_len.tolist()}): "
              f"max|kernel-plain|={err:g} {'bitwise' if ok else 'DIFFER'}; "
              f"the model's own output "
              f"{'bitwise' if ok_model else 'DIFFER'}", flush=True)
        check(ok and ok_model, f"serve-encdec: K2 differs from its plain "
                               f"version on the {kind}-attention call")
        ms = cuda_ms(lambda: fd.flash_decode_cuda(
            qf, k, v, bias, sm_scale=sc, block_kv=512), REPS)
        rows = int(kv_len.clamp(max=k.shape[1]).sum())
        kh, d, h = k.shape[2], k.shape[3], q.shape[1]
        nbytes = rows * (2 * kh * d * 4 + 4) + 2 * q.numel() * 4
        nops = rows * h * (4 * d + 1)
        bound = max(nbytes / HBM_BYTES_PER_S, nops / FP32_OPS_PER_S) * 1e3
        k4 = k.permute(0, 2, 1, 3).contiguous()
        v4 = v.permute(0, 2, 1, 3).contiguous()
        mask = bias[:, None, None, :]
        sdpa_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            qf[:, :, None], k4, v4, attn_mask=mask, scale=sc), REPS)
        splits = -(-k.shape[1] // fd.SPLIT_ROWS)
        k2[kind] = (ms, bound, nbytes, sdpa_ms, plain_ms, splits)
        entries.append({
            "name": f"flash_decode_kernel<dense>/serve-encdec {kind}",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode.py:72",
            "launches": tap[kind], "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                         >= nops / FP32_OPS_PER_S else "operations"),
            "library_ms": sdpa_ms})
        del q, k, v, qf, bias, kern, plain, out, k4, v4, mask
    torch.cuda.empty_cache()

    # batch independence: each request in its row of an otherwise empty
    # batch (token-0 prompts, zero memories), greedy tokens bitwise
    for i in ENCDEC_ALONE:
        p1 = torch.zeros_like(prompts)
        m1 = torch.zeros_like(enc_embeds)
        p1[i], m1[i] = prompts[i], enc_embeds[i]
        alone = generate(p1, m1, ENCDEC_ALONE_TOKENS - 1)[0][i]
        ok = torch.equal(alone, toks[i, :ENCDEC_ALONE_TOKENS])
        print(f"check request {i} alone vs in the batch: its first "
              f"{ENCDEC_ALONE_TOKENS} tokens {'bitwise' if ok else 'DIFFER'}",
              flush=True)
        check(ok, f"serve-encdec: request {i} depends on its batch")
        del p1, m1
    torch.cuda.empty_cache()

    # the last step's logits (caches, K2 on the memory) against a
    # cache-free train-mode forward over prompt and generated tokens
    seq = torch.cat([prompts, toks[:, :ENCDEC_NEW]], 1)
    with torch.no_grad():
        ref = M.forward(model, tokens=seq, enc_out=enc_out)[0][:, -1]
        swap = torch.arange(b, device=dev)
        swap[0], swap[1] = 1, 0
        swapped = M.forward(model, tokens=seq,
                            enc_out=enc_out[swap])[0][:, -1]
    std = ref.std(-1)
    rel = float(((last - ref).abs().amax(-1) / std).max())
    moved = ((swapped - ref).abs().amax(-1) / std)[:2]
    rest_same = torch.equal(swapped[2:], ref[2:])
    print(f"check the last decode step (position {seq.shape[1] - 1}) vs "
          f"forward(enc_out=) over the {seq.shape[1]} tokens: max|diff| / "
          f"std(logits) = {rel:.5f} over the {b} rows (bound "
          f"{SERVE_LOGIT_BOUND}), std {float(std.mean()):.4f}", flush=True)
    print(f"check requests 0 and 1 with their memories swapped: their "
          f"logits move {[round(float(x), 5) for x in moved]} std (at "
          f"least {ENCDEC_SWAP_MIN}); rows 2-{b - 1} "
          f"{'bitwise' if rest_same else 'DIFFER'}", flush=True)
    check(rel <= SERVE_LOGIT_BOUND, "serve-encdec: decode logits outside "
                                    "the bound of the cache-free forward")
    check(bool((moved > ENCDEC_SWAP_MIN).all()) and rest_same,
          "serve-encdec: swapping the memories did not move exactly their "
          "requests' logits")
    del ref, swapped, seq

    # timings: encode, the prefill step, a decode step at the final
    # caches (every row writing its last row, 127, again), the step's
    # cross K/V projections
    batch = {"tokens": prompts, "enc_embeds": enc_embeds}
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: M.encode(model, enc_embeds), 3)
        pre_ms = cuda_ms(lambda: prefill(model, batch), 3)
        _, caches = prefill(model, batch)
        caches = M.pad_caches_to(cfg, caches, ENCDEC_LEN)
        caches = [{"core": c["core"]._replace(length=torch.full_like(
            c["core"].length, ENCDEC_LEN - 1))} for c in caches]
        tok = toks[:, -1:]
        step_ms = cuda_ms(lambda: dstep(model, tok, caches, ENCDEC_LEN - 1,
                                        enc_out=enc_out), REPS)
        proj_ms = cuda_ms(lambda: [dense(w, enc_out) for blk in model.blocks
                                   for w in (blk.cross.wk, blk.cross.wv)],
                          REPS)
    proj_ops = 2 * cfg.n_layers * 2 * b * t * cfg.d_model \
        * cfg.n_kv_heads * cfg.hdim
    bytes_bound = weights_gb * 1e9 / HBM_BYTES_PER_S * 1e3
    ops_bound = proj_ops / BF16_OPS_PER_S * 1e3
    (xms, xbound, xbytes, xsdpa, xplain, xsplits), \
        (sms, sbound, sbytes, ssdpa, splain, _) = k2["cross"], k2["self"]
    print(f"time serve-encdec: encode at ({b}, {t}) {enc_ms:.3f} ms | "
          f"prefill step (encode included) {pre_ms:.3f} ms | decode step at "
          f"B={b} {step_ms:.3f} ms, bound {max(bytes_bound, ops_bound):.3f} "
          f"ms (the larger of the weights once, {bytes_bound:.3f} ms over "
          f"3.35 TB/s, and the cross projections' {proj_ops:.3e} "
          f"operations, {ops_bound:.3f} ms over 989 T/s in bf16; "
          f"{b * 1e3 / step_ms:.1f} tokens/s decoding) | the run: {new} "
          f"tokens in {wall * 1e3:.1f} ms ({new / wall:.1f} generated "
          f"tokens/s, encode and prefill included) | a step's "
          f"{2 * cfg.n_layers} cross K/V projections {proj_ms:.3f} ms | K2 "
          f"cross (kv_len {t}, {xsplits} splits x {cfg.n_kv_heads} heads x "
          f"{b}) {xms:.4f} ms, bound {xbound:.4f} ms ({xbytes / 1e6:.2f} "
          f"MB), plain {xplain:.1f} ms, SDPA {xsdpa:.4f} ms | K2 self "
          f"{sms:.4f} ms, bound {sbound:.4f} ms ({sbytes / 1e6:.2f} MB), "
          f"plain {splain:.1f} ms, SDPA {ssdpa:.4f} ms | parameters "
          f"{weights_gb:.3f} GB, peak {peak_gb:.2f} GiB | {smi}", flush=True)
    del model, enc_embeds, enc_out, caches, toks, last
    gc.collect()
    torch.cuda.empty_cache()
    print(f"serve-encdec: the phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


def digest(t) -> str:
    """SHA-256 of a tensor's bytes (any dtype), for bitwise comparisons
    across processes."""
    import hashlib
    import torch
    flat = t.detach().reshape(-1).contiguous().view(torch.uint8)
    return hashlib.sha256(flat.cpu().numpy().tobytes()).hexdigest()


def shard_bounds(n, world, rank, block):
    """The reference's shard_map split of an N-row stream: N padded to a
    multiple of world * block, each rank a contiguous equal share (its
    real rows clipped at N)."""
    per = (n + (-n) % (world * block)) // world
    return min(rank * per, n), min((rank + 1) * per, n)


def elastic_rank(group, *, seed, ckpt_dir, restore, steps, save_at,
                 launcher):
    """One rank of phase 21 (a fresh interpreter on the card): check 1,
    the sharded ``reduce`` of its slice of phase 5's stream; check 2, the
    elastic mean and ``collective_mean_tree`` of its share of a
    gradient-shaped stack; check 3, xlstm-125m's elastic step (restored
    from ``ckpt_dir`` first, or saving there after ``save_at`` steps);
    check 4 (``launcher``), the launcher's compressed step.  Returns
    digests, rank 0's results and the timings."""
    import contextlib
    import io
    import torch
    import repro_torch
    from repro_torch.ckpt import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.distributed import comm
    from repro_torch.distributed.collectives import make_elastic_train_step
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.launch import train as TL
    from repro_torch.models import convert, init_params
    from repro_torch.optim import adamw
    from repro_torch.reduce import (collective as C, get_backend,
                                    get_policy, mask_out_of_range,
                                    plan_program)
    from repro_torch.train import checkpoint_state, init_state
    dev = torch.device("cuda")
    r, w = comm.axis_index(group), comm.axis_size(group)
    out = {"rank": r, "world": w}

    def timed(fn):
        torch.cuda.synchronize()
        comm.barrier(group)
        K.LAUNCHES = 0
        comm.reset_stats()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, K.LAUNCHES, \
            comm.read_stats()

    # check 1: every tier through the sharded executor, K1 in each rank
    n, d, s = N_ROWS, WIDTH, SEGMENTS
    vals, ids = make_stream(n, d, s, seed, dev)
    lo, hi = shard_bounds(n, w, r, 512)
    sv, si = vals[lo:hi].contiguous(), ids[lo:hi].contiguous()
    del vals, ids
    out["reduce"] = {}
    for tier in TIERS:
        got, ms, launches, stats = timed(lambda: repro_torch.reduce(
            sv, segment_ids=si, num_segments=s, policy=tier,
            backend="shard_map", group=group))
        rec = {"digest": digest(got), "ms": ms, "launches": launches,
               "stats": stats, "out": got.cpu() if r == 0 else None}
        pol = get_policy(tier)
        if not pol.integer:
            # the port's own rank-order merge of the per-slice carries
            mids = mask_out_of_range(si, s)
            dom = torch.where((mids >= 0)[:, None], sv,
                              torch.zeros((), device=dev))
            prog = plan_program(pol, num_segments=s, domain_width=d,
                                block_size=512)
            carry = get_backend("cuda").run(dom, mids, s, policy=pol,
                                            block_size=512, program=prog)
            parts = [comm.all_gather(c, group) for c in carry]
            fold = tuple(p[0] for p in parts)
            for k in range(1, w):
                fold = pol.merge(fold, tuple(p[k] for p in parts))
            rec["own_merge"] = bool(torch.equal(pol.finalize(fold, None),
                                                got))
            del dom, carry, parts, fold
        out["reduce"][tier] = rec
        del got
    del sv, si
    torch.cuda.empty_cache()

    # check 2: a gradient-shaped stack of items, split over the ranks
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 210)
    items = torch.randn(ELASTIC_ITEMS, generator=g, device=dev) * 1e-3
    m = ELASTIC_ITEMS[0] // w
    mine = items[r * m:(r + 1) * m]
    out["elastic"], out["tree"] = {}, {}
    for tier in TIERS:
        got, ms, launches, stats = timed(lambda: C.elastic_reduce_mean(
            mine, group, policy=tier))
        out["elastic"][tier] = {"digest": digest(got), "ms": ms,
                                "launches": launches, "stats": stats}
        grads = {"w": items[r], "b": items[r, 0]}
        res = ({k: torch.zeros_like(v) for k, v in grads.items()}
               if tier == "compensated" else None)
        means, new_res = C.collective_mean_tree(grads, res, group,
                                                policy=tier)
        out["tree"][tier] = {
            "digest": digest(torch.cat([v.reshape(-1)
                                        for v in means.values()])),
            "residual": None if new_res is None else float(max(
                v.abs().max() for v in new_res.values()))}
    del items, mine, grads, means, new_res
    torch.cuda.empty_cache()

    # check 3: xlstm-125m whole through the elastic step
    cfg = get_config(ELASTIC_ARCH)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 21)
    model = init_params(cfg, generator=gen, device=dev)
    opt = init_state(model)
    start = 0
    if restore:
        _, manifest, _ = ckpt.restore_latest_valid(
            ckpt_dir, checkpoint_state(model, opt), inplace=True)
        start = manifest["extra"]["next_step"]
    step_fn = make_elastic_train_step(cfg, group,
                                      lr_fn=adamw.cosine_schedule(1e-3, 2, 20),
                                      microbatch_size=1)
    torch.cuda.reset_peak_memory_stats()
    train = {"start": start, "losses": [], "ms": [], "launches": [],
             "stats": []}
    for step in range(start, start + steps):
        bg = torch.Generator(device=dev)
        bg.manual_seed(seed * 1000 + 100 + step)
        batch = {"tokens": torch.randint(0, cfg.vocab, (ELASTIC_BATCH,
                                                        ELASTIC_SEQ),
                                         generator=bg, device=dev)}
        (model, opt, met), ms, launches, stats = timed(
            lambda: step_fn(model, opt, batch))
        train["losses"].append(met["loss"].cpu())
        train["ms"].append(ms)
        train["launches"].append(launches)
        train["stats"].append(stats)
        if save_at == step + 1:
            if r == 0:
                ckpt.save(ckpt_dir, step + 1, checkpoint_state(model, opt),
                          extra={"next_step": step + 1}, level=1)
            comm.barrier(group)
    train["peak"] = torch.cuda.max_memory_allocated()
    train["digest"] = digest(torch.cat([
        v.reshape(-1).view(torch.uint8) for v in
        convert.stacked_leaves(model).values()]))
    train["count"] = int(opt.count)
    out["train"] = train
    del model, opt, step_fn
    torch.cuda.empty_cache()

    # check 4: the launcher's data-parallel step, compressed
    if launcher:
        argv = ["--arch", ELASTIC_ARCH, "--compress-bits", "8",
                "--microbatches", "2", "--dist-backend", "gloo",
                "--steps", str(LAUNCH_STEPS), "--batch", str(ELASTIC_BATCH),
                "--seq", str(LAUNCH_SEQ), "--lr", "1e-3", "--warmup", "1",
                "--log-every", "1", "--seed", str(seed),
                "--world-size", str(w)]
        text = io.StringIO()
        comm.reset_stats()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(text):
            TL.main(argv)
        out["launch"] = {"log": text.getvalue(),
                         "s": time.perf_counter() - t0,
                         "stats": comm.read_stats()}
    return out


def elastic_bytes(cfg, world):
    """The bytes one rank of the elastic step holds, reckoned from the
    leaves: parameters, float32 AdamW moments, its microbatches'
    gradients (the parameters' dtype), and the largest leaf's exact2
    domain (8 float32 planes a value) with its float32 copy."""
    from repro_torch.models import convert, init_params
    leaves = convert.stacked_leaves(init_params(cfg, device="meta"))
    params = sum(v.numel() * v.element_size() for v in leaves.values())
    numel = sum(v.numel() for v in leaves.values())
    big = max(v.numel() for v in leaves.values())
    m = ELASTIC_BATCH // world
    return {"params": params, "moments": 8 * numel, "grads": m * params,
            "domain": m * big * 4 * 9, "total": params + 8 * numel
            + m * params + m * big * 4 * 9}


def train_elastic_phase(seed, dev, smi):
    """Phase 21: multi-process data parallelism on the card: groups of 2,
    4 and 1 ranks (fresh interpreters, gloo), the sharded ``reduce``,
    the elastic and tree means, xlstm-125m's elastic step resumed from 2
    ranks onto 4 and onto 1, and the launcher's compressed step; returns
    the kernel entry of K1 at the elastic step's shapes."""
    import tempfile
    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import spawn
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.models import convert, init_params
    from repro_torch.reduce import get_policy
    t_phase = time.perf_counter()
    cfg = get_config(ELASTIC_ARCH)
    for w in (1, 2, 4):
        b = elastic_bytes(cfg, w)
        print(f"train-elastic: reckoned bytes a rank at W={w}: parameters "
              f"{b['params'] / 1e9:.3f} GB, moments "
              f"{b['moments'] / 1e9:.3f} GB, {ELASTIC_BATCH // w} "
              f"microbatch gradients {b['grads'] / 1e9:.3f} GB, the largest "
              f"leaf's exact2 domain {b['domain'] / 1e9:.3f} GB: "
              f"{b['total'] / 1e9:.2f} GB a rank, {w * b['total'] / 1e9:.2f}"
              f" GB for the group, beside activations | card "
              f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f}"
              f" GB", flush=True)

    # the one-process results check 1 is held to: K1 on the whole stream
    n, d, s = N_ROWS, WIDTH, SEGMENTS
    vals, ids = make_stream(n, d, s, seed, dev)
    ref, absum, cnt = f64_reference(vals, ids, s)
    bsafe = torch.where(ids >= 0, ids, torch.full_like(ids, s)).long()
    blk = torch.arange(n, device=dev) // 512
    pairs = torch.unique(blk * (s + 1) + bsafe)
    blocks_per_seg = torch.bincount(pairs % (s + 1), minlength=s + 1)[:s] \
        .to(torch.float64)
    one, bound = {}, {}
    for tier in TIERS:
        pol = get_policy(tier)
        one[tier] = repro_torch.reduce(vals, segment_ids=ids,
                                       num_segments=s, policy=tier).cpu()
        ctx = pol.prepare_ctx(vals[ids >= 0].abs().max(), n) \
            if pol.needs_max_stat else None
        bound[tier] = tier_bound(tier, ref, absum, cnt, blocks_per_seg, ctx,
                                 512).cpu()
    ref, absum = ref.cpu(), absum.cpu()
    del vals, ids, cnt, bsafe, blk, pairs, blocks_per_seg
    torch.cuda.empty_cache()

    runs = {}
    with tempfile.TemporaryDirectory(dir=ROOT / "build",
                                     prefix="elastic_smoke_") as tmp:
        for w in ELASTIC_WORLDS:
            t0 = time.perf_counter()
            runs[w] = spawn.run_ranks(
                "chip_smoke:elastic_rank", w, workdir=Path(tmp) / f"w{w}",
                kwargs={"seed": seed, "ckpt_dir": str(Path(tmp) / "ck"),
                        "restore": w != 2,
                        "steps": ELASTIC_STEPS if w == 2
                        else ELASTIC_STEPS - ELASTIC_SAVE,
                        "save_at": ELASTIC_SAVE if w == 2 else None,
                        "launcher": w == 2},
                paths=[str(ROOT)], timeout=RANK_TIMEOUT)
            print(f"train-elastic: the group of {w} rank(s) took "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)

    # check 1: the sharded reduce
    for tier in TIERS:
        for w in (1, 2, 4):
            outs = runs[w]
            recs = [o["reduce"][tier] for o in outs]
            digests = {rec["digest"] for rec in recs}
            got = recs[0]["out"]
            check(len(digests) == 1, f"train-elastic: {tier} at W={w}: the "
                  f"ranks' results differ")
            diff = float((got.double() - one[tier].double()).abs().max())
            if tier in INT_TIERS:
                ok = torch.equal(got, one[tier])
                verdict = "bitwise" if ok else "DIFFER"
            else:
                # each merge add rounds once more: W * 2^-24 of |x| sums
                lim = bound[tier] + w * U * absum
                worst = float(((got.double() - ref).abs() / lim).max())
                ok = worst <= 1.0 and all(rec["own_merge"] for rec in recs)
                verdict = (f"own rank-order merge "
                           f"{'bitwise' if ok else 'DIFFER'}, err/bound vs "
                           f"float64 {worst:.4f}")
            print(f"check train-elastic reduce {tier:13s} W={w}: "
                  f"{verdict}; max|sharded - one process| {diff:g}; K1 "
                  f"launches per rank {[rec['launches'] for rec in recs]}; "
                  f"ms per rank {[round(rec['ms'], 3) for rec in recs]}; "
                  f"bytes across a rank "
                  f"{recs[0]['stats']['bytes_across']}, staged "
                  f"{recs[0]['stats']['bytes_staged']} | {smi}", flush=True)
            check(ok and all(rec["launches"] >= 1 for rec in recs),
                  f"train-elastic: {tier} at W={w}: the sharded reduce "
                  f"failed its check")

    # check 2: the elastic mean bitwise across W; the tree's residual
    for tier in TIERS:
        dig = {w: {o["elastic"][tier]["digest"] for o in runs[w]}
               for w in (1, 2, 4)}
        tree = {w: {o["tree"][tier]["digest"] for o in runs[w]}
                for w in (1, 2, 4)}
        across = len(set().union(*dig.values())) == 1
        replicated = all(len(v) == 1 for v in list(dig.values())
                         + list(tree.values()))
        res = [o["tree"][tier]["residual"] for o in runs[2]]
        ms = {w: round(runs[w][0]["elastic"][tier]["ms"], 3)
              for w in (1, 2, 4)}
        print(f"check train-elastic elastic_reduce_mean {tier:13s}: "
              f"W=1,2,4 {'bitwise' if across else 'differ'}; every rank's "
              f"result its group's {'yes' if replicated else 'NO'}; ms "
              f"{ms}; collective_mean_tree residual (W=2) {res}", flush=True)
        check(replicated, f"train-elastic: {tier}: ranks disagree")
        if tier in INT_TIERS:
            check(across, f"train-elastic: {tier}: the elastic mean "
                  f"depends on the rank count")
        if tier == "compensated":
            check(all(v is not None and v > 0 for v in res),
                  "train-elastic: compensated returned no residual")

    # check 3: xlstm-125m resumed from 2 ranks onto 4 and onto 1
    whole = runs[2][0]["train"]
    for w in (2, 4, 1):
        tr = [o["train"] for o in runs[w]]
        same_ranks = len({t["digest"] for t in tr}) == 1
        print(f"train-elastic: xlstm-125m W={w} from step {tr[0]['start']}: "
              f"losses {[float(v) for v in tr[0]['losses']]}; ms a step "
              f"{[round(v, 1) for v in tr[0]['ms']]}; K1 launches a step "
              f"per rank {[t['launches'] for t in tr]}; bytes across a "
              f"rank a step {tr[0]['stats'][-1]['bytes_across']}, staged "
              f"{tr[0]['stats'][-1]['bytes_staged']}, ms in collectives "
              f"{[round(st['ms'], 1) for st in tr[0]['stats']]}; peak "
              f"per rank "
              f"{[round(t['peak'] / 2 ** 30, 2) for t in tr]} GiB; ranks "
              f"{'bitwise' if same_ranks else 'DIFFER'} | {smi}", flush=True)
        check(same_ranks and all(min(t["launches"]) >= 1 for t in tr),
              f"train-elastic: W={w}: ranks differ or K1 did not launch")
        if w != 2:
            ok = (tr[0]["digest"] == whole["digest"] and all(
                torch.equal(a, b) for a, b in zip(
                    tr[0]["losses"], whole["losses"][ELASTIC_SAVE:])))
            print(f"check train-elastic resume 2 -> {w}: params and losses "
                  f"{'bitwise' if ok else 'DIFFER'} the uninterrupted "
                  f"run's", flush=True)
            check(ok, f"train-elastic: the resume onto {w} rank(s) is not "
                  f"bitwise")

    # check 4: the launcher's compressed step on 2 ranks, losses falling
    log = runs[2][0]["launch"]["log"]
    losses = [float(ln.split()[3]) for ln in log.splitlines()
              if ln.startswith("step")]
    print(f"check train-elastic launcher --compress-bits 8 --microbatches 2 "
          f"on 2 ranks: losses {losses} in "
          f"{runs[2][0]['launch']['s']:.1f} s; bytes across rank 0 "
          f"{runs[2][0]['launch']['stats']['bytes_across']}, staged "
          f"{runs[2][0]['launch']['stats']['bytes_staged']}, ms in "
          f"collectives {runs[2][0]['launch']['stats']['ms']:.1f}",
          flush=True)
    check(len(losses) == LAUNCH_STEPS and losses[-1] < losses[0],
          "train-elastic: the launcher's losses did not fall")
    check(runs[2][1]["launch"]["log"] == "",
          "train-elastic: a rank other than 0 printed")

    # K1 at the elastic step's shapes: a stack of W=2's 4 microbatch rows
    # of the largest leaf whose padded plain version fits (w_if, 36,864
    # values), against its plain version; and at the embedding's shape
    leaves = convert.stacked_leaves(init_params(cfg, device="meta"))
    name = max((k for k, v in leaves.items() if v.numel() <= 1 << 17),
               key=lambda k: leaves[k].numel())
    g = torch.Generator(device=dev)
    g.manual_seed(seed + 211)
    rows = ELASTIC_BATCH // 2
    stack = torch.randn((rows, leaves[name].numel()), generator=g,
                        device=dev) * 1e-3
    zeros = torch.zeros(rows, dtype=torch.int32, device=dev)
    pol = get_policy("exact2")
    dom_i = pol.prepare(stack, rows)[0].to(torch.int32)
    entry = k1_entry(f"elastic {name}", stack, zeros, 1, "exact2", smi,
                     library=lambda: torch.zeros(
                         (1, dom_i.shape[1]), dtype=torch.int32,
                         device=dev).index_add_(0, zeros.long(), dom_i))
    del stack, dom_i
    emb = leaves["embed"].numel()
    big = torch.randn((rows, emb), generator=g, device=dev) * 1e-3
    dom, _ = pol.prepare(big, rows)
    ms = cuda_ms(lambda: K.segsum_policy_cuda(dom, zeros, 1, policy=pol,
                                              block_rows=512), 3)
    nbytes = dom.numel() * 4
    print(f"time train-elastic K1 exact2 at the embedding's shape ({rows} x "
          f"{emb}, domain {nbytes / 1e9:.2f} GB): {ms:.3f} ms, bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms | {smi}", flush=True)
    del big, dom
    torch.cuda.empty_cache()
    launches = sum(sum(o["train"]["launches"]) for o in runs[2])
    print(f"train-elastic: the phase {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return [dict(entry, launches=launches)]


def vlm_positions(n_before, n_after, grid, dev):
    """(S, 3) int32 M-RoPE positions of one prompt: ``n_before`` text
    tokens (the three streams equal), a ``grid`` x ``grid`` patch grid at
    t = n_before holding (t, t + row, t + col), then ``n_after`` text
    tokens resuming at the largest position so far + 1."""
    import torch
    text = torch.arange(n_before, dtype=torch.int32, device=dev)
    t = n_before
    cell = torch.arange(grid * grid, dtype=torch.int32, device=dev)
    patches = torch.stack([torch.full_like(cell, t), t + cell // grid,
                           t + cell % grid], dim=1)
    after = torch.arange(t + grid, t + grid + n_after, dtype=torch.int32,
                         device=dev)
    return torch.cat([text[:, None].expand(-1, 3), patches,
                      after[:, None].expand(-1, 3)])


def fsm_bitwise(kern, plain) -> bool:
    """The JugglePAC kernel's four outputs bitwise its plain version's
    (``res_v`` as int32 bits: NaN included)."""
    import torch
    return (torch.equal(kern[0].view(torch.int32), plain[0].view(torch.int32))
            and all(torch.equal(a, b) for a, b in zip(kern[1:], plain[1:])))


def circuit_check_streams(seed, t):
    """Check 1's three circuits of ``t`` cycles (numpy): row 0 Table I's
    sets, 20 back-to-back sets of 5, then random sets; rows 1-2 random
    sets; every row with idle gaps inside and between sets, starts on
    invalid cycles, -0.0, +-Inf and NaN after its first 130 cycles."""
    import numpy as np
    rng = np.random.RandomState(seed)
    v = np.zeros((3, t), np.float32)
    st = np.zeros((3, t), bool)
    va = np.zeros((3, t), bool)
    for r in range(3):
        sets = ([[1, 2, 3, 4, 5], [10, 20, 30, 40],
                 [100, 200, 300, 400, 500, 600, 700, 800, 900]]
                + [list(rng.randint(1, 9, 5)) for _ in range(20)]
                if r == 0 else [])
        p = 0
        for s in sets:
            v[r, p:p + len(s)] = s
            st[r, p] = True
            va[r, p:p + len(s)] = True
            p += len(s)
        p += 4
        while p < t - 600:      # 8L + 32 idle cycles drain L = 64
            n = rng.randint(1, 90)
            v[r, p:p + n] = rng.randint(-40, 40, n)
            st[r, p] = True
            va[r, p:p + n] = True
            p += n + rng.randint(0, 6)
        k = rng.rand(t)
        k[:130] = 1.0
        va[r] &= ~((k < 0.03) & ~st[r])                   # gaps in a set
        st[r] |= ~va[r] & (rng.rand(t) < 0.05)            # starts ignored
        v[r, (k >= 0.03) & (k < 0.08)] = -0.0
        v[r, (k >= 0.08) & (k < 0.09)] = np.inf
        v[r, (k >= 0.09) & (k < 0.10)] = -np.inf
        v[r, (k >= 0.10) & (k < 0.11)] = np.nan
    return v, st, va


def table2_streams(lat):
    """Every candidate circuit of ``jugglepac_min_set_size`` at adder
    latency ``lat``: (values, starts, valids) as (597, T) numpy arrays and
    per row (n, t, n_in, guard, sums), T the longest input + its guard."""
    import numpy as np
    metas, rows = [], []
    for n in range(2, 201):
        for t in range(3):
            sizes = [n + ((7 * i + t) % 3) for i in range(12)]
            sets = [np.arange(sz, dtype=np.float64) + i * 1000
                    for i, sz in enumerate(sizes)]
            rows.append(sets)
            metas.append((n, t, sum(sizes),
                          4 * lat + 16 + max(sizes) + 10000,
                          [float(s.sum()) for s in sets]))
    tt = max(m[2] + m[3] for m in metas)
    v = np.zeros((len(rows), tt), np.float32)
    st = np.zeros((len(rows), tt), bool)
    va = np.zeros((len(rows), tt), bool)
    for r, sets in enumerate(rows):
        p = 0
        for s in sets:
            v[r, p:p + len(s)] = s
            st[r, p] = True
            va[r, p:p + len(s)] = True
            p += len(s)
    return v, st, va, metas


def table2_verdicts(outs, metas):
    """Each candidate's verdict as the Python ``ok`` computes it: its run
    stops after the inputs if 12 results are out by then, else at the
    12th result (or after the guard); the results by then must be
    exactly 12, sets 0..11 in order, each within 1e-6 of its sum, and no
    cycle up to there may overflow."""
    import numpy as np
    res_v, res_set, res_en, ovf = (o.cpu().numpy() for o in outs)
    verdicts = {}
    for row, (n, t, n_in, guard, sums) in enumerate(metas):
        cyc = np.flatnonzero(res_en[row])
        if (cyc < n_in).sum() >= 12:
            got, stop = cyc[cyc < n_in], n_in - 1
        elif cyc.size >= 12 and cyc[11] < n_in + guard:
            got, stop = cyc[:12], cyc[11]
        else:
            got, stop = cyc[:0], n_in + guard - 1
        ok = got.size == 12 and not ovf[row, :stop + 1].any()
        for i, c in enumerate(got if ok else ()):
            ok = ok and res_set[row, c] == i and abs(
                float(res_v[row, c]) - sums[i]) <= 1e-6 * abs(sums[i])
        verdicts[(n, t)] = bool(ok)
    return verdicts


def min_from_verdicts(verdicts, probe_max=200):
    """``jugglepac_min_set_size``'s binary search over the card's
    verdicts; and the n above the minimum (up to probe_max) that fail."""
    def ok(n):
        return all(verdicts[(n, t)] for t in range(3))
    lo, hi = 2, probe_max
    if not ok(hi):
        return probe_max + 1, []
    while lo < hi:
        mid = (lo + hi) // 2
        if ok(mid):
            hi = mid
        else:
            lo = mid + 1
    return lo, [n for n in range(lo + 1, probe_max + 1) if not ok(n)]


def circuit_real_streams(seed, b, t, lat, dev):
    """Check 3's (b, t) streams on the card: back-to-back sets with
    lengths uniform in ``CIRCUIT_SETS``, a set starting while 8L + 32 +
    512 cycles remain, idle after; values integers in [1, 49] as float32.
    Also each set's start and length (b, S) int64, how many sets each
    circuit holds, and the sets' int64 sums (b, S)."""
    import torch
    lo, hi = CIRCUIT_SETS
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    cap = t // lo + 1
    lengths = torch.randint(lo, hi + 1, (b, cap), generator=g, device=dev)
    first = torch.cumsum(lengths, 1) - lengths
    keep = first <= t - (8 * lat + 32 + hi)
    nsets = keep.sum(1)
    lengths = torch.where(keep, lengths, torch.zeros_like(lengths))
    end = (first + lengths).gather(1, (nsets - 1)[:, None])[:, 0]
    pos = torch.arange(t, device=dev)
    valids = pos[None, :] < end[:, None]
    starts = torch.zeros((b, t), dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)[:, None].expand(b, cap)
    starts[rows[keep], first[keep]] = True
    values = torch.empty((b, t), dtype=torch.float32, device=dev)
    sums = torch.zeros((b, cap), dtype=torch.int64, device=dev)
    step = 4096
    for r0 in range(0, b, step):
        r1 = min(b, r0 + step)
        x = torch.randint(1, 50, (r1 - r0, t), generator=g, device=dev,
                          dtype=torch.int32)
        x = torch.where(valids[r0:r1], x, torch.zeros_like(x))
        values[r0:r1] = x.to(torch.float32)
        c = torch.cumsum(x, 1, dtype=torch.int64)
        c = torch.cat([torch.zeros_like(c[:, :1]), c], 1)
        f, n = first[r0:r1].clamp(max=t), lengths[r0:r1]
        sums[r0:r1] = torch.where(keep[r0:r1], c.gather(1, (f + n).clamp(
            max=t)) - c.gather(1, f), torch.zeros_like(f))
    return values, starts, valids, first, lengths, nsets, sums


def circuit_flags(outs, first, lengths, nsets, sums):
    """Check (c) on the card, a chunk of circuits at a time: each
    circuit's results all present (as many as its sets), in order, equal
    to its sets' int64 sums, no cycle overflowing; and the worst latency
    constant (result cycle - first input cycle - set length) over the
    results that are in order."""
    import torch
    res_v, res_set, res_en, ovf = outs
    b, t = res_en.shape
    good = torch.empty(b, dtype=torch.bool, device=res_en.device)
    worst = -(1 << 30)
    pos = torch.arange(t, device=res_en.device)
    for r0 in range(0, b, 4096):
        r1 = min(b, r0 + 4096)
        en = res_en[r0:r1]
        k = torch.cumsum(en, 1, dtype=torch.int32) - 1
        kk = k.clamp(0, sums.shape[1] - 1).long()
        want = sums[r0:r1].gather(1, kk)
        right = (res_set[r0:r1] == k) & (
            res_v[r0:r1].double() == want.double())
        good[r0:r1] = ((right | ~en).all(1)
                       & (en.sum(1) == nsets[r0:r1])
                       & ~ovf[r0:r1].any(1))
        const = pos[None, :] - first[r0:r1].gather(1, kk) \
            - lengths[r0:r1].gather(1, kk)
        const = torch.where(en & right, const, torch.full_like(const,
                                                              -(1 << 30)))
        worst = max(worst, int(const.max()))
        del en, k, kk, want, right, const
    return good, worst


def oracle_run(vals, first, lengths, nsets, lat, regs):
    """One circuit of check 3 (its values (T,), each set's first cycle and
    length, and how many sets it holds) through the Python
    ``JugglePAC.run`` -> ([(set, value, cycle)], whether a push
    overflowed, the cycles it ran, its host seconds)."""
    from repro_torch.core import circuit
    f, n, vals = first.tolist(), lengths.tolist(), vals.tolist()
    sets = [vals[f[i]:f[i] + n[i]] for i in range(int(nsets))]
    pac = circuit.JugglePAC(lat, regs)
    t0 = time.perf_counter()
    res = [(x.set_index, x.value, x.cycle) for x in pac.run(sets)]
    return (res, pac.fifo_overflows > 0, pac.cycle,
            time.perf_counter() - t0)


def circuit_phase(seed, dev, smi):
    """Phase 22; returns the JugglePAC kernel's entry."""
    import numpy as np
    import torch
    from repro_torch.core import circuit, circuit_scan
    from repro_torch.kernels import _build
    from repro_torch.kernels import jugglepac_fsm as fsm
    t0 = time.perf_counter()

    # check 1: the kernel bitwise its plain version, B = 3 and B = 1
    v, st, va = (torch.tensor(x, device=dev)
                 for x in circuit_check_streams(seed + 22, CIRCUIT_CHECK_T))
    for lat, regs in CIRCUIT_SHAPES:
        kern = fsm.jugglepac_fsm_cuda(v, st, va, latency=lat,
                                      num_registers=regs)
        one = fsm.jugglepac_fsm_cuda(v[:1].contiguous(), st[:1].contiguous(),
                                     va[:1].contiguous(), latency=lat,
                                     num_registers=regs)
        plain = fsm.jugglepac_fsm_torch(v, st, va, latency=lat,
                                        num_registers=regs)
        torch.cuda.synchronize()
        ok = fsm_bitwise(kern, plain) and fsm_bitwise(
            one, tuple(p[:1] for p in plain))
        print(f"circuit check L={lat} R={regs} B=3 and B=1 x T="
              f"{CIRCUIT_CHECK_T}: results {int(kern[2].sum())}, overflow "
              f"cycles {int(kern[3].sum())} (row 0: {int(kern[3][0].sum())}"
              f"), NaN results {int((kern[2] & kern[0].isnan()).sum())}; "
              f"kernel vs plain {'bitwise' if ok else 'DIFFER'}",
              flush=True)
        check(ok, f"JugglePAC kernel differs from its plain version at "
                  f"L={lat} R={regs}")
        if (lat, regs) == (14, 2):
            check(bool(kern[3][0].any()), "20 sets of 5 at R=2 did not "
                                          "overflow the FIFO")
    print(f"circuit check 1: {time.perf_counter() - t0:.1f} s", flush=True)

    # check 2: Table II on the card, then the sweep over L
    t1 = time.perf_counter()
    mins = {}
    for lat in sorted(set(CIRCUIT_SWEEP_L) | {14}):
        v, st, va, metas = table2_streams(lat)
        v, st, va = (torch.tensor(x, device=dev) for x in (v, st, va))
        for regs in CIRCUIT_REGS:
            outs = fsm.jugglepac_fsm_cuda(v, st, va, latency=lat,
                                          num_registers=regs)
            verdicts = table2_verdicts(outs, metas)
            card, unclean = min_from_verdicts(verdicts)
            host = circuit.jugglepac_min_set_size(lat, regs)
            mins[(lat, regs)] = card
            held = ""
            if (lat, regs) in CIRCUIT_SWEEP_PLAIN:
                p = CIRCUIT_PREFIX
                plain = fsm.jugglepac_fsm_torch(
                    v[:, :p], st[:, :p], va[:, :p], latency=lat,
                    num_registers=regs)
                ok = fsm_bitwise(tuple(o[:, :p].contiguous() for o in outs),
                                 plain)
                held = (f"; first {p} cycles vs plain "
                        f"{'bitwise' if ok else 'DIFFER'}")
                check(ok, f"Table II launch L={lat} R={regs} differs from "
                          "the plain version")
            if lat == 14:
                print(f"table2 L=14 R={regs}: min set size on the card "
                      f"{card}, Python search {host}, paper "
                      f"{CIRCUIT_PAPER_MIN.get(regs, 'n/a')}; failing n "
                      f"above the minimum: {len(unclean)} {unclean[:8]}; "
                      f"B={v.shape[0]} T={v.shape[1]}{held}", flush=True)
            elif held:
                print(f"table2 L={lat} R={regs}: B={v.shape[0]} "
                      f"T={v.shape[1]}{held}", flush=True)
            check(card == host, f"Table II at L={lat} R={regs}: the card's "
                                f"{card} against Python's {host}")
            del outs
        del v, st, va
    print("table2 sweep, min set size (card = Python search): "
          + "; ".join(f"L={lat}: " + " ".join(
              f"R{r}={mins[(lat, r)]}" for r in CIRCUIT_REGS)
              for lat in CIRCUIT_SWEEP_L), flush=True)
    print(f"circuit check 2: {time.perf_counter() - t1:.1f} s", flush=True)

    # check 3: the real-size run through the entry point
    t2 = time.perf_counter()
    b, t, lat, regs = CIRCUIT_B, CIRCUIT_T, CIRCUIT_L, CIRCUIT_R
    values, starts, valids, first, lengths, nsets, sums = \
        circuit_real_streams(seed + 23, b, t, lat, dev)
    torch.cuda.synchronize()
    print(f"circuit run: B={b} T={t} L={lat} R={regs}, sets "
          f"{int(nsets.sum())} ({int(nsets.min())}-{int(nsets.max())} a "
          f"circuit), data {time.perf_counter() - t2:.1f} s", flush=True)
    reset_launches()
    outs = circuit_scan.jugglepac_scan(values, starts, valids, latency=lat,
                                       num_registers=regs)
    torch.cuda.synchronize()
    launches = fsm.LAUNCHES
    others = read_launches()
    check(launches == 1 and not any(others.values()),
          f"jugglepac_scan: expected one kernel launch and no other, got "
          f"{launches} and {others}")
    # (a) a prefix of the run is the run of the prefix
    p = CIRCUIT_PREFIX
    pre = tuple(x[:p, :p].contiguous() for x in (values, starts, valids))
    plain_ms, plain = host_ms(lambda: fsm.jugglepac_fsm_torch(
        *pre, latency=lat, num_registers=regs))
    ok_a = fsm_bitwise(tuple(o[:p, :p].contiguous() for o in outs), plain)
    print(f"circuit (a): first {p} cycles of {p} circuits vs plain "
          f"{'bitwise' if ok_a else 'DIFFER'}", flush=True)
    check(ok_a, "the real-size run differs from the plain version")
    del plain, pre
    # (b) whole circuits against the Python JugglePAC.run
    host_s, host_cycles = 0.0, 0
    ok_b = True
    cpu = [x[:CIRCUIT_ORACLE].cpu() for x in
           (values, first, lengths, nsets) + tuple(outs)]
    for r in range(CIRCUIT_ORACLE):
        vals, f, n, ns, rv, rs, re, of = (x[r] for x in cpu)
        py, py_ovf, cycles, secs = oracle_run(vals, f, n, ns, lat, regs)
        host_s += secs
        host_cycles += cycles
        cyc = torch.nonzero(re)[:, 0].tolist()
        card = [(int(rs[c]), float(rv[c]), c) for c in cyc]
        ok_b = ok_b and card == py and bool(of.any()) == py_ovf
    oracle_us = host_s / host_cycles * 1e6
    print(f"circuit (b): {CIRCUIT_ORACLE} circuits whole vs Python "
          f"JugglePAC.run {'identical' if ok_b else 'DIFFER'} "
          f"({host_cycles} cycles, {oracle_us:.3f} us a cycle on the host)",
          flush=True)
    check(ok_b, "the card's circuits differ from the Python oracle")
    del cpu
    # (c) every circuit: results present, in order, exact, no overflow
    good, worst = circuit_flags(outs, first, lengths, nsets, sums)
    share = float(good.float().mean())
    flagged = torch.nonzero(~good)[:, 0].tolist()
    agree = True
    for r in flagged[:CIRCUIT_ORACLE]:
        py, py_ovf, _, _ = oracle_run(
            *(x[r].cpu() for x in (values, first, lengths, nsets)), lat,
            regs)
        want = [(i, float(x)) for i, x in
                enumerate(sums[r, :int(nsets[r])].tolist())]
        agree = agree and (py_ovf or [x[:2] for x in py] != want)
    print(f"circuit (c): {share:.6f} of {b} circuits all present, in order, "
          f"exact and free of overflow ({len(flagged)} flagged; the oracle "
          f"{'agrees' if agree else 'DISAGREES'} on "
          f"{min(len(flagged), CIRCUIT_ORACLE)} re-run); worst latency "
          f"constant {worst} (Table II: DS + {CIRCUIT_PAPER_C[0]}.."
          f"{CIRCUIT_PAPER_C[1]})", flush=True)
    check(agree, "a flagged circuit passes in the Python oracle")
    # timings, and what the compiler and the occupancy calculator say
    kern_ms = cuda_ms(lambda: fsm.jugglepac_fsm_cuda(
        values, starts, valids, latency=lat, num_registers=regs), REPS)
    bytes_ = 16 * b * t
    bound_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    blocks = fsm.blocks_per_sm(lat, regs)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    waves = -(-(-(-b // fsm.THREADS)) // (blocks * sms))
    ptx = [k for k in _build.ptxas_kernels(
        _build.BUILD_LOG.get("jugglepac_fsm", {}).get("report", ""))
        if "jugglepac_fsm_kernel" in k["name"]]
    print(f"time circuit: kernel {kern_ms:.3f} ms for {b} x {t} "
          f"circuit-cycles ({b * t / kern_ms * 1e3:.4g} cycles/s) | bound "
          f"{bound_ms:.3f} ms ({bytes_ / 1e9:.3f} GB) | plain "
          f"{plain_ms:.1f} ms on {p} x {p} | Python oracle "
          f"{oracle_us:.3f} us a cycle | library n/a | {blocks} blocks of "
          f"{fsm.THREADS} circuits an SM at L={lat} R={regs} "
          f"({fsm.smem_bytes(lat, regs)} B shared a block), {waves} "
          f"wave(s) of {b} circuits on {sms} SMs | ptxas: "
          + ("; ".join(f"{k['registers']} registers, {k.get('stack')} B "
                       f"stack, spills {k.get('spill_stores')}/"
                       f"{k.get('spill_loads')} B" for k in ptx)
             or "no report (a cached build)") + f" | {smi}", flush=True)
    print(f"circuit check 3: {time.perf_counter() - t2:.1f} s; phase 22 "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del values, starts, valids, outs, first, lengths, sums
    torch.cuda.empty_cache()
    return {"name": "jugglepac_fsm_kernel", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/jugglepac_fsm.cu",
            "replaces": "src/repro/core/circuit_jax.py:67",
            "launches": launches, "max_abs_err": 0.0, "ms": kern_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": None, "cycles": b * t, "plain_cycles": p * p}


def bits_equal(a, b) -> bool:
    """Bitwise equality of two tensors, the sign of zero and NaN payloads
    included (``torch.equal`` takes -0 for +0)."""
    import torch
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}
        a, b = (t.contiguous().view(view[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def knobs_autograd_phase(seed, dev, smi):
    """Phase 23: the reduce knobs under autograd, K1 in the forward and a
    gather by label in the backward; the dry-run against phase 10's
    allocations.  Returns K1's entries on the knob's train path."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataCfg, SyntheticLM
    from repro_torch.kernels import jugglepac_segsum as K
    from repro_torch.launch import dryrun, specs
    from repro_torch.models import layers as LY
    from repro_torch.models import model as M
    from repro_torch.models.config import ShapeCfg
    from repro_torch.optim import adamw
    from repro_torch.reduce import get_policy, plan_program
    from repro_torch.train import init_state, make_grad_fn, make_train_step

    t_phase = time.perf_counter()
    cfg = get_config(KNOB_ARCH)
    d, dt = cfg.d_model, getattr(torch, cfg.dtype)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 231)
    shape = (KNOB_BATCH, KNOB_SEQ, d)
    x0 = torch.randn(shape, generator=gen, device=dev).to(dt)
    g0 = (1 + 0.1 * torch.randn(d, generator=gen, device=dev)).to(dt)
    cot = torch.randn(shape, generator=gen, device=dev).to(dt)

    # 1. one rmsnorm per tier, on K1 and on its plain version: output,
    # dL/dx and dL/dg bitwise; K1 once in the forward, never backward
    for tier in TIERS:
        res = {}
        for backend in ("cuda", "blocked"):
            g = g0.clone().requires_grad_(True)
            x = x0.clone().requires_grad_(True)
            K.LAUNCHES = 0
            y = LY.rmsnorm(g, x, cfg.norm_eps, policy=tier, backend=backend)
            fwd = K.LAUNCHES
            dx, dg = torch.autograd.grad(y, (x, g), cot)
            torch.cuda.synchronize()
            res[backend] = (y.detach(), dx, dg, fwd, K.LAUNCHES - fwd)
        same_bits = [bits_equal(a, b) for a, b in zip(res["cuda"][:3],
                                                      res["blocked"][:3])]
        print(f"knobs rmsnorm {tier:13s} ({KNOB_BATCH} x {KNOB_SEQ} tokens "
              f"x {d}, {cfg.dtype}): cuda vs blocked output / dL/dx / "
              f"dL/dg {['bitwise' if s else 'DIFFER' for s in same_bits]}; "
              f"K1 launches forward {res['cuda'][3]}, backward "
              f"{res['cuda'][4]} (blocked: {res['blocked'][3]})", flush=True)
        check(all(same_bits) and res["cuda"][3:] == (1, 0)
              and res["blocked"][3:] == (0, 0),
              f"knobs: rmsnorm({tier}) on K1 differs from blocked under "
              f"autograd, or K1 ran {res['cuda'][3:]} times")
    del x0, g0, cot, res, x, g, y, dx, dg

    # 2. a train step with cfg.norm_reduce_policy set, KNOB_LAYERS layers
    data = SyntheticLM(DataCfg(vocab=cfg.vocab, seq_len=KNOB_SEQ,
                               global_batch=KNOB_BATCH, seed=seed))
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in data.batch(0).items()}
    lr_fn = adamw.cosine_schedule(TRAIN_LR, 1, TRAIN_STEPS)
    entries = []
    for tier in KNOB_TIERS:
        kcfg = cfg.scaled(n_layers=KNOB_LAYERS, norm_reduce_policy=tier)
        gen.manual_seed(seed + 232)
        model = M.init_params(kcfg, generator=gen, device=dev)
        model.requires_grad_(True)
        grad_fn = make_grad_fn(kcfg)
        runs = []
        for _ in range(2):
            K.LAUNCHES = 0
            grads, (loss, _) = grad_fn(model, batch)
            torch.cuda.synchronize()
            runs.append((grads, float(loss), K.LAUNCHES))
        rep = [k for k in runs[0][0]
               if not bits_equal(runs[0][0][k], runs[1][0][k])]
        step = make_train_step(kcfg, lr_fn=lr_fn, device=dev)
        state = init_state(model)
        # the main path: counts set to 0 just before the step, read after
        K.LAUNCHES = 0
        _, state, met = step(model, state, batch)
        torch.cuda.synchronize()
        launches = K.LAUNCHES
        step_loss = float(met["loss"])
        step_ms = cuda_ms(lambda: step(model, state, batch), 3)
        print(f"main knobs train ({kcfg.name} at {KNOB_LAYERS} layers, "
              f"norm_reduce_policy={tier}, {KNOB_BATCH} x {KNOB_SEQ}): "
              f"loss {runs[0][1]:.6f}, {len(runs[0][0])} gradient leaves, "
              f"{len(rep)} differ across two runs {rep}; K1 launches a "
              f"forward and backward {runs[0][2]}, a step {launches} (want "
              f"{KNOB_K1_PER_STEP}); step loss {step_loss:.6f}", flush=True)
        check(math.isfinite(runs[0][1]) and runs[0][1] == runs[1][1]
              and not rep and math.isfinite(step_loss)
              and runs[0][2] == runs[1][2] == launches == KNOB_K1_PER_STEP,
              f"knobs: the {tier} step is not finite, repeatable or on K1 "
              f"{KNOB_K1_PER_STEP} times a step")
        # K1 at the knob's launch: the (d, B*S) sumsq stream, one label
        pol = get_policy(tier)
        cols = torch.randn(d, KNOB_BATCH * KNOB_SEQ, generator=gen,
                           device=dev)
        n = cols.shape[0]
        dom, _ = pol.prepare(cols * cols, n)
        ids = torch.zeros(n, dtype=torch.int32, device=dev)
        w = dom.shape[1]
        prog = plan_program(pol, num_segments=1, domain_width=w,
                            block_size=512, op="sumsq")
        call = lambda: K.segsum_policy_cuda(  # noqa: E731
            dom, ids, 1, policy=pol, program=prog, block_rows=512)
        k1_ms = cuda_ms(call, REPS)
        kern = call()
        pad = (-n) % 512
        plain_ms, plain = host_ms(lambda: K.segsum_policy_torch(
            torch.cat([dom, dom.new_zeros((pad, w))]),
            torch.cat([ids, ids.new_full((pad,), -1)]), 1, policy=pol,
            program=prog, block_rows=512))
        ok, err = same(kern, plain)
        ldom = dom if not pol.integer else dom.to(torch.int32)
        lib_ms = cuda_ms(lambda: torch.sum(ldom, 0), REPS)
        bytes_ = n * 4 + n * w * 4 + sum(c.numel() * 4 for c in kern)
        ops = n * w
        bound_ms = max(bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S) * 1e3
        print(f"time knobs {tier}: K1 forward {k1_ms:.4f} ms a launch "
              f"(({n}, {w}) domain, one label) x {launches} a step = "
              f"{k1_ms * launches:.3f} ms of a {step_ms:.1f} ms step; "
              f"bound {bound_ms:.4f} ms, plain {plain_ms:.2f} ms, "
              f"torch.sum(0) {lib_ms:.4f} ms; kernel vs plain "
              f"{'bitwise' if ok else 'DIFFER'} | {smi}", flush=True)
        check(ok, f"knobs: K1 differs from its plain version at the "
                  f"{tier} knob's shape")
        entries.append({
            "name": f"segsum_policy_kernel<{tier}> rmsnorm knob",
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/segsum.cu",
            "replaces": "src/repro/kernels/jugglepac_segsum.py:77",
            "launches": launches, "max_abs_err": err,
            "ms": k1_ms * launches, "plain_ms": plain_ms * launches,
            "bound_ms": bound_ms * launches,
            "bound_by": ("bytes" if bytes_ / HBM_BYTES_PER_S
                         >= ops / FP32_OPS_PER_S else "operations"),
            "library_ms": lib_ms * launches})
        del model, state, runs, grads, step, grad_fn, dom, kern, plain, ldom
        torch.cuda.empty_cache()

    # 3. the dry-run's bytes against what phase 10 allocated
    scfg = get_config(SERVE_ARCH)
    want_p = specs.nbytes(specs.abstract_params(scfg))
    want_c = specs.nbytes(specs.abstract_caches(scfg, SERVE_SLOTS,
                                                SERVE_LEN))
    rec = dryrun.measure_step(scfg, ShapeCfg("serve", SERVE_LEN,
                                             SERVE_SLOTS, "decode"))
    inputs = SERVE_SLOTS * 4 + 4                 # token (B, 1), position
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"knobs dry-run: {SERVE_ARCH} parameters {want_p} B predicted, "
          f"{PHASE10_BYTES['params']} B allocated; caches ({SERVE_SLOTS} x "
          f"{SERVE_LEN}) {want_c} B predicted, {PHASE10_BYTES['caches']} B "
          f"allocated; the decode cell's arguments "
          f"{rec['argument_size_in_bytes']} B; total_memory {total} B "
          f"(dryrun.H100_MEMORY_BYTES {dryrun.H100_MEMORY_BYTES}, "
          f"{dryrun.H100_CARD})", flush=True)
    check(want_p == PHASE10_BYTES["params"]
          and want_c == PHASE10_BYTES["caches"]
          and rec["argument_size_in_bytes"] == want_p + want_c + inputs,
          "knobs: the dry-run's bytes differ from phase 10's allocations")
    print(f"knobs: phase 23 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return entries


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
        # one index_add_ gives the same totals: the segment sums of the
        # values (fast's and compensated's domain is the values
        # themselves), the integer tiers' int32 column sums of their domain
        safe = torch.where(mids >= 0, mids, torch.full_like(mids, s)) \
            .to(torch.int64)
        ldom = dom if tier in ("fast", "compensated") \
            else dom.to(torch.int32)
        lib_ms = cuda_ms(lambda: torch.zeros(
            (s + 1, w), dtype=ldom.dtype, device=dev).index_add_(
                0, safe, ldom), REPS)
        del ldom
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
    kernels += serve_moe_phase(args.seed, dev, smi)
    print(f"elapsed after phase 14: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += serve_mla_phase(args.seed, dev, smi)
    print(f"elapsed after phase 15: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += serve_hybrid_phase(args.seed, dev, smi)
    print(f"elapsed after phase 16: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += serve_xlstm_phase(args.seed, dev, smi)
    print(f"elapsed after phase 17: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += train_moe_phase(args.seed, dev, smi)
    print(f"elapsed after phase 18: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += serve_vlm_phase(args.seed, dev, smi)
    print(f"elapsed after phase 19: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += serve_encdec_phase(args.seed, dev, smi)
    print(f"elapsed after phase 20: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += train_elastic_phase(args.seed, dev, smi)
    print(f"elapsed after phase 21: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels.append(circuit_phase(args.seed, dev, smi))
    print(f"elapsed after phase 22: {time.perf_counter() - t_start:.1f} s",
          flush=True)
    kernels += knobs_autograd_phase(args.seed, dev, smi)
    print(f"elapsed after phase 23: {time.perf_counter() - t_start:.1f} s",
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
