"""Continuous-batching serving engine: paged KV admission, chunked
prefill, lock-step decode over fixed slots, in-order results.

The PyTorch counterpart of the reference's ``repro.serve.engine``, with
the same contract.  Requests are JugglePAC's variable-length sets, the
``max_batch`` decode slots its pipeline stages, the ``Scheduler``'s
reorder buffer its in-order output, and the ``PagedKVPool`` its bounded
intermediate storage (admission only: the KV itself lives in one dense
slot cache, ``models.init_caches``).

Prefill streams in ``prefill_chunk``-token pieces at batch 1, every chunk
padded to the same width, interleaved with decode steps; a sliding-window
model (ring caches) and a model with recurrent blocks (Mamba, mLSTM or
sLSTM states, whose scans take the prompt whole) prefill each prompt
whole at batch 1 instead, as the reference does, and splice each cache's
fields (a ring, a KV cache padded to ``max_len``, a ``MambaState``'s h
and conv, an ``MLSTMState``'s c, n, m and conv, an ``SLSTMState``'s c,
n, h and m) into the slot.  Every model call runs the MoE layers' ``dense`` dispatch, as
the reference's engine does.
Every decode step runs all ``max_batch`` rows with idle and mid-prefill
slots masked (``active``: their caches and lengths stay as they were).
Fixed shapes and row-parallel math make a request's logits bitwise
independent of its batchmates, so greedy tokens are the same alone or
batched.  On a CUDA device each decode step's attention is K2
(``kernels.flash_decode``) in every GQA layer (an MLA model decodes
absorbed in its latent space, in float32 einsums; a Mamba, mLSTM or
sLSTM layer takes one recurrent step of its state), and ``mean_logprob`` is one segmented
mean through ``repro_torch.reduce``: K1 on the ``cuda`` backend.

Sampling differs from the reference in how, not in what it promises.  The
reference derives each sample's key with ``jax.random.fold_in``, which
PyTorch cannot reproduce.  Here each sampled token draws from its own
``torch.Generator`` seeded from (engine seed, request id or
``Request.seed``, step), by the Gumbel-max rule on ``logits /
temperature``.  So samples are reproducible and independent of the batch,
but not the reference's samples; greedy decoding is the oracle shared by
both packages.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from .. import reduce as _reduce
from .. import resolve_device
from ..models.config import ModelConfig
from ..models.model import (LM, decode_step, forward, init_caches,
                            pad_caches_to)
from .kv_pool import PagedKVPool
from .scheduler import Scheduler, TrackedRequest


@dataclasses.dataclass
class Request:
    prompt: Sequence[int]
    max_new_tokens: int = 32
    temperature: float = 0.0
    eos_id: Optional[int] = None
    #: optional per-request sampling seed: when set, sampled tokens depend
    #: only on (engine seed, this seed, step) — stable even if the request
    #: is resubmitted under a different request id
    seed: Optional[int] = None


@dataclasses.dataclass
class Result:
    tokens: List[int]
    prompt_len: int
    mean_logprob: Optional[float] = None
    rid: int = -1
    finish_reason: Optional[str] = None
    latency_s: float = 0.0


def sample_seed(seed: int, custom: int, idv: int, step: int) -> int:
    """The 63-bit seed of one sampled token's generator, mixed from
    (engine seed, custom-seed flag, request id or seed, step)."""
    words = [int(x) % (1 << 64) for x in (seed, custom, idv, step)]
    hi, lo = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return ((int(hi) << 32) | int(lo)) & ((1 << 63) - 1)


class Engine:
    """Continuous-batching engine over ``Scheduler`` + ``PagedKVPool``.

    ``max_batch`` decode slots share one pre-allocated float32 cache of
    ``max_len`` context each (a ring of ``cfg.window`` slots for a
    sliding-window model; a fixed-size state at each recurrent layer);
    ``num_pages`` x ``page_size`` tokens of KV pool gate admission
    (default: exactly enough for every slot at full context, so admission
    is slot-bound; shrink it to exercise queueing).
    ``model`` is an ``LM`` on ``device`` (None means CUDA).
    """

    def __init__(self, cfg: ModelConfig, model: LM, *, max_len: int = 512,
                 seed: int = 0, max_batch: int = 8, page_size: int = 16,
                 num_pages: Optional[int] = None, prefill_chunk: int = 32,
                 logprob_policy: str = "compensated", device=None):
        self.device = resolve_device(device)
        where = {p.device.type for p in model.parameters()}
        if where != {self.device.type}:
            raise ValueError(f"Engine on {self.device}: the model's "
                             f"parameters are on {sorted(where)}")
        self.cfg = cfg
        self.model = model
        self.max_len = max_len
        self.max_batch = max_batch
        self.prefill_chunk = max(1, int(prefill_chunk))
        self.logprob_policy = logprob_policy
        _reduce.get_policy(logprob_policy)        # fail fast on a typo
        self.seed = int(seed)
        pool_pages = num_pages if num_pages is not None else \
            max_batch * PagedKVPool(1, page_size).pages_for(max_len)
        self.pool = PagedKVPool(pool_pages, page_size)
        self.scheduler = Scheduler(max_batch, self.pool)
        self._caches = init_caches(cfg, max_batch, max_len,
                                   device=self.device)
        # chunked prefill streams through the attention extend path; ring
        # (sliding-window) caches must not see padded chunk writes and
        # recurrent states have no extend path (their decode takes one token a
        # row), so those models prefill whole-prompt, as the reference's
        self._extend_ok = (all(sp.kind == "attn" for sp in cfg.period)
                           and cfg.window is None)
        self._clock = 0
        self._rid_base = 0
        self._lp_vals: List[torch.Tensor] = []
        self._lp_ids: List[np.ndarray] = []

    # -- model calls -------------------------------------------------------

    def _decode(self, toks, pos, active):
        """One decode step of every slot; inactive slots keep their
        caches."""
        logits, self._caches = decode_step(self.model, toks, self._caches,
                                           pos, active=active,
                                           moe_impl="dense")
        return logits

    def _prefill_chunk(self, slot: int, toks, start: int,
                       n_valid: int):
        """One prompt chunk for one slot: extend the slot's cache view
        from ``start`` (pad tokens write past ``n_valid`` and are rolled
        back by setting the length), return the last valid position's
        logits (1, 1, V)."""
        sub = []
        for c in self._caches:
            view = type(c["core"])(*(t[:, slot:slot + 1] for t in c["core"]))
            sub.append({"core": view._replace(
                length=torch.full_like(view.length, start))})
        logits, _, _ = forward(self.model, tokens=toks, mode="decode",
                               caches=sub, position_offset=start,
                               moe_impl="dense")
        for c in self._caches:
            c["core"].length[:, slot] = start + n_valid
        return logits[:, n_valid - 1:n_valid]

    def _classic_prefill(self, slot: int, toks):
        """Whole-prompt prefill at batch 1, padded to ``max_len`` (a ring
        is its ``cfg.window`` slots already, a recurrent state O(1)) and
        spliced into the slot field by field."""
        logits, sub, _ = forward(self.model, tokens=toks, mode="prefill",
                                 moe_impl="dense")
        sub = pad_caches_to(self.cfg, sub, self.max_len)
        for full, one in zip(self._caches, sub):
            for t, u in zip(full["core"], one["core"]):
                t[:, slot] = u[:, 0]
        return logits[:, -1:]

    def _sample(self, logits, custom, idv, steps, temps):
        """(tokens, their log-probabilities) for each row of ``logits``
        (B, s, V): greedy where ``temps`` is 0, else one Gumbel-max draw
        from the row's own generator (``sample_seed``)."""
        lg = logits[:, -1, :self.cfg.vocab]
        tok = torch.argmax(lg, dim=-1)
        for r in np.flatnonzero(temps > 0):
            g = torch.Generator(device=lg.device)
            g.manual_seed(sample_seed(self.seed, custom[r], idv[r],
                                      steps[r]))
            u = torch.rand(lg.shape[1], generator=g, device=lg.device)
            gumbel = -torch.log(-torch.log(u))
            tok[r] = torch.argmax(lg[r] / max(float(temps[r]), 1e-6)
                                  + gumbel)
        logp = torch.log_softmax(lg, dim=-1)
        lp = torch.gather(logp, 1, tok[:, None])[:, 0]
        return tok.to(torch.int32), lp.to(torch.float32)

    # -- intake ------------------------------------------------------------

    def submit(self, request: Request, *, arrival: float = 0.0) -> int:
        """Enqueue one request; ``arrival`` is in engine steps relative to
        the start of the next :meth:`run`.  Returns the request id, which
        is also its delivery position."""
        plen = len(request.prompt)
        need = min(plen + max(request.max_new_tokens, 1), self.max_len)
        return self.scheduler.submit(request, arrival=arrival,
                                     need_tokens=need)

    def cancel(self, rid: int) -> bool:
        """Kill a request wherever it is (queued, prefilling, or
        mid-decode).  Its KV pages and slot are released immediately;
        other requests' outputs are untouched (per-slot isolation).  The
        reorder buffer still delivers a ``cancelled`` result in order."""
        tr = self.scheduler.tracked(rid)
        if tr.state == "done":
            return False
        if not tr.out:
            tr.out = list(tr.request.prompt)
        tr.finish_reason = "cancelled"
        self.scheduler.finish(tr, self._result_of(tr), reason="cancelled")
        return True

    # -- the continuous loop ----------------------------------------------

    @torch.no_grad()
    def run(self, *, on_step: Optional[Callable] = None) -> List[Result]:
        """Drain every submitted request; returns results in submission
        order.  ``on_step(engine, step)`` fires after each engine step
        (fault injection, probes)."""
        sched = self.scheduler
        self._clock = 0
        self._rid_base = sched._next_deliver
        self._lp_vals, self._lp_ids = [], []
        delivered: List[Result] = []
        while sched.has_work():
            sched.advance(self._clock)
            progressed = bool(sched.admit())
            progressed |= self._prefill_work()
            progressed |= self._decode_work()
            delivered.extend(sched.pop_ready())
            if on_step is not None:
                on_step(self, self._clock)
                delivered.extend(sched.pop_ready())
            if not progressed and sched.next_arrival() is None \
                    and not any(r is not None for r in sched.slots) \
                    and sched._queue:
                raise RuntimeError(
                    "admission deadlock: queued requests cannot be "
                    "admitted and no slot is active")
            self._clock += 1
        self._finalize_logprobs(delivered)
        return delivered

    def generate(self, requests: List[Request], *,
                 truncate_prompts: bool = False) -> List[Result]:
        """Generate for a batch of requests (all enqueued at time zero,
        then drained — the all-at-once wrapper over the continuous loop).

        An empty batch, an empty prompt, or a prompt that cannot fit the
        engine's ``max_len`` context (together with at least one new
        token) fails fast with a ``ValueError`` naming the offending
        request.  ``truncate_prompts=True`` instead keeps the *last*
        ``max_len - 1`` tokens of an over-long prompt; ``Result.prompt_len``
        then reports the truncated length.
        """
        if not requests:
            raise ValueError("generate() needs at least one request; "
                             "got an empty batch")
        limit = self.max_len - 1       # decode stops at max_len - 1
        for i, r in enumerate(requests):
            if len(r.prompt) == 0:
                raise ValueError(f"request {i} has an empty prompt")
            if len(r.prompt) > limit and not truncate_prompts:
                raise ValueError(
                    f"request {i} prompt has {len(r.prompt)} tokens but "
                    f"the engine context is max_len={self.max_len} "
                    f"(prompts are capped at {limit} so at least one "
                    f"token can be generated); shorten the prompt or "
                    f"pass truncate_prompts=True")
        if truncate_prompts:
            requests = [dataclasses.replace(r, prompt=list(r.prompt)[-limit:])
                        for r in requests]
        rids = [self.submit(r) for r in requests]
        by_rid = {res.rid: res for res in self.run()}
        return [by_rid[rid] for rid in rids]

    # -- phases ------------------------------------------------------------

    def _prefill_work(self) -> bool:
        """One prompt chunk per mid-prefill slot (chunked prefill: long
        prompts interleave with decode steps instead of stalling them)."""
        worked = False
        for tr in self.scheduler.in_state("prefill"):
            worked = True
            prompt = list(tr.request.prompt)
            if self._extend_ok:
                chunk = self.prefill_chunk
                start = tr.prefill_pos
                piece = prompt[start:start + chunk]
                n_valid = len(piece)
                toks = torch.zeros((1, chunk), dtype=torch.long)
                toks[0, :n_valid] = torch.tensor(piece, dtype=torch.long)
                logits = self._prefill_chunk(tr.slot, toks.to(self.device),
                                             start, n_valid)
                tr.prefill_pos = start + n_valid
                if tr.prefill_pos < len(prompt):
                    continue                      # more chunks to stream
            else:
                toks = torch.tensor([prompt], dtype=torch.long,
                                    device=self.device)
                logits = self._classic_prefill(tr.slot, toks)
                tr.prefill_pos = len(prompt)
            self._first_token(tr, logits)
        return worked

    def _first_token(self, tr: TrackedRequest, logits) -> None:
        """Prefill just completed: sample the request's first token from
        the last prompt position's logits."""
        req = tr.request
        custom, idv = self._key_id(tr)
        tok, lp = self._sample(logits, [custom], [idv], [0],
                               np.asarray([max(req.temperature, 0.0)]))
        t = int(tok[0])
        self._lp_vals.append(lp)
        self._lp_ids.append(np.asarray([tr.rid - self._rid_base], np.int32))
        tr.out = list(req.prompt) + [t]
        tr.last_token = t
        tr.new_tokens = 1
        tr.state = "decode"
        self._maybe_retire(tr, t)

    def _decode_work(self) -> bool:
        """One lock-step decode step across every decode-state slot; idle
        and mid-prefill slots ride along masked (fixed shapes, and
        per-row bitwise independence)."""
        dec = self.scheduler.in_state("decode")
        if not dec:
            return False
        b = self.max_batch
        toks = np.zeros((b, 1), np.int64)
        pos = np.zeros(b, np.int32)
        active = np.zeros(b, bool)
        custom = np.zeros(b, np.int64)
        idv = np.zeros(b, np.int64)
        steps = np.zeros(b, np.int64)
        temps = np.zeros(b, np.float32)
        for tr in dec:
            s = tr.slot
            active[s] = True
            toks[s, 0] = tr.last_token
            plen = len(tr.request.prompt)
            pos[s] = plen + tr.new_tokens - 1     # == the slot's cache len
            custom[s], idv[s] = self._key_id(tr)
            steps[s] = tr.new_tokens
            temps[s] = max(tr.request.temperature, 0.0)
        dev = self.device
        logits = self._decode(torch.from_numpy(toks).to(dev),
                              torch.from_numpy(pos).to(dev),
                              torch.from_numpy(active).to(dev))
        tok, lp = self._sample(logits, custom, idv, steps, temps)
        tok_np = tok.cpu().numpy()
        ids = np.full(b, _reduce.OUT_OF_RANGE_LABEL, np.int32)
        for tr in dec:
            ids[tr.slot] = tr.rid - self._rid_base
        self._lp_vals.append(lp)
        self._lp_ids.append(ids)
        for tr in dec:
            t = int(tok_np[tr.slot])
            tr.out.append(t)
            tr.last_token = t
            tr.new_tokens += 1
            self._maybe_retire(tr, t)
        return True

    def _maybe_retire(self, tr: TrackedRequest, last_tok: int) -> None:
        req = tr.request
        plen = len(req.prompt)
        reason = None
        if req.eos_id is not None and last_tok == req.eos_id:
            reason = "stop"
        elif tr.new_tokens >= req.max_new_tokens:
            reason = "length"
        elif plen + tr.new_tokens >= self.max_len:
            reason = "length"                     # context full
        if reason is not None:
            tr.finish_reason = reason
            self.scheduler.finish(tr, self._result_of(tr), reason=reason)

    # -- results -----------------------------------------------------------

    def _key_id(self, tr: TrackedRequest):
        """(custom-seed flag, id) feeding the per-token sampling seed."""
        if tr.request.seed is not None:
            return 1, int(tr.request.seed)
        return 0, tr.rid

    def _result_of(self, tr: TrackedRequest) -> Result:
        lat = max(time.perf_counter() - tr.arrive_wall, 0.0) \
            if tr.arrive_wall else 0.0
        return Result(tokens=list(tr.out) or list(tr.request.prompt),
                      prompt_len=len(tr.request.prompt),
                      rid=tr.rid, finish_reason=tr.finish_reason,
                      latency_s=lat)

    def _finalize_logprobs(self, results: List[Result]) -> None:
        """One segmented mean over the whole run's (step x slot) logprob
        stream — requests are the variable-length sets; steps where a slot
        was idle / another request carry the sentinel and vanish from both
        sum and count.  ``logprob_policy`` selects the accuracy tier; on a
        CUDA device the sum is K1."""
        if not self._lp_vals:
            return
        nseg = max(r.rid for r in results) - self._rid_base + 1 \
            if results else 0
        if nseg <= 0:
            return
        mean = _reduce.reduce(
            torch.cat(self._lp_vals),
            segment_ids=torch.from_numpy(np.concatenate(self._lp_ids)),
            num_segments=nseg, op="mean", policy=self.logprob_policy,
            device=self.device)
        mean_np = mean.cpu().numpy()
        for r in results:
            sampled = len(r.tokens) - r.prompt_len
            if sampled > 0:
                r.mean_logprob = float(mean_np[r.rid - self._rid_base])
        self._lp_vals, self._lp_ids = [], []
