"""Continuous-batching scheduler: arrival queue, decode slots, in-order
results.

This is JugglePAC's control plane, lifted to serving.  The paper's problem
is a stream of back-to-back variable-length *sets* whose results must come
out in input order with bounded intermediate state; here the sets are
requests, the pipeline stages are the engine's fixed decode *slots*, and
the in-order output guarantee is the *reorder buffer*: requests finish in
whatever order their lengths dictate, but results are released strictly in
submission order.

Lifecycle of one request::

    submit()          pending   (arrival time not reached yet)
      advance(now)    queued    (arrived; waiting for a slot + KV pages)
      admit()         prefill   (slot assigned, pages reserved; prompt
                                 streams in chunks between decode steps)
                      decode    (engine flips the state after the last
                                 prompt chunk samples the first token)
      finish()        done      (slot + pages released, result buffered
                                 until every earlier rid has finished)

Admission is FIFO over *arrived* requests and is gated on the
``PagedKVPool``: a request is admitted only when its worst-case KV
footprint fits in free pages, so a burst of long prompts queues instead of
thrashing memory.  The scheduler is pure host-side bookkeeping — the
engine owns every device computation.

A copy of the reference's scheduler: plain Python, no framework.
"""

from __future__ import annotations

import dataclasses
import heapq
import time
from typing import Any, Dict, List, Optional

from .kv_pool import PagedKVPool


@dataclasses.dataclass
class TrackedRequest:
    """One request's scheduling state (host-side, engine-agnostic)."""
    rid: int
    request: Any
    arrival: float
    need_tokens: int                 # worst-case KV footprint (pool gate)
    state: str = "pending"           # pending|queued|prefill|decode|done
    slot: Optional[int] = None
    prefill_pos: int = 0             # prompt tokens already streamed
    new_tokens: int = 0              # tokens sampled so far
    last_token: int = 0
    out: List[int] = dataclasses.field(default_factory=list)
    submit_wall: float = 0.0
    arrive_wall: float = 0.0
    finish_wall: float = 0.0
    finish_reason: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.state in ("prefill", "decode")


class Scheduler:
    """Request queue + slot map + reorder buffer over a ``PagedKVPool``."""

    def __init__(self, max_slots: int, pool: PagedKVPool):
        if max_slots <= 0:
            raise ValueError(f"max_slots must be positive, got {max_slots}")
        self.max_slots = int(max_slots)
        self.pool = pool
        self.slots: List[Optional[int]] = [None] * self.max_slots
        self._tracked: Dict[int, TrackedRequest] = {}
        self._pending: List = []          # heap of (arrival, rid)
        self._queue: List[int] = []       # arrived, FIFO
        self._results: Dict[int, Any] = {}  # finished, awaiting delivery
        self._next_rid = 0
        self._next_deliver = 0

    # -- intake ------------------------------------------------------------

    def submit(self, request: Any, *, arrival: float = 0.0,
               need_tokens: int = 1) -> int:
        """Register a request; returns its rid (== delivery order)."""
        if self.pool.pages_for(need_tokens) > self.pool.num_pages:
            raise ValueError(
                f"request needs {self.pool.pages_for(need_tokens)} KV pages "
                f"({need_tokens} tokens) but the pool only has "
                f"{self.pool.num_pages}; raise num_pages or shorten the "
                f"request")
        rid = self._next_rid
        self._next_rid += 1
        tr = TrackedRequest(rid=rid, request=request, arrival=float(arrival),
                            need_tokens=int(need_tokens),
                            submit_wall=time.perf_counter())
        self._tracked[rid] = tr
        heapq.heappush(self._pending, (tr.arrival, rid))
        return rid

    def advance(self, now: float) -> List[TrackedRequest]:
        """Move every request with ``arrival <= now`` into the FIFO queue."""
        arrived = []
        while self._pending and self._pending[0][0] <= now:
            _, rid = heapq.heappop(self._pending)
            tr = self._tracked[rid]
            if tr.state != "pending":     # cancelled while pending
                continue
            tr.state = "queued"
            tr.arrive_wall = time.perf_counter()
            self._queue.append(rid)
            arrived.append(tr)
        return arrived

    def next_arrival(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    # -- admission ---------------------------------------------------------

    def admit(self) -> List[TrackedRequest]:
        """FIFO-admit queued requests into free slots while the pool can
        reserve their worst-case footprint.  Head-of-line blocking is
        deliberate: admission order == arrival order."""
        admitted = []
        while self._queue:
            free = [i for i, r in enumerate(self.slots) if r is None]
            if not free:
                break
            tr = self._tracked[self._queue[0]]
            if not self.pool.can_alloc(tr.need_tokens):
                break
            self._queue.pop(0)
            self.pool.alloc(tr.rid, tr.need_tokens)
            tr.slot = free[0]
            tr.state = "prefill"
            tr.prefill_pos = 0
            self.slots[free[0]] = tr.rid
            admitted.append(tr)
        return admitted

    # -- retirement --------------------------------------------------------

    def release(self, tr: TrackedRequest) -> None:
        """Give back ``tr``'s slot and pages (no result yet)."""
        if tr.slot is not None:
            self.slots[tr.slot] = None
            tr.slot = None
        self.pool.free(tr.rid)

    def finish(self, tr: TrackedRequest, result: Any,
               reason: str = "stop") -> None:
        """Retire ``tr``: release resources, buffer ``result`` for in-order
        delivery."""
        self.release(tr)
        if tr.state == "queued":
            self._queue.remove(tr.rid)
        tr.state = "done"
        tr.finish_reason = tr.finish_reason or reason
        tr.finish_wall = time.perf_counter()
        self._results[tr.rid] = result

    def pop_ready(self) -> List[Any]:
        """Results whose every predecessor has finished — the reorder
        buffer's in-order release."""
        out = []
        while self._next_deliver in self._results:
            out.append(self._results.pop(self._next_deliver))
            self._next_deliver += 1
        return out

    # -- views -------------------------------------------------------------

    def tracked(self, rid: int) -> TrackedRequest:
        return self._tracked[rid]

    def in_state(self, state: str) -> List[TrackedRequest]:
        """Active requests in ``state``, in slot order (deterministic)."""
        out = []
        for rid in self.slots:
            if rid is not None and self._tracked[rid].state == state:
                out.append(self._tracked[rid])
        return out

    def has_work(self) -> bool:
        return (bool(self._pending) or bool(self._queue)
                or any(r is not None for r in self.slots)
                or bool(self._results))

    @property
    def undelivered(self) -> int:
        return self._next_rid - self._next_deliver
