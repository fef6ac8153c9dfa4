"""Paged KV-cache pool: fixed-size pages, per-request page tables.

JugglePAC mapping: the pool is the engine's bounded intermediate storage —
the serving analogue of the paper's "few PIS registers, not a BRAM".  A
request (one variable-length *set* in the paper's stream) owns a page
table: a list of fixed-size physical pages covering its KV footprint.
Pages are allocated when the scheduler admits the request and returned the
moment it retires (finishes, hits its length cap, or is cancelled
mid-decode), so back-to-back request streams reuse the same bounded pool
instead of growing per-request dense caches.

The pool is deliberately host-side bookkeeping (plain Python / numpy): it
gates *admission* — a request enters a decode slot only when its
worst-case footprint (prompt + max_new_tokens, capped at the engine
context) fits in free pages — and feeds the paged-gather decode kernel
(``repro_torch.kernels.flash_decode_paged``) its per-request page tables.
A copy of the reference's pool: plain Python and numpy, no framework.

    pool = PagedKVPool(num_pages=64, page_size=16)
    pages = pool.alloc(rid=0, n_tokens=100)   # 7 pages
    pool.extend(rid=0, n_tokens=130)          # grows to 9 pages
    table = pool.page_table(0, max_pages=16)  # int32, -1 padded
    pool.free(0)                              # all 9 back in the free list
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

#: page-table padding sentinel — logical pages past a request's footprint
FREE_PAGE = -1


class PoolExhausted(RuntimeError):
    """Raised when an allocation cannot be satisfied from the free list."""


class PagedKVPool:
    """Fixed-size-page allocator with per-request page tables.

    ``num_pages`` physical pages of ``page_size`` tokens each.  Allocation
    is O(pages) off a free list; pages are recycled LIFO so a hot serving
    loop keeps touching the same memory.
    """

    def __init__(self, num_pages: int, page_size: int):
        if num_pages <= 0 or page_size <= 0:
            raise ValueError(
                f"PagedKVPool needs positive sizes; got num_pages="
                f"{num_pages}, page_size={page_size}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        # pop() takes from the end: keep low page ids at the end so fresh
        # pools allocate 0, 1, 2, ... (deterministic tables for tests)
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._tables: Dict[int, List[int]] = {}
        self._tokens: Dict[int, int] = {}

    # -- capacity ----------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def live_requests(self) -> int:
        return len(self._tables)

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold ``n_tokens`` (at least one)."""
        return max(1, -(-int(n_tokens) // self.page_size))

    def can_alloc(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    # -- lifecycle ---------------------------------------------------------

    def alloc(self, rid: int, n_tokens: int) -> List[int]:
        """Reserve pages covering ``n_tokens`` for request ``rid``."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already holds pages")
        need = self.pages_for(n_tokens)
        if need > len(self._free):
            raise PoolExhausted(
                f"request {rid} needs {need} pages for {n_tokens} tokens "
                f"but only {len(self._free)}/{self.num_pages} are free")
        self._tables[rid] = [self._free.pop() for _ in range(need)]
        self._tokens[rid] = int(n_tokens)
        return list(self._tables[rid])

    def extend(self, rid: int, n_tokens: int) -> List[int]:
        """Grow ``rid``'s reservation to cover ``n_tokens`` total; returns
        the newly added pages (empty if the current table already covers)."""
        if rid not in self._tables:
            raise KeyError(f"request {rid} holds no pages")
        need = self.pages_for(n_tokens) - len(self._tables[rid])
        if need > len(self._free):
            raise PoolExhausted(
                f"request {rid} needs {need} more pages but only "
                f"{len(self._free)}/{self.num_pages} are free")
        new = [self._free.pop() for _ in range(max(need, 0))]
        self._tables[rid].extend(new)
        self._tokens[rid] = max(self._tokens[rid], int(n_tokens))
        return new

    def free(self, rid: int) -> int:
        """Return every page owned by ``rid``; returns the count freed."""
        pages = self._tables.pop(rid, None)
        self._tokens.pop(rid, None)
        if pages is None:
            return 0
        self._free.extend(reversed(pages))
        return len(pages)

    # -- views -------------------------------------------------------------

    def owns(self, rid: int) -> bool:
        return rid in self._tables

    def pages_of(self, rid: int) -> List[int]:
        return list(self._tables.get(rid, ()))

    def page_table(self, rid: int, max_pages: Optional[int] = None
                   ) -> np.ndarray:
        """``rid``'s page table as int32, ``FREE_PAGE``-padded to
        ``max_pages`` (default: just the owned pages) — the layout the
        paged-gather flash-decode kernel consumes."""
        pages = self._tables.get(rid, [])
        width = len(pages) if max_pages is None else int(max_pages)
        if len(pages) > width:
            raise ValueError(
                f"request {rid} owns {len(pages)} pages > max_pages={width}")
        table = np.full(width, FREE_PAGE, np.int32)
        table[:len(pages)] = pages
        return table

    def __repr__(self) -> str:
        return (f"PagedKVPool(num_pages={self.num_pages}, "
                f"page_size={self.page_size}, free={self.free_pages}, "
                f"live={self.live_requests})")
