"""The port's serving subsystem: the continuous-batching ``Engine``, its
``Scheduler`` and the paged KV pool (which also feeds
``repro_torch.kernels.flash_decode_paged`` its page tables)."""

from .engine import Engine, Request, Result  # noqa: F401
from .kv_pool import FREE_PAGE, PagedKVPool, PoolExhausted  # noqa: F401
from .scheduler import Scheduler, TrackedRequest  # noqa: F401

__all__ = ["Engine", "Request", "Result", "Scheduler", "TrackedRequest",
           "PagedKVPool", "PoolExhausted", "FREE_PAGE"]
