"""Serving pieces of the port: the paged KV pool that feeds
``repro_torch.kernels.flash_decode_paged`` its page tables."""

from .kv_pool import FREE_PAGE, PagedKVPool, PoolExhausted  # noqa: F401

__all__ = ["FREE_PAGE", "PagedKVPool", "PoolExhausted"]
