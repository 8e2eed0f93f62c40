"""KV-cache subsystem of the port: the CacheBackend protocol (contiguous
slot rows, paged block-pool arena, O(1) state slabs, or the per-layer
hybrid mix — behind one interface: allocation, insert, decode, extend,
speculative verify/truncate), the block-pool allocator, and ref-counted
prompt-prefix sharing (see docs/KV_CACHE.md, docs/STATE_CACHE.md,
docs/SCHEDULER.md and docs/SPECULATIVE.md)."""
from .allocator import BlockPool, BlockPoolError
from .backend import (CacheBackend, CachePressure, PagedBackend,
                      SlotBackend, make_backend, max_request_tokens)
from .prefix import PrefixIndex, ROOT, chain_key
from .state import HybridBackend, StateBackend

__all__ = ["BlockPool", "BlockPoolError", "CacheBackend", "CachePressure",
           "HybridBackend", "PagedBackend", "PrefixIndex", "ROOT",
           "SlotBackend", "StateBackend", "chain_key", "make_backend",
           "max_request_tokens"]
