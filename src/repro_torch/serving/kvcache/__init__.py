"""KV-cache subsystem of the port: the CacheBackend protocol (contiguous
slot rows or a paged block-pool arena behind one interface: allocation,
insert, decode, extend, speculative verify/truncate), the block-pool
allocator, and ref-counted prompt-prefix sharing (see docs/KV_CACHE.md,
docs/SCHEDULER.md and docs/SPECULATIVE.md).  The state and hybrid
layouts raise until ROADMAP Queue 1 item 7 ports them."""
from .allocator import BlockPool, BlockPoolError
from .backend import (CacheBackend, CachePressure, PagedBackend,
                      SlotBackend, make_backend, max_request_tokens)
from .prefix import PrefixIndex, ROOT, chain_key

__all__ = ["BlockPool", "BlockPoolError", "CacheBackend", "CachePressure",
           "PagedBackend", "PrefixIndex", "ROOT", "SlotBackend",
           "chain_key", "make_backend", "max_request_tokens"]
