"""Serving surface of the port, bottom-up:

* :class:`LLMEngine` (``engine.py``) — eager prefill / decode / extend /
  verify on the card, dispatched on a cache backend's layout;
* :class:`CacheBackend` / :class:`SlotBackend` / :class:`PagedBackend`
  (``kvcache/``) — contiguous slot rows or a paged block-pool arena with
  ref-counted prefix sharing;
* :class:`Scheduler` (``batching.py``) — continuous batching: priority
  admission, chunked prefill, preemption, self-speculative decoding.

Quickstart (on the CPU; drop ``device`` to run on the card)::

    from repro_torch.configs import get_config
    from repro_torch.serving import LLMEngine, Scheduler, make_backend

    engine = LLMEngine(get_config("minicpm_2b").reduced(), max_len=128,
                       device="cpu")
    sched = Scheduler(make_backend(engine, paged=True, num_blocks=64),
                      max_new_tokens=8, chunk_size=32, speculate_k=4)
    sched.submit({"tokens": [1, 2, 3, 4], "id": "a"})
    while sched.has_work():
        for ev in sched.admit() + sched.step():
            if ev.finished:
                print(ev.request.id, ev.request.tokens)

The GraphServer, its calculators and the asyncio front door come with
ROADMAP Queue 1 item 3b.
"""
from .batching import DeadlineExceeded, Request, Scheduler, TokenEvent
from .engine import LLMEngine
from .kvcache import (BlockPool, BlockPoolError, CacheBackend,
                      CachePressure, PagedBackend, PrefixIndex, SlotBackend,
                      make_backend)
from .observe import NULL_OBSERVER, Observer
from .speculative import lookup_draft

__all__ = ["LLMEngine", "Request", "Scheduler", "TokenEvent",
           "DeadlineExceeded", "BlockPool", "BlockPoolError", "CacheBackend",
           "CachePressure", "PagedBackend", "PrefixIndex", "SlotBackend",
           "make_backend", "lookup_draft", "NULL_OBSERVER", "Observer"]
