"""Serving surface of the port, bottom-up:

* :class:`LLMEngine` (``engine.py``) — eager prefill / decode / extend /
  verify on the card, dispatched on a cache backend's layout;
* :class:`CacheBackend` / :class:`SlotBackend` / :class:`PagedBackend`
  / :class:`StateBackend` / :class:`HybridBackend` (``kvcache/``) —
  contiguous slot rows, a paged block-pool arena with ref-counted prefix
  sharing, O(1) recurrent state slabs, or the Jamba-style per-layer mix;
* :class:`Scheduler` (``batching.py``) — continuous batching: priority
  admission, chunked prefill, preemption, self-speculative decoding;
* :class:`GraphServer` (``server.py``) — the whole thing wired as a
  MediaPipe-style graph (``repro_torch.core``) with flow-limited
  admission and streamed responses;
* :class:`AsyncFrontend` (``frontend.py``) — the asyncio front door:
  per-token async streaming, client disconnect → cancellation,
  deadlines/TTFT targets, retry/timeout policy.

Quickstart (on the CPU; drop ``device`` to run on the card)::

    from repro_torch.configs import get_config
    from repro_torch.serving import GraphServer, LLMEngine

    engine = LLMEngine(get_config("minicpm_2b").reduced(), max_len=128,
                       device="cpu")
    with GraphServer(engine, num_slots=4, speculate_k=4) as server:
        tokens = server.submit([1, 2, 3, 4]).result()

The Scheduler alone, without the graph, is driven by ``sched.admit() +
sched.step()`` until ``sched.has_work()`` is false.
"""
from .engine import LLMEngine
from .batching import DeadlineExceeded, Request, Scheduler, TokenEvent
from .calculators import (BatcherCalculator, ContinuousBatchCalculator,
                          UnbatchCalculator, LLMPrefillCalculator,
                          LLMDecodeLoopCalculator)
from .frontend import AsyncFrontend, Policy, RequestTimeout
from .kvcache import (BlockPool, BlockPoolError, CacheBackend,
                      CachePressure, HybridBackend, PagedBackend,
                      PrefixIndex, SlotBackend, StateBackend, make_backend)
from .observe import (FlightRecorder, NULL_OBSERVER, Observer,
                      RequestTimeline, export_run)
from .pipeline import build_continuous_serving_graph, build_serving_graph
from .server import GraphServer, RequestHandle
from .speculative import lookup_draft

__all__ = ["LLMEngine", "BatcherCalculator", "ContinuousBatchCalculator",
           "UnbatchCalculator", "LLMPrefillCalculator",
           "LLMDecodeLoopCalculator", "Request", "Scheduler", "TokenEvent",
           "DeadlineExceeded", "AsyncFrontend", "Policy", "RequestTimeout",
           "BlockPool", "BlockPoolError", "CacheBackend", "CachePressure",
           "HybridBackend", "PagedBackend", "PrefixIndex", "SlotBackend",
           "StateBackend", "make_backend",
           "build_serving_graph", "build_continuous_serving_graph",
           "GraphServer", "RequestHandle", "lookup_draft",
           "FlightRecorder", "NULL_OBSERVER", "Observer",
           "RequestTimeline", "export_run"]
