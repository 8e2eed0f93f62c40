"""The serving pipeline graphs — MediaPipe's flow-limited inference pattern
(paper Fig. 3 + §6.1) applied to LLM serving.

Fixed-batch pipeline (:func:`build_serving_graph`):

    requests -> FlowLimiter -> Batcher -> LLMPrefill -> Unbatch -> responses
                     ^                                      |
                     +----------- FINISHED loopback ---------+

Continuous-batching pipeline (:func:`build_continuous_serving_graph`):

    requests -> FlowLimiter -> ContinuousBatch -+-> tokens
                     ^              ^    |      +-> responses
    control ---------|--------------+    |           |
    (cancel)         |              +-tick loop      |
                     +--------- FINISHED loopback ---+

The flow limiter bounds in-flight requests so bursts do not queue unbounded
work behind the accelerator; drops happen UPSTREAM of prefill (no wasted
work).  The heavy inference node runs on a dedicated executor (paper §3.6's
thread-locality advice).  In the continuous graph the decode loop itself is
a loopback stream: every decode step is one scheduler dispatch, so
admission, back-pressure and the tracer all see the loop at step
granularity.

Both graphs are authored with :class:`~repro_torch.core.builder.GraphBuilder`:
ports are contract-checked as the graph is written, and the FINISHED/TICK
back edges are declared by ``b.loopback()`` handles instead of manual
``back_edge_inputs`` bookkeeping.  ``build()`` returns a plain
``GraphConfig`` for the runtime.
"""
from __future__ import annotations

from typing import Optional

from .. import calculators as _basic_calculators  # noqa: F401 (registers
#     PassThroughCalculator & co. for the loopback nodes)
from ..core.builder import GraphBuilder
from ..core.graph_config import GraphConfig


def build_serving_graph(*, batch_size: int = 4, max_in_flight: int = 2,
                        queue_size: int = 256,
                        drop_on_overload: bool = False) -> GraphConfig:
    b = GraphBuilder(num_threads=4, enable_tracer=True)
    requests = b.input("requests")
    engine_sp = b.side_input("engine")
    b.executor("inference", 1)

    finished = b.loopback()
    limiter = b.add_node(
        "FlowLimiterCalculator", name="limiter",
        inputs={"IN": requests, "FINISHED": finished},
        options={"max_in_flight": max_in_flight * batch_size,
                 "queue_size": 0 if drop_on_overload else queue_size})
    batcher = b.add_node(
        "BatcherCalculator", name="batcher",
        inputs={"REQUEST": limiter.out("OUT", name="admitted")},
        options={"batch_size": batch_size})
    engine = b.add_node(
        "LLMPrefillCalculator", name="engine",
        inputs={"BATCH": batcher.out("BATCH", name="batches")},
        side_inputs={"engine": engine_sp},
        executor="inference")
    unbatch = b.add_node(
        "UnbatchCalculator", name="unbatch",
        inputs={"BATCH_RESULT": engine.out("BATCH_RESULT",
                                           name="batch_results")})
    responses = b.output(unbatch.out("RESPONSE", name="responses"))
    loop = b.add_node("PassThroughCalculator", name="loop",
                      inputs={"responses": responses})
    finished.tie(loop.out("responses", name="responses_loop"))
    return b.build()


def build_continuous_serving_graph(*, num_slots: int = 4,
                                   max_in_flight: int = 0,
                                   queue_size: int = 1024,
                                   drop_on_overload: bool = False,
                                   max_new_tokens: int = 16,
                                   eos_id: Optional[int] = None,
                                   enable_tracer: bool = True,
                                   chunk_size: Optional[int] = None,
                                   speculate_k: int = 0,
                                   spec_ngram: int = 3,
                                   paged: bool = False,
                                   num_blocks: int = 0,
                                   block_size: int = 16,
                                   prefix_sharing: bool = True,
                                   admission: str = "preempt",
                                   watermark: int = 0,
                                   backend: Optional[str] = None,
                                   spec_window: int = 8
                                   ) -> GraphConfig:
    """Continuous-batching serving graph (the GraphServer topology).

    ``max_in_flight`` bounds requests inside the engine subsystem (waiting
    for a slot + occupying one); 0 means ``2 * num_slots`` so a full next
    wave is always staged while the current one decodes.  Beyond that the
    limiter queues up to ``queue_size`` requests — or drops immediately
    when ``drop_on_overload`` (which makes ``queue_size`` moot).

    With ``paged=True`` the engine node runs the paged KV cache
    (``num_blocks`` blocks of ``block_size`` tokens; ref-counted prefix
    sharing unless ``prefix_sharing=False``).  The GraphServer derives a
    memory-aware ``max_in_flight`` default in that mode — see
    :class:`repro_torch.serving.server.GraphServer`.

    ``speculate_k > 0`` turns on self-speculative decoding as the
    default for every request (prompt-lookup drafting with n-grams up
    to ``spec_ngram``; see docs/SPECULATIVE.md).

    ``backend`` names the cache layout outright ("slot" | "paged" |
    "state" | "hybrid"; wins over the legacy ``paged`` flag).  "state"
    serves recurrent/mixed stacks from O(1) state slabs; "hybrid"
    (Jamba-style) pages attention K/V while recurrent layers ride state
    slabs — ``spec_window`` caps their speculative verify window
    (docs/STATE_CACHE.md).
    """
    if max_in_flight <= 0:
        max_in_flight = 2 * num_slots
    b = GraphBuilder(num_threads=4, enable_tracer=enable_tracer)
    requests = b.input("requests")
    # control bypasses the flow limiter on purpose: a cancel must reach
    # the scheduler even (especially) when the admission queue is full
    control = b.input("control")
    engine_sp = b.side_input("engine")
    b.executor("inference", 1)

    engine_opts = {"num_slots": num_slots, "max_new_tokens": max_new_tokens,
                   "eos_id": eos_id, "chunk_size": chunk_size,
                   "speculate_k": speculate_k, "spec_ngram": spec_ngram}
    if backend is not None:
        engine_opts.update({"backend": backend,
                            "spec_window": spec_window})
    if paged or backend in ("paged", "hybrid"):
        engine_opts.update({"paged": paged, "num_blocks": num_blocks,
                            "block_size": block_size,
                            "prefix_sharing": prefix_sharing,
                            "admission": admission,
                            "watermark": watermark})

    finished = b.loopback()
    tick = b.loopback()
    limiter = b.add_node(
        "FlowLimiterCalculator", name="limiter",
        inputs={"IN": requests, "FINISHED": finished},
        options={"max_in_flight": max_in_flight,
                 "queue_size": 0 if drop_on_overload else queue_size})
    engine = b.add_node(
        "ContinuousBatchCalculator", name="engine",
        inputs={"REQUEST": limiter.out("OUT", name="admitted"),
                "CONTROL": control,
                "TICK": tick},
        side_inputs={"engine": engine_sp},
        options=engine_opts,
        executor="inference")
    tokens = engine.out("TOKEN", name="tokens")
    responses = engine.out("RESPONSE", name="responses")
    ticks = engine.out("TICK_OUT", name="ticks")
    b.output(responses)
    b.output(tokens)
    tick_loop = b.add_node("PassThroughCalculator", name="tick_loop",
                           inputs={"ticks": ticks})
    tick.tie(tick_loop.out("ticks", name="tick_loop"))
    finished_loop = b.add_node("PassThroughCalculator", name="finished_loop",
                               inputs={"responses": responses})
    finished.tie(finished_loop.out("responses", name="responses_loop"))
    return b.build()
