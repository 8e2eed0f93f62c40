"""Serving calculators: request batching, LLM prefill/decode, unbatching,
and the continuous-batching engine node.

This is the paper's framework applied to LLM serving: requests are packets
on a stream; a batcher groups them (the flow-limiter pattern bounds
in-flight batches); the engine node runs the model on the card; an
unbatch node fans results back out to per-request timestamps.  The default
input policy guarantees responses align with their originating requests.

Two engine nodes:

* ``BatcherCalculator`` + ``LLMPrefillCalculator`` + ``UnbatchCalculator``
  — the original fixed-batch pipeline (a batch must drain before the next
  one starts).
* ``ContinuousBatchCalculator`` — continuous batching over the unified
  Scheduler/CacheBackend stack (slot rows or paged arena, optional
  chunked prefill and preemptive admission — docs/SCHEDULER.md):
  requests join a *running* decode batch and stream tokens out per step.
  The decode loop is driven by the graph scheduler itself through a tick
  loopback stream, so admission, chunk ingestion and decode steps
  naturally interleave and back-pressure/tracing see every step.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..core import tracer as trace_mod
from ..core.calculator import Calculator, CalculatorContext
from ..core.contract import AnyType, contract
from ..core.registry import register_calculator
from ..core.timestamp import Timestamp
from .batching import DeadlineExceeded, Scheduler, TokenEvent
from .kvcache.backend import make_backend
from .observe import NULL_OBSERVER, Observer


@register_calculator
class BatcherCalculator(Calculator):
    """Groups request packets into fixed-size padded batches.

    Input:  REQUEST — dict {'tokens': 1-D int32 list/array, 'id': any}
    Output: BATCH   — dict {'tokens': [B,S] int32, 'ids': [...],
                            'timestamps': [...], 'lengths': [...]}
    Options: batch_size (default 4), pad_id (default 0),
             max_wait (packets to wait before flushing a short batch).
    """

    CONTRACT = (contract()
                .add_input("REQUEST", AnyType)
                .add_output("BATCH")
                .set_input_policy("immediate"))

    def open(self, ctx: CalculatorContext) -> None:
        self.batch_size = int(ctx.options.get("batch_size", 4))
        self.pad_id = int(ctx.options.get("pad_id", 0))
        self.pending: List = []

    def _flush(self, ctx: CalculatorContext) -> None:
        if not self.pending:
            return
        reqs = self.pending
        self.pending = []
        S = max(len(r.payload["tokens"]) for r in reqs)
        B = len(reqs)
        toks = np.full((B, S), self.pad_id, np.int32)
        lengths = []
        for i, r in enumerate(reqs):
            t = np.asarray(r.payload["tokens"], np.int32)
            toks[i, S - len(t):] = t          # left-pad
            lengths.append(len(t))
        batch = {"tokens": toks,
                 "ids": [r.payload.get("id") for r in reqs],
                 "timestamps": [r.timestamp for r in reqs],
                 "lengths": lengths,
                 "max_new_tokens": max(r.payload.get("max_new_tokens", 16)
                                       for r in reqs)}
        # the batch carries the timestamp of its newest request
        ctx.outputs("BATCH").add(batch, reqs[-1].timestamp)

    def process(self, ctx: CalculatorContext) -> None:
        p = ctx.inputs["REQUEST"]
        if p.is_empty():
            return
        self.pending.append(p)
        if len(self.pending) >= self.batch_size:
            self._flush(ctx)

    def close(self, ctx: CalculatorContext) -> None:
        self._flush(ctx)


@register_calculator
class LLMPrefillCalculator(Calculator):
    """Runs engine.generate on a BATCH (prefill + greedy decode).

    Side packet: engine — an LLMEngine.
    Pin this node to a dedicated executor in the GraphConfig for thread
    locality (paper §3.6's mobile-inference advice, unchanged on GPU hosts).
    """

    CONTRACT = (contract()
                .add_input("BATCH", AnyType)
                .add_output("BATCH_RESULT")
                .add_input_side_packet("engine", AnyType))

    def open(self, ctx: CalculatorContext) -> None:
        self._engine = ctx.side("engine")

    def process(self, ctx: CalculatorContext) -> None:
        p = ctx.inputs["BATCH"]
        if p.is_empty():
            return
        batch = p.payload
        out = self._engine.generate(batch["tokens"],
                                    batch["max_new_tokens"])
        ctx.outputs("BATCH_RESULT").add(dict(batch, output_tokens=out),
                                        p.timestamp)


# Backwards-compatible alias used by the serving pipeline docs
LLMDecodeLoopCalculator = LLMPrefillCalculator


@register_calculator
class ContinuousBatchCalculator(Calculator):
    """Continuous-batching engine node over the unified Scheduler.

    Inputs:
        REQUEST  — admitted request packets
                   ({'tokens', 'id', 'max_new_tokens'?, 'eos_id'?,
                     'priority'?, 'deadline'?, 'ttft_deadline'?})
        CONTROL  — optional out-of-band control packets.  NOT routed
                   through the flow limiter: a cancel must reach the
                   scheduler even when the admission queue is full
                   (that is exactly when clients give up).
                   {'op': 'cancel', 'id': request-id} cancels at any
                   lifecycle point; unknown ids are remembered so a
                   cancel racing ahead of its own queued REQUEST still
                   lands (and a cancel for an already-finished id — the
                   post-EOS race — is a no-op).
        TICK     — self-loopback (back edge): each tick packet drives one
                   admission round + one decode step.  The graph scheduler
                   interleaves REQUEST packets between ticks, which is what
                   lets new requests join the running batch.
    Outputs:
        TOKEN    — one packet per generated token
                   {'id', 'token', 'index', 'finished'} (``token`` is
                   None on a token-less completion: cancelled or missed
                   deadline — ``finish_reason`` says which)
        RESPONSE — one packet per finished request
                   {'id', 'tokens': np int32 [n], 'finish_reason'}
                   (emitted for cancelled/expired requests too, so the
                   FINISHED loopback always returns limiter budget)
        TICK_OUT — loop back to TICK while work remains
    Side packets:
        engine   — an LLMEngine (pin this node to a dedicated executor).
    Options:
        num_slots (default 4), max_new_tokens (default 16), eos_id.
        chunk_size — chunked prefill: ingest long prompts this many
        tokens per tick, interleaved with decode steps.
        speculate_k — self-speculative decoding: draft up to k tokens
        per tick by prompt lookup and verify them in one pass
        (docs/SPECULATIVE.md); acceptance is recorded into the graph
        tracer as ``spec.*`` gauges.  spec_ngram sets the largest
        lookup n-gram (default 3).
        paged (default False) — use the paged KV cache
        (:class:`~repro_torch.serving.kvcache.PagedBackend`) with
        num_blocks / block_size / prefix_sharing / admission
        ("preempt" | "reserve") / watermark; block-pool occupancy is
        recorded into the graph tracer as ``kvcache.*`` gauges.
        backend — cache layout by name ("slot" | "paged" | "state" |
        "hybrid"; wins over ``paged``): "state" serves recurrent/mixed
        stacks from O(1) state slabs, "hybrid" pages attention K/V
        while recurrent layers ride state slabs (docs/STATE_CACHE.md);
        spec_window caps their speculative verify window.

    Each output stream carries its own monotonically increasing timestamp
    counter: responses finish out of request order by design (that is the
    point of continuous batching), so they cannot be emitted at the
    request's own timestamp without violating stream monotonicity.
    """

    CONTRACT = (contract()
                .add_input("REQUEST", AnyType)
                .add_input("CONTROL", AnyType, optional=True)
                .add_input("TICK", AnyType, optional=True)
                .add_output("TOKEN")
                .add_output("RESPONSE")
                .add_output("TICK_OUT")
                .add_input_side_packet("engine", AnyType)
                .set_input_policy("immediate"))

    def open(self, ctx: CalculatorContext) -> None:
        opts = ctx.options
        backend = make_backend(
            ctx.side("engine"),
            paged=bool(opts.get("paged")),
            backend=opts.get("backend"),
            num_slots=int(opts.get("num_slots", 4)),
            num_blocks=int(opts.get("num_blocks", 0)),
            block_size=int(opts.get("block_size", 16)),
            prefix_sharing=bool(opts.get("prefix_sharing", True)),
            admission=opts.get("admission", "preempt"),
            watermark=int(opts.get("watermark", 0)),
            spec_window=int(opts.get("spec_window", 8)))
        chunk = opts.get("chunk_size")
        # Lifecycle observer: spans into the graph tracer + a metrics
        # registry (GraphServer.metrics() merges it with the engine's).
        # Under tracer.COMPILED_OUT the scheduler gets the null observer
        # and pays for nothing (serving/observe.py).
        self.observer = NULL_OBSERVER if trace_mod.COMPILED_OUT else \
            Observer(tracer=ctx.tracer, node_id=ctx.node_index)
        # Tag metrics with the serving-mesh shape (docs/SHARDING.md);
        # set_mesh is a no-op on the shared NULL_OBSERVER singleton.
        self.observer.set_mesh(ctx.side("engine").mesh_desc)
        self.sched = Scheduler(
            backend,
            max_new_tokens=int(opts.get("max_new_tokens", 16)),
            eos_id=opts.get("eos_id"),
            chunk_size=int(chunk) if chunk else None,
            speculate_k=int(opts.get("speculate_k", 0)),
            spec_ngram=int(opts.get("spec_ngram", 3)),
            trace=ctx.trace_gauge,
            observer=self.observer)
        self._tick_pending = False
        self._ts = {"TOKEN": 0, "RESPONSE": 0, "TICK_OUT": 0}

    def _emit(self, ctx: CalculatorContext, port: str, payload) -> None:
        ctx.outputs(port).add(payload, self._ts[port])
        self._ts[port] += 1

    def _emit_events(self, ctx: CalculatorContext,
                     events: List[TokenEvent]) -> None:
        for ev in events:
            token = {"id": ev.request.id, "token": ev.token,
                     "index": ev.index, "finished": ev.finished}
            if ev.finished:
                # the final TOKEN event is self-contained so stream
                # consumers never need to join against RESPONSE packets
                # (which arrive on another stream, i.e. another thread)
                token["finish_reason"] = ev.request.finish_reason
                token["metrics"] = self.sched.request_metrics(ev.request)
            self._emit(ctx, "TOKEN", token)
            if ev.finished:
                self._emit(ctx, "RESPONSE", {
                    "id": ev.request.id,
                    "tokens": np.asarray(ev.request.tokens, np.int32),
                    "finish_reason": ev.request.finish_reason})

    def process(self, ctx: CalculatorContext) -> None:
        req = ctx.inputs["REQUEST"]
        if not req.is_empty():
            try:
                self.sched.submit(req.payload)
            except DeadlineExceeded:
                # A relative deadline that expired while the request sat
                # in the admission queue: not the submitter's error (they
                # validated at THEIR submit time), so complete it as
                # deadline_missed instead of erroring the whole graph.
                self.sched.stats["deadline_missed"] += 1
                rid = req.payload.get("id")
                self._emit(ctx, "TOKEN", {
                    "id": rid, "token": None, "index": 0,
                    "finished": True, "finish_reason": "deadline",
                    "metrics": {
                        "id": rid, "finish_reason": "deadline",
                        "tokens": 0,
                        "prompt_tokens": len(req.payload["tokens"]),
                        "preemptions": 0, "spec_drafted": 0,
                        "spec_accepted": 0, "ttft_ms": None,
                        "queue_wait_ms": None}})
                self._emit(ctx, "RESPONSE", {
                    "id": rid, "tokens": np.zeros(0, np.int32),
                    "finish_reason": "deadline"})
        ctrl = ctx.inputs["CONTROL"]
        if not ctrl.is_empty():
            msg = ctrl.payload
            if msg.get("op") == "cancel":
                self._emit_events(ctx, self.sched.cancel(msg.get("id")))
        tick = ctx.inputs["TICK"]
        if not tick.is_empty():
            self._tick_pending = False
            self._emit_events(ctx, self.sched.admit() + self.sched.step())
        if self.sched.has_work() and not self._tick_pending:
            # one tick in flight at a time: request bursts queue behind it
            # and are admitted together at the next round.  (Payload must
            # be non-None: a None payload is an *empty* packet.)
            self._tick_pending = True
            self._emit(ctx, "TICK_OUT", self._ts["TICK_OUT"])

    def close(self, ctx: CalculatorContext) -> None:
        # Drain: if the run is shutting down with work still in flight
        # (tick loopback severed by quiescence), finish it synchronously.
        while self.sched.has_work():
            self._emit_events(ctx, self.sched.admit() + self.sched.step())


@register_calculator
class UnbatchCalculator(Calculator):
    """Fans a BATCH_RESULT back out to one packet per original request, at
    each request's ORIGINAL timestamp — responses stay associated with the
    requests that produced them (the paper's timestamp-as-sync-key idea)."""

    CONTRACT = (contract()
                .add_input("BATCH_RESULT", AnyType)
                .add_output("RESPONSE"))

    def open(self, ctx: CalculatorContext) -> None:
        self._emitted: List[Timestamp] = []

    def process(self, ctx: CalculatorContext) -> None:
        p = ctx.inputs["BATCH_RESULT"]
        if p.is_empty():
            return
        batch = p.payload
        for i, (rid, ts) in enumerate(zip(batch["ids"],
                                          batch["timestamps"])):
            ctx.outputs("RESPONSE").add(
                {"id": rid, "tokens": batch["output_tokens"][i]}, ts)
