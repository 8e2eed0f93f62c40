"""Request-lifecycle observability: spans and metrics.

The lifecycle observer (docs/OBSERVABILITY.md):

* :class:`Observer` — the seam between the :class:`Scheduler` and the
  telemetry sinks.  Every lifecycle transition (submitted → admitted →
  per-chunk prefill → first token → decode/verify ticks → preempted /
  replayed → finished) lands as a SPAN event in the graph's lock-free
  :class:`~repro_torch.core.tracer.Tracer` ring AND as counters/histograms in
  a :class:`~repro_torch.core.metrics.MetricsRegistry`.  Under
  ``repro_torch.core.tracer.COMPILED_OUT`` the scheduler holds
  :data:`NULL_OBSERVER` instead (``enabled`` False), so the hot path
  carries no clock reads at all.

The JAX package's ``RequestTimeline`` (per-request Perfetto tracks) and
``FlightRecorder`` (incident dumps) come with the port's GraphServer
(ROADMAP Queue 1 item 3b); until then ``Observer.recorder`` stays None.

SPAN encoding (fits the existing :class:`TraceEvent` tuple unchanged):
``stream_id = "<phase>@<request_id>"``, ``packet_timestamp`` a
phase-specific sequence number (token index, chunk start, ...),
``packet_data_id`` a phase-specific value (accepted count, slot, ...).
"""
from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional

from ..core import tracer as trace_mod
from ..core.metrics import MetricsRegistry, NullRegistry

# Lifecycle phases, in nominal order.  "finished" carries the reason as
# "finished:<reason>" (eos | length | cancelled | deadline).
PHASES = ("submitted", "admitted", "chunk", "first_token", "token",
          "verify", "preempted", "replayed", "finished")


def span_id(phase: str, rid: Any) -> str:
    return f"{phase}@{rid}"


def parse_span(stream_id: str):
    """``"<phase>@<rid>" -> (phase, rid_str)`` — phase may carry a
    ``:detail`` suffix (``finished:eos``)."""
    phase, _, rid = stream_id.partition("@")
    return phase, rid


class Observer:
    """Telemetry sink for one scheduler: spans into the tracer ring,
    aggregates into a metrics registry, incidents into a recorder."""

    enabled = True

    def __init__(self, tracer=None, registry: Optional[MetricsRegistry] = None,
                 node_id: int = -1):
        self.tracer = tracer if tracer is not None else trace_mod.NullTracer()
        self.registry = registry if registry is not None else MetricsRegistry()
        self.node_id = int(node_id)
        self.recorder: Optional["FlightRecorder"] = None
        self.now: Callable[[], float] = time.perf_counter
        reg = self.registry
        # -- instruments (pre-bound so hooks don't do name lookups) -------
        self._h_ttft = reg.histogram(
            "serve.ttft_ms", "submit to first token, scheduler-side (ms)")
        self._h_itl = reg.histogram(
            "serve.itl_ms", "gap between consecutive tokens of one "
            "request, scheduler-side (ms)")
        self._h_queue = reg.histogram(
            "serve.queue_wait_ms", "submit to slot admission (ms)")
        self._h_decode = reg.histogram(
            "serve.decode_step_ms", "one batched decode step (ms)")
        self._h_verify = reg.histogram(
            "serve.verify_step_ms", "one speculative verify pass (ms)")
        self._h_prefill = reg.histogram(
            "serve.prefill_ms", "one prefill/ingest backend call (ms)")
        self._h_occupancy = reg.histogram(
            "serve.batch_occupancy", "active decode rows per step")
        self._h_accept = reg.histogram(
            "serve.spec_accepted_per_tick", "accepted draft tokens per "
            "verify tick")
        self._c_submitted = reg.counter(
            "serve.requests_submitted", "requests entering the scheduler")
        self._c_finished = reg.counter(
            "serve.requests_finished", "requests leaving, by reason")
        self._c_tokens = reg.counter(
            "serve.tokens_emitted", "generated tokens streamed out")
        self._c_preempt = reg.counter(
            "serve.preemptions", "victim evictions (pressure or SLO)")
        self._c_replayed = reg.counter(
            "serve.replayed_tokens", "tokens recomputed on readmission")
        self._c_pressure = reg.counter(
            "serve.cache_pressure", "CachePressure events during ingest")
        self._g_waiting = reg.gauge(
            "serve.waiting", "requests queued for admission")
        self._g_mesh_devices = reg.gauge(
            "serve.mesh_devices", "devices in the serving mesh (1 when "
            "unsharded)")
        self._g_mesh_model = reg.gauge(
            "serve.mesh_model", "tensor-parallel (model-axis) size of "
            "the serving mesh")
        self.mesh: Dict[str, Any] = {"devices": 1, "axes": {}}
        self._g_mesh_devices.set(1)
        self._g_mesh_model.set(1)

    def set_mesh(self, desc: Dict[str, Any]) -> None:
        """Tag this observer's metrics with the serving-mesh shape
        (docs/SHARDING.md).  Called once by the engine calculator after
        it learns the engine's mesh — every later metrics snapshot and
        flight-recorder incident carries the shape, so a postmortem from
        a tp=4 run is distinguishable from a single-chip one."""
        self.mesh = dict(desc)
        self._g_mesh_devices.set(int(desc.get("devices", 1)))
        self._g_mesh_model.set(int(desc.get("axes", {}).get("model", 1)))

    # -- span primitive ---------------------------------------------------
    def span(self, phase: str, rid: Any, seq: int = 0, value: int = 0) -> None:
        self.tracer.record(trace_mod.SPAN, self.node_id,
                           span_id(phase, rid), int(seq), int(value))

    # -- scheduler lifecycle hooks ---------------------------------------
    def submitted(self, req, waiting: int) -> None:
        self._c_submitted.inc()
        self._g_waiting.set(waiting)
        self.span("submitted", req.id, seq=int(req.prompt.size),
                  value=req.priority)

    def admitted(self, req, wait_ms: Optional[float]) -> None:
        if wait_ms is not None:      # None = readmission after preemption
            self._h_queue.observe(wait_ms)
        self.span("admitted", req.id, seq=req.preemptions, value=req.slot)

    def prefill(self, dur_ms: float, tokens: int) -> None:
        self._h_prefill.observe(dur_ms)

    def chunk(self, req, start: int, end: int, dur_ms: float) -> None:
        self._h_prefill.observe(dur_ms)
        self.span("chunk", req.id, seq=start, value=end - start)

    def first_token(self, req, ttft_ms: float, index: int = 0) -> None:
        self._h_ttft.observe(ttft_ms)
        self._c_tokens.inc()
        self.span("first_token", req.id, seq=index, value=int(ttft_ms))

    def token(self, req, index: int, itl_ms: float) -> None:
        self._h_itl.observe(itl_ms)
        self._c_tokens.inc()
        self.span("token", req.id, seq=index)

    def decode_tick(self, dur_ms: float, occupancy: int) -> None:
        self._h_decode.observe(dur_ms)
        self._h_occupancy.observe(occupancy)

    def verify_tick(self, dur_ms: float, occupancy: int) -> None:
        self._h_verify.observe(dur_ms)
        self._h_occupancy.observe(occupancy)

    def verified(self, req, accepted: int, drafted: int, seq: int) -> None:
        self._h_accept.observe(accepted)
        self.span("verify", req.id, seq=seq, value=accepted)

    def preempted(self, req) -> None:
        self._c_preempt.inc()
        self.span("preempted", req.id, seq=len(req.tokens),
                  value=req.preemptions)
        if self.recorder is not None:
            self.recorder.incident(
                "preemption", f"request {req.id!r} evicted "
                f"(preemption #{req.preemptions})")

    def replayed(self, req, n_tokens: int) -> None:
        self._c_replayed.inc(n_tokens)
        self.span("replayed", req.id, seq=n_tokens)

    def pressure(self, req) -> None:
        self._c_pressure.inc()
        self.span("pressure", req.id, seq=req.ingested)
        if self.recorder is not None:
            self.recorder.incident(
                "cache_pressure", f"ingest of request {req.id!r} hit "
                f"CachePressure at {req.ingested} tokens")

    def finished(self, req, reason: str) -> None:
        self._c_finished.inc(reason=reason)
        self.span(f"finished:{reason}", req.id, seq=len(req.tokens))
        if reason == "deadline" and self.recorder is not None:
            self.recorder.incident(
                "deadline_miss", f"request {req.id!r} missed its deadline "
                f"after {len(req.tokens)} tokens")


class _NullObserver(Observer):
    """Every hook a no-op; ``enabled`` False lets the scheduler skip the
    clock reads that would feed the hooks."""

    enabled = False

    def __init__(self):
        self.tracer = trace_mod.NullTracer()
        self.registry = NullRegistry()
        self.node_id = -1
        self.recorder = None
        self.now = time.perf_counter
        self.mesh = {"devices": 1, "axes": {}}

    def set_mesh(self, *a, **k):
        pass

    def span(self, *a, **k):
        pass

    def submitted(self, *a, **k):
        pass

    def admitted(self, *a, **k):
        pass

    def prefill(self, *a, **k):
        pass

    def chunk(self, *a, **k):
        pass

    def first_token(self, *a, **k):
        pass

    def token(self, *a, **k):
        pass

    def decode_tick(self, *a, **k):
        pass

    def verify_tick(self, *a, **k):
        pass

    def verified(self, *a, **k):
        pass

    def preempted(self, *a, **k):
        pass

    def replayed(self, *a, **k):
        pass

    def pressure(self, *a, **k):
        pass

    def finished(self, *a, **k):
        pass


NULL_OBSERVER = _NullObserver()
