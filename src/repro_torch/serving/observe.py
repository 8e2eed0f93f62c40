"""Request-lifecycle observability: spans, metrics, flight recorder.

Three pieces (docs/OBSERVABILITY.md):

* :class:`Observer` — the seam between the :class:`Scheduler` and the
  telemetry sinks.  Every lifecycle transition (submitted → admitted →
  per-chunk prefill → first token → decode/verify ticks → preempted /
  replayed → finished) lands as a SPAN event in the graph's lock-free
  :class:`~repro_torch.core.tracer.Tracer` ring AND as counters/histograms in
  a :class:`~repro_torch.core.metrics.MetricsRegistry`.  Under
  ``repro_torch.core.tracer.COMPILED_OUT`` the scheduler holds
  :data:`NULL_OBSERVER` instead (``enabled`` False), so the hot path
  carries no clock reads at all.

* :class:`RequestTimeline` — reconstructs per-request lifecycles from
  the SPAN events: one Perfetto track per request
  (:meth:`RequestTimeline.export_perfetto`) plus a JSON lifecycle
  record per request (:meth:`RequestTimeline.records`) answering "why
  was THIS request's TTFT 40ms".

* :class:`FlightRecorder` — on an incident (``cache_pressure``,
  ``preemption``, ``deadline_miss``, ``executor_error``) dumps the
  last-N trace events + a metrics snapshot + sanitized scheduler state
  into a provenance-stamped run directory
  (``GraphServer(observe_dir=...)``), rate-limited so pressure storms
  don't flood the disk.

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


# ---------------------------------------------------------------------------
# Timeline reconstruction
# ---------------------------------------------------------------------------

#: phase -> label of the segment it OPENS on the request's track
_SEGMENT_AFTER = {"submitted": "queued", "admitted": "prefill",
                  "first_token": "decode", "preempted": "requeued"}
_INSTANT_PHASES = {"chunk", "verify", "preempted", "replayed", "pressure",
                   "token"}


class RequestTimeline:
    """Per-request lifecycle reconstruction from SPAN events.

    Build with :meth:`from_tracer` (or from a loaded trace file's
    events); render with :meth:`records` (JSON lifecycle dicts) or
    :meth:`export_perfetto` (one named track per request).
    """

    def __init__(self, events: List[trace_mod.TraceEvent]):
        self._by_req: Dict[str, List[trace_mod.TraceEvent]] = {}
        for e in events:
            if e.event_type != trace_mod.SPAN:
                continue
            phase, rid = parse_span(e.stream_id)
            if not rid:
                continue
            self._by_req.setdefault(rid, []).append(e)
        for evs in self._by_req.values():
            evs.sort(key=lambda e: e.event_time)

    @classmethod
    def from_tracer(cls, tracer) -> "RequestTimeline":
        return cls(tracer.events())

    def request_ids(self) -> List[str]:
        return sorted(self._by_req)

    # -- JSON lifecycle records ------------------------------------------
    def records(self) -> List[Dict[str, Any]]:
        out = []
        for rid in self.request_ids():
            evs = self._by_req[rid]
            rec: Dict[str, Any] = {
                "id": rid, "finish_reason": None,
                "submitted_ms": None, "admitted_ms": None,
                "first_token_ms": None, "finished_ms": None,
                "queue_wait_ms": None, "ttft_ms": None, "total_ms": None,
                "tokens": 0, "chunks": 0, "verify_ticks": 0,
                "accepted_total": 0, "preemptions": 0,
                "replayed_tokens": 0, "pressure_events": 0,
                "events": [],
            }
            for e in evs:
                phase, _ = parse_span(e.stream_id)
                t_ms = e.event_time / 1e6
                base, _, detail = phase.partition(":")
                rec["events"].append({"t_ms": t_ms, "phase": phase,
                                      "seq": e.packet_timestamp,
                                      "value": e.packet_data_id})
                if base == "submitted" and rec["submitted_ms"] is None:
                    rec["submitted_ms"] = t_ms
                elif base == "admitted" and rec["admitted_ms"] is None:
                    rec["admitted_ms"] = t_ms
                elif base == "first_token":
                    rec["first_token_ms"] = t_ms
                    rec["tokens"] += 1
                elif base == "token":
                    rec["tokens"] += 1
                elif base == "chunk":
                    rec["chunks"] += 1
                elif base == "verify":
                    rec["verify_ticks"] += 1
                    rec["accepted_total"] += e.packet_data_id
                elif base == "preempted":
                    rec["preemptions"] += 1
                elif base == "replayed":
                    rec["replayed_tokens"] += e.packet_timestamp
                elif base == "pressure":
                    rec["pressure_events"] += 1
                elif base == "finished":
                    rec["finished_ms"] = t_ms
                    rec["finish_reason"] = detail or "unknown"
            if rec["submitted_ms"] is not None:
                if rec["admitted_ms"] is not None:
                    rec["queue_wait_ms"] = \
                        rec["admitted_ms"] - rec["submitted_ms"]
                if rec["first_token_ms"] is not None:
                    rec["ttft_ms"] = \
                        rec["first_token_ms"] - rec["submitted_ms"]
                if rec["finished_ms"] is not None:
                    rec["total_ms"] = \
                        rec["finished_ms"] - rec["submitted_ms"]
            out.append(rec)
        return out

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump({"requests": self.records()}, f, indent=2,
                      sort_keys=True)

    # -- Perfetto export --------------------------------------------------
    def export_perfetto(self, path: str, pid: int = 1) -> None:
        """One track (tid) per request: X slices for the lifecycle
        segments (queued / prefill / decode / requeued), instants for
        chunk ingests, verify ticks, preemptions and replays."""
        out: List[Dict[str, Any]] = [
            {"ph": "M", "name": "process_name", "pid": pid,
             "args": {"name": "requests"}}]
        for tid, rid in enumerate(self.request_ids()):
            out.append({"ph": "M", "name": "thread_name", "pid": pid,
                        "tid": tid, "args": {"name": f"req {rid}"}})
            seg_label: Optional[str] = None
            seg_t0 = 0.0
            for e in self._by_req[rid]:
                phase, _ = parse_span(e.stream_id)
                base, _, detail = phase.partition(":")
                ts_us = e.event_time / 1e3
                closes = base in _SEGMENT_AFTER or base == "finished"
                if closes and seg_label is not None:
                    out.append({"ph": "X", "pid": pid, "tid": tid,
                                "name": seg_label, "cat": "lifecycle",
                                "ts": seg_t0, "dur": ts_us - seg_t0,
                                "args": {}})
                    seg_label = None
                if base in _SEGMENT_AFTER:
                    seg_label = _SEGMENT_AFTER[base]
                    seg_t0 = ts_us
                if base in _INSTANT_PHASES or base == "finished":
                    out.append({"ph": "i", "s": "t", "pid": pid,
                                "tid": tid, "name": phase,
                                "cat": "lifecycle", "ts": ts_us,
                                "args": {"seq": e.packet_timestamp,
                                         "value": e.packet_data_id}})
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

def run_provenance(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Best-effort provenance stamp (git sha, interpreter, argv, time)."""
    sha = None
    try:
        import subprocess
        sha = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=5, cwd=os.path.dirname(os.path.abspath(__file__)),
        ).stdout.strip() or None
    except Exception:
        pass
    return {
        "git_sha": sha,
        "python": sys.version.split()[0],
        "argv": list(sys.argv if argv is None else argv),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
    }


class FlightRecorder:
    """Dumps a postmortem artifact per incident into ``out_dir``.

    Rate limiting: at most ``max_dumps`` incidents per run and at most
    one per ``min_interval_s`` per trigger kind (a pressure storm during
    a long ingest would otherwise write hundreds of identical files);
    suppressed incidents are counted, not lost silently.
    """

    TRIGGERS = ("cache_pressure", "preemption", "deadline_miss",
                "executor_error")

    def __init__(self, out_dir: str, *, last_n: int = 512,
                 max_dumps: int = 8, min_interval_s: float = 1.0,
                 registry: Optional[MetricsRegistry] = None,
                 mesh: Optional[Dict[str, Any]] = None):
        self.out_dir = out_dir
        self.last_n = int(last_n)
        self.max_dumps = int(max_dumps)
        self.min_interval_s = float(min_interval_s)
        # serving-mesh shape (docs/SHARDING.md) — stamped into every
        # incident so multi-device postmortems identify their topology
        self.mesh = dict(mesh) if mesh is not None else \
            {"devices": 1, "axes": {}}
        self._dumps = 0
        self._last_by_trigger: Dict[str, float] = {}
        self._events_fn: Callable[[], list] = list
        self._metrics_fn: Callable[[], dict] = dict
        self._state_fn: Callable[[], dict] = dict
        self._provenance = run_provenance()
        reg = registry if registry is not None else NullRegistry()
        self._c_dumps = reg.counter(
            "observe.flight_dumps", "incident files written")
        self._c_suppressed = reg.counter(
            "observe.flight_dumps_suppressed",
            "incidents skipped by rate limiting")

    def bind(self, *, events_fn=None, metrics_fn=None, state_fn=None) -> None:
        """Late-bind the snapshot providers (the scheduler exists only
        after the graph opens its engine node)."""
        if events_fn is not None:
            self._events_fn = events_fn
        if metrics_fn is not None:
            self._metrics_fn = metrics_fn
        if state_fn is not None:
            self._state_fn = state_fn

    @property
    def incident_dir(self) -> str:
        return os.path.join(self.out_dir, "incidents")

    def incident(self, trigger: str, detail: str = "") -> Optional[str]:
        """Write one postmortem file; returns its path (None when rate
        limited or on a write failure — an incident dump must never take
        the serving path down with it)."""
        now = time.monotonic()
        last = self._last_by_trigger.get(trigger)
        if self._dumps >= self.max_dumps or (
                last is not None and now - last < self.min_interval_s):
            self._c_suppressed.inc(trigger=trigger)
            return None
        self._last_by_trigger[trigger] = now
        self._dumps += 1
        seq = self._dumps
        try:
            events = [list(e) for e in self._events_fn()[-self.last_n:]]
            doc = {
                "trigger": trigger,
                "detail": detail,
                "seq": seq,
                "wall_time": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
                "mesh": self.mesh,
                "provenance": self._provenance,
                "events": events,
                "metrics": self._metrics_fn(),
                "scheduler": self._state_fn(),
            }
            os.makedirs(self.incident_dir, exist_ok=True)
            path = os.path.join(self.incident_dir,
                                f"incident-{seq:03d}-{trigger}.json")
            with open(path, "w") as f:
                json.dump(doc, f, indent=2, sort_keys=True, default=str)
        except Exception:
            return None
        self._c_dumps.inc(trigger=trigger)
        return path


# ---------------------------------------------------------------------------
# Run export
# ---------------------------------------------------------------------------

def export_run(out_dir: str, *, tracer, node_names=None,
               registry: Optional[MetricsRegistry] = None,
               argv: Optional[List[str]] = None) -> Dict[str, str]:
    """Write the full observability artifact set for one serve run:

    ``trace.json`` (graph chrome trace), ``requests.perfetto.json``
    (one track per request), ``timelines.json`` (JSON lifecycle
    records), ``metrics.json`` / ``metrics.prom`` (registry snapshot /
    Prometheus text), ``provenance.json``.  Returns {artifact: path}.
    """
    os.makedirs(out_dir, exist_ok=True)
    paths: Dict[str, str] = {}

    def _p(name: str) -> str:
        paths[name] = os.path.join(out_dir, name)
        return paths[name]

    tracer.export_chrome_trace(_p("trace.json"), node_names or {})
    tl = RequestTimeline.from_tracer(tracer)
    tl.export_perfetto(_p("requests.perfetto.json"))
    tl.to_json(_p("timelines.json"))
    reg = registry if registry is not None else MetricsRegistry()
    with open(_p("metrics.json"), "w") as f:
        f.write(reg.snapshot_json())
    with open(_p("metrics.prom"), "w") as f:
        f.write(reg.to_prometheus())
    with open(_p("provenance.json"), "w") as f:
        json.dump(run_provenance(argv), f, indent=2, sort_keys=True)
    return paths
