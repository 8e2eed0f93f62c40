"""GraphServer — multi-request LLM serving on the MediaPipe graph runtime.

The server owns a continuous-batching graph
(:func:`repro_torch.serving.pipeline.build_continuous_serving_graph`): concurrent
``submit`` calls feed request packets into the graph input stream, a
``FlowLimiterCalculator`` admits them under ``max_in_flight``, the
``ContinuousBatchCalculator`` inserts them into a running slot-based decode
batch, and generated tokens come back through an ``OutputStreamPoller`` on
the ``tokens`` stream that a background dispatcher thread routes to
:class:`RequestHandle`s (the ``responses`` stream feeds the limiter's
FINISHED loopback).

    engine = LLMEngine(cfg, max_len=128)
    with GraphServer(engine, num_slots=4) as server:
        h = server.submit([1, 2, 3], max_new_tokens=8)
        for tok in h.stream():       # tokens as they are generated
            ...
        tokens = h.result()          # the full generation, np.int32 [n]

Determinism: greedy decode through the server is bit-identical to
``LLMEngine.generate`` one request at a time — prefill batches group only
equal-length prompts (no padding) and every decode-batch row op is
row-independent.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np

from ..core.graph import Graph, OutputStreamPoller
from ..core.metrics import MetricsRegistry
from .batching import DeadlineExceeded
from .engine import LLMEngine
from .kvcache.backend import max_request_tokens
from .observe import FlightRecorder, export_run
from .pipeline import build_continuous_serving_graph


class RequestHandle:
    """Client-side handle to one in-flight generation request.

    A request can end without a final token: cancellation
    (:meth:`cancel` / server-side disconnect) or a missed deadline.
    :meth:`stream` then simply ends and :meth:`result` returns the
    tokens generated so far — check :attr:`finish_reason`
    (``"cancelled"`` / ``"deadline"`` vs ``"eos"`` / ``"length"``)."""

    _END = object()

    def __init__(self, request_id: Any, server: "GraphServer" = None):
        self.id = request_id
        self._server = server
        self._events: "queue.Queue" = queue.Queue()
        self._done = threading.Event()
        self._mutex = threading.Lock()
        self._tokens: List[int] = []
        self._listeners: List[Callable[[Optional[int], bool, str],
                                       None]] = []
        self._result: Optional[np.ndarray] = None
        self._finish_reason = ""
        self._error: Optional[BaseException] = None
        #: scheduler-side per-request metrics record (TTFT, queue wait,
        #: accepted/drafted, preemptions ...), set with the final token —
        #: see docs/OBSERVABILITY.md
        self.metrics: Optional[Dict[str, Any]] = None

    # -- fed by the server's dispatcher thread (one thread: the TOKEN
    # stream is the single source of truth, so tokens and completion can
    # never be observed out of order) ----------------------------------
    def _on_token(self, token: Optional[int], finished: bool,
                  reason: str, metrics: Optional[Dict[str, Any]] = None
                  ) -> None:
        with self._mutex:
            if token is not None:
                self._tokens.append(token)
                self._events.put(token)
            if finished:
                self._result = np.asarray(self._tokens, np.int32)
                self._finish_reason = reason
                if metrics is not None:
                    self.metrics = metrics
                self._events.put(self._END)
                self._done.set()
            for fn in self._listeners:
                fn(token, finished, reason)

    def _on_error(self, err: BaseException) -> None:
        with self._mutex:
            if self._done.is_set():
                return
            self._error = err
            self._events.put(self._END)
            self._done.set()
            for fn in self._listeners:
                fn(None, True, "error")

    def add_listener(self, fn: Callable[[Optional[int], bool, str],
                                        None]) -> None:
        """Register ``fn(token, finished, reason)`` to be called for
        every event on this request (from the server's dispatcher
        thread — keep it non-blocking, e.g. ``call_soon_threadsafe``).
        Events that arrived before registration are replayed first, so a
        listener attached after :meth:`GraphServer.submit` returns never
        misses a token; a replayed completion arrives as a token-less
        ``(None, True, reason)`` event."""
        with self._mutex:
            for t in self._tokens:
                fn(t, False, "")
            if self._done.is_set():
                fn(None, True,
                   "error" if self._error is not None
                   else self._finish_reason)
                return
            self._listeners.append(fn)

    # -- client API ----------------------------------------------------
    def stream(self, timeout: Optional[float] = 120.0) -> Iterator[int]:
        """Yield generated token ids as they arrive, until completion."""
        while True:
            ev = self._events.get(timeout=timeout)
            if ev is self._END:
                if self._error is not None:
                    raise RuntimeError(
                        f"request {self.id!r} failed") from self._error
                return
            yield ev

    def result(self, timeout: Optional[float] = 120.0) -> np.ndarray:
        """Block until finished; returns the generated tokens [n] int32."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"request {self.id!r} not finished "
                               f"after {timeout}s")
        if self._error is not None:
            raise RuntimeError(f"request {self.id!r} failed") from self._error
        return self._result

    @property
    def finish_reason(self) -> str:
        return self._finish_reason

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Ask the server to cancel this request (idempotent; safe after
        completion — the post-EOS race is a no-op).  Returns True if the
        request was still pending when the cancel was sent."""
        if self._server is None or self._done.is_set():
            return False
        return self._server.cancel(self.id)


class GraphServer:
    """Continuous-batching LLM server over the graph runtime.

    Thread-safe: ``submit`` may be called from any number of client
    threads.

    Overload behaviour: with ``drop_on_overload=True`` the limiter keeps
    **no** waiting queue (``queue_size`` is ignored) and sheds every
    request beyond ``max_in_flight`` upstream of prefill, mirroring the
    paper's real-time pipelines where stale frames are simply discarded.
    With the default ``drop_on_overload=False`` requests wait in the
    limiter's queue, but a burst beyond ``max_in_flight + queue_size``
    outstanding is still shed.  Either way a shed request's handle stays
    unresolved until :meth:`close` fails it (poll :meth:`stats` for the
    drop count).
    """

    def __init__(self, engine: LLMEngine, *, num_slots: int = 4,
                 max_in_flight: int = 0, queue_size: int = 1024,
                 max_new_tokens: int = 16, eos_id: Optional[int] = None,
                 drop_on_overload: bool = False, enable_tracer: bool = True,
                 chunk_size: Optional[int] = None,
                 speculate_k: int = 0, spec_ngram: int = 3,
                 paged: bool = False, num_blocks: int = 0,
                 block_size: int = 16, prefix_sharing: bool = True,
                 admission: str = "preempt", watermark: int = 0,
                 backend: Optional[str] = None, spec_window: int = 8,
                 observe_dir: Optional[str] = None,
                 flight_max_dumps: int = 8):
        self.engine = engine
        self.observe_dir = observe_dir
        self._default_max_new = max_new_tokens
        # "backend" names the layout outright ("slot" | "paged" | "state"
        # | "hybrid") and wins over the legacy paged flag; "state" serves
        # recurrent/mixed stacks from O(1) state slabs, "hybrid" pages
        # attention K/V alongside them (docs/STATE_CACHE.md)
        kind = backend if backend is not None else \
            ("paged" if paged else "slot")
        self._backend_kind = kind
        if speculate_k:
            # fail in the caller's thread, not inside the graph run
            engine.check_spec_support(kind)
        self._paged = kind in ("paged", "hybrid")   # block-math capacity
        self._block_size = block_size
        if self._paged:
            if num_blocks <= 0:
                # arena sized to num_slots worst-case rows by default —
                # the same memory the slot cache would have used.  Under
                # a serving mesh the arena's K/V leaves are sharded
                # across TP ranks, so at fixed PER-RANK memory the pool
                # holds cache_shards() times as many blocks: capacity
                # scales with the mesh (docs/SHARDING.md)
                num_blocks = 1 + engine.cache_shards() * num_slots * \
                    (engine.max_len // block_size)
            if max_in_flight <= 0:
                # The limiter bounds scheduling burst; REAL memory
                # admission is the paged backend's block-availability
                # check.  A request that cannot take its blocks waits
                # inside the engine subsystem holding its limiter budget,
                # so sustained block pressure backs up into the limiter
                # and on to submitters.  The default is therefore at
                # least as permissive as slot mode, plus however many
                # worst-case rows the arena actually holds (a big arena
                # should admit more than 2*num_slots).
                max_in_flight = max(
                    2 * num_slots,
                    (num_blocks - 1) // (engine.max_len // block_size))
        self._num_blocks = num_blocks
        cfg = build_continuous_serving_graph(
            num_slots=num_slots, max_in_flight=max_in_flight,
            queue_size=queue_size, max_new_tokens=max_new_tokens,
            eos_id=eos_id, drop_on_overload=drop_on_overload,
            enable_tracer=enable_tracer, chunk_size=chunk_size,
            speculate_k=speculate_k, spec_ngram=spec_ngram,
            paged=paged, num_blocks=num_blocks, block_size=block_size,
            prefix_sharing=prefix_sharing, admission=admission,
            watermark=watermark, backend=backend,
            spec_window=spec_window)
        self.graph = Graph(cfg, side_packets={"engine": engine})
        self._token_poller = self.graph.add_output_stream_poller("tokens")
        self._handles: Dict[Any, RequestHandle] = {}
        self._lock = threading.Lock()
        self._ts = itertools.count()
        self._ctrl_ts = itertools.count()
        self._auto_id = itertools.count()
        self._closed = False
        self._final_stats: Dict[str, Any] = {}
        self.graph.start_run()
        # start_run opens calculators on executor threads; block until
        # the engine node's open() (scheduler + device cache
        # construction) lands so stats() deterministically reports the
        # scheduler counters from the moment the constructor returns —
        # and so a backend/arch mismatch raises here, not on first use
        engine_node = next(n for n in self.graph.nodes
                           if n.name == "engine")
        deadline = time.monotonic() + 300.0
        while not hasattr(engine_node.calculator, "sched"):
            self.graph._check_error()
            if time.monotonic() > deadline:
                raise RuntimeError(
                    "engine calculator did not finish opening")
            time.sleep(0.001)
        self._engine_calc = engine_node.calculator
        # flight recorder (docs/OBSERVABILITY.md): incidents dump the
        # last-N trace events + metrics + scheduler state to observe_dir
        self._recorder: Optional[FlightRecorder] = None
        if observe_dir is not None:
            obs = getattr(self._engine_calc, "observer", None)
            rec = FlightRecorder(
                observe_dir, max_dumps=flight_max_dumps,
                registry=obs.registry if obs is not None else None,
                mesh=engine.mesh_desc)
            rec.bind(events_fn=self.graph.tracer.events,
                     metrics_fn=self.metrics,
                     state_fn=self._engine_calc.sched.debug_state)
            if obs is not None and obs.enabled:
                # NULL_OBSERVER is a shared singleton: never mutate it
                obs.recorder = rec
            self._recorder = rec
        self._threads = [
            threading.Thread(target=self._pump_tokens, daemon=True,
                             name="graphserver-tokens"),
        ]
        for t in self._threads:
            t.start()

    # -- client API ----------------------------------------------------
    def submit(self, tokens, max_new_tokens: Optional[int] = None,
               eos_id: Optional[int] = None, priority: int = 0,
               speculate_k: Optional[int] = None,
               deadline_ms: Optional[float] = None,
               ttft_ms: Optional[float] = None,
               request_id: Any = None) -> RequestHandle:
        """Enqueue one generation request; returns immediately.

        ``priority``: higher values are admitted first and preempted
        last (paged backend under block pressure).

        ``speculate_k``: per-request speculative draft budget (overrides
        the server default; 0 disables speculation for this request —
        see docs/SPECULATIVE.md).

        ``deadline_ms`` / ``ttft_ms``: SLO budgets relative to this call
        — the whole request / the first token must land within that many
        milliseconds or the request is terminated with
        ``finish_reason="deadline"`` (tokens streamed so far stay
        valid).  A TTFT target also lets the request preempt a
        strictly-lower-priority active one when no slot is free
        (docs/FRONTEND.md).  A non-positive budget raises
        :class:`DeadlineExceeded` here, client-side; the graph payload
        carries the *absolute* times, so a budget that expires while the
        request sits in the admission queue becomes a ``deadline``
        completion, never a graph error.

        Invalid requests are rejected here, client-side — an error thrown
        inside a graph node would terminate the whole run.  The check
        mirrors ``Scheduler.submit``: the cap is the backend's REAL
        capacity (paged: arena blocks, not just engine max_len)."""
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        slo: Dict[str, float] = {}
        now = None
        for key, rel in (("deadline", deadline_ms),
                         ("ttft_deadline", ttft_ms)):
            if rel is None:
                continue
            rel = float(rel)
            if rel <= 0:
                raise DeadlineExceeded(
                    f"request {request_id!r}: "
                    f"{'deadline_ms' if key == 'deadline' else 'ttft_ms'}"
                    f"={rel:g} is already expired at submit")
            now = time.monotonic() if now is None else now
            slo[key] = now + rel / 1e3
        if speculate_k is not None:
            if int(speculate_k) < 0:
                raise ValueError(f"speculate_k must be >= 0, "
                                 f"got {int(speculate_k)}")
            if int(speculate_k) > 0:
                self.engine.check_spec_support(self._backend_kind)
        new = self._default_max_new if max_new_tokens is None \
            else int(max_new_tokens)
        if tokens.size == 0:
            raise ValueError("empty prompt")
        # state slabs are O(1) per request, so the state backend's only
        # bound is engine max_len (num_blocks=0 skips the block math);
        # hybrid keeps the block math for its attention layers
        cap = max_request_tokens(
            self.engine.max_len,
            self._num_blocks if self._paged else 0, self._block_size)
        if tokens.size + new > cap:
            detail = f"engine max_len ({self.engine.max_len})" \
                if not self._paged else \
                (f"backend capacity ({cap} tokens: "
                 f"{self._num_blocks - 1} usable blocks x "
                 f"{self._block_size}, engine max_len "
                 f"{self.engine.max_len})")
            raise ValueError(
                f"prompt ({tokens.size}) + max_new_tokens ({new}) "
                f"exceeds {detail}")
        with self._lock:
            if self._closed:
                raise RuntimeError("server is closed")
            if request_id is None:
                request_id = f"req-{next(self._auto_id)}"
            if request_id in self._handles:
                raise ValueError(f"duplicate request id {request_id!r}")
            handle = RequestHandle(request_id, self)
            self._handles[request_id] = handle
            payload = {"tokens": tokens, "id": request_id}
            payload.update(slo)
            if max_new_tokens is not None:
                payload["max_new_tokens"] = int(max_new_tokens)
            if eos_id is not None:
                payload["eos_id"] = int(eos_id)
            if priority:
                payload["priority"] = int(priority)
            if speculate_k is not None:
                payload["speculate_k"] = int(speculate_k)
            # feed the graph under the server lock: stream timestamps must
            # be added in allocation order or a faster thread would trip
            # the monotonicity check.  (The requests edge is unbounded, so
            # this never blocks on back-pressure.)
            self.graph.add_packet_to_input_stream("requests", payload,
                                                  next(self._ts))
        return handle

    def generate(self, tokens, max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 timeout: Optional[float] = 120.0) -> np.ndarray:
        """Blocking convenience wrapper: submit + result."""
        return self.submit(tokens, max_new_tokens, eos_id).result(timeout)

    def cancel(self, request_id: Any) -> bool:
        """Cancel a request at any lifecycle point (queued in the
        limiter, waiting for a slot, mid-prefill-chunk, mid-decode,
        between speculative verify ticks).  The cancel travels on the
        graph's ``control`` input stream, which bypasses the flow
        limiter — it gets through even (especially) when the admission
        queue is full.  The request's handle completes with
        ``finish_reason="cancelled"`` and whatever tokens were already
        streamed; all of its cache memory (slot row / blocks / trie
        refs) is released.  Idempotent; cancelling an id that already
        finished (the post-EOS race) is a no-op.  Returns True if the
        request was still pending when the cancel was sent."""
        with self._lock:
            if self._closed:
                return False
            pending = request_id in self._handles
            # under the lock for the same timestamp-monotonicity reason
            # as submit (the control edge is unbounded: never blocks)
            self.graph.add_packet_to_input_stream(
                "control", {"op": "cancel", "id": request_id},
                next(self._ctrl_ts))
        return pending

    def stats(self) -> Dict[str, Any]:
        """Limiter + scheduler counters (live)."""
        out: Dict[str, Any] = {}
        for node in self.graph.nodes:
            if node.name == "limiter":
                limiter = node.calculator
                out["admitted"] = getattr(limiter, "admitted", 0)
                out["dropped"] = getattr(limiter, "dropped", 0)
                out["in_flight"] = getattr(limiter, "in_flight", 0)
            elif node.name == "engine":
                sched = getattr(node.calculator, "sched", None)
                if sched is not None:
                    out["scheduler"] = dict(sched.stats)
                    pool = getattr(sched, "pool", None)
                    if pool is not None:
                        out["block_pool"] = dict(
                            pool.stats, num_blocks=pool.num_blocks,
                            block_size=pool.block_size,
                            in_use=pool.blocks_in_use,
                            free=pool.free_blocks,
                            reserved=pool.reserved_blocks)
        return out

    def metrics_registry(self) -> MetricsRegistry:
        """Merged view of the engine's profiling registry and the
        scheduler observer's lifecycle registry (both log-bucketed, so
        the merge is lossless — docs/OBSERVABILITY.md)."""
        regs = [self.engine.metrics]
        obs = getattr(self._engine_calc, "observer", None)
        if obs is not None:
            regs.append(obs.registry)
        return MetricsRegistry.merged(regs)

    def metrics(self) -> Dict[str, Any]:
        """JSON-serialisable snapshot of every counter/gauge/histogram
        (TTFT, ITL, queue wait, batch occupancy, kernel paths ...)."""
        return self.metrics_registry().snapshot()

    def metrics_text(self) -> str:
        """The same snapshot in Prometheus text exposition format."""
        return self.metrics_registry().to_prometheus()

    def dump_observability(self, out_dir: Optional[str] = None
                           ) -> Dict[str, str]:
        """Export the run's full observability artifact set (chrome
        trace, per-request Perfetto tracks, JSON timelines, metrics
        snapshot + Prometheus text, provenance) to ``out_dir`` (defaults
        to the server's ``observe_dir``).  Callable live or after
        :meth:`close`.  Returns {artifact name: path}."""
        out_dir = out_dir if out_dir is not None else self.observe_dir
        if out_dir is None:
            raise ValueError("no output directory: pass out_dir or "
                             "construct the server with observe_dir=")
        return export_run(out_dir, tracer=self.graph.tracer,
                          node_names=self.graph.node_names(),
                          registry=self.metrics_registry())

    def close(self, timeout: float = 300.0) -> Dict[str, Any]:
        """Stop accepting requests, drain in-flight work, stop the graph.
        Returns the final :meth:`stats` snapshot."""
        with self._lock:
            if self._closed:
                return self._final_stats
            self._closed = True
        self.graph.close_all_input_streams()
        try:
            self.graph.wait_until_done(timeout=timeout)
        finally:
            for t in self._threads:
                t.join(timeout=10.0)
            self._fail_pending(RuntimeError("server closed"))
        self._final_stats = self.stats()
        return self._final_stats

    def __enter__(self) -> "GraphServer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- dispatchers ----------------------------------------------------
    def _handle_of(self, rid: Any) -> Optional[RequestHandle]:
        with self._lock:
            return self._handles.get(rid)

    def _pump_tokens(self) -> None:
        self._pump(self._token_poller, self._dispatch_token)

    def _pump(self, poller: OutputStreamPoller, dispatch) -> None:
        try:
            while True:
                pkt = poller.next(timeout=None)
                if pkt is None:          # stream closed and drained
                    # a failed run closes every poller too: raise its
                    # error, so the requests in flight fail with it
                    # instead of waiting for their timeout
                    self.graph._check_error()
                    return
                dispatch(pkt.payload)
        except BaseException as e:       # graph error: fail fast
            if self._recorder is not None:
                self._recorder.incident("executor_error",
                                        f"{type(e).__name__}: {e}")
            self._fail_pending(e)

    def _dispatch_token(self, payload: Dict[str, Any]) -> None:
        h = self._handle_of(payload["id"])
        if h is not None:
            h._on_token(payload["token"], payload["finished"],
                        payload.get("finish_reason", ""),
                        payload.get("metrics"))
            if payload["finished"]:
                # prune: the handle owns its result now; keeping it in the
                # server map would grow memory forever on a long-lived
                # server and block the id from ever being reused
                with self._lock:
                    self._handles.pop(payload["id"], None)

    def _fail_pending(self, err: BaseException) -> None:
        with self._lock:
            handles = list(self._handles.values())
        for h in handles:
            h._on_error(err)
