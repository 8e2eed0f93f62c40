"""Graph runtime (paper §3.5, §4.1).

All processing takes place within the context of a Graph: nodes joined by
directed stream connections, a scheduler with one priority queue per
executor, decentralized timestamp-bound-driven readiness, back-pressure with
deadlock relaxation, side packets, graph input streams and output
observation/polling.

Threading model: all scheduling state is mutated under a single graph lock;
calculator code (open/process/close) runs *outside* the lock on executor
threads.  Each node runs on at most one thread at a time unless its contract
raises ``max_in_flight`` (paper footnote 1).
"""
from __future__ import annotations

import collections
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from . import tracer as trace_mod
from .calculator import Calculator, CalculatorContext, InputSet, SourceCalculator
from .contract import CalculatorContract
from .executor import Executor
from .graph_config import ExecutorConfig, GraphConfig, NodeConfig, expand_subgraphs
from .input_policy import InputPolicy, make_input_policy
from .packet import Packet, make_packet
from .registry import get_calculator
from .stream import InputStreamQueue, StreamError
from .timestamp import Timestamp, ts
from .tracer import NullTracer, Tracer
from .validation import node_contract, topological_priorities, validate

_packet_ids = itertools.count(1)


class GraphError(RuntimeError):
    pass


class _NodeRuntime:
    """Runtime state of one graph node."""

    # lifecycle states
    UNOPENED, OPENED, CLOSED = range(3)

    def __init__(self, index: int, config: NodeConfig,
                 contract: CalculatorContract, graph: "Graph"):
        self.index = index
        self.config = config
        self.contract = contract
        self.graph = graph
        self.name = config.display_name(index)
        self.calculator: Calculator = get_calculator(config.calculator)()
        self.is_source = not config.inputs
        self.state = self.UNOPENED
        self.source_finished = False
        self.scheduled = 0      # tasks queued on the executor for this node
        self.in_flight = 0      # process/open/close calls currently running
        self.max_in_flight = (config.max_in_flight or contract.max_in_flight)
        policy_spec = config.input_policy or contract.input_policy
        self.policy: InputPolicy = make_input_policy(policy_spec)
        self.options: Dict[str, Any] = dict(config.options)
        # timestamp_offset: if not None, after processing timestamp T every
        # output stream's bound advances to T+offset+1 (lets filtering nodes
        # keep downstream default-policy joins settled).
        toff = self.options.get("timestamp_offset",
                                getattr(contract, "timestamp_offset", None))
        self.timestamp_offset: Optional[int] = toff
        self.priority = 0
        self.executor_name = config.executor or "default"
        # wiring (filled by Graph)
        self.input_queues: Dict[str, InputStreamQueue] = {}
        # port -> list of downstream InputStreamQueue
        self.consumers: Dict[str, List[InputStreamQueue]] = \
            {p: [] for p in config.outputs}
        # port -> stream name
        self.output_streams: Dict[str, str] = dict(config.outputs)
        self.closed_outputs: set = set()
        self.input_side_packets: Dict[str, Packet] = {}
        self.output_names = list(config.outputs)
        self.ctx = CalculatorContext(self)

    # ---- called from calculator code (any executor thread) ---------------
    def emit(self, port: str, packet: Packet) -> None:
        self.graph._emit(self, port, packet)

    def advance_bound(self, port: str, bound: Timestamp) -> None:
        self.graph._advance_bound(self, port, bound)

    def close_output(self, port: str) -> None:
        self.graph._close_output(self, port)

    def emit_side_packet(self, name: str, payload: Any) -> None:
        side_name = self.config.output_side_packets.get(name)
        if side_name is None:
            raise KeyError(f"node {self.name!r}: undeclared output side "
                           f"packet {name!r}")
        self.graph._set_side_packet(side_name, payload)

    # ---- scheduling predicates (graph lock held) --------------------------
    def side_packets_available(self) -> bool:
        for port, side_name in self.config.input_side_packets.items():
            spec = self.contract.input_side_packets.get(port)
            optional = spec.optional if spec else False
            if not optional and side_name not in self.graph._side_packets:
                return False
        return True

    def throttled(self) -> bool:
        for qs in self.consumers.values():
            for q in qs:
                if q.is_full():
                    return True
        return False

    def inputs_done(self) -> bool:
        return all(q.is_done() for q in self.input_queues.values())

    def ready_timestamp(self) -> Optional[Timestamp]:
        return self.policy.ready_timestamp(self.input_queues)


class OutputStreamPoller:
    """Pull interface to a graph output stream (paper §3.5: 'poll any output
    streams via output stream polling functions')."""

    def __init__(self, stream: str):
        self.stream = stream
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False

    def _push(self, packet: Packet) -> None:
        with self._cv:
            self._q.append(packet)
            self._cv.notify()

    def _close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def next(self, timeout: Optional[float] = 30.0) -> Optional[Packet]:
        """Next packet, or None once the stream is closed and drained."""
        with self._cv:
            while not self._q and not self._closed:
                if not self._cv.wait(timeout):
                    raise TimeoutError(f"poller on {self.stream!r} timed out")
            return self._q.popleft() if self._q else None


class Graph:
    """Build with a GraphConfig, then either :meth:`run` (source-driven) or
    :meth:`start_run` + :meth:`add_packet_to_input_stream` +
    :meth:`close_all_input_streams` + :meth:`wait_until_done`."""

    def __init__(self, config: GraphConfig,
                 side_packets: Optional[Dict[str, Any]] = None):
        config = expand_subgraphs(config)
        self.config = config
        producers = validate(config)
        priorities = topological_priorities(config, producers)

        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._error: Optional[BaseException] = None
        self._error_node: str = ""
        self._started = False
        self._done = False
        self._active = 0  # scheduled + running tasks
        self._side_packets: Dict[str, Packet] = {}
        self._observers: Dict[str, List[Callable[[Packet], None]]] = {}
        self._pollers: Dict[str, List[OutputStreamPoller]] = {}
        self._graph_input_consumers: Dict[str, List[InputStreamQueue]] = \
            {s: [] for s in config.input_streams}
        self._graph_input_closed: Dict[str, bool] = \
            {s: False for s in config.input_streams}

        if trace_mod.COMPILED_OUT or not config.enable_tracer:
            self.tracer: Tracer = NullTracer()
        else:
            self.tracer = Tracer(config.trace_buffer_size)

        # ---- build nodes ----------------------------------------------
        self.nodes: List[_NodeRuntime] = []
        for i, nc in enumerate(config.nodes):
            node = _NodeRuntime(i, nc, node_contract(nc), self)
            node.priority = priorities[i]
            self.nodes.append(node)

        # ---- wire streams ------------------------------------------------
        default_q = config.max_queue_size
        for node in self.nodes:
            for port, stream in node.config.inputs.items():
                limit = node.config.max_queue_size
                if limit < 0:
                    limit = default_q
                q = InputStreamQueue(stream, node.name, port, limit)
                if port in node.config.back_edge_inputs or \
                        stream in node.config.back_edge_inputs:
                    # a back edge can't hold back readiness before the first
                    # downstream emission: start it settled at Min and never
                    # count it toward back-pressure.
                    q.max_queue_size = -1
                node.input_queues[port] = q
                prod = producers[stream]
                if prod[0] == -1:
                    self._graph_input_consumers[stream].append(q)
                else:
                    self.nodes[prod[0]].consumers[prod[1]].append(q)

        # ---- executors -----------------------------------------------------
        self._executors: Dict[str, Executor] = {}
        self._executors["default"] = Executor(
            "default", config.num_threads, self._run_task,
            on_error=self._executor_error)
        for e in config.executors:
            if e.name != "default":
                self._executors[e.name] = Executor(
                    e.name, e.num_threads, self._run_task,
                    on_error=self._executor_error)
        for node in self.nodes:
            if node.executor_name not in self._executors:
                raise GraphError(f"node {node.name!r} assigned to unknown "
                                 f"executor {node.executor_name!r}")

        if side_packets:
            for k, v in side_packets.items():
                self._side_packets[k] = make_packet(v, Timestamp.unset())

        self._node_names = {n.index: n.name for n in self.nodes}

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def observe_output_stream(self, stream: str,
                              callback: Callable[[Packet], None]) -> None:
        self._observers.setdefault(stream, []).append(callback)

    def add_output_stream_poller(self, stream: str) -> OutputStreamPoller:
        p = OutputStreamPoller(stream)
        self._pollers.setdefault(stream, []).append(p)
        return p

    def start_run(self, side_packets: Optional[Dict[str, Any]] = None) -> None:
        with self._lock:
            if self._started:
                raise GraphError("graph already started")
            self._started = True
            if side_packets:
                for k, v in side_packets.items():
                    self._side_packets[k] = make_packet(v, Timestamp.unset())
        for ex in self._executors.values():
            ex.start()
        with self._lock:
            for node in self.nodes:
                self._evaluate(node)

    def add_packet_to_input_stream(self, stream: str, payload: Any,
                                   timestamp) -> None:
        """Feed a packet into a graph input stream.  Blocks while any
        consumer queue is full (back-pressure extends to the application)."""
        packet = payload if isinstance(payload, Packet) else \
            make_packet(payload, timestamp)
        if not isinstance(payload, Packet):
            packet = make_packet(payload, ts(timestamp))
        with self._lock:
            if stream not in self._graph_input_consumers:
                raise GraphError(f"unknown graph input stream {stream!r}")
            if self._graph_input_closed[stream]:
                raise GraphError(f"graph input stream {stream!r} is closed")
            while any(q.is_full() for q in
                      self._graph_input_consumers[stream]):
                self._check_error()
                if not self._cv.wait(timeout=0.05):
                    self._relax_if_stalled()
            self._check_error()
            for q in self._graph_input_consumers[stream]:
                q.add(packet)
                self.tracer.record(trace_mod.PACKET_QUEUED, -1, stream,
                                   packet.timestamp.value, id(packet))
                self._evaluate(self._node_of_queue(q))

    def set_input_stream_bound(self, stream: str, bound) -> None:
        with self._lock:
            for q in self._graph_input_consumers[stream]:
                q.advance_bound(ts(bound))
                self._evaluate(self._node_of_queue(q))

    def close_input_stream(self, stream: str) -> None:
        with self._lock:
            if self._graph_input_closed.get(stream):
                return
            self._graph_input_closed[stream] = True
            for q in self._graph_input_consumers[stream]:
                q.close()
                self._evaluate(self._node_of_queue(q))
            self._maybe_done()

    def close_all_input_streams(self) -> None:
        for s in list(self._graph_input_consumers):
            self.close_input_stream(s)

    def wait_until_idle(self, timeout: float = 120.0) -> None:
        """Block until no task is scheduled or running and no node is ready
        (all pending data fully processed)."""
        with self._lock:
            deadline = threading.TIMEOUT_MAX if timeout is None else timeout
            import time as _t
            end = _t.monotonic() + deadline
            while True:
                self._check_error()
                if self._active == 0 and not self._any_ready():
                    return
                if not self._cv.wait(timeout=min(0.1, end - _t.monotonic())):
                    self._relax_if_stalled()
                if _t.monotonic() > end:
                    raise TimeoutError("graph did not become idle; "
                                       + self._stall_report())

    def wait_until_done(self, timeout: float = 300.0) -> None:
        import time as _t
        end = _t.monotonic() + timeout
        with self._lock:
            while not self._done:
                self._check_error()
                remaining = end - _t.monotonic()
                if remaining <= 0:
                    raise TimeoutError("graph run timed out; "
                                       + self._stall_report())
                if not self._cv.wait(timeout=min(0.1, remaining)):
                    self._relax_if_stalled()
            self._check_error()
        self._shutdown()

    def run(self, side_packets: Optional[Dict[str, Any]] = None,
            timeout: float = 300.0) -> None:
        """Single-shot run for graphs whose data originates at source nodes."""
        self.start_run(side_packets)
        self.close_all_input_streams()
        self.wait_until_done(timeout)

    def cancel(self) -> None:
        with self._lock:
            self._fail_locked(GraphError("graph run cancelled"), "<cancel>")

    def output_side_packet(self, name: str) -> Any:
        with self._lock:
            p = self._side_packets.get(name)
        if p is None:
            raise KeyError(f"side packet {name!r} was not produced")
        return p.payload

    # ------------------------------------------------------------------
    # internals — scheduling (call with lock held unless noted)
    # ------------------------------------------------------------------
    def _node_of_queue(self, q: InputStreamQueue) -> _NodeRuntime:
        for node in self.nodes:
            if node.name == q.consumer:
                return node
        raise KeyError(q.consumer)  # pragma: no cover

    def _any_ready(self) -> bool:
        return any(self._wants_task(n) for n in self.nodes)

    def _wants_task(self, node: _NodeRuntime) -> bool:
        """Would _evaluate schedule this node right now?"""
        if self._error is not None or node.state == node.CLOSED:
            return False
        slots = node.max_in_flight - node.scheduled - node.in_flight
        if slots <= 0:
            return False
        if node.state == node.UNOPENED:
            return node.side_packets_available() and \
                node.scheduled + node.in_flight == 0
        if node.is_source:
            return (not node.source_finished and not node.throttled()
                    and node.scheduled + node.in_flight == 0)
        if node.ready_timestamp() is not None:
            return not node.throttled()
        if node.inputs_done() and node.scheduled + node.in_flight == 0:
            return True
        return False

    def _evaluate(self, node: _NodeRuntime) -> None:
        if self._wants_task(node):
            node.scheduled += 1
            self._active += 1
            self.tracer.record(trace_mod.READY, node.index)
            self._executors[node.executor_name].submit(node.priority, node)

    def _check_error(self) -> None:
        if self._error is not None:
            raise GraphError(
                f"graph run failed in node {self._error_node!r}: "
                f"{self._error!r}") from self._error

    def _maybe_done(self) -> None:
        if self._done:
            return
        if all(n.state == n.CLOSED for n in self.nodes):
            self._done = True
            for pollers in self._pollers.values():
                for p in pollers:
                    p._close()
            self._cv.notify_all()

    def _stall_report(self) -> str:
        lines = []
        for n in self.nodes:
            qinfo = {p: (len(q), repr(q.bound), q.closed)
                     for p, q in n.input_queues.items()}
            lines.append(f"{n.name}: state={n.state} sched={n.scheduled} "
                         f"run={n.in_flight} throttled={n.throttled()} "
                         f"queues={qinfo}")
        return "stall state:\n" + "\n".join(lines)

    def _relax_if_stalled(self) -> None:
        """Deadlock-avoidance (paper §4.1.4): if nothing can run but some
        node is blocked solely by a full queue, relax that queue's limit."""
        if self._active > 0 or self._error is not None:
            return
        relaxed = False
        for node in self.nodes:
            blocked = (node.state != node.CLOSED and
                       ((node.is_source and not node.source_finished) or
                        node.ready_timestamp() is not None) and
                       node.throttled())
            if blocked:
                for qs in node.consumers.values():
                    for q in qs:
                        if q.is_full():
                            q.max_queue_size = max(q.max_queue_size * 2,
                                                   q.max_queue_size + 1)
                            relaxed = True
        # Also relax queues blocking graph-input writers.
        for stream, qs in self._graph_input_consumers.items():
            for q in qs:
                if q.is_full():
                    q.max_queue_size = max(q.max_queue_size * 2,
                                           q.max_queue_size + 1)
                    relaxed = True
        if relaxed:
            for node in self.nodes:
                self._evaluate(node)
            self._cv.notify_all()
            return
        # Quiescence close: if every data origin is exhausted (graph inputs
        # closed, sources finished) and nothing can run, then no packet can
        # ever be emitted again — close the remaining open queues so nodes
        # in loopback cycles (e.g. flow-limiter/tracker patterns) can close.
        if (not self._done
                and all(self._graph_input_closed.values())
                and all(n.source_finished for n in self.nodes if n.is_source)
                and not self._any_ready()):
            # Close BACK-EDGE queues first: their consumers then close and
            # the closure cascades downstream in topological order, letting
            # Close() methods still flush into open streams (closing
            # everything at once would race nodes whose close() emits).
            back_q = [q for n in self.nodes
                      for p, q in n.input_queues.items()
                      if not q.closed and
                      (p in n.config.back_edge_inputs or
                       q.stream_name in n.config.back_edge_inputs)]
            open_q = back_q or [q for n in self.nodes
                                for q in n.input_queues.values()
                                if not q.closed]
            if open_q:
                for q in open_q:
                    q.drop_when_closed = True   # consumer-initiated
                    q.close()
                for node in self.nodes:
                    self._evaluate(node)
                self._cv.notify_all()

    # ------------------------------------------------------------------
    # internals — task execution (executor threads; lock NOT held on entry)
    # ------------------------------------------------------------------
    def _run_task(self, node: _NodeRuntime) -> None:
        action = None
        input_set: Optional[InputSet] = None
        with self._lock:
            node.scheduled -= 1
            if self._error is not None or node.state == node.CLOSED:
                self._task_finished(node)
                return
            if node.state == node.UNOPENED:
                if node.side_packets_available() and node.in_flight == 0:
                    action = "open"
                    node.input_side_packets = {
                        port: self._side_packets[side]
                        for port, side in
                        node.config.input_side_packets.items()
                        if side in self._side_packets}
            elif node.is_source:
                if not node.source_finished and not node.throttled() \
                        and node.in_flight == 0:
                    action = "process"
            else:
                t = node.ready_timestamp()
                if t is not None and not node.throttled():
                    input_set = node.policy.pop_input_set(node.input_queues, t)
                    action = "process"
                elif node.inputs_done() and node.in_flight == 0:
                    action = "close"
            if action is None:
                self._task_finished(node)
                return
            node.in_flight += 1
            self.tracer.record(
                trace_mod.RUN_START, node.index, "",
                input_set.timestamp.value if input_set else 0)

        # ---- calculator code runs without the lock -----------------------
        err: Optional[BaseException] = None
        source_more = True
        try:
            if action == "open":
                node.calculator.open(node.ctx)
            elif action == "process":
                if input_set is not None:
                    node.ctx.inputs = input_set
                result = node.calculator.process(node.ctx)
                if node.is_source:
                    source_more = bool(result)
            elif action == "close":
                node.calculator.close(node.ctx)
        except BaseException as e:  # noqa: BLE001 - error terminates run
            err = e

        with self._lock:
            node.in_flight -= 1
            self.tracer.record(
                trace_mod.RUN_END, node.index, "",
                input_set.timestamp.value if input_set else 0)
            if err is not None:
                self._fail_locked(err, node.name)
                self._task_finished(node)
                return
            if action == "open":
                node.state = node.OPENED
                self.tracer.record(trace_mod.OPEN, node.index)
            elif action == "process":
                if node.is_source and not source_more:
                    node.source_finished = True
                if input_set is not None and \
                        node.timestamp_offset is not None:
                    b = input_set.timestamp + (node.timestamp_offset + 1)
                    for port in node.output_names:
                        self._advance_bound_locked(node, port, b)
                # Consuming freed queue space: producers may unthrottle.
                if input_set is not None:
                    for up in self._producers_of(node):
                        self._evaluate(up)
            elif action == "close":
                self._finish_close(node)
            if node.is_source and node.source_finished and \
                    node.state == node.OPENED and node.in_flight == 0:
                # a finished source closes immediately
                node.state = node.CLOSED  # will call calculator.close below
                self._close_node_outputs(node)
                self.tracer.record(trace_mod.CLOSE, node.index)
                close_now = True
            else:
                close_now = False
            self._evaluate(node)
            self._task_finished(node)
        if close_now:
            try:
                node.calculator.close(node.ctx)
            except BaseException as e:  # noqa: BLE001
                with self._lock:
                    self._fail_locked(e, node.name)
            with self._lock:
                self._maybe_done()
                self._cv.notify_all()

    def _task_finished(self, node: _NodeRuntime) -> None:
        self._active -= 1
        if self._active == 0:
            self._relax_if_stalled()
        self._cv.notify_all()

    def _executor_error(self, err: BaseException) -> None:
        """An exception escaped the task runner itself (scheduler state,
        input-policy code) — not calculator code, which _run_task already
        confines.  Record it as the run's error so wait_until_done raises
        instead of hanging on a silently-lost task."""
        with self._lock:
            self._fail_locked(err, "<executor>")
            # the failed task never reached _task_finished
            self._active = max(0, self._active - 1)
            self._cv.notify_all()

    def _finish_close(self, node: _NodeRuntime) -> None:
        if node.state == node.CLOSED:
            return
        node.state = node.CLOSED
        self.tracer.record(trace_mod.CLOSE, node.index)
        self._close_node_outputs(node)
        self._maybe_done()

    def _close_node_outputs(self, node: _NodeRuntime) -> None:
        for port in node.output_names:
            self._close_output_locked(node, port)

    def _producers_of(self, node: _NodeRuntime) -> List[_NodeRuntime]:
        out = []
        for port, q in node.input_queues.items():
            stream = node.config.inputs[port]
            for up in self.nodes:
                if stream in up.output_streams.values():
                    out.append(up)
        return out

    def _fail_locked(self, err: BaseException, node_name: str) -> None:
        if self._error is None:
            self._error = err
            self._error_node = node_name
        # Terminate: close every queue so nothing else becomes ready.
        for n in self.nodes:
            for q in n.input_queues.values():
                q.close()
        self._done = True
        for pollers in self._pollers.values():
            for p in pollers:
                p._close()
        self._cv.notify_all()

    # ------------------------------------------------------------------
    # internals — emission (called from calculator threads, takes lock)
    # ------------------------------------------------------------------
    def _emit(self, node: _NodeRuntime, port: str, packet: Packet) -> None:
        stream = node.output_streams.get(port)
        if stream is None:
            raise KeyError(f"node {node.name!r}: unknown output port {port!r}")
        callbacks: List[Tuple[Callable[[Packet], None], Packet]] = []
        with self._lock:
            if port in node.closed_outputs:
                raise StreamError(f"node {node.name!r}: output {port!r} "
                                  f"already closed")
            self.tracer.record(trace_mod.PACKET_EMIT, node.index, stream,
                               packet.timestamp.value, id(packet))
            for q in node.consumers[port]:
                q.add(packet)
                self.tracer.record(trace_mod.PACKET_QUEUED, node.index,
                                   stream, packet.timestamp.value, id(packet))
                self._evaluate(self._node_of_queue(q))
            for cb in self._observers.get(stream, ()):  # collect, call later
                callbacks.append((cb, packet))
            for p in self._pollers.get(stream, ()):
                p._push(packet)
        for cb, pkt in callbacks:
            cb(pkt)

    def _advance_bound(self, node: _NodeRuntime, port: str,
                       bound: Timestamp) -> None:
        with self._lock:
            self._advance_bound_locked(node, port, bound)

    def _advance_bound_locked(self, node: _NodeRuntime, port: str,
                              bound: Timestamp) -> None:
        for q in node.consumers.get(port, ()):
            if bound > q.bound:
                q.advance_bound(bound)
                self._evaluate(self._node_of_queue(q))

    def _close_output(self, node: _NodeRuntime, port: str) -> None:
        with self._lock:
            self._close_output_locked(node, port)

    def _close_output_locked(self, node: _NodeRuntime, port: str) -> None:
        if port in node.closed_outputs:
            return
        node.closed_outputs.add(port)
        stream = node.output_streams[port]
        for q in node.consumers[port]:
            q.close()
            self._evaluate(self._node_of_queue(q))
        for pollers in self._pollers.get(stream, ()):
            pass  # pollers close when the whole graph is done
        self._cv.notify_all()

    def _set_side_packet(self, name: str, payload: Any) -> None:
        with self._lock:
            self._side_packets[name] = make_packet(payload, Timestamp.unset())
            for node in self.nodes:
                if node.state == node.UNOPENED:
                    self._evaluate(node)

    # ------------------------------------------------------------------
    def _shutdown(self) -> None:
        for ex in self._executors.values():
            ex.stop(join=False)

    # -- introspection ---------------------------------------------------
    def node_names(self) -> Dict[int, str]:
        return dict(self._node_names)

    def queue_high_water_marks(self) -> Dict[str, int]:
        with self._lock:
            return {f"{q.stream_name}->{q.consumer}": q.hwm
                    for n in self.nodes for q in n.input_queues.values()}
