"""Typed fluent graph-authoring API (paper §2, §3.6).

:class:`GraphBuilder` is the first-class way to author pipelines.  Where
``GraphConfig.add_node`` wires string-keyed dicts (typos surface only when
``Graph(...)`` validates — or at runtime), the builder hands out typed
:class:`Stream` / :class:`SidePacket` handles and checks every connection
against the registered :class:`~repro_torch.core.contract.CalculatorContract`
*as the graph is written*:

* misspelled ports raise immediately, naming the node, the port and the
  valid alternatives (with a did-you-mean suggestion);
* producer/consumer packet types are checked per connection;
* ``build()`` verifies that every required input and side packet is
  connected and that every cycle goes through a declared back edge —
  all before a :class:`~repro_torch.core.graph.Graph` is ever constructed.

Loopbacks (the flow-limiter / tracker-reset / decode-tick patterns) need no
manual ``back_edge_inputs`` bookkeeping: ``b.loopback()`` returns a stream
handle that may be consumed before its producer exists; connecting it marks
the consuming port as a back edge, and ``lb.tie(stream)`` closes the loop.

``build()`` emits a plain :class:`~repro_torch.core.graph_config.GraphConfig`, so
the runtime, validator, text format and visualizer are untouched —
``GraphConfig`` remains the stable low-level / serialization layer (see
``docs/GRAPH_CONFIG.md``).  Subgraphs are plain Python functions that take
and return handles; composition is ordinary function calls.

    from repro_torch.core import GraphBuilder

    b = GraphBuilder(enable_tracer=True)
    frame = b.input("frame")
    detect = b.add_node("ObjectDetectorCalculator", name="detect",
                        options={"threshold": 0.4})
    detect["FRAME"] = frame
    detections = detect.out("DETECTIONS")
    overlay = b.add_node("AnnotationOverlayCalculator", name="annotate")
    overlay["FRAME"] = frame
    overlay["DETECTIONS"] = detections
    b.output(overlay.out("ANNOTATED_FRAME", name="annotated"))
    cfg = b.build()                      # a normal GraphConfig
"""
from __future__ import annotations

import difflib
from typing import Any, Dict, List, Optional, Sequence, Union

from . import registry
from .contract import AnyType, CalculatorContract, PortSpec
from .graph_config import ExecutorConfig, GraphConfig, NodeConfig


class BuilderError(ValueError):
    """A graph-authoring error caught at build time (or earlier)."""


def _suggest(name: str, candidates: Sequence[str]) -> str:
    close = difflib.get_close_matches(name, candidates, n=1)
    return f" — did you mean {close[0]!r}?" if close else ""


class Stream:
    """Handle to one data stream: produced by a graph input or a node
    output port, consumable by any number of node inputs."""

    def __init__(self, builder: "GraphBuilder", name: str,
                 producer: Optional["NodeHandle"], port: str,
                 spec: Optional[PortSpec]):
        self._builder = builder
        self._name = name
        self.producer = producer        # None = graph input
        self.port = port
        self.spec = spec                # producer-side PortSpec (type info)

    @property
    def name(self) -> str:
        return self._name

    def __repr__(self) -> str:
        src = self.producer.name if self.producer else "<graph input>"
        return f"Stream({self._name!r} from {src}:{self.port})"


class LoopbackStream(Stream):
    """Forward-declared back-edge stream: consume it *before* its producer
    exists, then close the loop with :meth:`tie`.  Every port it is
    connected to is automatically recorded in that node's
    ``back_edge_inputs``."""

    def __init__(self, builder: "GraphBuilder"):
        super().__init__(builder, "", None, "", None)
        self.target: Optional[Stream] = None
        # (node, port) pairs consuming this loopback — for error messages
        self.consumers: List[tuple] = []

    @property
    def name(self) -> str:
        if self.target is None:
            raise BuilderError(self._untied_message())
        return self.target.name

    def _untied_message(self) -> str:
        who = ", ".join(f"{n.name!r} port {p!r}" for n, p in self.consumers) \
            or "no node yet"
        return (f"loopback stream is not tied to a producer "
                f"(consumed by {who}); close the loop with "
                f"loopback.tie(<stream>)")

    def tie(self, stream: Stream) -> Stream:
        """Bind the loopback to the stream that feeds it (the end of the
        loop).  Returns ``stream`` for chaining."""
        if isinstance(stream, LoopbackStream):
            raise BuilderError("cannot tie a loopback to another loopback")
        if not isinstance(stream, Stream):
            raise BuilderError(f"loopback.tie expects a Stream, got "
                               f"{type(stream).__name__}")
        if stream._builder is not self._builder:
            raise BuilderError("loopback tied to a stream from a different "
                               "GraphBuilder")
        if self.target is not None:
            raise BuilderError(f"loopback already tied to "
                               f"{self.target.name!r}")
        # the type check deferred at connect time (spec unknown then)
        if stream.spec is not None:
            for node, port in self.consumers:
                spec = node.contract.inputs.get(port) \
                    if node.contract is not None else None
                if spec is not None and not spec.accepts(stream.spec.type):
                    raise BuilderError(
                        f"type mismatch: node {node.name!r} back-edge input "
                        f"{port!r} expects {spec.type.__name__} but the tied "
                        f"stream from "
                        f"{stream.producer.name if stream.producer else 'graph input'}"
                        f":{stream.port} carries {stream.spec.type.__name__}")
        self.target = stream
        return stream

    def __repr__(self) -> str:
        tied = self.target.name if self.target else "<untied>"
        return f"LoopbackStream(-> {tied})"


class SidePacket:
    """Handle to a side packet (run-time constant, paper §3.2)."""

    def __init__(self, builder: "GraphBuilder", name: str,
                 producer: Optional["NodeHandle"], port: str,
                 spec: Optional[PortSpec]):
        self._builder = builder
        self.name = name
        self.producer = producer
        self.port = port
        self.spec = spec

    def __repr__(self) -> str:
        return f"SidePacket({self.name!r})"


class NodeHandle:
    """One node under construction.  Connect inputs with
    ``node["PORT"] = stream_or_side_packet``; create outputs with
    ``node.out("PORT")`` / ``node.side_out("PORT")``.  All port names are
    checked against the calculator's contract (unless it declares a
    variable port set), with errors raised at the offending line."""

    def __init__(self, builder: "GraphBuilder", index: int, calculator: str,
                 name: str, contract: Optional[CalculatorContract],
                 config_kw: Dict[str, Any]):
        self._builder = builder
        self.index = index
        self.calculator = calculator
        self.name = name
        self.contract = contract        # None = DYNAMIC (ports by use)
        self.config_kw = config_kw
        self.inputs: Dict[str, Stream] = {}
        self.side_inputs: Dict[str, SidePacket] = {}
        self.outputs: Dict[str, Stream] = {}
        self.side_outputs: Dict[str, SidePacket] = {}
        self.back_edges: List[str] = []

    # -- connection ------------------------------------------------------
    def __setitem__(self, port: str,
                    value: Union[Stream, SidePacket]) -> None:
        self.connect(port, value)

    def connect(self, port: str, value: Union[Stream, SidePacket]) -> None:
        if isinstance(value, SidePacket):
            self._connect_side(port, value)
            return
        if not isinstance(value, Stream):
            raise BuilderError(
                f"node {self.name!r}: input {port!r} must be connected to a "
                f"Stream or SidePacket handle, got {type(value).__name__} "
                f"(use b.input()/node.out() handles, not raw names)")
        if value._builder is not self._builder:
            raise BuilderError(f"node {self.name!r}: stream {value!r} "
                               f"belongs to a different GraphBuilder")
        spec = None
        if self.contract is not None:
            spec = self.contract.inputs.get(port)
            if spec is None:
                declared = list(self.contract.inputs)
                raise BuilderError(
                    f"node {self.name!r} ({self.calculator}) has no input "
                    f"port {port!r}{_suggest(port, declared)} "
                    f"(declared inputs: {declared})")
        if port in self.inputs:
            raise BuilderError(f"node {self.name!r}: input port {port!r} "
                               f"already connected to "
                               f"{self.inputs[port]!r}")
        # for an already-tied loopback, check against the tied stream
        src = value.target if isinstance(value, LoopbackStream) \
            and value.target is not None else value
        if spec is not None and src.spec is not None \
                and not spec.accepts(src.spec.type):
            raise BuilderError(
                f"type mismatch: node {self.name!r} input {port!r} expects "
                f"{spec.type.__name__} but stream from "
                f"{src.producer.name if src.producer else 'graph input'}"
                f":{src.port} carries {src.spec.type.__name__}")
        self.inputs[port] = value
        if isinstance(value, LoopbackStream):
            value.consumers.append((self, port))
            self.back_edges.append(port)

    def _connect_side(self, port: str, sp: SidePacket) -> None:
        if sp._builder is not self._builder:
            raise BuilderError(f"node {self.name!r}: side packet {sp!r} "
                               f"belongs to a different GraphBuilder")
        if self.contract is not None \
                and port not in self.contract.input_side_packets:
            declared = list(self.contract.input_side_packets)
            raise BuilderError(
                f"node {self.name!r} ({self.calculator}) has no input side "
                f"packet {port!r}{_suggest(port, declared)} "
                f"(declared side packets: {declared})")
        if port in self.side_inputs:
            raise BuilderError(f"node {self.name!r}: side packet port "
                               f"{port!r} already connected")
        self.side_inputs[port] = sp

    # -- outputs ---------------------------------------------------------
    def out(self, port: str, name: Optional[str] = None) -> Stream:
        """Stream produced on output ``port``.  Auto-named
        ``<node>__<port-lowercase>`` unless ``name`` is given; repeated
        calls return the same handle."""
        if port in self.outputs:
            existing = self.outputs[port]
            if name is not None and name != existing.name:
                raise BuilderError(
                    f"node {self.name!r}: output {port!r} already named "
                    f"{existing.name!r}, cannot rename to {name!r}")
            return existing
        spec = None
        if self.contract is not None:
            spec = self.contract.outputs.get(port)
            if spec is None:
                declared = list(self.contract.outputs)
                raise BuilderError(
                    f"node {self.name!r} ({self.calculator}) has no output "
                    f"port {port!r}{_suggest(port, declared)} "
                    f"(declared outputs: {declared})")
        stream_name = name or f"{self.name}__{port.lower()}"
        self._builder._claim_stream_name(stream_name, f"{self.name}:{port}")
        s = Stream(self._builder, stream_name, self, port, spec)
        self.outputs[port] = s
        return s

    def side_out(self, port: str, name: Optional[str] = None) -> SidePacket:
        """Side packet produced on output side-packet ``port``."""
        if port in self.side_outputs:
            existing = self.side_outputs[port]
            if name is not None and name != existing.name:
                raise BuilderError(
                    f"node {self.name!r}: output side packet {port!r} "
                    f"already named {existing.name!r}, cannot rename to "
                    f"{name!r}")
            return existing
        spec = None
        if self.contract is not None:
            spec = self.contract.output_side_packets.get(port)
            if spec is None:
                declared = list(self.contract.output_side_packets)
                raise BuilderError(
                    f"node {self.name!r} ({self.calculator}) has no output "
                    f"side packet {port!r}{_suggest(port, declared)} "
                    f"(declared: {declared})")
        sp = SidePacket(self._builder, name or f"{self.name}__{port.lower()}",
                        self, port, spec)
        self.side_outputs[port] = sp
        return sp

    def __repr__(self) -> str:
        return f"NodeHandle({self.name!r}: {self.calculator})"


def _resolve_contract(calculator: str) -> Optional[CalculatorContract]:
    """Contract for build-time checking; None means a variable (DYNAMIC)
    port set — ports are declared by use and only connectivity/cycle
    checks apply."""
    sub = registry.get_subgraph(calculator)
    if sub is not None:
        # a subgraph's interface is its declared graph-level streams
        return CalculatorContract(
            inputs={s: PortSpec(s, AnyType) for s in sub.input_streams},
            outputs={s: PortSpec(s, AnyType) for s in sub.output_streams},
            input_side_packets={s: PortSpec(s, AnyType, optional=True)
                                for s in sub.input_side_packets},
            output_side_packets={s: PortSpec(s, AnyType)
                                 for s in sub.output_side_packets})
    try:
        cls = registry.get_calculator(calculator)
    except KeyError as e:
        raise BuilderError(str(e)) from None
    if getattr(cls, "DYNAMIC", False):
        return None
    return cls.get_contract()


class GraphBuilder:
    """Fluent, contract-checked authoring front end for
    :class:`~repro_torch.core.graph_config.GraphConfig` (see module docstring)."""

    def __init__(self, *, num_threads: int = 4, max_queue_size: int = -1,
                 enable_tracer: bool = False,
                 trace_buffer_size: int = 65536):
        self._graph_kw = dict(num_threads=num_threads,
                              max_queue_size=max_queue_size,
                              enable_tracer=enable_tracer,
                              trace_buffer_size=trace_buffer_size)
        self._nodes: List[NodeHandle] = []
        self._inputs: List[Stream] = []
        self._outputs: List[Stream] = []
        self._side_inputs: List[SidePacket] = []
        self._side_outputs: List[SidePacket] = []
        self._executors: List[ExecutorConfig] = []
        self._loopbacks: List[LoopbackStream] = []
        self._stream_names: Dict[str, str] = {}  # name -> producer label

    # -- graph-level interface ------------------------------------------
    def input(self, name: str) -> Stream:
        """Declare a graph input stream and return its handle."""
        self._claim_stream_name(name, "<graph input>")
        s = Stream(self, name, None, name, None)
        self._inputs.append(s)
        return s

    def side_input(self, name: str) -> SidePacket:
        """Declare a graph input side packet and return its handle."""
        if any(sp.name == name for sp in self._side_inputs):
            raise BuilderError(f"graph input side packet {name!r} declared "
                               f"twice")
        sp = SidePacket(self, name, None, name, None)
        self._side_inputs.append(sp)
        return sp

    def output(self, stream: Stream) -> Stream:
        """Declare ``stream`` as a graph output (observable/pollable)."""
        if not isinstance(stream, Stream):
            raise BuilderError(f"b.output expects a Stream handle, got "
                               f"{type(stream).__name__}")
        if isinstance(stream, LoopbackStream):
            raise BuilderError("a loopback handle cannot be a graph output; "
                               "declare the tied stream instead")
        if stream._builder is not self:
            raise BuilderError("graph output stream belongs to a different "
                               "GraphBuilder")
        self._outputs.append(stream)
        return stream

    def side_output(self, sp: SidePacket) -> SidePacket:
        """Declare ``sp`` as a graph output side packet."""
        if not isinstance(sp, SidePacket) or sp._builder is not self:
            raise BuilderError("b.side_output expects a SidePacket handle "
                               "from this builder")
        self._side_outputs.append(sp)
        return sp

    def executor(self, name: str, num_threads: int = 1) -> str:
        """Declare a named executor; pass the returned name to
        ``add_node(..., executor=...)``."""
        self._executors.append(ExecutorConfig(name, num_threads))
        return name

    def loopback(self) -> LoopbackStream:
        """Forward-declared back-edge stream (see
        :class:`LoopbackStream`)."""
        lb = LoopbackStream(self)
        self._loopbacks.append(lb)
        return lb

    # -- nodes -----------------------------------------------------------
    def add_node(self, calculator: str, *, name: str = "",
                 inputs: Optional[Union[Dict[str, Any], Sequence[Any]]] = None,
                 side_inputs: Optional[Dict[str, SidePacket]] = None,
                 options: Optional[Dict[str, Any]] = None,
                 executor: str = "", input_policy: Any = None,
                 max_in_flight: int = 0,
                 max_queue_size: int = -1) -> NodeHandle:
        """Add a node; returns its handle.  ``inputs`` may be given here as
        ``{port: handle}`` (or a bare sequence of handles mapped to the
        contract's declared port order) or connected afterwards with
        ``node["PORT"] = handle``."""
        contract = _resolve_contract(calculator)
        index = len(self._nodes)
        display = name or f"{calculator}_{index}"
        if any(n.name == display for n in self._nodes):
            raise BuilderError(f"node name {display!r} used twice")
        node = NodeHandle(self, index, calculator, display, contract,
                          dict(name=name, options=dict(options or {}),
                               executor=executor, input_policy=input_policy,
                               max_in_flight=max_in_flight,
                               max_queue_size=max_queue_size))
        if inputs is not None:
            if not isinstance(inputs, dict):
                if contract is None:
                    raise BuilderError(
                        f"node {display!r} ({calculator}) has a variable "
                        f"port set; positional inputs need a declared "
                        f"contract — pass a {{port: stream}} dict")
                ports = list(contract.inputs)
                if len(inputs) > len(ports):
                    raise BuilderError(
                        f"node {display!r} ({calculator}): {len(inputs)} "
                        f"positional inputs but contract declares only "
                        f"{len(ports)} ({ports})")
                inputs = dict(zip(ports, inputs))
            for port, handle in inputs.items():
                node.connect(port, handle)
        for port, sp in (side_inputs or {}).items():
            node.connect(port, sp)
        # registered only once fully wired: a connection error above leaves
        # the builder unchanged (no half-built node, name still free)
        self._nodes.append(node)
        return node

    # -- build -----------------------------------------------------------
    def build(self) -> GraphConfig:
        """Run the build-time checks and emit a plain ``GraphConfig``."""
        errors: List[str] = []
        for lb in self._loopbacks:
            if lb.target is None and lb.consumers:
                errors.append(lb._untied_message())
        for node in self._nodes:
            errors.extend(self._check_required(node))
        errors.extend(self._check_cycles())
        if errors:
            raise BuilderError(
                "graph build failed:\n  - " + "\n  - ".join(errors))

        cfg = GraphConfig(
            input_streams=[s.name for s in self._inputs],
            output_streams=[s.name for s in self._outputs],
            input_side_packets=[sp.name for sp in self._side_inputs],
            output_side_packets=[sp.name for sp in self._side_outputs],
            executors=list(self._executors),
            **self._graph_kw)
        for node in self._nodes:
            kw = node.config_kw
            cfg.nodes.append(NodeConfig(
                calculator=node.calculator,
                name=kw["name"],
                inputs={p: s.name for p, s in node.inputs.items()},
                outputs={p: s.name for p, s in node.outputs.items()},
                input_side_packets={p: sp.name
                                    for p, sp in node.side_inputs.items()},
                output_side_packets={p: sp.name
                                     for p, sp in node.side_outputs.items()},
                options=dict(kw["options"]),
                executor=kw["executor"],
                input_policy=kw["input_policy"],
                max_in_flight=kw["max_in_flight"],
                back_edge_inputs=list(node.back_edges),
                max_queue_size=kw["max_queue_size"],
            ))
        return cfg

    # -- internals -------------------------------------------------------
    def _claim_stream_name(self, name: str, producer: str) -> None:
        prev = self._stream_names.get(name)
        if prev is not None:
            raise BuilderError(f"stream name {name!r} already produced by "
                               f"{prev} (streams have exactly one producer)")
        self._stream_names[name] = producer

    def _check_required(self, node: NodeHandle) -> List[str]:
        errors = []
        if node.contract is None:
            return errors
        for port, spec in node.contract.inputs.items():
            if not spec.optional and port not in node.inputs:
                errors.append(
                    f"node {node.name!r} ({node.calculator}): required "
                    f"input {port!r} not connected (connect with "
                    f"node[{port!r}] = <stream>)")
        for port, spec in node.contract.input_side_packets.items():
            if not spec.optional and port not in node.side_inputs:
                errors.append(
                    f"node {node.name!r} ({node.calculator}): required "
                    f"input side packet {port!r} not connected")
        return errors

    def _check_cycles(self) -> List[str]:
        """Kahn's algorithm over forward edges (back edges excluded); any
        remaining node sits on an undeclared cycle."""
        n = len(self._nodes)
        adj: Dict[int, List[int]] = {i: [] for i in range(n)}
        indeg = [0] * n
        for node in self._nodes:
            for port, s in node.inputs.items():
                if port in node.back_edges:
                    continue
                # s cannot be a LoopbackStream here: connecting one always
                # marks the port as a back edge, skipped above
                if s.producer is not None:
                    adj[s.producer.index].append(node.index)
                    indeg[node.index] += 1
        order = [i for i in range(n) if indeg[i] == 0]
        head = 0
        while head < len(order):
            u = order[head]
            head += 1
            for v in adj[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    order.append(v)
        if len(order) == n:
            return []
        stuck = set(range(n)) - set(order)
        edges = []
        for i in sorted(stuck):
            node = self._nodes[i]
            for port, s in node.inputs.items():
                if port in node.back_edges:
                    continue
                if s.producer is not None and s.producer.index in stuck:
                    edges.append(f"{node.name!r} port {port!r} <- "
                                 f"{s.producer.name!r}:{s.port}")
        return [f"cycle without a declared back edge (mark one input as a "
                f"loopback with b.loopback()): " + "; ".join(edges)]
