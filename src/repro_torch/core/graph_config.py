"""GraphConfig — the declarative pipeline specification (paper §3.6).

A GraphConfig describes topology and functionality: nodes (calculator type,
input/output streams, side packets, options, executor, input policy),
graph-level input/output streams, executors and global settings.  Configs
can be authored as Python dataclasses or parsed from a plain dict (the
moral equivalent of the paper's protobuf text format).

Subgraphs (§3.6): a graph config registered under a name can be used as a
node; at load time each subgraph node is replaced by its expanded calculator
graph with namespaced internal streams, so semantics and performance are
identical to inlining by hand.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

from . import registry


@dataclasses.dataclass
class NodeConfig:
    calculator: str
    name: str = ""
    # port name -> stream name.  For convenience a bare list maps ports
    # positionally to the calculator contract's declared port order.
    inputs: Dict[str, str] = dataclasses.field(default_factory=dict)
    outputs: Dict[str, str] = dataclasses.field(default_factory=dict)
    input_side_packets: Dict[str, str] = dataclasses.field(default_factory=dict)
    output_side_packets: Dict[str, str] = dataclasses.field(default_factory=dict)
    options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    executor: str = ""           # "" = the graph's default executor
    input_policy: Any = None      # overrides the contract's policy
    max_in_flight: int = 0        # 0 = use contract value
    # Back-edge inputs (loopbacks, e.g. the flow-limiter pattern in Fig. 3)
    # are excluded from the topological sort and start with an open bound.
    back_edge_inputs: List[str] = dataclasses.field(default_factory=list)
    # per-input-stream queue limit; -1 inherits graph default
    max_queue_size: int = -1

    def __post_init__(self) -> None:
        for field in ("inputs", "outputs", "input_side_packets",
                      "output_side_packets"):
            value = getattr(self, field)
            if isinstance(value, (list, tuple)):
                setattr(self, field, self._map_positional(field, list(value)))

    def _map_positional(self, field: str, streams: List[str]) -> Dict[str, str]:
        ports = _declared_port_order(self.calculator, field)
        if ports is None:
            raise ValueError(
                f"node {self.calculator!r}: positional {field} need a "
                f"declared contract port order; this calculator has a "
                f"variable (DYNAMIC) port set — use an explicit "
                f"{{port: stream}} dict")
        if len(streams) > len(ports):
            raise ValueError(
                f"node {self.calculator!r}: {len(streams)} positional "
                f"{field} but the contract declares only {len(ports)} "
                f"ports ({ports})")
        return {port: stream for port, stream in zip(ports, streams)}

    def display_name(self, index: int) -> str:
        return self.name or f"{self.calculator}_{index}"


def _declared_port_order(calculator: str, field: str) -> Optional[List[str]]:
    """Contract (or subgraph-interface) port order for positional mapping;
    None when the calculator's port set is variable (DYNAMIC)."""
    sub = registry.get_subgraph(calculator)
    if sub is not None:
        return {"inputs": list(sub.input_streams),
                "outputs": list(sub.output_streams),
                "input_side_packets": list(sub.input_side_packets),
                "output_side_packets": list(sub.output_side_packets)}[field]
    cls = registry.get_calculator(calculator)
    if getattr(cls, "DYNAMIC", False):
        return None
    c = cls.get_contract()
    return {"inputs": list(c.inputs),
            "outputs": list(c.outputs),
            "input_side_packets": list(c.input_side_packets),
            "output_side_packets": list(c.output_side_packets)}[field]


@dataclasses.dataclass
class ExecutorConfig:
    name: str
    num_threads: int = 1


@dataclasses.dataclass
class GraphConfig:
    nodes: List[NodeConfig] = dataclasses.field(default_factory=list)
    input_streams: List[str] = dataclasses.field(default_factory=list)
    output_streams: List[str] = dataclasses.field(default_factory=list)
    input_side_packets: List[str] = dataclasses.field(default_factory=list)
    output_side_packets: List[str] = dataclasses.field(default_factory=list)
    executors: List[ExecutorConfig] = dataclasses.field(default_factory=list)
    num_threads: int = 4                 # default executor pool size
    max_queue_size: int = -1             # default per-input-stream limit
    enable_tracer: bool = False
    trace_buffer_size: int = 65536

    # -- construction helpers ----------------------------------------------
    def add_node(self, calculator: str, **kw) -> "GraphConfig":
        self.nodes.append(NodeConfig(calculator=calculator, **kw))
        return self

    # -- dict parsing ------------------------------------------------------
    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "GraphConfig":
        nodes = [NodeConfig(**n) for n in d.get("nodes", [])]
        executors = [ExecutorConfig(**e) for e in d.get("executors", [])]
        kw = {k: v for k, v in d.items() if k not in ("nodes", "executors")}
        return GraphConfig(nodes=nodes, executors=executors, **kw)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# Subgraph support
# ---------------------------------------------------------------------------

def register_subgraph(name: str, config: GraphConfig) -> None:
    """Register ``config`` so it can be referenced by ``name`` as if it were
    a calculator."""
    registry.register_subgraph(name, config)


def _is_subgraph(calculator: str) -> bool:
    return registry.get_subgraph(calculator) is not None


def expand_subgraphs(config: GraphConfig) -> GraphConfig:
    """Replace every subgraph node with the subgraph's calculators.

    Internal streams/side-packets are namespaced ``<nodename>__<stream>``;
    the subgraph's declared input/output streams are re-bound to the streams
    connected at the call site.  Expansion is recursive (subgraphs may
    contain subgraphs) with a depth guard.
    """
    return _expand(config, depth=0)


def _expand(config: GraphConfig, depth: int) -> GraphConfig:
    if depth > 16:
        raise RecursionError("subgraph nesting too deep (cycle?)")
    if not any(_is_subgraph(n.calculator) for n in config.nodes):
        return config

    out = dataclasses.replace(config, nodes=[])
    for i, node in enumerate(config.nodes):
        sub = registry.get_subgraph(node.calculator)
        if sub is None:
            out.nodes.append(node)
            continue
        sub = _expand(sub, depth + 1)
        prefix = node.display_name(i)
        # Interface binding: subgraph-declared stream name -> outer stream.
        bind: Dict[str, str] = {}
        for port, outer in node.inputs.items():
            bind[port] = outer
        for port, outer in node.outputs.items():
            bind[port] = outer
        sidebind: Dict[str, str] = {}
        for port, outer in node.input_side_packets.items():
            sidebind[port] = outer
        for port, outer in node.output_side_packets.items():
            sidebind[port] = outer

        def map_stream(s: str) -> str:
            if s in bind:
                return bind[s]
            return f"{prefix}__{s}"

        def map_side(s: str) -> str:
            if s in sidebind:
                return sidebind[s]
            return f"{prefix}__{s}"

        unknown = [p for p in list(node.inputs) + list(node.outputs)
                   if p not in sub.input_streams + sub.output_streams]
        if unknown:
            raise ValueError(
                f"subgraph node {prefix!r} connects undeclared interface "
                f"streams {unknown}; declared inputs={sub.input_streams} "
                f"outputs={sub.output_streams}")

        for j, inner in enumerate(sub.nodes):
            out.nodes.append(dataclasses.replace(
                inner,
                name=f"{prefix}/{inner.display_name(j)}",
                inputs={p: map_stream(s) for p, s in inner.inputs.items()},
                outputs={p: map_stream(s) for p, s in inner.outputs.items()},
                input_side_packets={p: map_side(s) for p, s in
                                    inner.input_side_packets.items()},
                output_side_packets={p: map_side(s) for p, s in
                                     inner.output_side_packets.items()},
                executor=inner.executor or node.executor,
            ))
    return out
