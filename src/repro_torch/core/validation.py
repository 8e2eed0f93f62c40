"""Graph validation (paper §3.5).

Checked when a graph is initialized:
  1. each stream / side packet is produced by exactly one source;
  2. connected input/output types are compatible;
  3. each node's connections are compatible with its contract.

``validate`` raises :class:`GraphValidationError` with a message describing
every violation found (not just the first).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from . import registry
from .contract import AnyType, CalculatorContract, PortSpec
from .graph_config import GraphConfig, NodeConfig


class GraphValidationError(ValueError):
    pass


def node_contract(node: NodeConfig) -> CalculatorContract:
    """Resolve the contract for a node, synthesizing wildcard ports for
    calculators that declare ``DYNAMIC = True`` (variable port sets, e.g.
    pass-through / mux nodes, mirroring MediaPipe's GetContract receiving
    the connected ports)."""
    cls = registry.get_calculator(node.calculator)
    c = cls.get_contract()
    if getattr(cls, "DYNAMIC", False):
        c = dataclasses.replace(
            c,
            inputs={p: PortSpec(p, AnyType) for p in node.inputs},
            outputs={p: PortSpec(p, AnyType) for p in node.outputs},
            input_side_packets={p: PortSpec(p, AnyType)
                                for p in node.input_side_packets},
            output_side_packets={p: PortSpec(p, AnyType)
                                 for p in node.output_side_packets},
        )
    return c


def validate(config: GraphConfig) -> Dict[str, Tuple[int, str]]:
    """Validate; returns the stream producer map
    ``stream -> (node_index, port)`` with graph inputs as index -1."""
    errors: List[str] = []

    # ---- constraint 1: single producer per stream -------------------------
    producers: Dict[str, Tuple[int, str]] = {}
    for s in config.input_streams:
        if s in producers:
            errors.append(f"graph input stream {s!r} declared twice")
        producers[s] = (-1, s)
    side_producers: Dict[str, Tuple[int, str]] = {}
    for s in config.input_side_packets:
        side_producers[s] = (-1, s)

    contracts: List[CalculatorContract] = []
    for i, node in enumerate(config.nodes):
        try:
            c = node_contract(node)
        except KeyError as e:
            errors.append(str(e))
            contracts.append(CalculatorContract())
            continue
        contracts.append(c)
        for port, stream in node.outputs.items():
            if stream in producers:
                errors.append(
                    f"stream {stream!r} produced by both "
                    f"{producers[stream]} and node {node.display_name(i)!r}")
            producers[stream] = (i, port)
        for port, sp in node.output_side_packets.items():
            if sp in side_producers:
                errors.append(f"side packet {sp!r} produced twice")
            side_producers[sp] = (i, port)

    # ---- constraints 2+3: contract/type compatibility ---------------------
    for i, node in enumerate(config.nodes):
        c = contracts[i]
        name = node.display_name(i)
        for port, stream in node.inputs.items():
            if port not in c.inputs:
                errors.append(f"node {name!r}: input port {port!r} not in "
                              f"contract (declared: {list(c.inputs)})")
                continue
            prod = producers.get(stream)
            if prod is None:
                errors.append(f"node {name!r}: input stream {stream!r} has "
                              f"no producer")
                continue
            pi, pport = prod
            if pi >= 0:
                out_spec = contracts[pi].outputs.get(pport)
                if out_spec is not None and not c.inputs[port].accepts(out_spec.type):
                    errors.append(
                        f"type mismatch on stream {stream!r}: "
                        f"{config.nodes[pi].display_name(pi)!r}:{pport} "
                        f"produces {out_spec.type.__name__}, node {name!r}:"
                        f"{port} expects {c.inputs[port].type.__name__}")
        for port in node.outputs:
            if port not in c.outputs:
                errors.append(f"node {name!r}: output port {port!r} not in "
                              f"contract (declared: {list(c.outputs)})")
        # required (non-optional) contract inputs must be connected
        for port, spec in c.inputs.items():
            if not spec.optional and port not in node.inputs:
                errors.append(f"node {name!r}: required input {port!r} "
                              f"not connected")
        for port, spec in c.input_side_packets.items():
            if not spec.optional and port not in node.input_side_packets:
                errors.append(f"node {name!r}: required input side packet "
                              f"{port!r} not connected")
        for port in node.input_side_packets:
            if port not in c.input_side_packets:
                errors.append(f"node {name!r}: side-packet port {port!r} "
                              f"not in contract")

    # ---- graph outputs must be produced ------------------------------------
    for s in config.output_streams:
        if s not in producers:
            errors.append(f"graph output stream {s!r} has no producer")

    if errors:
        raise GraphValidationError(
            "graph validation failed:\n  - " + "\n  - ".join(errors))
    return producers


def topological_priorities(config: GraphConfig,
                           producers: Dict[str, Tuple[int, str]]) -> List[int]:
    """Topologically sort nodes (back edges excluded) and assign priorities:
    nodes closer to the output side get higher priority, sources lowest
    (paper §4.1.1)."""
    n = len(config.nodes)
    adj: Dict[int, List[int]] = {i: [] for i in range(n)}
    indeg = [0] * n
    for i, node in enumerate(config.nodes):
        for port, stream in node.inputs.items():
            if port in node.back_edge_inputs or stream in node.back_edge_inputs:
                continue
            prod = producers.get(stream)
            if prod and prod[0] >= 0:
                adj[prod[0]].append(i)
                indeg[i] += 1
    order: List[int] = [i for i in range(n) if indeg[i] == 0]
    head = 0
    while head < len(order):
        u = order[head]
        head += 1
        for v in adj[u]:
            indeg[v] -= 1
            if indeg[v] == 0:
                order.append(v)
    if len(order) != n:
        cyc = [config.nodes[i].display_name(i) for i in range(n)
               if i not in order]
        raise GraphValidationError(
            f"graph contains a cycle not marked with back_edge_inputs: {cyc}")
    prio = [0] * n
    for rank, i in enumerate(order):
        prio[i] = rank  # later in topo order = closer to outputs = higher
    return prio
