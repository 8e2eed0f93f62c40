"""Visualizer (paper §5.2) — topology (Graph view) and timeline views.

Terminal-native: the Graph view renders the topology as indented ASCII or
GraphViz DOT; the Timeline view renders per-node RUN intervals from a trace
(one row per node, one column per time bucket), matching the structure of
the paper's Figure 4.
"""
from __future__ import annotations

from typing import Dict, List

from .graph_config import GraphConfig, expand_subgraphs
from .tracer import RUN_END, RUN_START, Tracer
from .validation import validate


def topology_ascii(config: GraphConfig) -> str:
    config = expand_subgraphs(config)
    validate(config)
    lines: List[str] = []
    for s in config.input_side_packets:
        lines.append(f"(side) {s}")
    for s in config.input_streams:
        lines.append(f"[in]  {s}")
    for i, node in enumerate(config.nodes):
        name = node.display_name(i)
        ins = ", ".join(f"{p}<-{s}" for p, s in node.inputs.items()) or "(source)"
        outs = ", ".join(f"{p}->{s}" for p, s in node.outputs.items()) or "(sink)"
        side = ""
        if node.input_side_packets:
            side = "  {side: " + ", ".join(
                f"{p}<-{s}" for p, s in node.input_side_packets.items()) + "}"
        lines.append(f"  [{node.calculator}] {name}")
        lines.append(f"      in : {ins}{side}")
        lines.append(f"      out: {outs}")
    for s in config.output_streams:
        lines.append(f"[out] {s}")
    return "\n".join(lines)


def topology_dot(config: GraphConfig) -> str:
    config = expand_subgraphs(config)
    producers = validate(config)
    lines = ["digraph mediapipe {", "  rankdir=TB;",
             '  node [shape=box, fontname="monospace"];']
    for i, node in enumerate(config.nodes):
        lines.append(f'  n{i} [label="{node.display_name(i)}\\n'
                     f'({node.calculator})"];')
    for s in config.input_streams:
        lines.append(f'  "in_{s}" [shape=parallelogram, label="{s}"];')
    for i, node in enumerate(config.nodes):
        for port, stream in node.inputs.items():
            src_i, _ = producers[stream]
            style = ' [style=dashed]' if (port in node.back_edge_inputs or
                                          stream in node.back_edge_inputs) else ''
            src = f"n{src_i}" if src_i >= 0 else f'"in_{stream}"'
            lines.append(f'  {src} -> n{i} [label="{stream}"]{style};'
                         .replace(f']{style};', f', {style[2:]}' if style else '];')
                         if False else f'  {src} -> n{i} [label="{stream}"];')
    for s in config.output_streams:
        src_i, _ = producers[s]
        lines.append(f'  "out_{s}" [shape=parallelogram, label="{s}"];')
        lines.append(f'  n{src_i} -> "out_{s}";')
    lines.append("}")
    return "\n".join(lines)


def timeline_ascii(tracer: Tracer, node_names: Dict[int, str],
                   width: int = 80) -> str:
    """One row per node; '#' marks time buckets where the node was running."""
    events = tracer.events()
    if not events:
        return "(no trace events)"
    t_max = max(e.event_time for e in events) or 1
    scale = width / t_max
    rows: Dict[int, List[str]] = {}
    starts: Dict[tuple, int] = {}
    for e in events:
        if e.node_id < 0:
            continue
        rows.setdefault(e.node_id, [" "] * width)
        key = (e.node_id, e.packet_timestamp)
        if e.event_type == RUN_START:
            starts[key] = e.event_time
        elif e.event_type == RUN_END and key in starts:
            a = int(starts.pop(key) * scale)
            b = max(a + 1, int(e.event_time * scale))
            for x in range(a, min(b, width)):
                rows[e.node_id][x] = "#"
    name_w = max((len(n) for n in node_names.values()), default=8)
    lines = [f"timeline ({t_max/1e6:.2f} ms total, {width} cols)"]
    for nid in sorted(rows):
        nm = node_names.get(nid, str(nid)).rjust(name_w)
        lines.append(f"{nm} |{''.join(rows[nid])}|")
    return "\n".join(lines)
