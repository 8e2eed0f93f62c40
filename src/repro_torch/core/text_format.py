"""Text-format GraphConfig files (paper §3.6: 'a graph is typically defined
via a graph configuration as a separate file').

The syntax mirrors MediaPipe's protobuf text format closely enough that a
MediaPipe user feels at home:

    input_stream: "frame"
    output_stream: "annotated"
    num_threads: 4
    executor { name: "inference" num_threads: 1 }
    node {
      calculator: "ObjectDetectorCalculator"
      name: "detect"
      input_stream: "FRAME:frame"          # PORT:stream (or bare stream)
      output_stream: "DETECTIONS:detections"
      input_side_packet: "labels:labels"
      executor: "inference"
      options { threshold: 0.55 every: 4 }
      back_edge_input: "RESET"
    }

``parse_graph_config(text)`` -> GraphConfig;
``serialize_graph_config(cfg)`` round-trips.
"""
from __future__ import annotations

import re
import shlex
from typing import Any, Dict, List, Optional, Tuple

from .graph_config import ExecutorConfig, GraphConfig, NodeConfig


class TextFormatError(ValueError):
    pass


class _NullToken:
    """Marks an unquoted ``null``/``none`` scalar.  Only option values may
    be null (they round-trip Python ``None``); everywhere else the token is
    rejected so a stream/field is never silently renamed to 'None'."""

    def __repr__(self) -> str:
        return "null"


_NULL = _NullToken()


def _scalar(value: Any, key: str) -> Any:
    if value is _NULL:
        raise TextFormatError(
            f"field {key!r}: bare null is only valid as an option value "
            f"(quote it for a literal string)")
    return value


_TOKEN_RE = re.compile(r'"[^"]*"|\{|\}|[^\s{}]+')


def _tokenize(text: str) -> List[str]:
    out = []
    for line in text.splitlines():
        line = line.split("#", 1)[0]
        out.extend(_TOKEN_RE.findall(line))
    return out


def _unquote(tok: str) -> str:
    if tok.startswith('"') and tok.endswith('"'):
        return tok[1:-1]
    return tok


def _coerce(tok: str) -> Any:
    t = _unquote(tok)
    if t != tok:            # was quoted -> string
        return t
    low = t.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none"):     # unset option values (quoted stays str)
        return _NULL
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t


def _split_port(value: str) -> Tuple[str, str]:
    """'PORT:stream' -> (PORT, stream); bare 'stream' -> (stream, stream)."""
    if ":" in value:
        port, stream = value.split(":", 1)
        return port, stream
    return value, value


class _Parser:
    def __init__(self, tokens: List[str]):
        self.toks = tokens
        self.i = 0

    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise TextFormatError("unexpected end of input")
        self.i += 1
        return tok

    def expect(self, tok: str) -> None:
        got = self.next()
        if got != tok:
            raise TextFormatError(f"expected {tok!r}, got {got!r}")

    def parse_block(self) -> List[Tuple[str, Any]]:
        """Parse `key: value` / `key { ... }` pairs until '}' or EOF."""
        fields: List[Tuple[str, Any]] = []
        while True:
            tok = self.peek()
            if tok is None or tok == "}":
                return fields
            key = self.next()
            if key.endswith(":"):
                key = key[:-1]
                fields.append((key, _coerce(self.next())))
            elif self.peek() == "{":
                self.next()
                sub = self.parse_block()
                self.expect("}")
                fields.append((key, sub))
            elif self.peek() == ":":
                self.next()
                fields.append((key, _coerce(self.next())))
            else:
                raise TextFormatError(
                    f"expected ':' or '{{' after {key!r}, got {self.peek()!r}")


def _node_from_fields(fields: List[Tuple[str, Any]]) -> NodeConfig:
    node = NodeConfig(calculator="")
    for key, value in fields:
        if key != "options":
            value = _scalar(value, key)
        if key == "calculator":
            node.calculator = str(value)
        elif key == "name":
            node.name = str(value)
        elif key == "input_stream":
            port, stream = _split_port(str(value))
            node.inputs[port] = stream
        elif key == "output_stream":
            port, stream = _split_port(str(value))
            node.outputs[port] = stream
        elif key == "input_side_packet":
            port, side = _split_port(str(value))
            node.input_side_packets[port] = side
        elif key == "output_side_packet":
            port, side = _split_port(str(value))
            node.output_side_packets[port] = side
        elif key == "executor":
            node.executor = str(value)
        elif key == "input_policy":
            node.input_policy = str(value)
        elif key == "max_in_flight":
            node.max_in_flight = int(value)
        elif key == "max_queue_size":
            node.max_queue_size = int(value)
        elif key == "back_edge_input":
            node.back_edge_inputs.append(str(value))
        elif key == "options":
            node.options.update({k: (None if v is _NULL else v)
                                 for k, v in value})
        else:
            raise TextFormatError(f"unknown node field {key!r}")
    if not node.calculator:
        raise TextFormatError("node missing 'calculator'")
    return node


def parse_graph_config(text: str) -> GraphConfig:
    parser = _Parser(_tokenize(text))
    fields = parser.parse_block()
    if parser.peek() is not None:
        raise TextFormatError(f"trailing tokens at {parser.peek()!r}")
    cfg = GraphConfig()
    for key, value in fields:
        if key not in ("executor", "node"):
            value = _scalar(value, key)
        if key == "input_stream":
            cfg.input_streams.append(str(value))
        elif key == "output_stream":
            cfg.output_streams.append(str(value))
        elif key == "input_side_packet":
            cfg.input_side_packets.append(str(value))
        elif key == "output_side_packet":
            cfg.output_side_packets.append(str(value))
        elif key == "num_threads":
            cfg.num_threads = int(value)
        elif key == "max_queue_size":
            cfg.max_queue_size = int(value)
        elif key == "enable_tracer":
            cfg.enable_tracer = bool(value)
        elif key == "trace_buffer_size":
            cfg.trace_buffer_size = int(value)
        elif key == "executor":
            kw = {k: _scalar(v, f"executor.{k}") for k, v in value}
            cfg.executors.append(ExecutorConfig(
                name=str(kw.get("name", "default")),
                num_threads=int(kw.get("num_threads", 1))))
        elif key == "node":
            cfg.nodes.append(_node_from_fields(value))
        else:
            raise TextFormatError(f"unknown graph field {key!r}")
    return cfg


def load_graph_config(path: str) -> GraphConfig:
    with open(path) as f:
        return parse_graph_config(f.read())


def serialize_graph_config(cfg: GraphConfig) -> str:
    lines: List[str] = []
    for s in cfg.input_streams:
        lines.append(f'input_stream: "{s}"')
    for s in cfg.output_streams:
        lines.append(f'output_stream: "{s}"')
    for s in cfg.input_side_packets:
        lines.append(f'input_side_packet: "{s}"')
    for s in cfg.output_side_packets:
        lines.append(f'output_side_packet: "{s}"')
    if cfg.num_threads != 4:
        lines.append(f"num_threads: {cfg.num_threads}")
    if cfg.max_queue_size != -1:
        lines.append(f"max_queue_size: {cfg.max_queue_size}")
    if cfg.enable_tracer:
        lines.append("enable_tracer: true")
    for e in cfg.executors:
        lines.append(f'executor {{ name: "{e.name}" '
                     f"num_threads: {e.num_threads} }}")
    for i, n in enumerate(cfg.nodes):
        lines.append("node {")
        lines.append(f'  calculator: "{n.calculator}"')
        if n.name:
            lines.append(f'  name: "{n.name}"')
        for port, stream in n.inputs.items():
            lines.append(f'  input_stream: "{port}:{stream}"')
        for port, stream in n.outputs.items():
            lines.append(f'  output_stream: "{port}:{stream}"')
        for port, side in n.input_side_packets.items():
            lines.append(f'  input_side_packet: "{port}:{side}"')
        for port, side in n.output_side_packets.items():
            lines.append(f'  output_side_packet: "{port}:{side}"')
        if n.executor:
            lines.append(f'  executor: "{n.executor}"')
        if isinstance(n.input_policy, str) and n.input_policy:
            lines.append(f'  input_policy: "{n.input_policy}"')
        if n.max_in_flight:
            lines.append(f"  max_in_flight: {n.max_in_flight}")
        if n.max_queue_size != -1:
            lines.append(f"  max_queue_size: {n.max_queue_size}")
        for b in n.back_edge_inputs:
            lines.append(f'  back_edge_input: "{b}"')
        if n.options:
            opts = " ".join(
                f'{k}: "{v}"' if isinstance(v, str) else
                f"{k}: null" if v is None else
                f"{k}: {str(v).lower() if isinstance(v, bool) else v}"
                for k, v in n.options.items())
            lines.append(f"  options {{ {opts} }}")
        lines.append("}")
    return "\n".join(lines) + "\n"
