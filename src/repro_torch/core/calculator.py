"""Calculator base class and execution context (paper §3.4).

All calculators derive from :class:`Calculator` and implement the four
essential methods ``get_contract`` / ``open`` / ``process`` / ``close``.
The framework constructs one calculator object per graph node per graph run,
calls ``open`` once side packets are available, calls ``process`` repeatedly
whenever the node's input policy forms a valid input set, and calls ``close``
when inputs are exhausted or an error terminates the run.

Execution guarantee (paper §3): each calculator executes on at most one
thread at a time (unless it opts into ``max_in_flight > 1``), which together
with packet immutability means calculator authors need no multithreading
expertise.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, TYPE_CHECKING

from .contract import CalculatorContract, contract
from .packet import Packet, empty_packet
from .timestamp import Timestamp, ts

if TYPE_CHECKING:  # pragma: no cover
    from .graph import _NodeRuntime


class InputSet:
    """The packets presented to one ``process`` call — one slot per input
    stream, aligned at a single settled timestamp (default policy) or
    whatever the node's input policy formed."""

    __slots__ = ("_packets", "_timestamp")

    def __init__(self, packets: Dict[str, Packet], timestamp: Timestamp):
        self._packets = packets
        self._timestamp = timestamp

    @property
    def timestamp(self) -> Timestamp:
        return self._timestamp

    def __getitem__(self, name: str) -> Packet:
        return self._packets.get(name) or empty_packet(self._timestamp)

    def has(self, name: str) -> bool:
        p = self._packets.get(name)
        return p is not None and not p.is_empty()

    def names(self) -> List[str]:
        return list(self._packets)

    def value(self, name: str, default: Any = None) -> Any:
        p = self._packets.get(name)
        return default if (p is None or p.is_empty()) else p.payload


class OutputStreamHandle:
    """Write-side of an output stream as seen by a calculator."""

    def __init__(self, name: str, node: "_NodeRuntime"):
        self._name = name
        self._node = node

    def add_packet(self, packet: Packet) -> None:
        self._node.emit(self._name, packet)

    def add(self, payload: Any, timestamp) -> None:
        self.add_packet(Packet(payload, ts(timestamp)))

    def set_next_timestamp_bound(self, bound) -> None:
        """Explicitly advance the timestamp bound beyond what the last packet
        implies (paper footnote 6) so downstream nodes settle sooner."""
        self._node.advance_bound(self._name, ts(bound))

    def close(self) -> None:
        self._node.close_output(self._name)


class CalculatorContext:
    """Handed to open/process/close. Exposes inputs, outputs, side packets,
    node options and the current input timestamp."""

    def __init__(self, node: "_NodeRuntime"):
        self._node = node
        self.inputs: InputSet = InputSet({}, Timestamp.unset())
        self._outputs = {name: OutputStreamHandle(name, node)
                         for name in node.output_names}

    # -- outputs -------------------------------------------------------
    def outputs(self, name: str) -> OutputStreamHandle:
        try:
            return self._outputs[name]
        except KeyError:
            raise KeyError(f"node {self._node.name!r} has no output {name!r}; "
                           f"declared: {list(self._outputs)}") from None

    def emit(self, name: str, payload: Any, timestamp=None) -> None:
        t = self.input_timestamp if timestamp is None else ts(timestamp)
        self.outputs(name).add(payload, t)

    # -- inputs / metadata ------------------------------------------------
    @property
    def input_timestamp(self) -> Timestamp:
        return self.inputs.timestamp

    def side(self, name: str, default: Any = None) -> Any:
        p = self._node.input_side_packets.get(name)
        return default if p is None or p.is_empty() else p.payload

    def output_side_packet(self, name: str, payload: Any) -> None:
        self._node.emit_side_packet(name, payload)

    @property
    def options(self) -> Dict[str, Any]:
        return self._node.options

    @property
    def node_name(self) -> str:
        return self._node.name

    @property
    def node_index(self) -> int:
        return self._node.index

    # -- tracing -------------------------------------------------------
    @property
    def tracer(self):
        """The graph's tracer (a :class:`~repro_torch.core.tracer.NullTracer`
        when tracing is disabled) — for calculators that record richer
        events than :meth:`trace_gauge`, e.g. the serving observer's SPAN
        lifecycle markers (serving/observe.py)."""
        return self._node.graph.tracer

    def trace_gauge(self, name: str, value: int) -> None:
        """Record a named gauge sample (e.g. KV-block-pool occupancy) into
        the graph's tracer; exported as a chrome://tracing counter track
        by :meth:`repro_torch.core.tracer.Tracer.export_chrome_trace`."""
        from . import tracer as trace_mod
        self._node.graph.tracer.record(trace_mod.GAUGE, self._node.index,
                                       name, 0, int(value))


class Calculator:
    """Base class for all calculators."""

    #: Subclasses may override as a class attribute instead of get_contract.
    CONTRACT: Optional[CalculatorContract] = None

    @classmethod
    def get_contract(cls) -> CalculatorContract:
        if cls.CONTRACT is not None:
            return cls.CONTRACT
        return contract()

    # Lifecycle ---------------------------------------------------------
    def open(self, ctx: CalculatorContext) -> None:  # noqa: D401
        """Prepare per-graph-run state; side packets are available; may
        write outputs."""

    def process(self, ctx: CalculatorContext) -> None:
        """Handle one input set. May write zero, one or multiple outputs —
        the higher-level semantics that distinguish this framework from
        one-in/one-out NN graph engines (paper §2)."""
        raise NotImplementedError

    def close(self, ctx: CalculatorContext) -> None:
        """Called after inputs are exhausted or on error; side packets remain
        accessible, inputs do not; may still write outputs."""


class SourceCalculator(Calculator):
    """Convenience base for source nodes (no input streams): ``process`` is
    called repeatedly until it returns ``False`` (no more data)."""

    def process(self, ctx: CalculatorContext) -> bool:  # type: ignore[override]
        raise NotImplementedError
