"""Calculator contracts (paper §3.4 — ``GetContract()``).

A contract declares the expected types of a calculator's input streams,
output streams and side packets.  The framework verifies connected stream
types against contracts at graph-initialization time (paper §3.5 constraint
2/3) — a static check, before any data flows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Type


class AnyType:
    """Wildcard packet type (matches everything)."""


@dataclasses.dataclass
class PortSpec:
    """One named input/output port."""
    name: str
    type: Type = AnyType
    optional: bool = False

    def accepts(self, other: Type) -> bool:
        if self.type is AnyType or other is AnyType:
            return True
        return issubclass(other, self.type) or issubclass(self.type, other)


@dataclasses.dataclass
class CalculatorContract:
    inputs: Dict[str, PortSpec] = dataclasses.field(default_factory=dict)
    outputs: Dict[str, PortSpec] = dataclasses.field(default_factory=dict)
    input_side_packets: Dict[str, PortSpec] = dataclasses.field(default_factory=dict)
    output_side_packets: Dict[str, PortSpec] = dataclasses.field(default_factory=dict)
    # Name of the input policy this calculator requires (paper footnote 3:
    # a calculator using a special input policy declares it in its contract).
    input_policy: Optional[str] = None
    # Advanced feature (paper footnote 1): allow simultaneous Process()
    # calls assuming temporal independence.
    max_in_flight: int = 1

    # -- builder helpers ---------------------------------------------------
    def add_input(self, name: str, type: Type = AnyType, optional: bool = False) -> "CalculatorContract":
        self.inputs[name] = PortSpec(name, type, optional)
        return self

    def add_output(self, name: str, type: Type = AnyType) -> "CalculatorContract":
        self.outputs[name] = PortSpec(name, type)
        return self

    def add_input_side_packet(self, name: str, type: Type = AnyType, optional: bool = False) -> "CalculatorContract":
        self.input_side_packets[name] = PortSpec(name, type, optional)
        return self

    def add_output_side_packet(self, name: str, type: Type = AnyType) -> "CalculatorContract":
        self.output_side_packets[name] = PortSpec(name, type)
        return self

    def set_input_policy(self, policy: str) -> "CalculatorContract":
        self.input_policy = policy
        return self

    def set_max_in_flight(self, n: int) -> "CalculatorContract":
        self.max_in_flight = max(1, int(n))
        return self

    # -- queries -----------------------------------------------------------
    def expects_inputs(self) -> bool:
        return bool(self.inputs)


def contract() -> CalculatorContract:
    return CalculatorContract()
