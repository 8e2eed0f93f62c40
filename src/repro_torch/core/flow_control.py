"""Node-based flow control (paper §4.1.4, Figure 3).

Back-pressure (the first mechanism) lives in the stream queues + scheduler
(``max_queue_size`` + deadlock relaxation in :mod:`graph`).  This module
provides the second, richer mechanism: special nodes that drop packets
according to real-time constraints, placed *upstream* of expensive work so
no partial processing is wasted.

``FlowLimiterCalculator`` mirrors the paper's example: it admits a new
timestamp into the downstream subgraph only while fewer than
``max_in_flight`` timestamps are outstanding; a loopback stream from the
subgraph's final output tells the limiter when a timestamp finished.  It
uses the *immediate* input policy so it can make fast decisions without
waiting for timestamp alignment.
"""
from __future__ import annotations

from typing import Any, Deque, Dict
import collections

from .calculator import Calculator, CalculatorContext
from .contract import AnyType, contract
from .registry import register_calculator
from .timestamp import Timestamp


@register_calculator
class FlowLimiterCalculator(Calculator):
    """Inputs:
        IN        — the packet stream to admit or drop.
        FINISHED  — loopback from the end of the limited subgraph
                    (declare as a back edge in the NodeConfig).
    Outputs:
        OUT       — admitted packets.
    Options:
        max_in_flight (int, default 1) — outstanding timestamp budget.
        queue_size (int, default 0)    — packets waiting for admission
                                          instead of being dropped.
    """

    CONTRACT = (contract()
                .add_input("IN", AnyType)
                .add_input("FINISHED", AnyType, optional=True)
                .add_output("OUT")
                .set_input_policy("immediate"))

    def open(self, ctx: CalculatorContext) -> None:
        self.max_in_flight = int(ctx.options.get("max_in_flight", 1))
        self.queue_size = int(ctx.options.get("queue_size", 0))
        self.in_flight = 0
        self.pending: Deque = collections.deque()
        self.dropped = 0
        self.admitted = 0

    def _admit(self, ctx: CalculatorContext, packet) -> None:
        self.in_flight += 1
        self.admitted += 1
        ctx.outputs("OUT").add_packet(packet)

    def process(self, ctx: CalculatorContext) -> None:
        fin = ctx.inputs["FINISHED"]
        if not fin.is_empty():
            self.in_flight = max(0, self.in_flight - 1)
            while self.pending and self.in_flight < self.max_in_flight:
                self._admit(ctx, self.pending.popleft())
        pkt = ctx.inputs["IN"]
        if pkt.is_empty():
            return
        if self.in_flight < self.max_in_flight:
            self._admit(ctx, pkt)
        elif len(self.pending) < self.queue_size:
            self.pending.append(pkt)
        else:
            # Drop *upstream* of the expensive subgraph (the whole point):
            # downstream never sees this timestamp.  The output bound can
            # only advance while no earlier packet waits in the pending
            # queue (those may still be emitted later).
            self.dropped += 1
            if not self.pending:
                ctx.outputs("OUT").set_next_timestamp_bound(
                    pkt.timestamp.successor())

    def close(self, ctx: CalculatorContext) -> None:
        # flush whatever is still pending: the run is draining, so the
        # downstream subgraph will get to them
        while self.pending:
            self._admit(ctx, self.pending.popleft())


@register_calculator
class RealTimeDropCalculator(Calculator):
    """Drops packets older than ``max_age`` relative to the newest seen —
    a simpler real-time constraint node (keep-latest semantics)."""

    CONTRACT = (contract()
                .add_input("IN", AnyType)
                .add_output("OUT")
                .set_input_policy("immediate"))

    def open(self, ctx: CalculatorContext) -> None:
        self.max_age = int(ctx.options.get("max_age", 0))
        self.newest = Timestamp.unstarted()
        self.dropped = 0

    def process(self, ctx: CalculatorContext) -> None:
        pkt = ctx.inputs["IN"]
        if pkt.is_empty():
            return
        if pkt.timestamp > self.newest:
            self.newest = pkt.timestamp
        if self.newest - pkt.timestamp > self.max_age:
            self.dropped += 1
            ctx.outputs("OUT").set_next_timestamp_bound(
                pkt.timestamp.successor())
            return
        ctx.outputs("OUT").add_packet(pkt)
