"""Basic structural calculators: sources, sinks, pass-through, demux/mux,
gating, frame selection, cloning, sync points."""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import torch

from ..core.calculator import Calculator, CalculatorContext, SourceCalculator
from ..core.contract import AnyType, contract
from ..core.packet import Packet
from ..core.registry import register_calculator
from ..core.timestamp import Timestamp, ts


@register_calculator
class PassThroughCalculator(Calculator):
    """Forwards every input packet unchanged on the same-named output.
    Variable port set (DYNAMIC)."""

    DYNAMIC = True

    def process(self, ctx: CalculatorContext) -> None:
        for name in ctx.inputs.names():
            p = ctx.inputs[name]
            if not p.is_empty() and name in ctx._outputs:
                ctx.outputs(name).add_packet(p)


@register_calculator
class IteratorSourceCalculator(SourceCalculator):
    """Source that drains a Python iterable supplied as side packet 'items';
    each item may be (timestamp, payload) or just payload (auto-timestamped
    0,1,2,...)."""

    CONTRACT = (contract()
                .add_input_side_packet("items", AnyType)
                .add_output("OUT"))

    def open(self, ctx: CalculatorContext) -> None:
        self._it: Iterator = iter(ctx.side("items"))
        self._auto_t = 0

    def process(self, ctx: CalculatorContext) -> bool:
        try:
            item = next(self._it)
        except StopIteration:
            return False
        if isinstance(item, tuple) and len(item) == 2 and \
                isinstance(item[0], (int, Timestamp)):
            t, payload = item
        else:
            t, payload = self._auto_t, item
            self._auto_t += 1
        ctx.outputs("OUT").add(payload, ts(t))
        return True


@register_calculator
class CallbackSourceCalculator(SourceCalculator):
    """Source driven by a callable side packet 'next_fn' returning
    (timestamp, payload) or None when exhausted."""

    CONTRACT = (contract()
                .add_input_side_packet("next_fn", AnyType)
                .add_output("OUT"))

    def open(self, ctx: CalculatorContext) -> None:
        self._fn: Callable[[], Optional[tuple]] = ctx.side("next_fn")

    def process(self, ctx: CalculatorContext) -> bool:
        item = self._fn()
        if item is None:
            return False
        t, payload = item
        ctx.outputs("OUT").add(payload, ts(t))
        return True


@register_calculator
class SinkCalculator(Calculator):
    """Terminal node: hands every packet to a side-packet callback 'handler'
    (e.g. write to file / collect in memory)."""

    CONTRACT = (contract()
                .add_input("IN", AnyType)
                .add_input_side_packet("handler", AnyType))

    def open(self, ctx: CalculatorContext) -> None:
        self._handler = ctx.side("handler")

    def process(self, ctx: CalculatorContext) -> None:
        p = ctx.inputs["IN"]
        if not p.is_empty():
            self._handler(p)


@register_calculator
class DemuxCalculator(Calculator):
    """Splits an input stream into N interleaved substreams (paper §6.2's
    demultiplexing node): packet i goes to output ``OUT<i mod N>``.
    Advances the bounds of the other outputs so downstream default-policy
    nodes never stall."""

    DYNAMIC = True

    def open(self, ctx: CalculatorContext) -> None:
        self._i = 0
        self._outs: List[str] = sorted(
            ctx._node.output_names)  # OUT0, OUT1, ...

    def process(self, ctx: CalculatorContext) -> None:
        p = ctx.inputs["IN"]
        if p.is_empty():
            return
        k = self._i % len(self._outs)
        self._i += 1
        for j, name in enumerate(self._outs):
            if j == k:
                ctx.outputs(name).add_packet(p)
            else:
                ctx.outputs(name).set_next_timestamp_bound(
                    p.timestamp.successor())


@register_calculator
class MuxCalculator(Calculator):
    """Merges packets from all inputs into one output ordered by timestamp
    (inputs must be disjoint in timestamps, e.g. demuxed substreams)."""

    DYNAMIC = True

    def process(self, ctx: CalculatorContext) -> None:
        for name in ctx.inputs.names():
            p = ctx.inputs[name]
            if not p.is_empty():
                ctx.outputs("OUT").add_packet(p)


@register_calculator
class GateCalculator(Calculator):
    """Passes IN through while the most recent ALLOW packet is truthy."""

    CONTRACT = (contract()
                .add_input("IN", AnyType)
                .add_input("ALLOW", AnyType, optional=True)
                .add_output("OUT")
                .set_input_policy("immediate"))

    def open(self, ctx: CalculatorContext) -> None:
        self._allow = bool(ctx.options.get("initially_open", True))

    def process(self, ctx: CalculatorContext) -> None:
        a = ctx.inputs["ALLOW"]
        if not a.is_empty():
            self._allow = bool(a.payload)
        p = ctx.inputs["IN"]
        if p.is_empty():
            return
        if self._allow:
            ctx.outputs("OUT").add_packet(p)
        else:
            ctx.outputs("OUT").set_next_timestamp_bound(
                p.timestamp.successor())


@register_calculator
class FrameSelectCalculator(Calculator):
    """Selects every Nth packet (temporal subsampling for the slow
    detection branch, paper §6.1 'frame-selection node').  Dropped
    timestamps advance the output bound (timestamp_offset semantics) so the
    downstream detector-merge join stays settled."""

    CONTRACT = (contract()
                .add_input("IN", AnyType)
                .add_output("OUT"))

    def open(self, ctx: CalculatorContext) -> None:
        self._every = int(ctx.options.get("every", 1))
        self._count = 0

    def process(self, ctx: CalculatorContext) -> None:
        p = ctx.inputs["IN"]
        if p.is_empty():
            return
        if self._count % self._every == 0:
            ctx.outputs("OUT").add_packet(p)
        else:
            ctx.outputs("OUT").set_next_timestamp_bound(
                p.timestamp.successor())
        self._count += 1


@register_calculator
class PacketClonerCalculator(Calculator):
    """For each TICK packet, re-emits the most recent packet seen on VALUE
    at the tick's timestamp (the classic MediaPipe PacketCloner used to
    align a slow stream with a fast one)."""

    CONTRACT = (contract()
                .add_input("VALUE", AnyType)
                .add_input("TICK", AnyType)
                .add_output("OUT")
                .set_input_policy("immediate"))

    def open(self, ctx: CalculatorContext) -> None:
        self._latest: Optional[Packet] = None

    def process(self, ctx: CalculatorContext) -> None:
        v = ctx.inputs["VALUE"]
        if not v.is_empty():
            self._latest = v
        t = ctx.inputs["TICK"]
        if not t.is_empty():
            if self._latest is not None:
                ctx.outputs("OUT").add(self._latest.payload, t.timestamp)
            else:
                ctx.outputs("OUT").set_next_timestamp_bound(
                    t.timestamp.successor())


@register_calculator
class SidePacketToStreamCalculator(SourceCalculator):
    """Emits the side packet once at Timestamp.prestream()."""

    CONTRACT = (contract()
                .add_input_side_packet("packet", AnyType)
                .add_output("OUT"))

    def open(self, ctx: CalculatorContext) -> None:
        self._sent = False

    def process(self, ctx: CalculatorContext) -> bool:
        if self._sent:
            return False
        ctx.outputs("OUT").add(ctx.side("packet"), Timestamp.prestream())
        self._sent = True
        return True


@register_calculator
class SyncPointCalculator(Calculator):
    """The paper's GPU sync-fence policy: CUDA launches are asynchronous;
    the only place we force a host sync is at a graph sink.  This node
    waits for every CUDA tensor in the payload (bare, or inside a tuple,
    list or dict) on a ``torch.cuda.Event`` recorded on the current
    stream of the tensor's device, then forwards the packet unchanged —
    everything upstream stays pipelined (DESIGN.md §2).  CPU tensors and
    other payloads pass straight through.  A CUDA error raised by the
    wait propagates: it fails the graph run."""

    CONTRACT = (contract()
                .add_input("IN", AnyType)
                .add_output("OUT"))

    def process(self, ctx: CalculatorContext) -> None:
        p = ctx.inputs["IN"]
        if p.is_empty():
            return
        for device in sorted(_cuda_devices(p.payload), key=str):
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
            event.synchronize()
        ctx.outputs("OUT").add_packet(p)


def _cuda_devices(payload) -> set:
    """The CUDA devices of the tensors in ``payload``, looking inside
    tuples, lists and dict values."""
    if isinstance(payload, (tuple, list)):
        return set().union(*map(_cuda_devices, payload))
    if isinstance(payload, dict):
        return set().union(*map(_cuda_devices, payload.values()))
    if isinstance(payload, torch.Tensor) and payload.is_cuda:
        return {payload.device}
    return set()
