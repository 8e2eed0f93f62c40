"""Packets — the basic data unit (paper §3.1).

A Packet pairs a numeric timestamp with a shared reference to an immutable
payload.  Packets are value classes: copies are cheap and share ownership of
the payload (Python references give us the paper's reference-counting
semantics for free), while each copy carries its own timestamp.

Payload immutability is by convention, for arbitrary Python objects and
for ``torch.Tensor`` payloads alike.  The framework never mutates
payloads; calculators must not either.
"""
from __future__ import annotations

from typing import Any, Optional, Type

from .timestamp import Timestamp, ts


class Packet:
    __slots__ = ("_payload", "_timestamp", "_type")

    def __init__(self, payload: Any, timestamp: Timestamp = Timestamp.unset(),
                 payload_type: Optional[Type] = None):
        self._payload = payload
        self._timestamp = ts(timestamp)
        self._type = payload_type if payload_type is not None else type(payload)

    # -- accessors ------------------------------------------------------
    @property
    def timestamp(self) -> Timestamp:
        return self._timestamp

    @property
    def payload(self) -> Any:
        return self._payload

    def get(self) -> Any:
        if self.is_empty():
            raise ValueError("get() on an empty packet")
        return self._payload

    @property
    def payload_type(self) -> Type:
        return self._type

    def is_empty(self) -> bool:
        return self._payload is None

    # -- value semantics --------------------------------------------------
    def at(self, timestamp) -> "Packet":
        """A copy of this packet with a different timestamp (shares payload)."""
        return Packet(self._payload, ts(timestamp), self._type)

    def __repr__(self) -> str:
        return f"Packet({self._type.__name__}@{self._timestamp!r})"


# The canonical empty packet — used by input sets when a stream has no
# packet at a settled timestamp (paper §4.1.3 footnote 7).
def empty_packet(timestamp: Timestamp = Timestamp.unset()) -> Packet:
    return Packet(None, timestamp, type(None))


def make_packet(payload: Any, timestamp) -> Packet:
    return Packet(payload, ts(timestamp))
