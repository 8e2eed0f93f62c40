"""Streams and input queues (paper §3.2, §4.1.2).

An output stream may fan out to any number of input streams of the same
type; *each input stream receives its own copy of the packets and maintains
its own queue* so the receiving node consumes at its own pace.  We therefore
model the receive side directly: one :class:`InputStreamQueue` per
(consumer-node, input-port) edge.  Packet copies are cheap (shared payload).

Every queue tracks a **timestamp bound** — the lowest possible timestamp of
a future packet.  Arrival of a packet at timestamp ``T`` advances the bound
to ``T + 1`` (monotonicity); a producer may also advance the bound
explicitly without sending a packet (paper footnote 6), letting downstream
nodes settle sooner.  A timestamp ``t`` is *settled* once ``t < bound``.
"""
from __future__ import annotations

import collections
from typing import Deque, Optional

from .packet import Packet
from .timestamp import Timestamp


class StreamError(RuntimeError):
    pass


class InputStreamQueue:
    """Receive-side queue of one stream edge.  NOT thread-safe by itself —
    the graph serializes access under its scheduling lock."""

    __slots__ = ("stream_name", "consumer", "port", "queue", "bound",
                 "closed", "max_queue_size", "hwm", "drop_when_closed")

    def __init__(self, stream_name: str, consumer: str, port: str,
                 max_queue_size: int = -1):
        self.stream_name = stream_name
        self.consumer = consumer
        self.port = port
        self.queue: Deque[Packet] = collections.deque()
        self.bound: Timestamp = Timestamp.unstarted()
        self.closed = False
        # consumer-initiated closure (quiescence breaking a loopback
        # cycle): late packets are silently dropped, not an error — the
        # producer is still alive and allowed to flush during Close().
        self.drop_when_closed = False
        # -1 = unbounded.  When set, the producer is throttled while
        # len(queue) >= max_queue_size (back-pressure, paper §4.1.4).
        self.max_queue_size = max_queue_size
        self.hwm = 0  # high-water mark, reported by the tracer

    # -- producer side ---------------------------------------------------
    def add(self, packet: Packet) -> None:
        if self.closed:
            if self.drop_when_closed:
                return
            raise StreamError(
                f"packet sent to closed stream {self.stream_name!r}")
        t = packet.timestamp
        if not t.is_allowed_in_stream():
            raise StreamError(
                f"timestamp {t!r} not allowed in stream {self.stream_name!r}")
        if t < self.bound:
            raise StreamError(
                f"non-monotonic timestamp on {self.stream_name!r}: {t!r} is "
                f"below the stream's timestamp bound {self.bound!r}")
        self.queue.append(packet)
        self.hwm = max(self.hwm, len(self.queue))
        self.bound = t.next_allowed_in_stream()

    def advance_bound(self, bound: Timestamp) -> None:
        if self.closed:
            return
        if bound < self.bound:
            raise StreamError(
                f"timestamp bound may not regress on {self.stream_name!r}: "
                f"{bound!r} < {self.bound!r}")
        self.bound = bound

    def close(self) -> None:
        self.closed = True
        self.bound = Timestamp.done()

    # -- consumer side -----------------------------------------------------
    def head_timestamp(self) -> Optional[Timestamp]:
        return self.queue[0].timestamp if self.queue else None

    def settled(self, t: Timestamp) -> bool:
        """State of this stream at ``t`` is irrevocably known."""
        return t < self.bound

    def pop_at(self, t: Timestamp) -> Optional[Packet]:
        if self.queue and self.queue[0].timestamp == t:
            return self.queue.popleft()
        return None

    def pop(self) -> Packet:
        return self.queue.popleft()

    def is_done(self) -> bool:
        return self.closed and not self.queue

    def is_full(self) -> bool:
        return self.max_queue_size >= 0 and len(self.queue) >= self.max_queue_size

    def __len__(self) -> int:
        return len(self.queue)

    def __repr__(self) -> str:
        return (f"InputStreamQueue({self.stream_name!r}->{self.consumer}:"
                f"{self.port}, n={len(self.queue)}, bound={self.bound!r}, "
                f"closed={self.closed})")
