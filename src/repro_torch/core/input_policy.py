"""Input policies (paper §4.1.3).

Synchronization is handled *locally on each node*: the node's input policy
looks at the node's input-stream queues and decides (a) whether the node is
ready, and (b) which packets form the next *input set*.

``DefaultInputPolicy`` provides the paper's deterministic guarantees:
  1. packets with equal timestamps on multiple streams are always processed
     together, regardless of real-time arrival order;
  2. input sets are processed in strictly ascending timestamp order;
  3. no packets are dropped; fully deterministic;
  4. the node becomes ready as soon as possible given 1–3.

A calculator with the default policy is ready iff there is a timestamp that
is **settled across all input streams** and has a packet on at least one
stream.  (A timestamp is settled on a stream once it is below the stream's
timestamp bound.)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from .calculator import InputSet
from .packet import Packet, empty_packet
from .stream import InputStreamQueue
from .timestamp import Timestamp


class InputPolicy:
    """Strategy interface.  All methods are called under the graph lock."""

    name = "base"

    def ready_timestamp(self, queues: Dict[str, InputStreamQueue]) -> Optional[Timestamp]:
        """Return the timestamp of the next processable input set, or None."""
        raise NotImplementedError

    def pop_input_set(self, queues: Dict[str, InputStreamQueue],
                      t: Timestamp) -> InputSet:
        raise NotImplementedError


class DefaultInputPolicy(InputPolicy):
    name = "default"

    def ready_timestamp(self, queues: Dict[str, InputStreamQueue]) -> Optional[Timestamp]:
        # Candidate = smallest head timestamp over non-empty queues.
        candidate: Optional[Timestamp] = None
        for q in queues.values():
            h = q.head_timestamp()
            if h is not None and (candidate is None or h < candidate):
                candidate = h
        if candidate is None:
            return None
        # Ready iff the candidate is settled on every input stream.  Streams
        # that hold a packet at ``candidate`` are settled trivially (their
        # bound is already past it); the binding constraint comes from the
        # streams with no packet at the candidate timestamp (Figure 2).
        for q in queues.values():
            if not q.settled(candidate):
                return None
        return candidate

    def pop_input_set(self, queues: Dict[str, InputStreamQueue],
                      t: Timestamp) -> InputSet:
        packets: Dict[str, Packet] = {}
        for port, q in queues.items():
            p = q.pop_at(t)
            packets[port] = p if p is not None else empty_packet(t)
        return InputSet(packets, t)


class ImmediateInputPolicy(InputPolicy):
    """Deliver packets as soon as they arrive — sacrifices cross-stream
    alignment (guarantee 1) in exchange for minimum latency.  Used by
    real-time flow-control nodes (paper §4.1.4: 'these nodes use special
    input policies to make fast decisions')."""

    name = "immediate"

    def ready_timestamp(self, queues: Dict[str, InputStreamQueue]) -> Optional[Timestamp]:
        candidate: Optional[Timestamp] = None
        for q in queues.values():
            h = q.head_timestamp()
            if h is not None and (candidate is None or h < candidate):
                candidate = h
        return candidate

    def pop_input_set(self, queues: Dict[str, InputStreamQueue],
                      t: Timestamp) -> InputSet:
        # Deliver every packet whose head matches t, but do not wait for
        # bounds on the other streams.
        packets: Dict[str, Packet] = {}
        for port, q in queues.items():
            p = q.pop_at(t)
            packets[port] = p if p is not None else empty_packet(t)
        return InputSet(packets, t)


class SyncSetInputPolicy(InputPolicy):
    """Group inputs into named sets; enforce timestamp synchronization only
    *within* each set, not across sets (last paragraph of paper §4.1.3).

    ``sets`` maps set-name -> list of input-port names.  Readiness is the
    earliest default-policy-ready timestamp of any single set.
    """

    name = "sync_sets"

    def __init__(self, sets: List[List[str]]):
        self.sets = [list(s) for s in sets]
        self._default = DefaultInputPolicy()

    def _subqueues(self, queues: Dict[str, InputStreamQueue], ports: List[str]):
        return {p: queues[p] for p in ports if p in queues}

    def ready_timestamp(self, queues: Dict[str, InputStreamQueue]) -> Optional[Timestamp]:
        best: Optional[Tuple[Timestamp, int]] = None
        for i, ports in enumerate(self.sets):
            sub = self._subqueues(queues, ports)
            if not sub:
                continue
            t = self._default.ready_timestamp(sub)
            if t is not None and (best is None or t < best[0]):
                best = (t, i)
        return best[0] if best else None

    def pop_input_set(self, queues: Dict[str, InputStreamQueue],
                      t: Timestamp) -> InputSet:
        # Pop from the ready set(s) at t; other sets contribute empty slots.
        packets: Dict[str, Packet] = {p: empty_packet(t) for p in queues}
        for ports in self.sets:
            sub = self._subqueues(queues, ports)
            if sub and self._default.ready_timestamp(sub) == t:
                for port, q in sub.items():
                    p = q.pop_at(t)
                    if p is not None:
                        packets[port] = p
        return InputSet(packets, t)


_POLICIES = {
    "default": DefaultInputPolicy,
    "immediate": ImmediateInputPolicy,
}


def make_input_policy(spec) -> InputPolicy:
    """``spec`` is a policy name, a policy instance, or
    ``("sync_sets", [[...], [...]])``."""
    if isinstance(spec, InputPolicy):
        return spec
    if spec is None:
        return DefaultInputPolicy()
    if isinstance(spec, str):
        try:
            return _POLICIES[spec]()
        except KeyError:
            raise KeyError(f"unknown input policy {spec!r}; "
                           f"known: {sorted(_POLICIES)} + sync_sets") from None
    if isinstance(spec, (tuple, list)) and spec and spec[0] == "sync_sets":
        return SyncSetInputPolicy(spec[1])
    raise TypeError(f"bad input policy spec: {spec!r}")
