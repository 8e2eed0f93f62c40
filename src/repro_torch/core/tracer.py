"""Tracer (paper §5.1).

Follows individual packets across the graph recording timing events.  Each
event is a :class:`TraceEvent` with ``event_time``, ``event_type``,
``packet_timestamp``, ``packet_data_id``, ``node_id`` and ``stream_id`` —
sufficient to reconstruct data flow and execution across the graph.

Storage is a fixed-size circular buffer.  To avoid thread contention the
implementation is *mutex-free*: slot indices are claimed with
``itertools.count`` (atomic in CPython) and written without locking, exactly
the lock-free ring-buffer approach the paper describes.  When tracing is
disabled the graph holds a :class:`NullTracer` whose ``record`` is a no-op —
and like the paper's compiler flag, ``repro_torch.core.tracer.COMPILED_OUT = True``
removes even that call overhead by swapping the graph's hooks out entirely.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, NamedTuple, Optional

# Event types
READY = "READY"
RUN_START = "RUN_START"
RUN_END = "RUN_END"
PACKET_EMIT = "PACKET_EMIT"
PACKET_QUEUED = "PACKET_QUEUED"
PACKET_DROPPED = "PACKET_DROPPED"
OPEN = "OPEN"
CLOSE = "CLOSE"
THROTTLE = "THROTTLE"
# Named gauge sample (stream_id = gauge name, packet_data_id = value);
# e.g. KV-block-pool occupancy from the paged serving scheduler.
GAUGE = "GAUGE"
# Request-lifecycle span marker (serving/observe.py): stream_id is
# "<phase>@<request_id>", packet_timestamp a sequence number (token index,
# chunk index, ...), packet_data_id a phase-specific value (accepted
# count, finish-reason code, ...).
SPAN = "SPAN"

# Module-level switch mirroring the paper's "omit the tracer module code
# using a compiler flag".
COMPILED_OUT = False


class TraceEvent(NamedTuple):
    event_time: int          # perf_counter_ns
    event_type: str
    node_id: int
    stream_id: str
    packet_timestamp: int
    packet_data_id: int
    thread_id: int


class Tracer:
    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._buf: List[Optional[TraceEvent]] = [None] * capacity
        self._next = itertools.count()
        self._recorded = 0       # high-water mark, read by events()
        self._t0 = time.perf_counter_ns()
        # OS thread ident -> small dense id.  dict.setdefault is atomic in
        # CPython, so this stays lock-free; the id counter may skip values
        # when two threads race their first record, which is harmless.
        self._thread_ids: Dict[int, int] = {}
        self._next_thread_id = itertools.count()

    # Hot path: no locks.  itertools.count.__next__ is atomic in CPython.
    def record(self, event_type: str, node_id: int = -1, stream_id: str = "",
               packet_timestamp: int = 0, packet_data_id: int = 0) -> None:
        ident = threading.get_ident()
        tid = self._thread_ids.get(ident)
        if tid is None:
            tid = self._thread_ids.setdefault(ident,
                                              next(self._next_thread_id))
        i = next(self._next)
        self._buf[i % self.capacity] = TraceEvent(
            time.perf_counter_ns() - self._t0, event_type, node_id,
            stream_id, packet_timestamp, packet_data_id, tid)
        if i >= self._recorded:  # benign race: analysis-time snapshot only
            self._recorded = i + 1

    # -- analysis (cold path) ---------------------------------------------
    def events(self) -> List[TraceEvent]:
        # Read the high-water mark WITHOUT claiming a slot id from
        # self._next: consuming one here would make every analysis call
        # shift the ring's wraparound cut by one, skewing which events
        # later reads consider oldest.
        n = self._recorded
        if n <= self.capacity:
            evs = self._buf[:n]
        else:
            cut = n % self.capacity
            evs = self._buf[cut:] + self._buf[:cut]
        return [e for e in evs if e is not None]

    def node_histograms(self, node_names: Dict[int, str]) -> Dict[str, Dict[str, float]]:
        """Elapsed wall time per calculator (paper: 'histograms of various
        resources, such as elapsed time across each calculator')."""
        starts: Dict[tuple, int] = {}
        agg: Dict[str, List[int]] = {}
        for e in self.events():
            key = (e.node_id, e.packet_timestamp)
            if e.event_type == RUN_START:
                starts[key] = e.event_time
            elif e.event_type == RUN_END and key in starts:
                agg.setdefault(node_names.get(e.node_id, str(e.node_id)),
                               []).append(e.event_time - starts.pop(key))
        out = {}
        for name, xs in agg.items():
            xs.sort()
            out[name] = {
                "count": float(len(xs)),
                "total_us": sum(xs) / 1e3,
                "mean_us": (sum(xs) / len(xs)) / 1e3,
                "p50_us": xs[len(xs) // 2] / 1e3,
                "max_us": xs[-1] / 1e3,
            }
        return out

    def stream_histograms(self) -> Dict[str, int]:
        """Packets per stream."""
        out: Dict[str, int] = {}
        for e in self.events():
            if e.event_type == PACKET_QUEUED:
                out[e.stream_id] = out.get(e.stream_id, 0) + 1
        return out

    def critical_path(self, node_names: Dict[int, str],
                      packet_timestamp: int) -> List[str]:
        """Which calculators' RUN intervals lie on the path that produced
        the output at ``packet_timestamp``: the chain of RUN_END events for
        that timestamp ordered by completion (end-to-end latency
        decomposition, paper §5.1)."""
        runs = [e for e in self.events()
                if e.event_type == RUN_END
                and e.packet_timestamp == packet_timestamp]
        runs.sort(key=lambda e: e.event_time)
        return [node_names.get(e.node_id, str(e.node_id)) for e in runs]

    def latency_ns(self, stream_id: str, packet_timestamp: int) -> Optional[int]:
        """Time from first QUEUED event of a timestamp anywhere to its EMIT
        on ``stream_id``."""
        first = None
        emit = None
        for e in self.events():
            if e.packet_timestamp != packet_timestamp:
                continue
            if first is None and e.event_type == PACKET_QUEUED:
                first = e.event_time
            if e.event_type == PACKET_EMIT and e.stream_id == stream_id:
                emit = e.event_time
        if first is None or emit is None:
            return None
        return emit - first


    # -- trace files (paper §5.2: the visualizer 'can load a pre-recorded
    # trace file') ---------------------------------------------------------
    def save(self, path: str, node_names=None) -> None:
        import json
        with open(path, "w") as f:
            f.write(json.dumps({"node_names": node_names or {},
                                "capacity": self.capacity}) + "\n")
            for e in self.events():
                f.write(json.dumps(list(e)) + "\n")

    @staticmethod
    def load(path: str):
        """Returns (Tracer, node_names) reconstructed from a trace file."""
        import json
        with open(path) as f:
            header = json.loads(f.readline())
            t = Tracer(header.get("capacity", 65536))
            for line in f:
                e = TraceEvent(*json.loads(line))
                i = next(t._next)
                t._buf[i % t.capacity] = e
                t._recorded = i + 1
        names = {int(k): v for k, v in header.get("node_names", {}).items()}
        return t, names

    def export_chrome_trace(self, path: str, node_names=None) -> None:
        """Write the ring buffer as chrome://tracing / Perfetto JSON
        (paper §5.2: the visualizer loads pre-recorded trace files).

        Calculator RUN intervals become complete ("X") events named after
        the node and laid out on one track per *executor thread* (the
        thread that actually ran the task — ``TraceEvent.thread_id``),
        packet events become instants ("i"), GAUGE samples become counter
        ("C") tracks — so KV-block-pool occupancy plots as a pressure
        curve over the decode timeline — and SPAN lifecycle markers
        (serving/observe.py) become instants on their thread track."""
        import json
        names = node_names or {}
        evs = self.events()
        out = []
        for tid in sorted({e.thread_id for e in evs}):
            out.append({"ph": "M", "name": "thread_name", "pid": 0,
                        "tid": int(tid), "args": {"name": f"thread-{tid}"}})
        starts: Dict[tuple, int] = {}
        for e in evs:
            ts_us = e.event_time / 1e3
            key = (e.node_id, e.thread_id, e.packet_timestamp)
            if e.event_type == RUN_START:
                starts[key] = e.event_time
            elif e.event_type == RUN_END:
                t0 = starts.pop(key, None)
                if t0 is None:
                    continue         # start fell off the ring buffer
                out.append({
                    "ph": "X", "pid": 0, "tid": e.thread_id,
                    "name": str(names.get(e.node_id, e.node_id)),
                    "cat": "run", "ts": t0 / 1e3,
                    "dur": (e.event_time - t0) / 1e3,
                    "args": {"node": str(names.get(e.node_id, e.node_id)),
                             "packet_timestamp": e.packet_timestamp}})
            elif e.event_type == GAUGE:
                out.append({
                    "ph": "C", "pid": 0, "ts": ts_us,
                    "name": e.stream_id,
                    "args": {"value": e.packet_data_id}})
            elif e.event_type == SPAN:
                out.append({
                    "ph": "i", "s": "t", "pid": 0, "tid": e.thread_id,
                    "name": e.stream_id, "cat": "lifecycle", "ts": ts_us,
                    "args": {"seq": e.packet_timestamp,
                             "value": e.packet_data_id}})
            elif e.event_type in (PACKET_EMIT, PACKET_QUEUED,
                                  PACKET_DROPPED):
                out.append({
                    "ph": "i", "s": "t", "pid": 0, "tid": e.thread_id,
                    "name": f"{e.event_type} {e.stream_id}",
                    "cat": "packet", "ts": ts_us,
                    "args": {"node": str(names.get(e.node_id, e.node_id)),
                             "packet_timestamp": e.packet_timestamp,
                             "packet_data_id": e.packet_data_id}})
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)


class NullTracer(Tracer):
    def __init__(self):  # no buffer
        self._next = itertools.count()
        self._buf = []
        self.capacity = 0
        self._t0 = 0

    def record(self, *a, **k) -> None:  # pragma: no cover - trivial
        pass

    def events(self) -> List[TraceEvent]:
        return []
