"""The traced run's instruments: host spans around the engine's calls,
and the device's timeline from ``torch.profiler`` over part of the
window.

Spans are taken by the benchmark around the calls into the program's
engine instance (``decode``, ``prefill``, ``extend``, ``insert``), on the
host clock, with what each call was given (rows, positions, prompt
tokens).  The profiler records CUDA activity only; a marker kernel
launched on a stream of its own right after the profiler starts ties its
clock to the host's, so that each of the device's idle gaps is charged
to what the host was doing at the time.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import numpy as np

ENGINE_CALLS = ("decode", "prefill", "extend", "insert")


@dataclasses.dataclass
class Span:
    name: str
    t0: float
    t1: float
    info: Dict[str, Any]


def _info(name: str, args, kw) -> Dict[str, Any]:
    if name == "decode":
        positions, active = np.asarray(args[3]), np.asarray(args[4], bool)
        return {"rows": int(active.size), "active": int(active.sum()),
                "key_sum": int((positions[active] + 1).sum())}
    if name == "prefill":
        return {"tokens": int(np.asarray(args[0]).shape[-1]), "prefix": 0}
    if name == "extend":
        return {"tokens": int(np.asarray(args[2]).size),
                "prefix": int(args[3])}
    return {}


class Spans:
    """Host spans around an engine instance's calls (or each training step),
    kept while ``recording``; ``where`` names what a span's host time was
    in (``"engine."`` + the call's name)."""

    def __init__(self, where: str = "engine.",
                 outside: str = "host outside the engine"):
        self.spans: List[Span] = []
        self.recording = False
        self.where, self.outside = where, outside

    def wrap(self, engine) -> None:
        for name in ENGINE_CALLS:
            setattr(engine, name, self._wrapped(name, getattr(engine, name)))

    def _wrapped(self, name, fn):
        def call(*args, **kw):
            if not self.recording:
                return fn(*args, **kw)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            self.spans.append(Span(name, t0, time.perf_counter(),
                                   _info(name, args, kw)))
            return out
        return call

    def within(self, t0: float, t1: float,
               names=ENGINE_CALLS) -> List[Span]:
        """The spans of ``names`` (None: every span) that start in
        [t0, t1), in time order."""
        return sorted((s for s in self.spans
                       if (names is None or s.name in names)
                       and t0 <= s.t0 < t1),
                      key=lambda s: s.t0)


def _union(intervals):
    """Merged [start, end] intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """``torch.profiler`` over [start, stop] of the window, CUDA only."""

    MARK = "spin"

    def __init__(self):
        self.prof = None
        self.t_mark = self.t_stop = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        stream = torch.cuda.Stream()
        with torch.cuda.stream(stream):
            self.t_mark = time.perf_counter()
            torch.cuda._sleep(1000)

    def stop(self) -> None:
        self.t_stop = time.perf_counter()
        self.prof.stop()

    def reduce(self, spans: Optional[Spans] = None) -> Dict[str, Any]:
        """busy_s, window_s, the device operations that took most time
        and the idle gaps by what the host was doing."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in
               ("kernel", "gpu_memcpy", "gpu_memset")]
        marks = [e for e in dev if self.MARK in e.get("name", "")]
        dev = [e for e in dev if self.MARK not in e.get("name", "")]
        if not marks:
            raise RuntimeError("the profiler recorded no marker kernel: "
                               "no device timeline to read")
        mark = min(float(e["ts"]) for e in marks)
        window_us = (self.t_stop - self.t_mark) * 1e6
        end = mark + window_us
        ivals = [(max(float(e["ts"]), mark),
                  min(float(e["ts"]) + float(e["dur"]), end))
                 for e in dev]
        ivals = [(a, b) for a, b in ivals if b > a]
        busy = _union(ivals)
        busy_us = sum(b - a for a, b in busy)
        by_name: Dict[str, float] = {}
        for e in dev:
            name = e["name"][:160]
            by_name[name] = by_name.get(name, 0.0) + float(e["dur"]) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps: Dict[str, float] = {}
        edges = [mark] + [x for ab in busy for x in ab] + [end]
        host = spans.within(self.t_mark, self.t_stop, None) if spans \
            else []
        starts = [s.t0 for s in host]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = self.t_mark + ((a + b) / 2 - mark) / 1e6
            i = bisect.bisect_right(starts, mid) - 1
            what = f"host in {spans.where}{host[i].name}" \
                if i >= 0 and mid < host[i].t1 else \
                (spans.outside if spans else "host outside the spans")
            gaps[what] = gaps.get(what, 0.0) + (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_us / 1e6, "window_s": window_us / 1e6,
                "device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle],
                "kernels": len(dev)}
