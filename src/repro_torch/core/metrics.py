"""Metrics registry: counters, gauges, and percentile histograms.

The serving stack (scheduler, engine, frontend) records into a
:class:`MetricsRegistry`; :meth:`GraphServer.metrics` merges the
per-component registries and exports them as a JSON snapshot or in
Prometheus text exposition format (docs/OBSERVABILITY.md).

Histograms use a *fixed* log-spaced bucket ladder shared by every
instance, which buys two properties:

* registries are mergeable by plain bucket-count addition — no
  re-binning, no loss — so the engine's registry and the scheduler's
  registry combine into one snapshot;
* p50/p95/p99 come straight from the cumulative bucket counts.  A
  quantile is reported as the *upper edge* of the bucket it falls in
  (a conservative bound; ``quantile_bounds`` exposes both edges for
  callers that need the resolution, e.g. the load_bench cross-check).

Like the tracer, metrics honour ``repro_torch.core.tracer.COMPILED_OUT``:
components construct a :class:`NullRegistry` when the flag is set, so
the hot path carries no timing calls at all (measured by the
``observability`` section of ``benchmarks/serve_bench.py``).
"""
from __future__ import annotations

import bisect
import json
import math
import threading
from typing import Dict, Iterable, List, Optional, Tuple

# The shared bucket ladder: 60 log-spaced upper edges covering
# [0.001, ~10^7] with 6 buckets per decade (ratio ~1.47), plus +inf.
# Wide enough for sub-millisecond ITLs and multi-second compile times
# in the same family of histograms (values are unit-agnostic; by
# convention serving histograms record milliseconds, occupancy
# histograms record counts).
_DECADES = 10          # 10^-3 .. 10^7
_PER_DECADE = 6
BUCKET_EDGES: Tuple[float, ...] = tuple(
    10.0 ** (-3 + i / _PER_DECADE) for i in range(_DECADES * _PER_DECADE + 1)
) + (math.inf,)


def _fmt(v: float) -> str:
    """Prometheus-friendly float formatting ("+Inf" for the last edge)."""
    if v == math.inf:
        return "+Inf"
    return repr(float(v))


def _label_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in labels)
    return "{" + inner + "}"


def _sanitize(name: str) -> str:
    """Registry names use dots (``serve.ttft_ms``); Prometheus wants
    ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    if not out or not (out[0].isalpha() or out[0] in "_:"):
        out = "_" + out
    return out


class BoundCounter:
    """Label-resolved counter handle from :meth:`Counter.bind`.

    ``inc`` skips the per-call label sort and tuple allocation, so
    per-tick call sites (the engine's kernel-path observation) can
    record with two dict operations under the lock and nothing else.
    """

    __slots__ = ("_counter", "_key")

    def __init__(self, counter: "Counter",
                 key: Tuple[Tuple[str, str], ...]):
        self._counter = counter
        self._key = key

    def inc(self, amount: float = 1.0) -> None:
        c = self._counter
        with c._lock:
            c._values[self._key] = c._values.get(self._key, 0.0) + amount


class Counter:
    """Monotonically increasing count (per label set)."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def bind(self, **labels: str) -> BoundCounter:
        """Pre-resolve ``labels`` into a :class:`BoundCounter` for
        hot-path use."""
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        return BoundCounter(self, key)

    def value(self, **labels: str) -> float:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        return self._values.get(key, 0.0)

    def total(self) -> float:
        return sum(self._values.values())

    def _merge(self, other: "Counter") -> None:
        with self._lock:
            for key, v in other._values.items():
                self._values[key] = self._values.get(key, 0.0) + v

    def _snapshot(self):
        return {"type": self.kind, "help": self.help,
                "values": [{"labels": dict(k), "value": v}
                           for k, v in sorted(self._values.items())]}

    def _prometheus(self, lines: List[str]) -> None:
        name = _sanitize(self.name)
        lines.append(f"# HELP {name} {self.help or self.name}")
        lines.append(f"# TYPE {name} counter")
        for key, v in sorted(self._values.items()):
            lines.append(f"{name}{_label_str(key)} {_fmt(v)}")


class Gauge:
    """Last-write-wins instantaneous value (per label set)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels: str) -> None:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        self._values[key] = float(value)

    def value(self, **labels: str) -> Optional[float]:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        return self._values.get(key)

    def _merge(self, other: "Gauge") -> None:
        self._values.update(other._values)

    def _snapshot(self):
        return {"type": self.kind, "help": self.help,
                "values": [{"labels": dict(k), "value": v}
                           for k, v in sorted(self._values.items())]}

    def _prometheus(self, lines: List[str]) -> None:
        name = _sanitize(self.name)
        lines.append(f"# HELP {name} {self.help or self.name}")
        lines.append(f"# TYPE {name} gauge")
        for key, v in sorted(self._values.items()):
            lines.append(f"{name}{_label_str(key)} {_fmt(v)}")


class BoundHistogram:
    """Label-resolved histogram handle from :meth:`Histogram.bind` —
    ``observe`` goes straight to the pre-resolved series (one bisect,
    five cell updates; no label sort, no allocation)."""

    __slots__ = ("_series",)

    def __init__(self, series: dict):
        self._series = series

    def observe(self, value: float) -> None:
        Histogram._record(self._series, value)


class Histogram:
    """Log-bucketed distribution with bucket-derived percentiles.

    Every histogram shares :data:`BUCKET_EDGES`, so two histograms of
    the same name merge by element-wise bucket addition.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        # label set -> (bucket counts, total count, sum, min, max)
        self._series: Dict[Tuple[Tuple[str, str], ...], dict] = {}
        self._lock = threading.Lock()

    def _series_for(self, labels: Dict[str, str]) -> dict:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, {
                    "buckets": [0] * len(BUCKET_EDGES),
                    "count": 0, "sum": 0.0,
                    "min": math.inf, "max": -math.inf})
        return s

    @staticmethod
    def _record(s: dict, value: float) -> None:
        i = bisect.bisect_left(BUCKET_EDGES, value)
        if i >= len(BUCKET_EDGES):
            i = len(BUCKET_EDGES) - 1
        # benign races under CPython: += on list element is not atomic but
        # the scheduler records from a single engine thread; cross-thread
        # observers (frontend) use their own registry and merge at read.
        s["buckets"][i] += 1
        s["count"] += 1
        s["sum"] += value
        if value < s["min"]:
            s["min"] = value
        if value > s["max"]:
            s["max"] = value

    def observe(self, value: float, **labels: str) -> None:
        self._record(self._series_for(labels), value)

    def bind(self, **labels: str) -> BoundHistogram:
        """Pre-resolve ``labels`` into a :class:`BoundHistogram` for
        hot-path use (creates the series eagerly)."""
        return BoundHistogram(self._series_for(labels))

    # -- analysis ---------------------------------------------------------
    def count(self, **labels: str) -> int:
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        s = self._series.get(key)
        return 0 if s is None else s["count"]

    def total_count(self) -> int:
        return sum(s["count"] for s in self._series.values())

    def quantile_bounds(self, q: float, **labels: str
                        ) -> Optional[Tuple[float, float]]:
        """(lower, upper) edges of the bucket holding quantile ``q``,
        merged across label sets when none are given."""
        if labels:
            key = tuple(sorted((k, str(v)) for k, v in labels.items()))
            series = [self._series[key]] if key in self._series else []
        else:
            series = list(self._series.values())
        total = sum(s["count"] for s in series)
        if total == 0:
            return None
        buckets = [0] * len(BUCKET_EDGES)
        for s in series:
            for i, c in enumerate(s["buckets"]):
                buckets[i] += c
        rank = q * total
        cum = 0
        for i, c in enumerate(buckets):
            cum += c
            if cum >= rank and c > 0:
                lo = 0.0 if i == 0 else BUCKET_EDGES[i - 1]
                return (lo, BUCKET_EDGES[i])
        return (0.0, BUCKET_EDGES[-1])

    def quantile(self, q: float, **labels: str) -> Optional[float]:
        """Conservative quantile estimate: the upper edge of the bucket
        (clamped to the observed max so +Inf never leaks out)."""
        bounds = self.quantile_bounds(q, **labels)
        if bounds is None:
            return None
        hi = bounds[1]
        mx = max((s["max"] for s in self._series.values()
                  if s["count"]), default=hi)
        return min(hi, mx)

    def _merge(self, other: "Histogram") -> None:
        with self._lock:
            for key, o in other._series.items():
                s = self._series.setdefault(key, {
                    "buckets": [0] * len(BUCKET_EDGES),
                    "count": 0, "sum": 0.0,
                    "min": math.inf, "max": -math.inf})
                for i, c in enumerate(o["buckets"]):
                    s["buckets"][i] += c
                s["count"] += o["count"]
                s["sum"] += o["sum"]
                s["min"] = min(s["min"], o["min"])
                s["max"] = max(s["max"], o["max"])

    def _snapshot(self):
        out = []
        for key, s in sorted(self._series.items()):
            entry = {"labels": dict(key), "count": s["count"],
                     "sum": s["sum"]}
            if s["count"]:
                entry.update({
                    "min": s["min"], "max": s["max"],
                    "mean": s["sum"] / s["count"],
                    "p50": self.quantile(0.50, **dict(key)),
                    "p95": self.quantile(0.95, **dict(key)),
                    "p99": self.quantile(0.99, **dict(key)),
                })
            out.append(entry)
        return {"type": self.kind, "help": self.help, "values": out}

    def _prometheus(self, lines: List[str]) -> None:
        name = _sanitize(self.name)
        lines.append(f"# HELP {name} {self.help or self.name}")
        lines.append(f"# TYPE {name} histogram")
        for key, s in sorted(self._series.items()):
            cum = 0
            for i, edge in enumerate(BUCKET_EDGES):
                cum += s["buckets"][i]
                labels = key + (("le", _fmt(edge)),)
                lines.append(f"{name}_bucket{_label_str(labels)} {cum}")
            lines.append(f"{name}_sum{_label_str(key)} {_fmt(s['sum'])}")
            lines.append(f"{name}_count{_label_str(key)} {s['count']}")


class MetricsRegistry:
    """Named collection of Counter/Gauge/Histogram instruments.

    ``counter``/``gauge``/``histogram`` are get-or-create, so call
    sites don't pre-declare; :meth:`merge` folds another registry in
    (bucket-wise for histograms, sum for counters, last-write for
    gauges); :meth:`snapshot` is JSON-serialisable; :meth:`to_prometheus`
    emits text exposition format.
    """

    #: False on NullRegistry — lets hot paths skip timing work entirely.
    enabled = True

    def __init__(self):
        self._metrics: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str):
        m = self._metrics.get(name)
        if m is None:
            with self._lock:
                m = self._metrics.setdefault(name, cls(name, help))
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered "
                            f"as {type(m).__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, name, help)

    def names(self) -> List[str]:
        return sorted(self._metrics)

    def get(self, name: str):
        return self._metrics.get(name)

    def merge(self, other: "MetricsRegistry") -> "MetricsRegistry":
        for name in other.names():
            om = other.get(name)
            mine = self._get(type(om), name, om.help)
            mine._merge(om)
        return self

    @staticmethod
    def merged(registries: Iterable["MetricsRegistry"]) -> "MetricsRegistry":
        out = MetricsRegistry()
        for r in registries:
            if r is not None and r.enabled:
                out.merge(r)
        return out

    def snapshot(self) -> Dict[str, dict]:
        return {name: self._metrics[name]._snapshot()
                for name in self.names()}

    def snapshot_json(self, **dump_kw) -> str:
        dump_kw.setdefault("indent", 2)
        dump_kw.setdefault("sort_keys", True)
        return json.dumps(self.snapshot(), **dump_kw)

    def to_prometheus(self) -> str:
        lines: List[str] = []
        for name in self.names():
            self._metrics[name]._prometheus(lines)
        return "\n".join(lines) + ("\n" if lines else "")


class NullRegistry(MetricsRegistry):
    """No-op registry handed out under ``tracer.COMPILED_OUT`` — every
    instrument accepts and discards; ``enabled`` is False so callers can
    skip the ``perf_counter`` work feeding it."""

    enabled = False

    class _NullInstrument:
        kind = "null"
        name = help = ""

        def inc(self, *a, **k):
            pass

        def set(self, *a, **k):
            pass

        def observe(self, *a, **k):
            pass

        def bind(self, **k):
            return self

        def value(self, **k):
            return 0.0

        def total(self):
            return 0.0

        def count(self, **k):
            return 0

        def total_count(self):
            return 0

        def quantile(self, q, **k):
            return None

        def quantile_bounds(self, q, **k):
            return None

    _NULL = _NullInstrument()

    def __init__(self):
        super().__init__()

    def counter(self, name: str, help: str = ""):
        return self._NULL

    def gauge(self, name: str, help: str = ""):
        return self._NULL

    def histogram(self, name: str, help: str = ""):
        return self._NULL

    def merge(self, other):
        return self

    def snapshot(self):
        return {}

    def to_prometheus(self) -> str:
        return ""
